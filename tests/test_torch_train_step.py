"""repro_torch.kernels.fused_train_step against repro.kernels.fused_train_step:
the fused L1 train step (host-sampled batch and in-op sampling) over 10
steps from one state, on the ``ref`` backend and on the ``cuda`` backend's
wrappers (pack, schedule scalars, train-step and AdamW wrappers, in-place
update, rebuild), which take the kernels' plain versions for CPU tensors;
one case against the JAX Pallas kernel in interpret mode; the state layout,
the schedule scalars, the guards and the ``sampling_brick`` knob.

Tolerance: 1e-5 absolute on params, moments and losses (float32; the
gradients' sums run in another order than XLA's, and AdamW's normalised
step passes those last-bit differences on)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dvnr as jdvnr
from repro.core.sampling import step_seeds as jstep_seeds
from repro.core.trainer import DVNRTrainer as JTrainer
from repro.data.volume import make_partition as jmake_partition
from repro.kernels.fused_train_step import ops as jops
from repro_torch import interop
from repro_torch.core.sampling import step_seeds
from repro_torch.kernels import build
from repro_torch.kernels.fused_train_step import ops, ref
from repro_torch.optim.adamw import AdamW, OptConfig, tree_leaves

CFG = jdvnr.SMOKE.replace(batch_size=384, n_levels=2, log2_hashmap_size=8,
                          n_neurons=16, n_hidden_layers=2, lrate=1e-2)
ATOL = 1e-5
P = 2


def _jax_state(cfg=CFG, key=0):
    tr = JTrainer(cfg, P)
    st = tr.init(jax.random.PRNGKey(key))
    return tr, st


def _port_state(st):
    np_state = {"params": jax.tree.map(np.asarray, st.params),
                "opt": jax.tree.map(np.asarray, st.opt),
                "loss_ma": np.asarray(st.loss_ma),
                "active": np.asarray(st.active), "step": st.step}
    return interop.state_from_numpy(np_state, "cpu")


def _assert_close(t_tree, j_tree, atol=ATOL):
    for a, b in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree), strict=True):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), atol=atol, rtol=0)


def _vols():
    parts = [jmake_partition("cloverleaf", p, (1, 1, 2), (10, 10, 10), 0.3)
             for p in range(P)]
    return np.stack([np.asarray(p.normalized()) for p in parts])[..., None]


def _opt_cfg(tr):
    return OptConfig(**tr.adam.cfg.__dict__)


def _jit(op, **static):
    """The JAX op under one jit (compiled once, not traced every step)."""
    return jax.jit(functools.partial(op, **static))


def _batches():
    rng = np.random.default_rng(0)
    gate = np.array([1.0, 1.0], np.float32)
    for step in range(10):
        if step == 6:
            gate = np.array([1.0, 0.0], np.float32)   # partition 1 converged
        yield (rng.uniform(0, 1, (P, 200, 3)).astype(np.float32),
               rng.uniform(0, 1, (P, 200, 1)).astype(np.float32), gate)


@pytest.fixture(scope="module")
def jax_fused_run():
    """10 JAX ``fused_train_step`` steps on ``ref``: the losses and the end
    state (shared by both port backends)."""
    tr, st = _jax_state()
    jp, jo = st.params, st.opt
    jstep = _jit(jops.fused_train_step, resolutions=CFG.level_resolutions(),
                 opt_cfg=tr.adam.cfg, impl="ref")
    losses = []
    for coords, target, gate in _batches():
        jp, jo, jl = jstep(jp, jo, jnp.asarray(coords), jnp.asarray(target),
                           jnp.asarray(gate))
        losses.append(np.asarray(jl))
    return tr, st, losses, jp, jo


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_fused_step_matches_jax_over_10_steps(jax_fused_run, backend):
    tr, st, losses, jp, jo = jax_fused_run
    ts = _port_state(st)
    tp, to = ts.params, ts.opt
    for (coords, target, gate), jl in zip(_batches(), losses):
        tp, to, tl = ops.fused_train_step(
            tp, to, torch.from_numpy(coords), torch.from_numpy(target),
            torch.from_numpy(gate), resolutions=CFG.level_resolutions(),
            opt_cfg=_opt_cfg(tr), impl=backend)
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=0)
    assert np.array_equal(to["step"].numpy(), np.asarray(jo["step"]))
    _assert_close(tp, jp)
    _assert_close(to["m"], jo["m"])
    _assert_close(to["v"], jo["v"])


SAMPLING_KW = dict(n_batch=CFG.batch_size, boundary_lambda=CFG.boundary_lambda,
                   sigma=CFG.boundary_sigma, ghost=1,
                   resolutions=CFG.level_resolutions())


@pytest.fixture(scope="module")
def jax_sampling_run():
    tr, st = _jax_state(key=1)
    jp, jo = st.params, st.opt
    vols = _vols()
    key = jax.random.PRNGKey(3)
    jstep = _jit(jops.fused_train_step_sampling, opt_cfg=tr.adam.cfg,
                 impl="ref", **SAMPLING_KW)
    losses = []
    for step in range(10):
        jp, jo, jl = jstep(jp, jo, jnp.asarray(vols), jstep_seeds(key, step, P),
                           jnp.ones(P))
        losses.append(np.asarray(jl))
    return tr, st, vols, losses, jp, jo


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_fused_sampling_step_matches_jax_over_10_steps(jax_sampling_run, backend):
    tr, st, vols, losses, jp, jo = jax_sampling_run
    ts = _port_state(st)
    tp, to = ts.params, ts.opt
    key = np.asarray(jax.random.PRNGKey(3))
    for step, jl in enumerate(losses):
        tp, to, tl = ops.fused_train_step_sampling(
            tp, to, torch.from_numpy(vols), step_seeds(key, step, P),
            torch.ones(P), opt_cfg=_opt_cfg(tr), impl=backend, **SAMPLING_KW)
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=0)
    _assert_close(tp, jp)
    _assert_close(to["m"], jo["m"])
    _assert_close(to["v"], jo["v"])


def test_fused_sampling_step_matches_jax_pallas_kernel_in_interpret_mode():
    """The JAX package's Pallas train-step kernel (interpret mode), which the
    CUDA kernel replaces, against the port's cuda wrappers on the CPU."""
    cfg = CFG.replace(batch_size=300)
    tr, st = _jax_state(cfg, key=2)
    ts = _port_state(st)
    jp, jo, tp, to = st.params, st.opt, ts.params, ts.opt
    vols = _vols()
    kw = dict(n_batch=cfg.batch_size, boundary_lambda=cfg.boundary_lambda,
              sigma=cfg.boundary_sigma, ghost=1,
              resolutions=cfg.level_resolutions())
    key = jax.random.PRNGKey(4)
    gate = np.ones(P, np.float32)
    for step in range(2):
        jp, jo, jl = jops.fused_train_step_sampling(
            jp, jo, jnp.asarray(vols), jstep_seeds(key, step, P),
            jnp.asarray(gate), opt_cfg=tr.adam.cfg, impl="pallas", **kw)
        tp, to, tl = ops.fused_train_step_sampling(
            tp, to, torch.from_numpy(vols), step_seeds(np.asarray(key), step, P),
            torch.from_numpy(gate), opt_cfg=_opt_cfg(tr), impl="cuda", **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_close(tp, jp)
    _assert_close(to["v"], jo["v"])


def test_bf16_plain_step_with_master_tracks_jax():
    """The bf16 policy (bf16 params and compute, f32 master and moments) on
    the plain path: JAX's reference adds the hash corners in bf16, the port
    in f32 rounded once, so the losses agree to bf16 precision (2e-2 on
    losses of ~0.3). AdamW's first steps move each master entry by about
    +-lr whatever the gradient's size, so an entry whose small gradient
    changes sign between the two roundings moves the other way: the masters
    agree on average, to well under one lr per entry."""
    cfg = CFG.replace(precision="bf16")
    tr, st = _jax_state(cfg, key=5)
    ts = _port_state(st)
    assert ts.params["tables"].dtype == torch.bfloat16 and "mw" in ts.opt
    jp, jo, tp, to = st.params, st.opt, ts.params, ts.opt
    rng = np.random.default_rng(5)
    res = cfg.level_resolutions()
    jstep = _jit(jops.fused_train_step, resolutions=res, opt_cfg=tr.adam.cfg,
                 impl="ref", compute_dtype="bfloat16")
    for step in range(5):
        coords = rng.uniform(0, 1, (P, 200, 3)).astype(np.float32)
        target = rng.uniform(0, 1, (P, 200, 1)).astype(np.float32)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(coords), jnp.asarray(target),
                           jnp.ones(P))
        tp, to, tl = ops.fused_train_step(
            tp, to, torch.from_numpy(coords), torch.from_numpy(target),
            torch.ones(P), resolutions=res, opt_cfg=_opt_cfg(tr), impl="ref",
            compute_dtype="bfloat16")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2, rtol=0)
    assert tp["tables"].dtype == torch.bfloat16
    diffs = [np.abs(a.numpy() - np.asarray(b)).mean()
             for a, b in zip(tree_leaves(to["mw"]), jax.tree.leaves(jo["mw"]))]
    assert max(diffs) < CFG.lrate


@pytest.mark.parametrize("H", [1, 2, 3])
def test_pack_layout_matches_jax_and_reuses_the_hidden_slab(H):
    tr, st = _jax_state(CFG.replace(n_hidden_layers=H))
    ts = _port_state(st)
    jflat, jn = jops._pack(st.params)
    tflat, tn = ops._pack(ts.params)
    assert tn == jn == H
    for k in ops.STATE_KEYS:
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(jflat[k]))
    if H == 1:
        assert not tflat["whid"].any()       # the dummy slab
    else:
        tree = ops._unpack(tflat, H)
        again, _ = ops._pack(tree)
        assert again["whid"] is tflat["whid"]    # views of one slab: no copy


def test_schedule_scalars_match_jax():
    tr, st = _jax_state(CFG.replace(lrate_decay=3))
    ts = _port_state(st)
    opt_cfg = _opt_cfg(tr)
    jo = {**st.opt, "step": jnp.asarray([4, 4], jnp.int32)}
    to = {**ts.opt, "step": torch.tensor([4, 4], dtype=torch.int32)}
    gate = np.array([1.0, 0.0], np.float32)
    jstep, jsc = jops._schedule_scalars(jo, tr.adam.cfg, tr.adam, jnp.asarray(gate))
    tstep, tsc = ops._schedule_scalars(to, opt_cfg, AdamW(opt_cfg),
                                       torch.from_numpy(gate))
    assert np.array_equal(tstep.numpy(), np.asarray(jstep))   # gated too
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-7, atol=0)
    table = ops.schedule_table(to["step"], opt_cfg, AdamW(opt_cfg), 3)
    np.testing.assert_array_equal(table[0, :, :3].numpy(), tsc[:, :3].numpy())
    assert (table[..., 3] == 1).all()


def test_kernel_path_guards():
    tr, st = _jax_state()
    ts = _port_state(st)
    coords, target = torch.rand(P, 10, 3), torch.rand(P, 10, 1)
    res = CFG.level_resolutions()
    for bad in (OptConfig(clip_norm=1.0), OptConfig(clip_norm=0.0,
                                                    moments_dtype="bfloat16")):
        with pytest.raises(ValueError, match="clip|moments"):
            ops.fused_train_step(ts.params, ts.opt, coords, target, torch.ones(P),
                                 resolutions=res, opt_cfg=bad, impl="cuda")


@pytest.mark.parametrize("brick", ["auto", "pinned", 0, 4])
def test_sampling_brick_modes_give_one_trajectory(brick):
    tr, st = _jax_state(key=6)
    vols = torch.from_numpy(_vols())
    seeds = step_seeds(0, 0, P)
    outs = []
    for mode in ("auto", brick):
        ts = _port_state(st)
        _, _, loss = ops.fused_train_step_sampling(
            ts.params, ts.opt, vols, seeds, torch.ones(P),
            n_batch=CFG.batch_size, boundary_lambda=CFG.boundary_lambda,
            sigma=CFG.boundary_sigma, ghost=1,
            resolutions=CFG.level_resolutions(), opt_cfg=_opt_cfg(tr),
            impl="cuda", sampling_brick=mode)
        outs.append((loss, ts.params["tables"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("bad", ["tiled", -1, 1.5, True])
def test_sampling_brick_rejects_bad_modes(bad):
    with pytest.raises(ValueError, match="sampling_brick"):
        ops.validate_sampling_brick(bad)


def test_kernel_plain_versions_compose_to_the_step_in_place():
    """Train-step grads + AdamW apply (the CUDA path's two launches, here
    their plain versions) give ref.train_step_ref's step exactly, updating
    the given tensors in place."""
    tr, st = _jax_state(key=7)
    opt_cfg = _opt_cfg(tr)
    rng = np.random.default_rng(7)
    coords = torch.from_numpy(rng.uniform(0, 1, (P, 150, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (P, 150, 1)).astype(np.float32))
    gate = torch.tensor([1.0, 0.0])
    a, b = _port_state(st), _port_state(st)
    from repro_torch import backends
    want_p, want_o, want_l = ref.train_step_ref(
        a.params, a.opt, coords, target, gate, CFG.level_resolutions(),
        AdamW(opt_cfg), backends.resolve("ref"))
    tables = b.params["tables"]
    got_p, got_o, got_l = ops.fused_train_step(
        b.params, b.opt, coords, target, gate,
        resolutions=CFG.level_resolutions(), opt_cfg=opt_cfg, impl="cuda")
    assert got_p["tables"] is tables                  # updated in place
    assert torch.equal(got_l, want_l)
    for x, y in zip(tree_leaves(got_p) + tree_leaves(got_o["m"]),
                    tree_leaves(want_p) + tree_leaves(want_o["m"])):
        assert torch.equal(x, y)


def _c_entries():
    """name -> parameter types of every ``extern "C" int`` entry in csrc/."""
    import re

    entries = {}
    for src in build.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            entries[m.group(1)] = params
    return entries


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_ctypes_signatures_match_the_c_entries(name):
    """Every ctypes signature has the C entry's arity, and pointers,
    64-bit ints, ints and floats in the C entry's order (a pointer passed
    as a 32-bit int would be cut)."""
    import ctypes

    params = _c_entries()[name]
    argtypes = build.SIGNATURES[name]
    assert len(argtypes) == len(params), (name, params)
    for t, p in zip(argtypes, params):
        if "*" in p:
            assert t is ctypes.c_void_p, (name, p)
        elif p.startswith("long long"):
            assert t is ctypes.c_longlong, (name, p)
        elif p.startswith("float"):
            assert t is ctypes.c_float, (name, p)
        else:
            assert p.startswith("int") and t is ctypes.c_int, (name, p)


@pytest.mark.parametrize("F,W,H,N", [(1, 16, 2, 203), (2, 16, 2, 256),
                                     (8, 64, 3, 130), (4, 32, 1, 97)])
def test_train_step_grads_match_jax_value_and_grad(F, W, H, N):
    """The train-step kernel's plain version (the yardstick the kernel is
    held to on the card) against JAX's value_and_grad of the per-partition
    L1 loss, at the shapes of the kernel's further cases: F=1 on a ragged
    batch, F=2, an ABLATION-like W=64, H=3, F=8 step, one hidden layer.
    The split route (the feature cotangent, then the hash-encode backward)
    gives the same table gradient."""
    from repro.kernels.fused_mlp.ops import fused_mlp as jfused_mlp
    from repro.kernels.hash_encoding.ops import hash_encode as jhash_encode
    from repro_torch.kernels.hash_encoding.ops import hash_encode_bwd_cuda

    cfg = CFG.replace(n_features_per_level=F, n_neurons=W, n_hidden_layers=H)
    res = cfg.level_resolutions()
    tr, st = _jax_state(cfg, key=F + H)
    rng = np.random.default_rng(N)
    coords = rng.uniform(0, 1, (P, N, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (P, N, 1)).astype(np.float32)

    def loss_fn(p, c, t):
        pred = jfused_mlp(jhash_encode(c, p["tables"], res, "ref"), p["mlp"], "ref")
        return jnp.mean(jnp.abs(pred - t))

    jl, jg = jax.vmap(jax.value_and_grad(loss_fn))(
        st.params, jnp.asarray(coords), jnp.asarray(target))
    flat = ops._pack(_port_state(st).params)[0]
    c_t, t_t = torch.from_numpy(coords), torch.from_numpy(target)
    got, loss_sum = ops.train_step_cuda(flat, H, res, coords=c_t, target=t_t)
    np.testing.assert_allclose(loss_sum.numpy() / N, np.asarray(jl), rtol=1e-6)
    want = {"tab": jg["tables"], "win": jg["mlp"][0], "wout": jg["mlp"][-1]}
    if H > 1:
        want["whid"] = jnp.stack(jg["mlp"][1:-1], 1)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    _, L, T, _ = flat["tab"].shape
    cot = torch.empty((P, N, L * F))
    ops.train_step_cuda(flat, H, res, coords=c_t, target=t_t, cotangent_out=cot)
    tab = hash_encode_bwd_cuda(cot, c_t, res, list(range(P)), (P, L, T, F))
    torch.testing.assert_close(tab, got["tab"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("H", [1, 2, 3])
def test_float64_yardstick_matches_the_plain_version(H):
    """``chip_smoke.step_grads_f64``, the float64 yardstick the card's
    train-step checks hold the kernel to (float64 sums, the float32 plain
    version's ReLU masks and residual signs), gives the plain version's
    gradients and loss sum within float32 rounding, with no ties on
    random data."""
    import chip_smoke

    cfg = CFG.replace(n_hidden_layers=H)
    tr, st = _jax_state(cfg, key=5 + H)
    flat = ops._pack(_port_state(st).params)[0]
    res = cfg.level_resolutions()
    rng = np.random.default_rng(5)
    coords = torch.from_numpy(rng.uniform(0, 1, (P, 160, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (P, 160, 1)).astype(np.float32))
    want, want_l = ref.train_step_grads_ref(flat, H, res, coords, target)
    (got, got_l), ties = chip_smoke.step_grads_f64(flat, H, res, coords, target)
    assert ties == 0
    torch.testing.assert_close(got_l.float(), want_l, rtol=1e-6, atol=0)
    for k in ops.STATE_KEYS:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-5 * float(want[k].abs().max()) + 1e-30)


def test_split_cotangent_then_backward_gives_the_fused_gradient():
    """The wrapper's ``cotangent_out`` (the kernel's split mode, here its
    plain version): the feature cotangent, scattered by the hash-encode
    backward, is the fused step's table gradient; the other gradients and
    the loss sum are the fused step's, and the table gradient it returns
    is zero."""
    from repro_torch.kernels.hash_encoding.ops import hash_encode_bwd_cuda

    tr, st = _jax_state(key=3)
    flat = ops._pack(_port_state(st).params)[0]
    H = CFG.n_hidden_layers
    res = CFG.level_resolutions()
    rng = np.random.default_rng(3)
    coords = torch.from_numpy(rng.uniform(-0.1, 1.1, (P, 130, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (P, 130, 1)).astype(np.float32))
    want_g, want_l = ops.train_step_cuda(flat, H, res, coords=coords,
                                         target=target)
    _, L, T, F = flat["tab"].shape
    cot = torch.empty((P, 130, L * F))
    got_g, got_l = ops.train_step_cuda(flat, H, res, coords=coords,
                                       target=target, cotangent_out=cot)
    assert not got_g["tab"].any()
    assert torch.equal(got_l, want_l)
    for k in ("win", "whid", "wout"):
        assert torch.equal(got_g[k], want_g[k])
    tab = hash_encode_bwd_cuda(cot, coords, res, list(range(P)), (P, L, T, F))
    torch.testing.assert_close(tab, want_g["tab"], rtol=0, atol=1e-8)
