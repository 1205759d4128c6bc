"""DVNR training under the bf16 policy (bf16 params and compute, float32
master and moments): the port's bf16 training kernels' plain versions (the
wrappers take them for CPU tensors; the kernels run on the card, in
chip_smoke.py) against the JAX package, and the rounding points those plain
versions hold.

- AdamW with a master: ``adamw_apply_cuda`` against JAX ``AdamW.step`` over
  10 steps with one gated-off partition, bit for bit (the same float32
  operations, the square root correctly rounded on both sides; the
  schedule scalars are JAX's own, so no ``pow`` last bit enters);
- the fused step (host-sampled and sampling) against JAX's Pallas train-step
  kernel in interpret mode with compute bf16 and masters: losses within
  2e-2 (JAX sums the encode's corners in bf16, the port in float32, and its
  MLP-backward products in bf16 per tile), the masters within one lr on
  average (AdamW's first steps move an entry by about +-lr whatever the
  gradient's size, so a small gradient whose sign the two roundings flip
  moves the other way);
- the MLP backward and the hash-encode backward on bf16 operands against
  ``fused_mlp_bwd_pallas`` (interpret) and the hash ``_bwd``: JAX
  accumulates dW and the table gradient in bf16, the port in float32
  rounded once, so they agree to a few bf16 ulps of the largest entry;
- the trainer (``impl="cuda"`` on the CPU) under the in-scope policies,
  fused and unfused: 16 losses against the JAX trainer within 2e-2, and
  the fused and unfused bf16 runs within 1 dB PSNR after training.

Inputs are made with numpy from a seed; weights cross with
``interop.state_from_numpy``."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import dvnr as jdvnr
from repro.core.sampling import step_seeds as jstep_seeds
from repro.core.trainer import DVNRTrainer as JTrainer
from repro.data.volume import make_partition as jmake_partition
from repro.kernels.fused_mlp.kernel import fused_mlp_bwd_pallas
from repro.kernels.fused_train_step import ops as jops
from repro.kernels.hash_encoding.ops import hash_encode as jhash_encode
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import interop
from repro_torch.configs import dvnr
from repro_torch.core import trainer as ttr
from repro_torch.core.sampling import step_seeds
from repro_torch.data.volume import make_partition
from repro_torch.kernels.fused_mlp import ops as mops
from repro_torch.kernels.fused_mlp.ref import fused_mlp_batched_bwd_ref
from repro_torch.kernels.fused_train_step import ops, ref
from repro_torch.kernels.hash_encoding import ops as hops
from repro_torch.kernels.hash_encoding.ref import hash_encode_batched_bwd_ref
from repro_torch.optim.adamw import OptConfig, tree_leaves

CFG = jdvnr.SMOKE.replace(batch_size=384, n_levels=2, log2_hashmap_size=8,
                          n_neurons=16, n_hidden_layers=2, lrate=1e-2,
                          precision="bf16")
P = 2
LOSS_ATOL = 2e-2      # bf16 losses of ~0.1-0.3 (the rounding points differ)


def _np(t):
    """A port tensor as float32 numpy (bf16 bit for bit)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).astype(np.float32)
    return t.numpy()


def _jax_state(cfg=CFG, key=0):
    tr = JTrainer(cfg, P)
    return tr, tr.init(jax.random.PRNGKey(key))


def _port_state(st):
    np_state = {"params": jax.tree.map(np.asarray, st.params),
                "opt": jax.tree.map(np.asarray, st.opt),
                "loss_ma": np.asarray(st.loss_ma),
                "active": np.asarray(st.active), "step": st.step}
    return interop.state_from_numpy(np_state, "cpu")


def _opt_cfg(tr):
    return OptConfig(**tr.adam.cfg.__dict__)


def _vols():
    parts = [jmake_partition("cloverleaf", p, (1, 1, 2), (10, 10, 10), 0.3)
             for p in range(P)]
    return np.stack([np.asarray(p.normalized()) for p in parts])[..., None]


# --------------------------------------------------------------------------- #
# AdamW with the float32 master
# --------------------------------------------------------------------------- #
def test_adamw_master_matches_jax_bit_for_bit():
    """The AdamW kernel's plain version on the bf16 policy's packed state
    (bf16 params, f32 master, m, v) against JAX ``AdamW.step`` (vmapped over
    the partitions) from the same f32 gradients over 10 steps, partition 1
    gated off from step 4: master, m, v, step and bf16 params bit for bit
    (the gated partition's params moved only before the gate closed)."""
    tr, st = _jax_state(key=3)
    ts = _port_state(st)
    assert ts.params["tables"].dtype == torch.bfloat16 and "mw" in ts.opt
    jadam = JAdamW(tr.adam.cfg)
    cfg = tr.adam.cfg
    jp, jo = st.params, st.opt
    flat_p, flat_m, flat_v, flat_mw, H = ops._pack_state(ts.params, ts.opt)
    step = ts.opt["step"]
    rng = np.random.default_rng(3)
    for i in range(10):
        gate = np.array([1.0, 0.0 if i >= 4 else 1.0], np.float32)
        gtree = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2,
            st.params)
        # the schedule scalars as JAX's fused op derives them
        _, jsc = jops._schedule_scalars(jo, cfg, jadam, jnp.asarray(gate))
        jp, jo = jax.vmap(jadam.step)(jax.tree.map(jnp.asarray, gtree), jo, jp,
                                      jnp.asarray(gate))
        grads = ops._pack(interop.state_from_numpy(
            {"params": gtree, "opt": {}, "loss_ma": np.zeros(P),
             "active": np.ones(P, bool), "step": 0}, "cpu").params)[0]
        step, scalars = ops._schedule_scalars({"step": step}, _opt_cfg(tr),
                                              ops.AdamW(_opt_cfg(tr)),
                                              torch.from_numpy(gate))
        loss = ops.adamw_apply_cuda(
            flat_p, flat_m, flat_v, grads, torch.from_numpy(np.array(jsc)),
            torch.ones(P), n_valid=4, beta1=cfg.beta1, beta2=cfg.beta2,
            eps=cfg.eps, weight_decay=cfg.weight_decay, n_hidden=H,
            flat_mw=flat_mw)
        assert torch.equal(loss, torch.full((P,), 0.25))
    np.testing.assert_array_equal(step.numpy(), np.asarray(jo["step"]))
    for name, flat in (("mw", flat_mw), ("m", flat_m), ("v", flat_v)):
        jflat = jops._pack(jo[name])[0]
        for k in ops.STATE_KEYS:
            np.testing.assert_array_equal(flat[k].numpy(), np.asarray(jflat[k]),
                                          err_msg=f"{name} {k}")
    jflat = jops._pack(jp)[0]
    for k in ops.STATE_KEYS:
        assert flat_p[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(flat_p[k]),
                                      np.asarray(jflat[k], np.float32), err_msg=k)
    tab0 = np.asarray(jops._pack(st.params)[0]["tab"][1], np.float32)
    np.testing.assert_array_equal(_np(flat_p["tab"][1]),
                                  np.asarray(jflat["tab"][1], np.float32))
    assert not np.array_equal(_np(flat_p["tab"][1]), tab0)   # moved up to step 4


# --------------------------------------------------------------------------- #
# the fused step against JAX's Pallas kernel (interpret mode)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", ["host-sampled", "sampling"])
def test_bf16_fused_step_tracks_jax_pallas_kernel(variant):
    """The port's bf16 fused step on the cuda backend's wrappers (the
    train-step and master AdamW kernels' plain versions) against JAX's
    Pallas train-step kernel in interpret mode (compute bf16, f32 masters),
    3 steps from one state."""
    cfg = CFG.replace(batch_size=300)
    tr, st = _jax_state(cfg, key=8)
    ts = _port_state(st)
    jp, jo, tp, to = st.params, st.opt, ts.params, ts.opt
    res = cfg.level_resolutions()
    rng = np.random.default_rng(8)
    vols = _vols()
    key = jax.random.PRNGKey(9)
    draw = dict(n_batch=cfg.batch_size, boundary_lambda=cfg.boundary_lambda,
                sigma=cfg.boundary_sigma, ghost=1, resolutions=res)
    for step in range(3):
        gate = np.ones(P, np.float32)
        if variant == "host-sampled":
            coords = rng.uniform(0, 1, (P, cfg.batch_size, 3)).astype(np.float32)
            target = rng.uniform(0, 1, (P, cfg.batch_size, 1)).astype(np.float32)
            jp, jo, jl = jops.fused_train_step(
                jp, jo, jnp.asarray(coords), jnp.asarray(target),
                jnp.asarray(gate), resolutions=res, opt_cfg=tr.adam.cfg,
                impl="pallas", compute_dtype="bfloat16")
            tp, to, tl = ops.fused_train_step(
                tp, to, torch.from_numpy(coords), torch.from_numpy(target),
                torch.from_numpy(gate), resolutions=res, opt_cfg=_opt_cfg(tr),
                impl="cuda", compute_dtype="bfloat16")
        else:
            jp, jo, jl = jops.fused_train_step_sampling(
                jp, jo, jnp.asarray(vols), jstep_seeds(key, step, P),
                jnp.asarray(gate), opt_cfg=tr.adam.cfg, impl="pallas",
                compute_dtype="bfloat16", **draw)
            tp, to, tl = ops.fused_train_step_sampling(
                tp, to, torch.from_numpy(vols),
                step_seeds(np.asarray(key), step, P), torch.from_numpy(gate),
                opt_cfg=_opt_cfg(tr), impl="cuda", compute_dtype="bfloat16",
                **draw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOSS_ATOL,
                                   rtol=0)
    assert tp["tables"].dtype == torch.bfloat16
    assert np.array_equal(to["step"].numpy(), np.asarray(jo["step"]))
    diffs = [np.abs(a.numpy() - np.asarray(b)).mean()
             for a, b in zip(tree_leaves(to["mw"]), jax.tree.leaves(jo["mw"]))]
    assert max(diffs) < cfg.lrate
    # the bf16 params are the masters rounded
    for p, w in zip(tree_leaves(tp), tree_leaves(to["mw"])):
        assert torch.equal(p, w.to(torch.bfloat16))


# --------------------------------------------------------------------------- #
# the unfused step's backward kernels on bf16 operands
# --------------------------------------------------------------------------- #
def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _t16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("H", [1, 2, 3])
def test_mlp_bwd_bf16_matches_jax_pallas(H):
    """bf16 x, cotangent and weights, 1,300 rows (three of the Pallas
    kernel's 512-row tiles): dx within 2 bf16 ulps of the largest |dx| (the
    same rounding points, f32 sums in another order); dW within 2^-5 of the
    largest |dW|: JAX rounds each tile's dW to bf16 and sums the tiles in
    bf16 (kernel.py:110-112), the port sums all rows in float32."""
    rng = np.random.default_rng(H)
    N, D_in, W, D_out = 1300, 8, 16, 1
    dims = [D_in] + [W] * H + [D_out]
    ws = [_bf16(rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a))
          for a, b in zip(dims[:-1], dims[1:])]
    x = _bf16(rng.uniform(-1, 1, (N, D_in)))
    g = _bf16(rng.choice([-1.0, 1.0], (N, D_out)) / N)
    w_hid = np.stack(ws[1:-1]) if H > 1 else np.zeros((1, W, W), ml_dtypes.bfloat16)
    jdx, jdi, jdh, jdo = fused_mlp_bwd_pallas(
        jnp.asarray(x), jnp.asarray(ws[0]), jnp.asarray(w_hid),
        jnp.asarray(ws[-1]), jnp.asarray(g), n_hidden=H, interpret=True)
    want = [np.asarray(jdi, np.float32)] + \
        [np.asarray(jdh[k], np.float32) for k in range(H - 1)] + \
        [np.asarray(jdo, np.float32)]
    dx, dws = mops.fused_mlp_bwd_cuda(_t16(x)[None], [_t16(w)[None] for w in ws],
                                      _t16(g)[None], [0])
    assert dx.dtype == torch.bfloat16
    assert all(d.dtype == torch.float32 for d in dws)
    jdx = np.asarray(jdx, np.float32)
    np.testing.assert_allclose(_np(dx[0]), jdx, rtol=0,
                               atol=2 * 2.0 ** -8 * np.abs(jdx).max())
    for k, (a, b) in enumerate(zip(dws, want)):
        np.testing.assert_allclose(a[0].numpy(), b, rtol=0,
                                   atol=2.0 ** -5 * np.abs(b).max(),
                                   err_msg=f"dW[{k}]")


@functools.partial(jax.jit, static_argnums=(3,))
def _jhash_vjp(coords, tables, cot, res):
    _, vjp = jax.vjp(lambda t: jhash_encode(coords, t, res, "ref"), tables)
    return vjp(cot)[0]


@pytest.mark.parametrize("L,T,F,res", [
    (2, 128, 2, (4, 8)),            # dense (125 <= 128) + hashed
    (3, 64, 4, (2, 3, 16)),         # dense, dense, hashed
    (2, 4096, 1, (8, 15))])         # both dense
def test_hash_bwd_bf16_cotangent_matches_jax(L, T, F, res):
    """A bf16 feature cotangent through the backward wrapper (its plain
    version on the CPU): within 2^-6 of the largest |gradient| of JAX's
    ``_bwd`` on bf16 tables (which rounds each weight and sums in bf16);
    bit for bit the float32 scatter of the widened cotangent (the kernel's
    function); float32 out."""
    rng = np.random.default_rng(T + F)
    N = 400
    coords = rng.uniform(-0.2, 1.2, (N, 3)).astype(np.float32)
    tables = rng.uniform(-0.1, 0.1, (L, T, F)).astype(np.float32)
    cot = _bf16(rng.standard_normal((N, L * F)))
    want = np.asarray(_jhash_vjp(jnp.asarray(coords),
                                 jnp.asarray(tables, jnp.bfloat16),
                                 jnp.asarray(cot), tuple(res)), np.float32)
    c_t, g_t = torch.from_numpy(coords)[None], _t16(cot)[None]
    got = hops.hash_encode_bwd_cuda(g_t, c_t, res, [0], (1, L, T, F))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())
    widened = hash_encode_batched_bwd_ref(g_t.float(), c_t, res,
                                          torch.tensor([0]), (1, L, T, F))
    assert torch.equal(got, widened)


# --------------------------------------------------------------------------- #
# the plain versions' rounding points
# --------------------------------------------------------------------------- #
def test_plain_mlp_bwd_rounds_deltas_and_sums_dw_in_float32():
    """The plain MLP backward on bf16 operands against the rounding points
    written out: each layer's output rounded to bf16 in the forward, each
    delta rounded to bf16 before its ReLU mask, dx rounded once from its
    float32 sum, dW the float32 sums, unrounded (within float32 rounding)."""
    rng = np.random.default_rng(4)
    N, dims = 200, [6, 16, 16, 2]
    ws = [_t16(rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a))
          for a, b in zip(dims[:-1], dims[1:])]
    x = _t16(rng.uniform(-1, 1, (N, dims[0])))
    g = _t16(rng.standard_normal((N, dims[-1])) / N)
    r = lambda t: t.to(torch.bfloat16).float()
    hs = [x.float()]
    for w in ws[:-1]:
        hs.append(r(torch.relu(hs[-1] @ w.float())))
    d = g.float()
    want_dw = [None] * len(ws)
    for k in range(len(ws) - 1, -1, -1):
        want_dw[k] = hs[k].T @ d
        d = d @ ws[k].float().T
        if k:
            d = r(d) * (hs[k] > 0)
    dx, dws = fused_mlp_batched_bwd_ref(x[None], [w[None] for w in ws], g[None],
                                        torch.tensor([0]))
    assert dx.dtype == torch.bfloat16
    torch.testing.assert_close(dx[0].float(), r(d), rtol=2.0 ** -8, atol=1e-30)
    for a, b in zip(dws, want_dw):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a[0], b, rtol=0, atol=1e-6 * float(b.abs().max()))
    assert any(not torch.equal(a[0], r(a[0])) for a in dws)   # not rounded


def test_plain_train_step_keeps_float32_gradients():
    """The train-step kernel's plain version on a bf16 state gives the
    float32 sums that the autograd step (``loss_and_grads``, which rounds
    each gradient to bf16 at its leaf) rounds: the same loss, and its
    gradients are exactly theirs rounded to bf16."""
    tr, st = _jax_state(key=4)
    ts = _port_state(st)
    flat = ops._pack(ts.params)[0]
    H = CFG.n_hidden_layers
    res = CFG.level_resolutions()
    rng = np.random.default_rng(4)
    coords = torch.from_numpy(rng.uniform(0, 1, (P, 150, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (P, 150, 1)).astype(np.float32))
    grads, loss_sum = ref.train_step_grads_ref(flat, H, res, coords, target)
    from repro_torch import backends
    loss, tree = ref.loss_and_grads(ts.params, coords, target, res,
                                    backends.resolve("ref"))
    assert torch.equal(loss_sum, loss * 150.0)
    auto = ops._pack(tree)[0]
    for k in ops.STATE_KEYS:
        assert grads[k].dtype == torch.float32 and auto[k].dtype == torch.bfloat16
        assert torch.equal(grads[k].to(torch.bfloat16), auto[k]), k
    assert not torch.equal(grads["tab"], auto["tab"].float())


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
TCFG = dvnr.SMOKE.replace(n_hidden_layers=2, batch_size=512)
JTCFG = jdvnr.SMOKE.replace(n_hidden_layers=2, batch_size=512)
POLICIES = ["bf16", "bf16_out", "bf16/f32/f32", "f32/bf16/f32"]


def _parts():
    grid = (1, 1, P)
    return ([jmake_partition("cloverleaf", p, grid, (10, 10, 10), 0.3)
             for p in range(P)],
            [make_partition("cloverleaf", p, grid, (10, 10, 10), 0.3,
                            device="cpu") for p in range(P)])


@functools.lru_cache(maxsize=None)
def _jax_trace(policy):
    """The JAX trainer's 16-step chunk under ``policy`` (fused where its
    backend has it; the bf16 roundings are the policy's either way)."""
    jparts, _ = _parts()
    tr = JTrainer(JTCFG.replace(precision=policy), P)
    st = tr.init(jax.random.PRNGKey(1))
    vols = jnp.stack([p.normalized() for p in jparts])
    _, trace = tr.train_chunk(st, vols, 16, key=jax.random.PRNGKey(2))
    return np.asarray(trace)


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("policy", POLICIES)
def test_trainer_policies_track_jax(policy, fuse):
    """``DVNRTrainer(impl="cuda", device="cpu")`` under each in-scope
    policy, fused (the train-step and AdamW kernels' plain versions) and
    unfused (the backward kernels' plain versions): the 16 losses of a
    chunk within 2e-2 of the JAX trainer's, the state in the policy's
    dtypes with a float32 master where the params are bf16."""
    _, parts = _parts()
    tr = ttr.DVNRTrainer(TCFG.replace(precision=policy, fuse_train_step=fuse),
                         P, impl="cuda", device="cpu")
    st = tr.init(1)
    st, trace = tr.train_chunk(st, torch.stack([p.normalized() for p in parts]),
                               16, key=2)
    np.testing.assert_allclose(trace.numpy(), _jax_trace(policy),
                               atol=LOSS_ATOL, rtol=0)
    assert st.params["tables"].dtype == tr.precision.param_torch
    assert ("mw" in st.opt) == (tr.precision.param_torch == torch.bfloat16)
    if "mw" in st.opt:
        for p, w in zip(tree_leaves(st.params), tree_leaves(st.opt["mw"])):
            assert w.dtype == torch.float32 and torch.equal(p, w.to(p.dtype))


def test_bf16_fused_and_unfused_train_to_the_same_quality():
    """bf16 fused (float32 gradients into the master) and unfused (bf16
    gradients from autograd) through the cuda backend's wrappers: the PSNR
    after 150 steps within 1 dB, as JAX holds its Pallas kernel against
    its unfused step (test_fused_train_step.py)."""
    _, parts = _parts()
    vols = torch.stack([p.normalized() for p in parts])
    psnr = {}
    for fuse in ("auto", "off"):
        tr = ttr.DVNRTrainer(TCFG.replace(precision="bf16", fuse_train_step=fuse),
                             P, impl="cuda", device="cpu")
        st, _ = tr.train(tr.init(0), vols, steps=150, key=1)
        psnr[fuse] = tr.evaluate(st, vols, (10, 10, 10))["psnr"]
    assert abs(psnr["auto"] - psnr["off"]) < 1.0, psnr
    assert psnr["auto"] > 15.0, psnr


@pytest.mark.parametrize("bad,match", [
    (OptConfig(clip_norm=0.0, moments_dtype="bfloat16"), "moments"),
    (OptConfig(clip_norm=1.0), "clip")])
def test_bf16_kernel_path_guards(bad, match):
    """bf16 moments and fused clipping stay refused on the kernel path with
    a bf16 state, as the JAX Pallas leg refuses them; so does f16 compute."""
    tr, st = _jax_state()
    ts = _port_state(st)
    coords, target = torch.rand(P, 10, 3), torch.rand(P, 10, 1)
    res = CFG.level_resolutions()
    with pytest.raises(ValueError, match=match):
        ops.fused_train_step(ts.params, ts.opt, coords, target, torch.ones(P),
                             resolutions=res, opt_cfg=bad, impl="cuda",
                             compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="float16"):
        ops.fused_train_step(ts.params, ts.opt, coords, target, torch.ones(P),
                             resolutions=res, opt_cfg=OptConfig(clip_norm=0.0),
                             impl="cuda", compute_dtype="float16")
