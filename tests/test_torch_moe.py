"""repro_torch's MoE layers and MoE transformers (grok-1, arctic) against
the JAX package: routing, capacity positions and drop sets exactly; the
dispatch, the block and the model's prefill, decode, loss and gradient at
``tests/test_torch_lm.py``'s tolerances (see ``torch_family_parity``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_parity as F
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models import transformer as T

MOE = ["grok_1_314b", "arctic_480b"]


def _block_inputs(arch, capacity=None, seed=1, shape=(F.B, 16)):
    cfg, jcfg = F.cfgs(arch)
    if capacity is not None:
        cfg, jcfg = F.with_capacity(cfg, capacity), F.with_capacity(jcfg, capacity)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg,
                                                jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, interop.lm_params_from_numpy(jp, "cpu"), x


# --------------------------------------------------------------------------- #
# routing and capacity
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE)
def test_route_equals_jax(arch):
    cfg, jcfg, jp, p, x = _block_inputs(arch, shape=(64,))
    jw, jids, jaux = jmoe.route(jcfg, jp, x)
    w, ids, aux = moe.route(cfg, p, torch.from_numpy(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    assert w.dtype == torch.float32


@pytest.mark.parametrize("n,experts,seed", [(64, 4, 0), (257, 8, 1), (1000, 128, 2)])
def test_positions_in_expert_equal_jax(n, experts, seed):
    flat = np.random.default_rng(seed).integers(0, experts, n).astype(np.int32)
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(flat), experts))
    got = moe._positions_in_expert(torch.from_numpy(flat), experts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # rows: JAX vmaps the 1-d function
    rows = flat[: (n // 4) * 4].reshape(4, -1)
    want = np.asarray(jax.vmap(lambda r: jmoe._positions_in_expert(r, experts))(rows))
    np.testing.assert_array_equal(
        moe._positions_in_expert(torch.from_numpy(rows), experts).numpy(), want)


@pytest.mark.parametrize("arch", MOE)
def test_capacity_equals_jax(arch):
    for cf in (1.0, 1.25, 2.0, 8.0):
        cfg, jcfg = F.cfgs(arch)
        cfg, jcfg = F.with_capacity(cfg, cf), F.with_capacity(jcfg, cf)
        for tokens in (1, 7, 16, 33, 4096, 8192):
            assert moe._capacity(cfg, tokens) == jmoe._capacity(jcfg, tokens)


# --------------------------------------------------------------------------- #
# dispatch
# --------------------------------------------------------------------------- #
def _drop_set(route_fn, cfg, p, x, per_row):
    """The (token, slot) pairs a dispatch drops, from its routing."""
    B, S, D = x.shape
    _, ids, _ = route_fn(cfg, p, x.reshape(B * S, D))
    ids = np.asarray(ids)
    k = cfg.moe.top_k
    if per_row:
        pos = np.stack([np.asarray(jmoe._positions_in_expert(jnp.asarray(r),
                                                             cfg.moe.num_experts))
                        for r in ids.reshape(B, S * k)])
        return pos >= jmoe._capacity(cfg, S)
    pos = np.asarray(jmoe._positions_in_expert(jnp.asarray(ids.reshape(-1)),
                                               cfg.moe.num_experts))
    return pos >= jmoe._capacity(cfg, B * S)


@pytest.mark.parametrize("capacity", [0.5, 8.0], ids=["binding", "nonbinding"])
@pytest.mark.parametrize("dispatch", ["scatter", "scatter_global"])
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_equals_jax(arch, dispatch, capacity):
    cfg, jcfg, jp, p, x = _block_inputs(arch, capacity, shape=(F.B, 64))
    jfn = {"scatter": jmoe.moe_block_scatter,
           "scatter_global": jmoe.moe_block_scatter_global}[dispatch]
    fn = {"scatter": moe.moe_block_scatter,
          "scatter_global": moe.moe_block_scatter_global}[dispatch]
    jy, jaux = jfn(jcfg, jp, x)
    y, aux = fn(cfg, p, torch.from_numpy(x))
    F.assert_close(y, jy, "float32", "y")
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    # the same drop set (exact): the port's routing and positions
    per_row = dispatch == "scatter"
    tx = torch.from_numpy(x)
    _, tids, _ = moe.route(cfg, p, tx.reshape(-1, cfg.d_model))
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    if per_row:
        tpos = moe._positions_in_expert(tids.reshape(F.B, -1), E)
        dropped = (tpos >= moe._capacity(cfg, x.shape[1])).numpy()
    else:
        tpos = moe._positions_in_expert(tids.reshape(-1), E)
        dropped = (tpos >= moe._capacity(cfg, F.B * x.shape[1])).numpy()
    want = _drop_set(jmoe.route, jcfg, jp, x, per_row)
    np.testing.assert_array_equal(dropped, want)
    assert want.any() == (capacity < 1)
    # the block's selection: without a sharder "scatter" is the grouped path
    y2, _ = moe.moe_block(cfg, p, tx, None, dispatch)
    assert torch.equal(y2, y)
    jy2, _ = jmoe.moe_block(jcfg, jp, x, None, dispatch)
    F.assert_close(y2, jy2, "float32", "moe_block")


def test_grouped_equals_global_when_capacity_nonbinding():
    cfg, _, _, p, x = _block_inputs("grok_1_314b", 8.0, shape=(4, 16))
    y1, a1 = moe.moe_block_scatter(cfg, p, torch.from_numpy(x))
    y2, a2 = moe.moe_block_scatter_global(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    assert abs(float(a1 - a2)) < 1e-6


def test_dense_residual_block_equals_jax():
    """arctic's layer: MoE plus the dense residual MLP, with its aux."""
    cfg, jcfg = F.cfgs("arctic_480b")
    assert cfg.moe.dense_residual
    jp = F.jax_params(jcfg)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    lp = T.layer_slices(F.port_params(jp)["layers"], cfg.n_layers)[0]
    assert sorted(lp["mlp"]) == ["wg", "wi", "wo"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((F.B, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (F.B, 16))
    jy, jaux = JT.block_fn(jcfg, jlp, x, pos, None, "xla")
    y, aux = T.block_fn(cfg, lp, torch.from_numpy(x),
                        torch.from_numpy(np.ascontiguousarray(pos)))
    F.assert_close(y, jy, "float32", "block")
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    # without the residual the layer differs
    y0, _ = moe.moe_block(cfg, lp["moe"], torch.from_numpy(x))
    assert float((y0 - (y - torch.from_numpy(x))).abs().max()) > 1e-3


def test_a2a_tp_and_sharder_raise():
    """Without a mesh ``"a2a"`` is the scatter, as JAX's ``moe_block``
    routes it, and ``build_model`` takes it; the mesh-only blocks refuse a
    missing mesh, and a sharder that is not a ``Sharder`` is a TypeError
    (the blocks on a mesh: ``test_torch_mesh_collectives.py``)."""
    cfg, jcfg, jp, p, x = _block_inputs("arctic_480b")
    tx = torch.from_numpy(x)
    y, aux = moe.moe_block(cfg, p, tx, None, "a2a")
    jy, jaux = jmoe.moe_block(jcfg, jp, x, None, "a2a")
    F.assert_close(y, jy, "float32", "a2a without a mesh")
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    assert torch.equal(y, moe.moe_block_scatter(cfg, p, tx)[0])
    for call in (lambda: moe.moe_block_a2a(cfg, p, tx, None),
                 lambda: moe.moe_block_tp(cfg, p, tx, None)):
        with pytest.raises(ValueError, match="needs a sharder with a mesh"):
            call()
    for call in (lambda: moe.moe_block_a2a(cfg, p, tx, object()),
                 lambda: moe.moe_block_tp(cfg, p, tx, object()),
                 lambda: moe.moe_block(cfg, p, tx, object(), "scatter"),
                 lambda: moe.moe_block_scatter(cfg, p, tx, object())):
        with pytest.raises(TypeError, match="Sharder"):
            call()
    with pytest.raises(ValueError, match="unknown"):
        moe.moe_block(cfg, p, tx, None, "ring")
    with pytest.raises(ValueError, match="unknown"):
        build_model(cfg, moe_dispatch="ring")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = F.make_batch(cfg)
    a2a = build_model(cfg, moe_dispatch="a2a")
    assert torch.equal(a2a.loss(params, batch, impl="ref")[0],
                       model.loss(params, batch, impl="ref")[0])
    with pytest.raises(TypeError, match="Sharder"):
        model.prefill(params, F.prompt(F.make_batch(cfg), 8), 8, sharder=object(),
                      impl="ref")


@pytest.mark.parametrize("dispatch", ["scatter_gspmd", "scatter_global"])
def test_build_model_dispatch_names_equal_jax(dispatch):
    from repro.models import build_model as jbuild
    cfg, jcfg = F.cfgs("grok_1_314b")
    jp = F.jax_params(jcfg)
    batch = F.make_batch(cfg)
    jloss, jm = jbuild(jcfg, dispatch).loss(jp, batch)
    loss, m = build_model(cfg, dispatch).loss(F.port_params(jp), batch, impl="ref")
    F.assert_close(loss, np.asarray(jloss), "float32", "loss")
    F.assert_close(m["aux"], np.asarray(jm["aux"]), "float32", "aux")


# --------------------------------------------------------------------------- #
# the model: init, prefill, decode, loss, gradients, interop
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE)
def test_init_tree_equals_jax(arch):
    F.check_init_tree(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_equals_jax(arch, dtype):
    F.check_prefill(arch, dtype)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_through_the_pallas_kernel_equals_jax(arch):
    F.check_prefill_pallas(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_step_from_a_shared_cache_equals_jax(arch, dtype):
    F.check_decode_shared(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_with_aux_equals_jax(arch, dtype):
    F.check_loss(arch, dtype)


@pytest.mark.parametrize("arch", MOE)
def test_loss_gradient_equals_jax_grad(arch):
    F.check_loss_grad(arch)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_equals_teacher_forced_jax_prefill(arch):
    """prefill(S) + decode(1) against JAX's prefill(S+1), with the capacity
    raised so that it binds in neither (C >= S*k: a bound capacity drops in
    the longer prefill a token that the decode step keeps)."""
    cfg, jcfg = F.cfgs(arch)
    E = cfg.moe.num_experts
    cfg, jcfg = F.with_capacity(cfg, float(E)), F.with_capacity(jcfg, float(E))
    assert moe._capacity(cfg, F.S + 1) >= (F.S + 1) * cfg.moe.top_k
    jp = F.jax_params(jcfg)
    full = F.make_batch(cfg, F.S + 1)
    from repro.models import build_model as jbuild
    want, _ = jbuild(jcfg).prefill(jp, F.prompt(full, F.S + 1), F.S + 1)
    model = build_model(cfg)
    params = F.port_params(jp)
    _, cache = model.prefill(params, F.prompt(full, F.S), F.S + 8, impl="cuda")
    got, cache = model.decode_step(params, cache, full["tokens"][:, F.S:F.S + 1])
    assert int(cache["pos"]) == F.S + 1
    F.assert_close(got, want, "float32")


@pytest.mark.parametrize("arch", MOE)
def test_prefill_launches_the_kernel_once_per_layer(monkeypatch, arch):
    n = F.base.get_smoke_config(arch).n_layers
    F.check_flash_launches(monkeypatch, arch, n, n)


@pytest.mark.parametrize("arch", MOE)
def test_entry_points_raise_on_auto_without_a_gpu(monkeypatch, arch):
    F.check_auto_raises(monkeypatch, arch)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_interop_round_trip_keeps_dtypes(arch, param_dtype):
    F.check_round_trip(arch, param_dtype)


def test_init_draws_a_large_narrow_tensor_in_chunks(monkeypatch):
    """grok's and arctic's bf16 expert stacks are drawn a float32 chunk at
    a time: the same truncated normal, in the narrow dtype."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_DRAW_CHUNK", 1024)
    gen = torch.Generator().manual_seed(0)
    t = layers.dense_init(gen, (8, 64, 100), 64, torch.bfloat16)
    assert t.dtype == torch.bfloat16 and t.shape == (8, 64, 100)
    std = 1 / 8.0
    assert abs(float(t.float().std()) / (0.9866 * std) - 1) < 0.05
    assert float(t.float().abs().max()) <= 3 * std * 1.01
    # every chunk is drawn (no chunk left at zero), float32 stays one draw
    assert bool((t.reshape(-1, 1024).float().abs().sum(-1) > 0).all())
    f = layers.dense_init(torch.Generator().manual_seed(0), (8, 64, 100), 64)
    g = torch.empty((8, 64, 100))
    torch.nn.init.trunc_normal_(g, 0.0, std, -3 * std, 3 * std,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(f, g)
