"""The INR inference kernel's plain version and route (repro_torch.kernels.
inr_forward, repro_torch.core.inr) against the JAX package's INR forward.

The plain version is the two-kernel route's function: the hash encode, then
the fused MLP. Tolerances: float32 within 1e-5 of the output's scale
(max(1, max|want|): coordinates outside [0,1] extrapolate to outputs of a
few hundred), as tests/test_torch_fused_mlp.py's 1e-5; bf16 within one bf16
ulp, as its bf16 test. Under bf16 the port's encode sums the 8 corners in
float32 and rounds once, JAX's "fused" arithmetic; JAX's "ref" and "pallas"
encodes sum them in bf16 (ROADMAP §C), so the bf16 cases take JAX's "fused"
encode and its "ref" / "pallas" MLP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dvnr as jdvnr
from repro.core import inr as jinr
from repro.kernels.fused_mlp.ops import fused_mlp as jfused_mlp
from repro.kernels.hash_encoding.ops import hash_encode as jhash_encode
from repro_torch import api, interop
from repro_torch.configs import dvnr
from repro_torch.core import inr, render
from repro_torch.data.volume import make_partition
from repro_torch.kernels.fused_mlp.ops import mma_smem_bytes
from repro_torch.kernels.inr_forward import ops as iops
from repro_torch.kernels.inr_forward.ops import inr_forward_cuda, refusal
from repro_torch.kernels.inr_forward.ref import inr_forward_ref

BF16_ULP = 2.0 ** -7
TABLE_AMP = 0.1   # a trained model's table magnitude (tests/test_torch_inr.py)
# SMOKE and a small PRODUCTION256: L=5, F=4, T=2^13 (levels 3 and 4 hashed),
# W=16, two hidden layers
CONFIGS = {"smoke": (jdvnr.SMOKE, dvnr.SMOKE),
           "p256": (jdvnr.PRODUCTION256, dvnr.PRODUCTION256)}


def _jax_params(jcfg, seed, n_partitions=None):
    key = jax.random.PRNGKey(seed)
    if n_partitions is None:
        p = jinr.init_inr(jcfg, key)
    else:
        p = jax.vmap(lambda k: jinr.init_inr(jcfg, k))(
            jax.random.split(key, n_partitions))
    p = jax.tree.map(np.asarray, p)
    p["tables"] = np.random.default_rng(seed).uniform(
        -TABLE_AMP, TABLE_AMP, p["tables"].shape).astype(np.float32)
    return p


def _coords(seed, shape, lo=-0.25, hi=1.25):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _stacked(params):
    return params["tables"][None], [w[None] for w in params["mlp"]]


def _close_f32(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("out_dim", [1, 3])
def test_plain_inference_matches_jax_f32(impl, name, out_dim):
    jcfg, cfg = (c.replace(out_dim=out_dim) for c in CONFIGS[name])
    npp = _jax_params(jcfg, seed=out_dim)
    xyz = _coords(7, (300, 3))
    want = np.asarray(jinr._inr_apply(jcfg, jax.tree.map(jnp.asarray, npp),
                                      jnp.asarray(xyz), impl))
    params = interop.params_from_numpy(npp, "cpu")
    tables, mlp = _stacked(params)
    c = torch.from_numpy(xyz)[None]
    got = inr_forward_ref(c, tables, mlp, [0], cfg.level_resolutions())[0]
    assert got.dtype == torch.float32 and got.shape == (300, out_dim)
    _close_f32(got.numpy(), want)
    wrapped = inr_forward_cuda(c, tables, mlp, [0], cfg.level_resolutions())[0]
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("mlp_impl", ["ref", "pallas"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("out_dim", [1, 3])
def test_plain_inference_matches_jax_bf16(mlp_impl, name, out_dim):
    """bf16 params: bf16 features (f32 corner sums, rounded once) into the
    bf16 MLP (f32 sums, each layer rounded to bf16), within one bf16 ulp."""
    jcfg, cfg = (c.replace(out_dim=out_dim) for c in CONFIGS[name])
    npp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                       _jax_params(jcfg, seed=10 + out_dim))
    jp = jax.tree.map(jnp.asarray, npp)
    xyz = _coords(8, (300, 3))
    feats = jhash_encode(jnp.asarray(xyz), jp["tables"], jcfg.level_resolutions(),
                         "fused")
    want = np.asarray(jfused_mlp(feats, jp["mlp"], mlp_impl)).astype(np.float32)
    params = interop.params_from_numpy(npp, "cpu")
    tables, mlp = _stacked(params)
    got = inr_forward_ref(torch.from_numpy(xyz)[None], tables, mlp, [0],
                          cfg.level_resolutions())[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_less(np.abs(got.float().numpy() - want),
                                 BF16_ULP * np.abs(want) + 1e-30)
    whole = np.asarray(jinr._inr_apply(jcfg, jp, jnp.asarray(xyz), "fused"))
    np.testing.assert_array_equal(got.float().numpy(), whole.astype(np.float32))


def test_mixed_policy_casts_as_the_route():
    """compute dtype bf16 over f32 params: the tables cast before the
    encode, features and weights before the MLP (the route's casts)."""
    cfg = dvnr.PRODUCTION256
    params = interop.params_from_numpy(_jax_params(jdvnr.PRODUCTION256, 3), "cpu")
    c = torch.from_numpy(_coords(9, (200, 3)))
    route = inr._inr_apply(cfg, params, c, "ref", compute_dtype="bfloat16")
    tables, mlp = _stacked(params)
    got = inr_forward_ref(c[None], tables, mlp, [0], cfg.level_resolutions(),
                          "bfloat16")[0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, route)


def test_partition_rows_match_per_partition_jax():
    jcfg, cfg = CONFIGS["p256"]
    P, part = 3, [2, 0, 1, 2]
    npp = _jax_params(jcfg, seed=5, n_partitions=P)
    sp = interop.params_from_numpy(npp, "cpu")
    xyz = _coords(11, (len(part), 120, 3))
    got = inr_forward_cuda(torch.from_numpy(xyz), sp["tables"], sp["mlp"], part,
                           cfg.level_resolutions())
    for b, p in enumerate(part):
        jp = jax.tree.map(lambda a: jnp.asarray(a[p]), npp)
        want = np.asarray(jinr._inr_apply(jcfg, jp, jnp.asarray(xyz[b]), "pallas"))
        _close_f32(got[b].numpy(), want)


# ---------------------------------------------------------------- the route
@pytest.fixture
def route_calls(monkeypatch):
    """Count the route's calls of the inference kernel's wrapper (on CPU
    tensors it takes the plain version and counts no launch)."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return inr_forward_cuda(*args, **kw)

    monkeypatch.setattr(inr, "inr_forward_cuda", counted)
    return calls


def _smoke_model(P=2, seed=0):
    npp = _jax_params(jdvnr.SMOKE, seed, n_partitions=P)
    metas = tuple({"origin": (0.0, 0.0, 0.5 * p), "extent": (1.0, 1.0, 0.5),
                   "vmin": -0.1 * p, "vmax": 1.0 + p} for p in range(P))
    return api.DVNRModel(dvnr.SMOKE, interop.params_from_numpy(npp, "cpu"), metas)


def _apply(m):
    return m.partition(1).apply(torch.from_numpy(_coords(1, (90, 3))), "cuda")


def _decode(m):
    return m.partition(0).decode_grid((5, 4, 6), "cuda", chunk=50)


def _render(m):
    return api.render(m, api.RenderRequest(width=6, height=5, n_samples=4),
                      backend="cuda")


def _render_partition(m):
    one = m.partition(1)
    origins, dirs = render.make_rays(api.Camera(), 6, 5, "cpu")
    meta = one.parts_meta[0]
    return render._render_partition(
        dvnr.SMOKE, one.params, meta["origin"], meta["extent"],
        (meta["vmin"], meta["vmax"]), m.grange, origins, dirs,
        render.default_tf(), n_samples=4, impl="cuda")[0]


def _evaluate(m):
    parts = [make_partition("cloverleaf", p, (1, 1, 2), (6, 6, 6), 0.3,
                            device="cpu") for p in range(2)]
    _, info = api.train(parts, dvnr.SMOKE, backend="cuda", steps=2, key=0)
    vols = torch.stack([p.normalized() for p in parts])
    return torch.tensor(info["trainer"].evaluate(info["state"], vols, (6, 6, 6))["psnr"])


@pytest.mark.parametrize("entry", [_apply, _decode, _render, _render_partition,
                                   _evaluate],
                         ids=["apply", "decode_grid", "render", "render_partition",
                              "evaluate"])
def test_inference_paths_take_the_route(route_calls, monkeypatch, entry):
    """Each inference entry point reaches the one-launch kernel on the cuda
    backend, and gives the two-op route's values bit for bit."""
    m = _smoke_model()
    got = entry(m)
    n = len(route_calls)
    assert n, "the entry point did not take the inference route"
    monkeypatch.setattr(inr, "_inference", lambda *a: False)
    want = entry(m)
    assert len(route_calls) == n
    assert torch.equal(got, want)


def test_no_grad_route_equals_autograd_route_bit_for_bit(route_calls):
    cfg = dvnr.PRODUCTION256
    sp = interop.params_from_numpy(_jax_params(jdvnr.PRODUCTION256, 2, 3), "cpu")
    c = torch.from_numpy(_coords(3, (4, 150, 3)))
    part = [0, 2, 1, 1]
    for policy in (None, "bfloat16"):
        with torch.no_grad():
            fast = inr._inr_apply_batched(cfg, sp, c, part, "cuda", policy)
        assert len(route_calls) == 1
        route_calls.clear()
        leaves = {"tables": sp["tables"].clone().requires_grad_(True),
                  "mlp": [w.clone().requires_grad_(True) for w in sp["mlp"]]}
        slow = inr._inr_apply_batched(cfg, leaves, c, part, "cuda", policy)
        assert not route_calls and slow.requires_grad
        assert torch.equal(fast, slow.detach())


def test_autograd_route_keeps_its_gradients(route_calls):
    """Parameters that require grad take the two autograd ops: the cuda
    backend's gradients (its wrappers' plain versions here) equal the ref
    backend's."""
    cfg = dvnr.PRODUCTION256
    sp = interop.params_from_numpy(_jax_params(jdvnr.PRODUCTION256, 4, 2), "cpu")
    c = torch.from_numpy(_coords(4, (2, 200, 3), 0.0, 1.0))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 200, 1))
                         .astype(np.float32))
    grads = {}
    for backend in ("cuda", "ref"):
        leaves = [sp["tables"].clone().requires_grad_(True),
                  *(w.clone().requires_grad_(True) for w in sp["mlp"])]
        out = inr._inr_apply_batched(cfg, {"tables": leaves[0], "mlp": leaves[1:]},
                                     c, [1, 0], backend)
        grads[backend] = torch.autograd.grad(out, leaves, g)
    assert not route_calls
    for a, b in zip(grads["cuda"], grads["ref"]):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ref_backend_and_refused_shapes_keep_the_pair(route_calls):
    cfg = dvnr.SMOKE.replace(n_neurons=8)   # W not among the kernel's widths
    m = api.DVNRModel.init(cfg, 0, device="cpu")
    xyz = torch.rand(20, 3, generator=torch.Generator().manual_seed(0))
    a = m.apply(xyz, backend="cuda")
    b = _smoke_model().partition(0).apply(xyz, backend="ref")
    assert a.shape == b.shape == (20, 1) and not route_calls


# ---------------------------------------------------------------- guards
def _operands(L=5, F=4, T=64, W=16, H=2, D_out=1, B=2, P=2, N=7,
              dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    dims = [L * F] + [W] * H + [D_out]
    tables = torch.rand((P, L, T, F), generator=g).to(dtype)
    mlp = [torch.rand((P, a, b), generator=g).to(dtype)
           for a, b in zip(dims[:-1], dims[1:])]
    return torch.rand((B, N, 3), generator=g), tables, mlp, [0] * B, [2] * L


def test_wrapper_takes_the_plain_version_on_cpu():
    coords, tables, mlp, part, res = _operands()
    before = (inr_forward_cuda.launches, inr_forward_cuda.bf16_launches)
    for dt in (None, torch.bfloat16):
        got = inr_forward_cuda(coords, tables, mlp, part, res, dt)
        assert torch.equal(got, inr_forward_ref(coords, tables, mlp, part, res, dt))
    assert (inr_forward_cuda.launches, inr_forward_cuda.bf16_launches) == before


@pytest.mark.parametrize("bad,exc,match", [
    (dict(coords_dtype=torch.float64), TypeError, "coords must be float32"),
    (dict(compute=torch.float16), TypeError, "float32 or bfloat16"),
    (dict(mlp_dtype=torch.bfloat16), TypeError, "share one dtype"),
    (dict(F=3), ValueError, "F=3"),
    (dict(W=8), ValueError, "W=8"),
    (dict(D_out=9), ValueError, "D_out=9"),
    (dict(H=0), ValueError, ">= 2 weights"),
    (dict(L=33), ValueError, "L=33"),
    (dict(B=65536, N=1), ValueError, "B=65536"),
    (dict(W=64, H=3, L=32, F=8), ValueError, "shared memory"),
    (dict(unchained=True), ValueError, "do not chain"),
    (dict(n_res=4), ValueError, "4 resolutions for 5 levels"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc, match):
    kw = {k: bad[k] for k in ("L", "F", "W", "H", "D_out", "B", "N") if k in bad}
    coords, tables, mlp, part, res = _operands(**kw)
    coords = coords.to(bad.get("coords_dtype", torch.float32))
    if "mlp_dtype" in bad:
        mlp = [w.to(bad["mlp_dtype"]) for w in mlp]
    if bad.get("unchained"):
        mlp[1] = mlp[1][:, :, :8]
    if "n_res" in bad:
        res = res[:bad["n_res"]]
    with pytest.raises(exc, match=match):
        inr_forward_cuda(coords, tables, mlp, part, res, bad.get("compute"))


def test_shared_memory_rule_matches_the_kernel_layout():
    """The kernel's block at PRODUCTION256 (csrc/inr_forward.cuh
    plan_layout): the weights' fragments (float32: 3 k-tiles of 8, K = 20
    padded to 24, x 2 n-tiles, one hidden layer of 2 x 2, the output 2 x 1,
    512 bytes a fragment; bf16: k-tiles of 16, 256 bytes), 256 bytes of
    resolutions and level offsets, 16 of the tables' barrier, the staged
    levels' rows (125, 729 and 4,913 dense rows, then 2 x 8,192 hashed; a
    row of 4 features, each level rounded up to 16 bytes) and one 32-row
    tile of stride 24 for each of the block's 32 warps. float32 stages the
    three dense levels (the first hashed one does not fit what is left);
    bf16 stages all five."""
    assert mma_smem_bytes(20, 16, 2, 4, 0) == (3 * 2 + 2 * 2 + 2) * 512
    assert mma_smem_bytes(20, 16, 2, 2, 0) == (2 * 2 + 1 * 2 + 1) * 256
    res = dvnr.PRODUCTION256.level_resolutions()
    fixed32, fixed16 = 12 * 512 + 256 + 16, 7 * 256 + 256 + 16
    dense32 = (125 + 729 + 4913) * 16
    assert iops.SMEM_LIMIT - fixed32 - 32 * 32 * 24 * 4 - dense32 < 8192 * 16
    assert iops.fwd_layout(res, 8192, 4, 16, 2, 4) == {
        "plan": "sssdd", "warps": 32, "bytes": fixed32 + dense32 + 32 * 32 * 24 * 4,
        "threads": 1024}
    rows = 1008 + 5840 + 39312 + 2 * 65536
    assert rows == sum(-(-r * 8 // 16) * 16 for r in (125, 729, 4913, 8192, 8192))
    assert iops.fwd_layout(res, 8192, 4, 16, 2, 2) == {
        "plan": "sssss", "warps": 32, "bytes": fixed16 + rows + 32 * 32 * 24 * 2,
        "threads": 1024}
    assert refusal(*_operands(L=10, F=8, W=64, H=3)[:3]) is None   # ABLATION
    assert iops.KERNEL_FEATURES == (1, 2, 4, 8)
