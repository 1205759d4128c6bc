"""The host side of the deterministic routes (ROADMAP C1; the routes
themselves are CUDA kernels, held on the card by ``chip_smoke.py``):

- PyTorch's own switch, ``torch.use_deterministic_algorithms(True)``,
  selects the fused step's route, and only on a CUDA device;
- the unfused path's backward kernels have routes of their own and no
  longer refuse the switch; the MLP backward's clocked measurement launch,
  which keeps float atomics, does;
- the unfused route's plain version (the hash backward's int64 fixed-point
  sum and its conversion) against a float64 sum, and its overflow guard;
- the fixed-point scale: the bound it requires of a contribution
  (``N |w g| <= FX_BOUND``) against the plain version's largest feature
  cotangent at PRODUCTION256's widths, at init and after training; and the
  precision of the int64 sums against float64, beside float32's;
- :func:`det_grads_to_float` reads the route's buffers back exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import dvnr
from repro_torch.core.sampling import batch_coords, step_seeds
from repro_torch.core.trainer import DVNRTrainer, init_params
from repro_torch.data.volume import make_partition, sample_trilinear_batched
from repro_torch.kernels import build
from repro_torch.kernels import fixed_point as fxp
from repro_torch.kernels.fused_mlp.ops import (fused_mlp_bwd_cuda,
                                               fused_mlp_bwd_stage_cycles)
from repro_torch.kernels.fused_train_step import ops as fts
from repro_torch.kernels.fused_train_step import ref as fref
from repro_torch.kernels.hash_encoding.ops import hash_encode_bwd_cuda
from repro_torch.kernels.hash_encoding.ref import (_corner_weight, _level_corners,
                                                   corner_indices,
                                                   fx_to_float,
                                                   hash_encode_batched_bwd_fx_ref,
                                                   hash_encode_batched_bwd_ref)
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def test_switch_selects_the_route(deterministic):
    cuda = torch.device("cuda")
    assert fts.deterministic()
    assert DVNRTrainer(dvnr.SMOKE, 2, impl="cuda", device="cpu")._det_route(cuda)
    # not for the plain backend, the CPU, or the unfused step
    assert not DVNRTrainer(dvnr.SMOKE, 2, impl="ref", device="cpu")._det_route(cuda)
    assert not DVNRTrainer(dvnr.SMOKE, 2, impl="cuda", device="cpu")._det_route("cpu")
    off = DVNRTrainer(dvnr.SMOKE.replace(fuse_train_step="off"), 2, impl="cuda",
                      device="cpu")
    assert not off._det_route(cuda)
    torch.use_deterministic_algorithms(False)
    assert not fts.deterministic()
    assert not DVNRTrainer(dvnr.SMOKE, 2, impl="cuda", device="cpu")._det_route(cuda)


def test_unfused_kernels_raise_under_the_switch(deterministic):
    """Under the switch the unfused backwards take their deterministic
    routes: on tensors of no CUDA device they raise the device error, not a
    refusal of the switch. Only a launch without a route refuses it."""
    meta = torch.device("meta")
    g = torch.zeros((1, 8, 4), device=meta)
    coords = torch.zeros((1, 8, 3), device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        hash_encode_bwd_cuda(g, coords, [4, 8], [0], (1, 2, 64, 2))
    ws = [torch.zeros((1, 4, 16), device=meta), torch.zeros((1, 16, 1), device=meta)]
    with pytest.raises(ValueError, match="CUDA device"):
        fused_mlp_bwd_cuda(g, ws, torch.zeros((1, 8, 1), device=meta), [0])
    with pytest.raises(RuntimeError, match="deterministic"):
        fused_mlp_bwd_stage_cycles(g, ws, torch.zeros((1, 8, 1), device=meta), [0])
    with pytest.raises(RuntimeError, match="deterministic"):
        build.refuse_nondeterministic("a kernel")
    torch.use_deterministic_algorithms(False)
    build.refuse_nondeterministic("a kernel")       # off: no refusal
    with pytest.raises(ValueError, match="CUDA device"):
        hash_encode_bwd_cuda(g, coords, [4, 8], [0], (1, 2, 64, 2))


def test_cpu_training_is_unchanged_under_the_switch():
    part = [make_partition("cloverleaf", p, (1, 1, 2), (8, 8, 8), 0.3, device="cpu")
            for p in range(2)]
    a, _ = api.train(part, dvnr.SMOKE, backend="cuda", steps=6, key=2)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        b, _ = api.train(part, dvnr.SMOKE, backend="cuda", steps=6, key=2)
    finally:
        torch.use_deterministic_algorithms(before)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def _step_cotangent(cfg, params, vols, seed, N):
    """The plain step's feature cotangent (1, N, L*F) and its batch."""
    flat, H = fts._pack(params)
    seeds = step_seeds(seed, 0, 1)
    coords = batch_coords(seeds, N, N - N // 5, cfg.boundary_sigma)
    target = sample_trilinear_batched(vols, coords, 1)
    target = target[..., None] if target.ndim == 2 else target
    g = torch.zeros((1, N, cfg.n_levels * cfg.n_features_per_level))
    fref.train_step_grads_ref(flat, H, cfg.level_resolutions(), coords, target,
                              cotangent_out=g)
    return g, coords


def test_fixed_point_bound_holds_the_plain_cotangent():
    """N |w g| <= N |g| (|w| <= 1) must stay far under FX_BOUND: at
    PRODUCTION256's widths, at init and after 64 steps of training (the gain
    from the loss cotangent to a feature does not depend on N, so the
    training runs a smaller batch)."""
    cfg = dvnr.PRODUCTION256
    part = make_partition("cloverleaf", 0, (1, 1, 1), (16, 16, 16), 0.3, device="cpu")
    vols = part.normalized()[None]
    N = 1 << 16
    g0, _ = _step_cotangent(cfg, init_params(cfg, 0, 1), vols, 1, N)
    small = cfg.replace(batch_size=4096)
    model, _ = api.train([part], small, backend="ref", steps=64, key=0)
    g1, _ = _step_cotangent(cfg, model.params, vols, 1, N)
    gains = [float(N * g.abs().max()) for g in (g0, g1)]
    assert all(0 < x < fts.FX_BOUND / 64 for x in gains), gains


def test_fixed_point_sums_are_closer_than_float32():
    """The route's table gradient emulated on the host (each contribution
    rounded to a multiple of 2^-47, summed in int64 in any order) against
    the float64 sum: within half a quantum a contribution, and closer than
    the float32 scatter of the plain version."""
    cfg = dvnr.SMOKE.replace(n_levels=3, log2_hashmap_size=9)
    part = make_partition("cloverleaf", 0, (1, 1, 1), (10, 10, 10), 0.3, device="cpu")
    N = 4096
    g, coords = _step_cotangent(cfg, init_params(cfg, 3, 1), part.normalized()[None],
                                5, N)
    L, F, T = cfg.n_levels, cfg.n_features_per_level, cfg.table_size
    x, gl = coords.reshape(N, 3), g.reshape(N, L, F)
    fx = torch.zeros((L * T, F), dtype=torch.int64)
    exact = torch.zeros((L * T, F), dtype=torch.float64)
    for l, res in enumerate(cfg.level_resolutions()):
        lo, w = _level_corners(x, int(res))
        for c in range(8):
            dx, dy, dz = (c >> 2) & 1, (c >> 1) & 1, c & 1
            idx = corner_indices(lo + torch.tensor([dx, dy, dz]), int(res), T) + l * T
            v = _corner_weight(w, dx, dy, dz)[:, None] * gl[:, l]        # float32
            assert float(N * v.abs().max()) <= fts.FX_BOUND
            q = torch.round(v.double() * 2.0 ** fts.FX_SHIFT).to(torch.int64)
            perm = torch.randperm(N, generator=torch.Generator().manual_seed(c))
            fx.index_add_(0, idx[perm], q[perm])                     # any order
            exact.index_add_(0, idx, v.double())
    fixed = fx.double() * 2.0 ** -fts.FX_SHIFT
    f32 = hash_encode_batched_bwd_ref(g, coords, cfg.level_resolutions(),
                                      torch.zeros(1, dtype=torch.int64),
                                      (1, L, T, F)).reshape(L * T, F).double()
    err_fx = float((fixed - exact).abs().max())
    assert err_fx <= 8 * N * 2.0 ** -(fts.FX_SHIFT + 1)
    assert err_fx <= float((f32 - exact).abs().max())


def test_det_grads_to_float_reads_the_buffers():
    P, groups, L, T, F = 2, 3, 2, 8, 2
    flat = {"tab": torch.zeros((P, L, T, F)), "win": torch.zeros((P, 4, 16)),
            "whid": torch.zeros((P, 1, 16, 16)), "wout": torch.zeros((P, 16, 1))}
    n_w = 4 * 16 + 16 * 16 + 16
    rng = np.random.default_rng(0)
    partials = torch.from_numpy(rng.standard_normal((P, groups, n_w + 1)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-2**50, 2**50, (P, L, T, F)))
    det = fts.DetGrads(partials, q, torch.zeros(P, dtype=torch.int64))
    grads, loss = fts.det_grads_to_float(det, flat, 2)
    # the kernel's order: float32, group after group from 0
    a = partials.numpy()
    sums = np.zeros((P, n_w + 1), np.float32)
    for i in range(groups):
        sums = sums + a[:, i]
    sums = torch.from_numpy(sums)
    assert torch.equal(grads["win"], sums[:, :64].reshape(P, 4, 16))
    assert torch.equal(grads["whid"], sums[:, 64:320].reshape(P, 1, 16, 16))
    assert torch.equal(grads["wout"], sums[:, 320:336].reshape(P, 16, 1))
    assert torch.equal(loss, sums[:, -1])
    assert torch.equal(grads["tab"], torch.from_numpy(
        (q.numpy().astype(np.float64) * 2.0 ** -47).astype(np.float32)))
    # an H = 1 MLP: no hidden columns, a zero dummy slab
    det1 = fts.DetGrads(partials[..., : 4 * 16 + 16 + 1].contiguous(), q, det.flags)
    g1, _ = fts.det_grads_to_float(det1, flat, 1)
    assert not g1["whid"].any()
    wout = np.zeros((P, 16), np.float32)
    for i in range(groups):
        wout = wout + a[:, i, 64:80]
    assert torch.equal(g1["wout"], torch.from_numpy(wout).reshape(P, 16, 1))


def _exact_table_grad(g, coords, res, part, shape):
    """The float64 sum of every corner contribution (each the float32
    product the kernel forms), and the number of adds an entry took."""
    B, N, _ = coords.shape
    P, L, T, F = shape
    x, gl = coords.reshape(B * N, 3), g.float().reshape(B * N, L, F)
    base = torch.as_tensor(part).repeat_interleave(N) * (L * T)
    exact = torch.zeros((P * L * T, F), dtype=torch.float64)
    adds = torch.zeros(P * L * T, dtype=torch.int64)
    for l, r in enumerate(res):
        lo, w = _level_corners(x, int(r))
        for c in range(8):
            dx, dy, dz = (c >> 2) & 1, (c >> 1) & 1, c & 1
            idx = corner_indices(lo + torch.tensor([dx, dy, dz]), int(r), T) + base + l * T
            v = _corner_weight(w, dx, dy, dz)[:, None] * gl[:, l]
            exact.index_add_(0, idx, v.double())
            adds.index_add_(0, idx, torch.ones_like(idx))
    return exact.reshape(P, L, T, F), adds.reshape(P, L, T, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfused_fixed_point_sum_against_float64(dtype):
    """The plain version of the unfused route (int64 fixed point, then the
    conversion) against the float64 sum of the same float32 contributions:
    within one 2^-47 quantum an add before the conversion, and the float32
    conversion within half an ulp of that. Rows of one partition in two
    batch rows (permuted part) add up as one."""
    cfg = dvnr.SMOKE.replace(n_levels=3, log2_hashmap_size=9)
    L, F, T = cfg.n_levels, cfg.n_features_per_level, cfg.table_size
    res = cfg.level_resolutions()
    rng = np.random.default_rng(7)
    B, N, P = 3, 2048, 2
    part = torch.tensor([1, 0, 1])
    coords = torch.from_numpy(rng.uniform(0, 1, (B, N, 3)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((B, N, L * F)) / (N * 4))
                         .astype(np.float32)).to(dtype)
    sums, flags = hash_encode_batched_bwd_fx_ref(g, coords, res, part, (P, L, T, F))
    assert sums.dtype == torch.int64 and not flags.any()
    exact, adds = _exact_table_grad(g, coords, res, part, (P, L, T, F))
    fixed = sums.double() * 2.0 ** -fxp.FX_SHIFT
    quanta = ((fixed - exact).abs() / 2.0 ** -fxp.FX_SHIFT)
    assert bool((quanta <= adds).all()), float((quanta - adds).max())
    got = fx_to_float(sums, flags)
    assert torch.equal(got, fixed.float())
    # the wrapper on the CPU under the switch is this plain version
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        wrapped = hash_encode_bwd_cuda(g, coords, res, part, (P, L, T, F))
    finally:
        torch.use_deterministic_algorithms(before)
    assert torch.equal(wrapped, got)


def test_unfused_fixed_point_guard_raises():
    """A contribution past FX_BOUND / M (M: the partition's points) flags
    FX_OVER on its partition only, and the wrapper raises; a NaN one flags
    FX_NONFINITE and its partition's gradient is NaN."""
    cfg = dvnr.SMOKE.replace(n_levels=2, log2_hashmap_size=8)
    L, F, T = cfg.n_levels, cfg.n_features_per_level, cfg.table_size
    res = cfg.level_resolutions()
    N, P = 256, 2
    coords = torch.full((P, N, 3), 0.5)
    g = torch.full((P, N, L * F), 1e-4)
    limit = fxp.FX_BOUND / N
    g[1, 3, 0] = 0.5 * limit           # a corner weight is at most 1
    _, flags = hash_encode_batched_bwd_fx_ref(g, coords, res, torch.arange(P),
                                              (P, L, T, F))
    assert flags.tolist() == [0, 0]
    g[1, 3, 0] = 16.0 * limit          # 0.5 lies on a vertex of a level: weight 1
    _, flags = hash_encode_batched_bwd_fx_ref(g, coords, res, torch.arange(P),
                                              (P, L, T, F))
    assert flags.tolist() == [0, fxp.FX_OVER]
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(fxp.FixedPointOverflowError, match=r"partitions \[1\]"):
            hash_encode_bwd_cuda(g, coords, res, torch.arange(P), (P, L, T, F))
    finally:
        torch.use_deterministic_algorithms(before)
    g[1, 3, 0] = float("nan")
    sums, flags = hash_encode_batched_bwd_fx_ref(g, coords, res, torch.arange(P),
                                                 (P, L, T, F))
    assert flags.tolist() == [0, fxp.FX_NONFINITE]
    out = fx_to_float(sums, flags)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
