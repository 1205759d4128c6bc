"""The tensor-core MLP backward's host side, on the CPU: its shared-memory
rule against the kernel's layout, the wrapper's refusals, and the tie-aware
yardstick (``chip_smoke.mlp_ties`` / ``step_ties``) that the card's checks
hold the kernel to. The kernel itself runs on the card (chip_smoke.py
phase 2); its plain version is held to the JAX package by
``test_torch_backward.py`` and ``test_torch_bf16_training.py``.

A tie is a decision whose input lies within rounding of its boundary: a
ReLU's pre-activation or an L1 residual near 0 (3xTF32 and float32 sums in
another order may put it on the other side), under bf16 a value near a
rounding boundary. The yardstick finds them with the plain version's
float64 function and adds each one's other side to the limit of what it
moves; everything else is held as strictly as before."""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.configs.dvnr import PRODUCTION256, SMOKE
from repro_torch.kernels.fused_mlp import ops
from repro_torch.kernels.fused_mlp.ref import fused_mlp_batched_bwd_ref
from repro_torch.kernels.fused_train_step import ref as fts_ref


def _mlp(rng, D_in, W, H, D_out, P=1, B=1, N=64):
    dims = [D_in] + [W] * H + [D_out]
    ws = [torch.from_numpy((rng.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a))
                           .astype(np.float32)) for a, b in zip(dims[:-1], dims[1:])]
    x = torch.from_numpy(rng.uniform(-1, 1, (B, N, D_in)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, N, D_out)).astype(np.float32))
    return x, ws, g


def _bwd_flipped(x, ws, g, flip):
    """The plain backward (float32, one batch row, one partition) with the
    ReLU mask of ``flip`` = (row, layer, unit) taken the other way: what a
    kernel that finds that pre-activation on the other side computes."""
    xs = x[0].clone().requires_grad_(True)
    wr = [w[0].clone().requires_grad_(True) for w in ws]
    h = xs
    for layer, w in enumerate(wr[:-1]):
        z = h @ w
        m = (z > 0).float()
        if layer == flip[1]:
            m[flip[0], flip[2]] = 1.0 - m[flip[0], flip[2]]
        h = torch.relu(z).detach() + (z - z.detach()) * m
    grads = torch.autograd.grad(h @ wr[-1], [xs, *wr], g[0])
    return grads[0][None], [d[None] for d in grads[1:]]


def _tie_operands():
    """A 4-16-16-1 MLP whose row 5 has layer-0 unit 3 at a pre-activation of
    1e-9 (0.5 - 0.5 + 1e-9 against a sum of magnitudes of 1)."""
    rng = np.random.default_rng(3)
    x, ws, g = _mlp(rng, 4, 16, 2, 1)
    x[0, 5] = torch.tensor([1.0, 1.0, 1e-9, 0.3])
    ws[0][0, :, 3] = torch.tensor([0.5, -0.5, 1.0, 0.0])
    return x, ws, g


def _held(got, want, ties, slack=True):
    """chip_smoke's float32 MLP backward limits, with or without the ties'
    allowance."""
    dx, dws = got
    want_dx, want_dws = want
    chip_smoke.check("dx", dx, want_dx, atol=2e-6 * float(want_dx.abs().max()),
                     slack=ties["dx"] if slack else None)
    for i, (a, b) in enumerate(zip(dws, want_dws)):
        chip_smoke.check(f"dW[{i}]", a, b, atol=2e-5 * float(b.abs().max()),
                         slack=ties["dW"][i] if slack else None)


def test_a_relu_taken_the_other_way_at_a_tie_passes_and_counts_one():
    x, ws, g = _tie_operands()
    part = torch.tensor([0])
    want = fused_mlp_batched_bwd_ref(x, ws, g, part)
    ties = chip_smoke.mlp_ties(x, ws, g, part)
    assert (ties["ties"], ties["widened"], ties["decisions"], ties["round"],
            ties["n"]) == (1, 0, 2 * 64 * 16, 0, 64)
    assert ties["dx"][0, 5].abs().max() > 0 and ties["dx"][0, :5].abs().max() == 0
    got = _bwd_flipped(x, ws, g, (5, 0, 3))
    with pytest.raises(chip_smoke.SmokeFailure):   # the flip matters ...
        _held(got, want, ties, slack=False)
    _held(got, want, ties)                         # ... and is a tie's other side


def test_the_same_flip_at_an_order_one_preactivation_fails():
    x, ws, g = _tie_operands()
    x[0, 5, 2] = 0.5                               # unit 3's input is now 0.5
    part = torch.tensor([0])
    want = fused_mlp_batched_bwd_ref(x, ws, g, part)
    ties = chip_smoke.mlp_ties(x, ws, g, part)
    assert ties["ties"] == 0 and float(ties["dx"].abs().max()) == 0.0
    with pytest.raises(chip_smoke.SmokeFailure):
        _held(_bwd_flipped(x, ws, g, (5, 0, 3)), want, ties)


def test_tie_count_above_its_share_fails():
    n = 100_000
    t_max, r_max = chip_smoke.TIE_SHARE_MAX, chip_smoke.NEED_ROW_SHARE_MAX
    ties, need = int(t_max * n), int(r_max * n)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_tie_count("too many ties", [("ties", ties + 1, n, t_max)])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_tie_count("too many rows needing them", [
            ("ties", 3, n, t_max), ("rows", need + 1, n, r_max)])
    chip_smoke.check_tie_count("within", [("ties", ties, n, t_max), ("rows", need, n, r_max)])
    chip_smoke.check_tie_count("one of a few", [("ties", 1, 32, t_max), ("rows", 1, 8, r_max)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_random_operands_have_few_ties(dtype):
    """PRODUCTION256's MLP at the training path's magnitudes: the ReLU ties
    stay inside their share, and the allowance is zero outside the tie
    rows."""
    rng = np.random.default_rng(7)
    x, ws, g = _mlp(rng, 20, 16, 2, 1, P=2, B=2, N=4096)
    x = x * 0.05
    x, ws, g = x.to(dtype), [w.to(dtype) for w in ws], g.to(dtype)
    ties = chip_smoke.mlp_ties(x, ws, g, torch.tensor([1, 0]))
    assert ties["n"] == 2 * 4096
    assert ties["decisions"] == 2 * 4096 * 32
    assert ties["ties"] <= chip_smoke.TIE_SHARE_MAX * ties["decisions"]
    assert ties["widened"] <= chip_smoke.WIDENED_SHARE_MAX * ties["decisions"]
    if dtype == torch.float32:
        assert ties["round"] == ties["round_wide"] == ties["rounded"] == 0
    else:
        assert 0 < ties["round"] <= chip_smoke.ROUND_SHARE_MAX * ties["rounded"]
    excused = (ties["dx"] > 0).any(-1)
    assert int(excused.sum()) <= (ties["ties"] + ties["widened"] + ties["round"]
                                  + ties["round_wide"])
    assert [tuple(d.shape) for d in ties["dW"]] == [tuple(w.shape) for w in ws]
    # dW's allowance comes only from the rows given
    none = chip_smoke.mlp_ties(x, ws, g, torch.tensor([1, 0]),
                               torch.zeros(2, 4096, dtype=torch.bool))
    assert all(float(d.abs().max()) == 0.0 for d in none["dW"])
    assert torch.equal(none["dx"], ties["dx"])


def test_bf16_rounding_gap():
    """The distance to the nearest bfloat16 rounding boundary and the ulp
    at it: 1.0 is a bf16 value (half an ulp from both boundaries), 1 +
    2^-8 the boundary itself, -3 - 2^-6 a bf16 value of the next binade, 0
    none."""
    v = torch.tensor([1.0, 1.0 + 2.0 ** -8, -3.0 - 2.0 ** -6, 0.0], dtype=torch.float64)
    gap, ulp = chip_smoke.bf16_rounding_gap(v)
    assert ulp[:3].tolist() == [2.0 ** -7, 2.0 ** -7, 2.0 ** -6]
    assert gap[:3].tolist() == [2.0 ** -8, 0.0, 2.0 ** -7]
    assert gap[3] == float("inf")


def test_an_l1_residual_at_a_tie_in_a_two_sample_train_step():
    """A train step of two samples, one with its residual within a few ulp
    of 0: the plain version with that residual's sign taken the other way
    passes the train-step check through the tie's allowance (and fails
    without it), with one tie row counted."""
    hc = SMOKE
    res, H = hc.level_resolutions(), hc.n_hidden_layers
    params = chip_smoke.step_params(hc, 1, "cpu", seed=4)
    rng = np.random.default_rng(4)
    coords = torch.from_numpy(rng.uniform(0, 1, (1, 2, 3)).astype(np.float32))
    pred = chip_smoke.step_pred(params, H, res, coords).float()
    ulp = torch.finfo(torch.float32).eps * pred.abs()
    at = pred - 4 * ulp                     # sample 0 at a tie, sample 1 not
    at[0, 1] = pred[0, 1] - 0.5
    other = at.clone()
    other[0, 0] = pred[0, 0] + 4 * ulp[0, 0]
    wants = chip_smoke.step_wants(params, H, res, coords, at)
    assert (wants["tie_count"], wants["decisions"]) == (1, 2 * 17)
    got_g, got_loss = fts_ref.train_step_grads_ref(params, H, res, coords, other)
    chip_smoke.check_step_grads("two samples", H, got_g, got_loss, wants)
    wants["allow"] = {k: torch.zeros_like(v) for k, v in wants["allow"].items()}
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_step_grads("two samples, no allowance", H, got_g,
                                    got_loss, wants)


def test_backward_shared_memory_rule_matches_the_kernel_layout():
    """PRODUCTION256 (D_in 20, W 16, H 2, D_out 1). float32: fragments of
    512 bytes, the forward's 3 x 2 (K = 20 padded to 24) and 1 x 2 x 2, the
    transposed 2 (w_out^T, K = 1 padded to 8), 2 x 2 and 2 x 3 (N = 20
    padded to 24): 22; a warp's dW 7 tiles of 512 bytes (dW_in 2 x 2,
    hidden 1 x 2, out 1), x tiles 2 x 32 rows of stride 24, g tiles 2 x 32
    of stride 2, and 4 tiles of 16 rows of stride 24 (2 activations, 2
    deltas). bf16: fragments of 256 bytes, 2 x 2 + 1 x 2 + 2 + 2 + 1 x 3,
    the g stride 8."""
    per_warp32 = 7 * 512 + 4 * (2 * 32 * 24 + 2 * 32 * 2 + 4 * 16 * 24)
    assert ops.mma_bwd_smem_bytes(20, 16, 2, 1, 4, 4) == 22 * 512 + 4 * per_warp32
    per_warp16 = 7 * 512 + 2 * (2 * 32 * 24 + 2 * 32 * 8 + 4 * 16 * 24)
    assert ops.mma_bwd_smem_bytes(20, 16, 2, 1, 2, 8) == 13 * 256 + 8 * per_warp16
    # D_out 3 under float32 takes the cotangent stride 8
    assert ops.mma_bwd_smem_bytes(20, 16, 2, 3, 4, 1) - \
        ops.mma_bwd_smem_bytes(20, 16, 2, 1, 4, 1) == 4 * 2 * 32 * 6
    # ABLATION (D_in 80, W 64, H 3): one warp a block under float32 (its
    # fragments unsplit, two words a lane), two under bf16
    assert ops.mma_bwd_smem_bytes(80, 64, 3, 1, 4, 1) <= ops.SMEM_LIMIT < \
        ops.mma_bwd_smem_bytes(80, 64, 3, 1, 4, 2)
    assert ops.mma_bwd_smem_bytes(80, 64, 3, 1, 2, 2) <= ops.SMEM_LIMIT
    L, F = PRODUCTION256.n_levels, PRODUCTION256.n_features_per_level
    assert (L * F, PRODUCTION256.n_neurons) == (20, 16)


def _operands(D_in=20, W=16, H=2, D_out=1, B=2, P=2, N=40, dtype=torch.float32):
    rng = np.random.default_rng(1)
    x, ws, g = _mlp(rng, D_in, W, H, D_out, P=P, B=B, N=N)
    return x.to(dtype), [w.to(dtype) for w in ws], g.to(dtype)


@pytest.mark.parametrize("bad,exc,match", [
    (dict(D_out=9), ValueError, "D_out=9"),
    (dict(W=24), ValueError, "W=24"),
    (dict(B=65536, N=1, P=1), ValueError, "B=65536"),
    (dict(D_in=400, W=64, H=3), ValueError, "shared memory"),
    (dict(g_dtype=torch.bfloat16), TypeError, "one dtype"),
    (dict(unchained=True), ValueError, "do not chain"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc, match):
    kw = {k: bad[k] for k in ("D_in", "W", "H", "D_out", "B", "P", "N") if k in bad}
    x, ws, g = _operands(**kw)
    if "g_dtype" in bad:
        g = g.to(bad["g_dtype"])
    if bad.get("unchained"):
        ws[1] = ws[1][:, :, :8]
    got = ops.bwd_refusal(x, ws, g)
    assert got is not None and got[0] is exc and match in got[1], got
    # on the CPU the wrapper takes the plain version all the same
    if exc is ValueError and "unchained" not in bad and "W" not in bad:
        ops.fused_mlp_bwd_cuda(x, ws, g, [0] * x.shape[0])


def test_wrapper_takes_the_main_paths_shapes():
    for kw in (dict(), dict(H=1), dict(H=3), dict(D_out=3), dict(W=32),
               dict(D_in=80, W=64, H=3), dict(D_in=5),
               dict(dtype=torch.bfloat16), dict(D_in=80, W=64, H=3, dtype=torch.bfloat16)):
        assert ops.bwd_refusal(*_operands(**kw)) is None, kw


def test_aligned16_copies_only_a_misaligned_start():
    base = torch.zeros(64)
    assert base.data_ptr() % 16 == 0 and ops.aligned16(base) is base
    view = base[1:33]
    got = ops.aligned16(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_dw_allowance_comes_only_from_the_rows_whose_dx_departs():
    """The flip of the first test moves its row's dx beyond the limit, and
    its dW: with that row given, both pass through the allowance; with no
    row given, dx keeps its allowance and dW fails."""
    x, ws, g = _tie_operands()
    part = torch.tensor([0])
    want = fused_mlp_batched_bwd_ref(x, ws, g, part)
    got = _bwd_flipped(x, ws, g, (5, 0, 3))
    rows = ((got[0] - want[0]).abs() > 2e-6 * float(want[0].abs().max())).any(-1)
    assert rows[0].nonzero().flatten().tolist() == [5]
    _held(got, want, chip_smoke.mlp_ties(x, ws, g, part, rows))
    with pytest.raises(chip_smoke.SmokeFailure):
        _held(got, want, chip_smoke.mlp_ties(x, ws, g, part, torch.zeros_like(rows)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_mlp_backward_controls_fail_on_planted_faults(dtype):
    """chip_smoke's controls at a small size: an output equal to the plain
    version's passes ``check_mlp_bwd``; the same with one 16-row pass left
    out of dW, and under bf16 the float32 policy's output, fail through the
    ties' allowance (``mlp_bwd_controls`` passes only when each fails)."""
    rng = np.random.default_rng(11)
    x, ws, g = _mlp(rng, 20, 16, 2, 1, P=2, B=2, N=4096)
    x, g = x * 0.05, g / 4096
    x, ws, g = x.to(dtype), [w.to(dtype) for w in ws], g.to(dtype)
    part = [1, 0]
    got = fused_mlp_batched_bwd_ref(x, ws, g, torch.tensor(part))
    chip_smoke.check_mlp_bwd("plain as the kernel", x, ws, g, part, got)
    chip_smoke.mlp_bwd_controls("plain as the kernel", x, ws, g, part, got)
    with pytest.raises(chip_smoke.SmokeFailure):      # a control that passes
        chip_smoke.must_fail("an unplanted output", lambda: None)


def test_the_train_step_control_fails_with_16_samples_left_out():
    """The train-step check (with the ties' allowance) on the plain
    version's own gradients passes; with 16 samples of partition 0 taken
    off, as phase 2's control plants, it fails."""
    hc = SMOKE
    res, H = hc.level_resolutions(), hc.n_hidden_layers
    params = chip_smoke.step_params(hc, 2, "cpu", seed=5)
    rng = np.random.default_rng(5)
    coords = torch.from_numpy(rng.uniform(0, 1, (2, 256, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (2, 256, 1)).astype(np.float32))
    wants = chip_smoke.step_wants(params, H, res, coords, target)
    got_g, got_loss = fts_ref.train_step_grads_ref(params, H, res, coords, target)
    chip_smoke.check_step_grads("plain as the kernel", H, got_g, got_loss, wants)
    part16, _ = fts_ref.train_step_grads_ref(params, H, res, coords[:, :16],
                                             target[:, :16])
    short = {k: v.clone() for k, v in got_g.items()}
    for k in short:
        short[k][0] -= part16[k][0] * (16 / 256)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_step_grads("16 samples left out", H, short, got_loss, wants)


def _emulate_bwd(x, ws, g, part):
    """The bf16 backward kernel's arithmetic on the CPU: every product of
    bf16 operands exact and each sum rounded once to float32 (float64 sums),
    then to bf16 where the kernel rounds (activations, deltas before their
    mask, dx); dW summed in float64 over a partition's rows, rounded once
    to float32."""
    f64, dt = torch.float64, x.dtype
    idx = torch.as_tensor(part).long()
    wsb = [w[idx].to(f64) for w in ws]
    rnd = lambda t: t.float().to(dt).to(f64)
    h, acts = x.to(f64), []
    for w in wsb[:-1]:
        h = rnd(torch.relu(h @ w))
        acts.append(h)
    d = rnd(g.to(f64) @ wsb[-1].transpose(1, 2)) * (acts[-1] > 0)
    dws = [None] * len(ws)
    dws[-1] = acts[-1].transpose(1, 2) @ g.to(f64)
    for layer in range(len(acts) - 1, 0, -1):
        dws[layer] = acts[layer - 1].transpose(1, 2) @ d
        d = rnd(d @ wsb[layer].transpose(1, 2)) * (acts[layer - 1] > 0)
    dws[0] = x.to(f64).transpose(1, 2) @ d
    dx = (d @ wsb[0].transpose(1, 2)).float().to(dt)
    P = ws[0].shape[0]
    return dx, [torch.zeros((P, *w.shape[1:]), dtype=f64).index_add_(0, idx, a).float()
                for w, a in zip(ws, dws)]


def test_bf16_emulation_reproduces_the_ablation_departure():
    """chip_smoke's ABLATION-shaped bf16 case (its inputs, replayed from
    its generator): the emulated kernel departs from the bf16 plain version
    by 1,075.98x the dx limit at most (the card's kernel read 1,075.9804x,
    NVIDIA H100 80GB HBM3), an activation rounded to its other bf16
    neighbour flipping masks below; on 687 elements of 66 rows (the card:
    906 elements, its float32 sums in another order). Every departure lies
    within the ties' allowance, the rows within their share, and the check
    passes the emulated output as a whole."""
    rng = np.random.default_rng(18)
    for label, P, part, N, D_in, W, H, D_out in chip_smoke.MLP_BWD_CASES:
        dims = [D_in] + [W] * H + [D_out]
        ws = [torch.as_tensor(rng.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a),
                              dtype=torch.float32) for a, b in zip(dims[:-1], dims[1:])]
        x = torch.as_tensor(rng.uniform(-0.05, 0.05, (len(part), N, D_in)),
                            dtype=torch.float32)
        g = torch.as_tensor(rng.choice([-1.0, 1.0], (len(part), N, D_out)) / N,
                            dtype=torch.float32)
        if label.startswith("W=64 D_in=80"):
            break
    dt = torch.bfloat16
    x, ws, g = x.to(dt), [w.to(dt) for w in ws], g.to(dt)
    got = _emulate_bwd(x, ws, g, part)
    dx_p, _ = fused_mlp_batched_bwd_ref(x, ws, g, torch.tensor(part))
    limit = chip_smoke.BF16_LIMITS["dx"] * float(dx_p.float().abs().max())
    err = (got[0].float() - dx_p.float()).abs()
    assert round(float(err.max()) / limit, 2) == 1075.98
    departs = err > limit
    assert (int(departs.sum()), int(departs.any(-1).sum())) == (687, 66)
    ties = chip_smoke.mlp_ties(x, ws, g, torch.tensor(part), departs.any(-1))
    assert bool((err <= limit + ties["dx"]).all())
    chip_smoke.check_mlp_bwd("ABLATION bf16, emulated", x, ws, g, part, got)


def test_stage_probe_names_the_kernels_stages_and_needs_the_card():
    """``fused_mlp_bwd_stage_cycles`` returns one count per stage of the C
    side's ``BwdStage`` (mlp_mma.cuh), and takes CUDA operands only."""
    import re
    text = (ops.build.CSRC / "mlp_mma.cuh").read_text()
    enum = re.search(r"enum BwdStage \{([^}]*)\}", text).group(1)
    stages = [s.strip() for s in enum.split(",") if s.strip()]
    assert stages[-1] == "kStages" and len(stages) - 1 == len(ops.BWD_STAGES)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_mlp_bwd_stage_cycles(*_operands(), [0, 1])
