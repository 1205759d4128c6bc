"""The deterministic route's ordered sums on the CPU: AdamW's role split
(repro_torch.kernels.fused_train_step.ops.adamw_det_plan, the mirror of
csrc/adamw.cu's det_plan) and the MLP backward's grid and dW rows
(repro_torch.kernels.fused_mlp.ops.det_plan, the mirror of
csrc/fused_mlp.cu's det_blocks and row width) at every config's shapes,
the ordered sum's grid over those rows, det_grads_to_float's group order,
the measurement entries' refusals, the launch plans and the kernels'
budgets. Shape arithmetic
and host code only: no kernel runs here and JAX is not imported
(chip_smoke.py phase 1 holds the mirrors against the library's own plans,
phase 2 the new designs against their yardsticks bit for bit).

Cost: ~6 s serial, the imports included.
"""
import pytest
import torch

from repro_torch.configs import dvnr
from repro_torch.kernels import budgets
from repro_torch.kernels.fused_mlp import ops as mops
from repro_torch.kernels.fused_train_step import ops as fts

CONFIGS = {name: getattr(dvnr, name) for name in dir(dvnr)
           if isinstance(getattr(dvnr, name), dvnr.DVNRConfig)}
#: (blocks a batch row, floats a block's dW row) of the deterministic MLP
#: backward at each config's batch: the same under f32 and bf16, and the
#: same as before the ordered sum moved into the launch (the rows, their
#: order and so the bits are unchanged)
DET_SHAPES = {
    "ABLATION": (64, 13824), "CLOVERLEAF_CACHE": (64, 384),
    "CLOVERLEAF_SCALING": (64, 896), "CONFIG": (64, 896), "NEKRS_CACHE": (64, 384),
    "NEKRS_INSITU": (64, 1152), "NEKRS_SCALING": (64, 1152), "PRODUCTION": (64, 896),
    "PRODUCTION256": (64, 896), "S3D_INSITU": (64, 640), "S3D_SCALING": (64, 640),
}


def _widths(hc, D_out=None):
    D_in = hc.n_levels * hc.n_features_per_level
    D_out = hc.out_dim if D_out is None else D_out
    n_w = D_in * hc.n_neurons + (hc.n_hidden_layers - 1) * hc.n_neurons ** 2 \
        + hc.n_neurons * D_out
    return D_in, n_w


def test_config_list_is_the_module_s():
    assert set(DET_SHAPES) | {"SMOKE"} == set(CONFIGS)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("name", sorted(DET_SHAPES))
def test_mlp_det_plan_unchanged_at_every_config(name, itemsize):
    hc = CONFIGS[name]
    D_in, _ = _widths(hc)
    assert mops.det_plan(hc.batch_size, D_in, hc.n_neurons, hc.n_hidden_layers,
                         hc.out_dim, itemsize) == DET_SHAPES[name]


def test_mlp_det_plan_follows_the_batch_and_the_warps():
    # SMOKE's 512 rows: 16 tiles over f32's 8 warps and bf16's 4 warps a block
    assert mops.det_plan(512, 4, 16, 1, 1, 4) == (2, 384)
    assert mops.det_plan(512, 4, 16, 1, 1, 2) == (4, 384)
    assert mops.bwd_pick(4, 16, 1, 1, 4)[0] == 8 and mops.bwd_pick(4, 16, 1, 1, 2)[0] == 4
    # PRODUCTION256: 4 warps (f32), 2 (bf16); one tile -> one block; the
    # ragged 40,009 rows still fill the cap of 64
    assert mops.bwd_pick(20, 16, 2, 1, 4)[0] == 4 and mops.bwd_pick(20, 16, 2, 1, 2)[0] == 2
    assert mops.det_plan(1, 20, 16, 2, 1, 4) == (1, 896)
    assert mops.det_plan(40_009, 20, 16, 2, 1, 4)[0] == mops.DET_BLOCKS
    # the dW row: C-fragment tiles of 16 x 8 (W = 16: w_in 2 x 2, a hidden
    # layer 1 x 2, w_out 1; D_out = 3 still one n-tile)
    assert mops.det_plan(65_536, 20, 16, 1, 3, 4)[1] == (4 + 1) * 128
    assert mops.det_plan(65_536, 20, 32, 2, 1, 4)[1] == (2 * 4 + 2 * 4 + 2) * 128
    assert mops.bwd_smem_bytes(20, 16, 2, 1, 4) == mops.bwd_pick(20, 16, 2, 1, 4)[1]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_adamw_role_split_at_every_config(name):
    hc = CONFIGS[name]
    n_tab = hc.n_levels * hc.table_size * hc.n_features_per_level
    for D_out in (1, 3):
        _, n_w = _widths(hc, D_out)
        for P in (1, 8):
            for sms in (132, 114):
                chain, table, vec = fts.adamw_det_plan(P, n_tab, n_w + 1, sms, True)
                # a block per 32 columns of the group rows (the MLP and the loss)
                assert (chain - 1) * 32 < P * (n_w + 1) <= chain * 32
                assert vec == 1          # every config's tables: a multiple of 4
                units = P * n_tab // 4
                assert table == min(-(-units // 256), 16 * sms)
                # unaligned state: one entry a unit, still at most 16 blocks an SM
                _, t1, v1 = fts.adamw_det_plan(P, n_tab, n_w + 1, sms, False)
                assert v1 == 0 and t1 == min(-(-P * n_tab // 256), 16 * sms)


def test_adamw_role_split_at_production256():
    hc = dvnr.PRODUCTION256
    _, n_w = _widths(hc)
    assert n_w + 1 == 593
    # 4,744 chain columns (8 x 593) in 149 blocks of 32; 327,680 units of
    # four table entries, one a thread, in 1,280 blocks (under 16 an SM)
    assert fts.adamw_det_plan(8, 163_840, 593, 132, True) == (149, 1280, 1)
    assert fts.adamw_det_plan(8, 163_842, 593, 132, True) == (149, 2112, 0)


@pytest.mark.parametrize("name", sorted(DET_SHAPES))
def test_ordered_sum_grid_covers_every_dw_column(name):
    # mlp_dw_ordered_kernel: a block per 32 columns of a row and a
    # partition, a batch row's 64 blocks staged at once (one stage a row)
    _, E = DET_SHAPES[name]
    assert E % 128 == 0 and (E // 32) * 32 == E
    assert mops.DET_BLOCKS <= 64


def _flat(P, n_w_parts, n_tab):
    win, whid, wout = n_w_parts
    return {"tab": torch.zeros(P, n_tab), "win": torch.zeros(P, win, 1),
            "whid": torch.zeros(P, 1, whid, 1) if whid else torch.zeros(P, 1, 1, 1),
            "wout": torch.zeros(P, wout, 1)}


@pytest.mark.parametrize("n_hidden", [2, 1])
def test_det_grads_to_float_sums_in_group_order(n_hidden):
    P, groups = 2, 5
    parts = (3, 2 if n_hidden > 1 else 0, 2)
    cols = sum(parts) + 1
    flat = _flat(P, parts, 4)
    # column 0 of partition 0: another order gives other bits
    x = torch.zeros(P, groups, cols)
    x[0, :, 0] = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0])
    x[1] = torch.randn(groups, cols, generator=torch.Generator().manual_seed(0))
    q = torch.tensor([[1, -1, 2**47, -(2**47) + 3]] * P, dtype=torch.int64)
    det = fts.DetGrads(x, q.view(P, 4), torch.zeros(P, dtype=torch.int64))
    grads, loss = fts.det_grads_to_float(det, flat, n_hidden)
    want = torch.zeros(P, cols)
    for g in range(groups):                       # from 0, group after group
        want = want + x[:, g]
    assert torch.equal(grads["win"].reshape(P, -1), want[:, :3])
    off = 3
    if n_hidden > 1:
        assert torch.equal(grads["whid"].reshape(P, -1), want[:, 3:5])
        off = 5
    else:
        assert not grads["whid"].any()            # the dummy slab
    assert torch.equal(grads["wout"].reshape(P, -1), want[:, off:off + 2])
    assert torch.equal(loss, want[:, -1])
    assert float(grads["win"][0, 0, 0]) == 4.0    # ((1e8 + 1) - 1e8 + 1) + 3
    backwards = x[0, :, 0].flip(0).cumsum(0)[-1]
    assert float(backwards) != 4.0                # the reverse order: other bits
    tab = (q.double() * 2.0 ** -47).float()
    assert torch.equal(grads["tab"], tab)
    assert grads["tab"][0].tolist()[2] == 1.0


def test_measurement_entries_refuse_cpu_and_meta():
    for dev in ("cpu", "meta"):
        x = torch.zeros(2, 32, 4, device=dev)
        ws = [torch.zeros(2, 4, 16, device=dev), torch.zeros(2, 16, 1, device=dev)]
        g = torch.zeros(2, 32, 1, device=dev)
        with pytest.raises(ValueError, match="runs on the card"):
            mops.fused_mlp_bwd_det_with(x, ws, g, [0, 1])
        with pytest.raises(ValueError, match="CUDA device"):
            mops.fused_mlp_bwd_stage_cycles(x, ws, g, [0, 1], grid="det")
        flat = {"tab": torch.zeros(2, 1, 4, 1, device=dev),
                "win": torch.zeros(2, 4, 16, device=dev),
                "whid": torch.zeros(2, 1, 16, 16, device=dev),
                "wout": torch.zeros(2, 16, 1, device=dev)}
        det = fts.DetGrads(torch.zeros(2, 1, 81, device=dev),
                           torch.zeros(2, 1, 4, 1, dtype=torch.int64, device=dev),
                           torch.zeros(2, dtype=torch.int64, device=dev))
        with pytest.raises(ValueError, match="runs on the card"):
            fts.adamw_det_with(flat, flat, flat, det, torch.zeros(2, 4), n_valid=1,
                               beta1=0.9, beta2=0.99, eps=1e-15, weight_decay=0.0,
                               n_hidden=1)
    with pytest.raises(ValueError, match="design"):
        mops.fused_mlp_bwd_det_with(x, ws, g, [0, 1], design="tree")
    with pytest.raises(ValueError, match="grid"):
        mops.fused_mlp_bwd_stage_cycles(x, ws, g, [0, 1], grid="wave")
    with pytest.raises(ValueError, match="design"):
        fts.adamw_det_with(flat, flat, flat, det, torch.zeros(2, 4), design="tree")


def test_launch_plans_name_the_route_s_ordered_sum():
    x, g = torch.zeros(2, 64, 20), torch.zeros(2, 64, 1)
    ws = [torch.zeros(2, 20, 16), torch.zeros(2, 16, 16), torch.zeros(2, 16, 1)]
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        plan = mops.bwd_launch_plan(x, ws, g)
    finally:
        torch.use_deterministic_algorithms(before)
    body = ("fused_mlp_bwd_kernel", mops.bwd_smem_bytes(20, 16, 2, 1, 4))
    assert plan == [body, ("mlp_dw_ordered_kernel", 0)]
    assert mops.bwd_launch_plan(x, ws, g) == [body]


@pytest.mark.parametrize("kernel,family", [
    ("adamw_det_kernel<false, true>", "adamw_det_kernel"),
    ("_ZN40_GLOBAL__N__63c7ab2e_8_adamw_cu_b6f47a3016adamw_det_kernelILb1ELb0EEEvNS_6GroupsE",
     "adamw_det_kernel"),
    ("adamw_kernel<true, true>", "adamw_kernel"),
    ("fused_mlp_bwd_kernel<float, 16, repro::mma::NoClock>", "fused_mlp_bwd_kernel"),
    ("_ZN45_GLOBAL__N__f07fbc0c_12_fused_mlp_cu_d870bfbd21mlp_dw_ordered_kernelEPKfPKiPf",
     "mlp_dw_ordered_kernel"),
    ("mlp_dw_reduce_kernel", "mlp_dw_reduce_kernel")])
def test_budgets_hold_the_sums_kernels(kernel, family):
    assert budgets.family_of(kernel) == family
    b = budgets.KERNEL_BUDGETS[family]
    assert b.stack_bytes == 0
    # the staged rows: adamw_det_kernel's 128 x 32 floats, the MLP sum's
    # 64 x 32; the yardsticks stage none
    staged = {"adamw_det_kernel": 128 * 32 * 4, "mlp_dw_ordered_kernel": 64 * 32 * 4}
    if family in staged or family in ("adamw_kernel", "mlp_dw_reduce_kernel"):
        assert (b.registers, b.smem_bytes) == (64, staged.get(family, 0))
