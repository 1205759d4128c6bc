"""The INR inference kernel's shape rules on the CPU (repro_torch.kernels.
inr_forward): fwd_plan's letters and fwd_layout's block at the configs'
widths, refusal at every shape the kernel takes, and the kernel's budget
entry. Shape arithmetic only: no kernel runs here (chip_smoke.py phase 1
holds fwd_layout against the library's own plan_layout, phase 2 the kernel
against its plain version at these shapes). Operands live on the meta
device, so a table of 2^32 - 1 rows costs nothing; the file takes well
under a second."""
import pytest
import torch

from repro_torch.configs import dvnr
from repro_torch.kernels import budgets
from repro_torch.kernels.fused_mlp.ops import SMEM_LIMIT, mma_smem_bytes
from repro_torch.kernels.inr_forward import ops as iops

CONFIGS = {"PRODUCTION256": dvnr.PRODUCTION256, "PRODUCTION": dvnr.PRODUCTION,
           "ABLATION": dvnr.ABLATION, "SMOKE": dvnr.SMOKE}
#: the rule's letters at each config's widths, float32 then bf16
PLANS = {"PRODUCTION256": ("sssdd", "sssss"), "PRODUCTION": ("ssddd", "ssddd"),
         "ABLATION": ("d" * 10, "ss" + "d" * 8), "SMOKE": ("ss", "ss")}


def _layout(hc, itemsize, plan=None):
    return iops.fwd_layout(hc.level_resolutions(), hc.table_size,
                           hc.n_features_per_level, hc.n_neurons,
                           hc.n_hidden_layers, itemsize, plan)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fwd_plan_letters_at_the_configs(name, itemsize):
    hc = CONFIGS[name]
    lay = _layout(hc, itemsize)
    assert lay["plan"] == PLANS[name][itemsize == 2]
    assert lay["threads"] == iops.block_threads(hc.n_neurons, hc.n_features_per_level,
                                                itemsize)
    assert lay["warps"] == lay["threads"] // 32 and lay["bytes"] <= SMEM_LIMIT


def test_fwd_plan_keeps_the_l1_unless_every_level_is_staged():
    """Staged levels stay within 195 KiB of shared memory (the 196 KiB
    carve-out, 60 KiB of L1) while some level is left in device memory:
    ABLATION's bf16 block (weights and 16 tiles, 118,032 bytes) stages its
    first two levels (2,000 + 11,664 bytes) but not the third (78,608),
    which would fit the 227 KB but take the 228 KiB carve-out; its f32
    block (200,976 bytes) is past the limit already and stages none.
    Where every level fits, they are all staged beyond it: PRODUCTION256
    under bf16 asks for 228,448 bytes."""
    hc = dvnr.ABLATION
    bf16, f32 = _layout(hc, 2), _layout(hc, 4)
    assert _layout(hc, 2, "d" * 10)["bytes"] == 118_032
    assert bf16["bytes"] == 118_032 + 2_000 + 11_664 <= iops.SMEM_KEEP_L1 == 195 * 1024
    assert 118_032 + 2_000 + 11_664 + 78_608 > iops.SMEM_KEEP_L1
    assert _layout(hc, 2, "sss" + "d" * 7)["warps"] == 16   # it would fit the 227 KB
    assert f32["bytes"] == 200_976 > iops.SMEM_KEEP_L1 and f32["plan"] == "d" * 10
    full = _layout(dvnr.PRODUCTION256, 2)
    assert full["plan"] == "sssss" and full["bytes"] == 228_448 > iops.SMEM_KEEP_L1
    assert _layout(dvnr.PRODUCTION256, 4)["bytes"] == 196_992 <= iops.SMEM_KEEP_L1


def test_fwd_plan_stages_levels_in_order_while_they_fit():
    """PRODUCTION256's bf16 rows take 177,232 bytes (each level rounded up
    to 16): one byte less of budget leaves the last hashed level direct,
    and so do f32's 223,344 bytes of four levels. A level that does not fit
    is skipped and a later one may still be staged (16,000 bytes of 1,000
    dense rows, 65,536 of a hashed level, 432 of 27 dense rows). A table
    whose level stride is not a multiple of 16 bytes is never staged,
    forced or not."""
    res = dvnr.PRODUCTION256.level_resolutions()
    assert iops.fwd_plan(res, 8192, 4, 2, 177_232) == "sssss"
    assert iops.fwd_plan(res, 8192, 4, 2, 177_231) == "ssssd"
    assert iops.fwd_plan(res, 8192, 4, 4, 223_344) == "ssssd"
    assert iops.fwd_plan(res, 8192, 4, 4, 92_271) == "ssddd"
    assert iops.fwd_plan([9, 30, 2], 4096, 4, 4, 17_000) == "sds"
    assert iops.fwd_plan([2, 3], 3001, 1, 4, 10 ** 9) == "dd"
    assert iops.fwd_layout([2, 3], 3001, 1, 16, 2, 4, "ss")["plan"] == "dd"


def test_forced_plans_trade_warps_for_staged_rows():
    """Forced plans at PRODUCTION256: f32 with two levels staged (2,000 +
    11,664 bytes of rows) keeps all 32 warps; with the first hashed level
    staged beside them (+131,072) 26 (their 3,072-byte tiles in what is
    left); with the three dense levels and a hashed one, or every level, no
    warp fits (the measurement entry refuses the plan)."""
    hc = dvnr.PRODUCTION256
    mixed = _layout(hc, 4, "ssddd")
    assert (mixed["plan"], mixed["warps"]) == ("ssddd", 32)
    assert mixed["bytes"] == _layout(hc, 4, "ddddd")["bytes"] + 2000 + 11664
    fixed = 12 * 512 + 256 + 16
    assert _layout(hc, 4, "ssdsd")["warps"] == \
        (SMEM_LIMIT - fixed - 2000 - 11664 - 131_072) // 3072 == 26
    assert _layout(hc, 4, "ssssd")["warps"] == _layout(hc, 4, "sssss")["warps"] == 0
    assert _layout(hc, 2, "ddddd")["warps"] == 32


# shapes the kernel takes: every F and W at PRODUCTION256's levels, the
# configs, 32 levels, 8 outputs, 65,535 batch rows, T = 2^32 - 1; (L, F, T,
# W, H, D_out, B)
TAKEN = ([(5, F, 1 << 13, W, 2, 1, 16) for F in (1, 2, 4, 8) for W in (16, 32, 64)]
         + [(5, 4, 1 << 16, 16, 2, 1, 16), (10, 8, 1 << 19, 64, 3, 1, 3),
            (32, 1, 1 << 10, 16, 2, 2, 2), (32, 8, 1 << 10, 16, 2, 8, 2),
            (5, 4, 1 << 13, 16, 2, 8, 65_535), (5, 4, (1 << 32) - 1, 16, 2, 1, 1),
            (6, 8, 1 << 12, 16, 3, 1, 3), (16, 2, 1 << 14, 32, 1, 8, 2)])


def _meta(L, F, T, W, H, D_out, B, dtype):
    dims = [L * F] + [W] * H + [D_out]
    coords = torch.empty((B, 3, 3), device="meta")
    tables = torch.empty((1, L, T, F), dtype=dtype, device="meta")
    weights = [torch.empty((1, a, b), dtype=dtype, device="meta")
               for a, b in zip(dims[:-1], dims[1:])]
    return coords, tables, weights


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TAKEN)
def test_refusal_takes_every_shape_the_kernel_takes(shape, dtype):
    assert iops.refusal(*_meta(*shape, dtype)) is None


@pytest.mark.parametrize("shape,match", [
    ((33, 1, 64, 16, 2, 1, 2), "L=33"), ((5, 3, 64, 16, 2, 1, 2), "F=3"),
    ((5, 4, 64, 8, 2, 1, 2), "W=8"), ((5, 4, 64, 16, 2, 9, 2), "D_out=9"),
    ((5, 4, 64, 16, 2, 1, 65_536), "B=65536"), ((5, 4, 1 << 32, 16, 2, 1, 1), "T=4294967296"),
    ((32, 8, 64, 64, 3, 1, 2), "shared memory")])
def test_refusal_refuses_what_the_kernel_does_not_take(shape, match):
    bad = iops.refusal(*_meta(*shape, torch.float32))
    assert bad is not None and bad[0] is ValueError and match in bad[1]


def test_the_kernel_refuses_no_shape_the_grid_stride_design_took():
    """The grid-stride design took a shape when the weights' fragments, the
    resolutions and one 32-row tile fit the 227 KB; the kernel when they,
    the level offsets, the tables' barrier and one warp's tile do. Over
    every L, F, W, dtype and H up to 6 the two rules agree."""
    differ = []
    for itemsize in (4, 2):
        for W in (16, 32, 64):
            for H in (1, 2, 3, 4, 6):
                for F in (1, 2, 4, 8):
                    for L in range(1, 33):
                        old = mma_smem_bytes(L * F, W, H, itemsize, 1) + 128 <= SMEM_LIMIT
                        new = iops.fwd_layout([0] * L, 64, F, W, H, itemsize,
                                              "d" * L)["warps"] >= 1
                        if old != new:
                            differ.append((itemsize, W, H, F, L))
    assert differ == []


def test_kernel_budget_holds_the_kernel():
    """The kernel's budget family by its profiler name (the yardstick's
    name is not in it: no program launches it); the register budget is
    the largest a thread of its blocks may take (256 threads at W = 64 under
    float32: the ISA's 255); a launch asks for its layout's bytes, within
    the 227 KB."""
    fam = budgets.family_of
    assert fam("void repro::inr::inr_forward_kernel<float, 16, 4, "
               "repro::inr::InrNoClock>(float const*)") == "inr_forward_kernel"
    assert fam("void repro::inr::inr_forward_grid_kernel<float, 16, 4, "
               "repro::inr::InrNoClock>(float const*)") is None
    threads = {iops.block_threads(W, F, isz) for W in (16, 32, 64) for F in (1, 2, 4, 8)
               for isz in (2, 4)}
    assert budgets.KERNEL_BUDGETS["inr_forward_kernel"].registers == \
        max(min(255, 65536 // t // 8 * 8) for t in threads) == 255
    coords, tables, weights = _meta(5, 4, 1 << 13, 16, 2, 1, 16, torch.float32)
    res = dvnr.PRODUCTION256.level_resolutions()
    assert iops.launch_plan(tables, weights, res) == [("inr_forward_kernel", 196_992)]
    assert budgets.KERNEL_BUDGETS["inr_forward_kernel"].smem_bytes >= SMEM_LIMIT


def test_measurement_entries_run_on_the_card_only():
    coords = torch.rand((2, 3, 3))
    tables = torch.rand((1, 5, 64, 4))
    weights = [torch.rand((1, a, b)) for a, b in ((20, 16), (16, 16), (16, 1))]
    with pytest.raises(ValueError, match="on the card"):
        iops.inr_forward_with(coords, tables, weights, [0, 0], [2] * 5)
    assert len(iops.INR_STAGES) == 5 and set(iops.DESIGNS) == {"persistent", "grid"}
    assert iops.GRID_WIDTHS == ((16, 4), (64, 8))
