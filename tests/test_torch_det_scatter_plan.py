"""The deterministic route's scatter plan on the CPU
(repro_torch.kernels.hash_encoding.ops.fx_plan, the mirror of
csrc/hash_encode.cu's fx_level_plan): its letters and cluster sizes at the
configs' widths and at every F, the shared bytes a block asks for, the grid
as a function of N and the level's rows alone, the launch plans the static
checks read, and the refusals. Shape arithmetic only: no kernel runs here
and JAX is not imported (chip_smoke.py phase 1 holds this mirror against
the library's own plan, phase 2 the kernels against their yardstick bit for
bit). Operands of the refusals live on the meta device."""
import pytest
import torch

from repro_torch.configs import dvnr
from repro_torch.kernels import budgets
from repro_torch.kernels.fused_train_step import ops as fts
from repro_torch.kernels.hash_encoding import ops as hops

CONFIGS = {"PRODUCTION256": dvnr.PRODUCTION256, "PRODUCTION": dvnr.PRODUCTION,
           "ABLATION": dvnr.ABLATION, "SMOKE": dvnr.SMOKE}
#: the rule's letters (a cluster's size after its 'c') at F = 1, 2, 4, 8
PLANS = {
    "PRODUCTION256": ("sssss", "sssss", "sssc2c2", "ssc2c4c4"),
    "PRODUCTION": ("ssc2c4c4", "ssc4c8c8", "ssc8dd", "sc2ddd"),
    "ABLATION": ("sssc2" + "d" * 6, "sssc4" + "d" * 6, "sssc8" + "d" * 6,
                 "ssc2" + "d" * 7),
    "SMOKE": ("ss", "ss", "ss", "ss"),
}
FS = (1, 2, 4, 8)


def _plan(name, F, force=None):
    hc = CONFIGS[name]
    return hops.fx_plan(hc.level_resolutions(), hc.table_size, F, force)


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fx_plan_letters_at_the_configs(name, F):
    assert hops.fx_letters(_plan(name, F)) == PLANS[name][FS.index(F)]


def test_production256_stages_dense_levels_and_clusters_the_hashed_ones():
    """PRODUCTION256 at F = 4: three dense levels of 125, 729 and 4,913
    rows in one block each (4,000, 23,328 and 157,216 bytes), the two
    hashed levels of 8,192 rows (262,144 bytes, past a block's 227 KB)
    across a cluster of two blocks of 4,096 rows each; PRODUCTION's 2 MiB
    hashed levels stay direct (no cluster of 8 holds them)."""
    plan = _plan("PRODUCTION256", 4)
    assert [p.rows for p in plan] == [125, 729, 4913, 8192, 8192]
    assert [p.smem for p in plan] == [4000, 23328, 157216, 131072, 131072]
    assert [(p.site, p.cluster, p.span) for p in plan[3:]] == [("c", 2, 4096)] * 2
    assert 8192 * 4 * 8 > budgets.H100_SMEM_OPTIN
    prod = _plan("PRODUCTION", 4)
    assert [p.site for p in prod[3:]] == ["d", "d"]
    assert prod[3].rows * 4 * 8 // 8 > hops.FX_STAGE_BUDGET


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fx_plan_shared_bytes_and_clusters(name, F):
    for p in _plan(name, F):
        assert p.smem <= hops.FX_STAGE_BUDGET <= budgets.H100_SMEM_OPTIN
        assert p.smem <= budgets.KERNEL_BUDGETS["hash_encode_bwd_fx_kernel"].smem_bytes
        if p.site == "d":
            assert (p.cluster, p.span, p.smem) == (1, 0, 0)
            assert p.points == p.threads == hops.FX_DIRECT_THREADS
            continue
        assert p.threads == hops.FX_SLAB_THREADS and p.smem == p.span * F * 8
        assert p.points % 32 == 0 and 1024 <= p.points <= 4096
        assert p.points >= min(p.span, 4096)
        if p.site == "s":
            assert (p.cluster, p.span) == (1, p.rows)
        else:
            # the fewest blocks whose shares fit, each row owned by one block
            assert p.cluster in hops.FX_CLUSTERS
            assert p.span * p.cluster >= p.rows > p.span * (p.cluster - 1)
            smaller = [c for c in (1,) + hops.FX_CLUSTERS if c < p.cluster]
            assert all(-(-p.rows // c) * F * 8 > hops.FX_STAGE_BUDGET for c in smaller)


@pytest.mark.parametrize("N", [1, 31, 1024, 4097, 40_009, 65_536, 100_003])
@pytest.mark.parametrize("force", [None, "d", "s", ("c", 2), ("c", 4), ("c", 8)])
def test_fx_grid_depends_on_n_and_rows_alone(force, N):
    """A level's plan is a function of its rows and F (two (res, T) pairs
    with the same rows plan alike), so its grid is a function of N and the
    rows: a multiple of the cluster, covering N points with at most one
    cluster's worth of padding."""
    for res, T, twin in ((4, 1 << 13, (4, 1 << 20)), (64, 1 << 13, (100, 1 << 13)),
                         (16, 1 << 13, (16, 1 << 19))):
        assert hops.level_rows(*twin) == hops.level_rows(res, T)
        a = hops.fx_level(res, T, 4, force)
        b = hops.fx_level(twin[0], twin[1], 4, force)
        assert a == b
        gx = a.grid_x(N)
        assert gx % a.cluster == 0
        assert gx * a.points >= N > (gx - a.cluster) * a.points


@pytest.mark.parametrize("force", [("c", 3), ("c", 16), "x", ("s", 2, 1)])
def test_fx_level_refuses_what_is_no_plan(force):
    with pytest.raises((ValueError, TypeError)):
        hops.fx_level(16, 1 << 13, 4, force)


def test_fx_force_arg_codes():
    arg = hops.fx_force_arg([None, "s", "d", ("c", 4)], 4)
    assert list(arg) == [0, ord("s"), ord("d"), ord("c") + 256 * 4]
    assert hops.fx_force_arg(None, 3) is None
    with pytest.raises(ValueError, match="forced letters"):
        hops.fx_force_arg(["s"], 2)


def test_launch_plans_on_the_deterministic_route():
    """What the static checks read: one scatter launch a level with its
    slab's bytes, then the conversion; the train step's split adds the
    scatter after its kernel. The default route's plans are as before."""
    hc = dvnr.PRODUCTION256
    res, T, F, L = hc.level_resolutions(), hc.table_size, 4, hc.n_levels
    shape = (8, L, T, F)
    default = hops.bwd_launch_plan(res, shape)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = hops.bwd_launch_plan(res, shape)
        flat = {"tab": torch.empty(shape, device="meta"),
                "win": torch.empty((8, L * F, 16), device="meta"),
                "whid": torch.empty((8, 1, 16, 16), device="meta"),
                "wout": torch.empty((8, 16, 1), device="meta")}
        step = fts.step_launch_plan(flat, 2, res)
    finally:
        torch.use_deterministic_algorithms(before)
    assert default == [("hash_encode_bwd_kernel", 8192 * F * 4)]
    assert det == [("hash_encode_bwd_fx_kernel", b)
                   for b in (4000, 23328, 157216, 131072, 131072)] + \
        [("fx_to_float_kernel", 0)]
    assert step[0][0] == "train_step_kernel" and step[1:] == det[:-1]
    assert fts.step_launch_plan(flat, 2, res) == step[:1]
    for fam, smem in det + step:
        assert smem <= budgets.KERNEL_BUDGETS[fam].smem_bytes


def test_measurement_entries_refuse_the_meta_device():
    """The yardstick and clock entries run on the card only and refuse a
    design they do not have."""
    hc = dvnr.PRODUCTION256
    res, L = hc.level_resolutions(), hc.n_levels
    g = torch.empty((2, 64, L * 4), device="meta")
    coords = torch.empty((2, 64, 3), device="meta")
    with pytest.raises(ValueError, match="on the card"):
        hops.hash_encode_bwd_fx_with(g, coords, res, [0, 1], (2, L, 1 << 13, 4))
    flat = {"tab": torch.empty((2, L, 1 << 13, 4), device="meta"),
            "win": torch.empty((2, L * 4, 16), device="meta"),
            "whid": torch.empty((2, 1, 16, 16), device="meta"),
            "wout": torch.empty((2, 16, 1), device="meta")}
    with pytest.raises(ValueError, match="on the card"):
        fts.train_step_det_with(flat, 2, res, coords=coords,
                                target=torch.empty((2, 64, 1), device="meta"))
    with pytest.raises(ValueError, match="design"):
        fts.train_step_det_with(flat, 2, res, design="other")


def test_budget_entries_hold_the_new_kernels():
    for fam in ("hash_encode_bwd_fx_kernel", "hash_encode_bwd_fx_block_kernel"):
        b = budgets.KERNEL_BUDGETS[fam]
        assert b.smem_bytes >= hops.FX_STAGE_BUDGET and b.registers == 64
    assert budgets.family_of("_Z25hash_encode_bwd_fx_kernelIfLi4ELc99EEvPKT_") == \
        "hash_encode_bwd_fx_kernel"
    assert budgets.family_of("hash_encode_bwd_fx_block_kernel<float, 4, true>") == \
        "hash_encode_bwd_fx_block_kernel"
    assert budgets.family_of("train_step_det_fused_kernel<float, true>") == \
        "train_step_det_fused_kernel"
