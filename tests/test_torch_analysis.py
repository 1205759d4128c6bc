"""repro_torch.analysis against repro.analysis: the three shared checks
give the same status (pass / skip / fail) on every standard program of the
``smoke`` and ``quickstart`` configs, the JAX ``ref`` and ``pallas`` legs
against the port's ``ref`` and ``cuda`` (the kernel wrappers' plain
versions, on the CPU); controls that must fail in both packages; the
trainer's ``static_checks`` modes; the CLI's exit codes; the CPU side of
``kernel_budget``; and a captured run that gives a plain run's bits.

JAX's ``zero_collectives`` reads the compiled HLO (level ``hlo``), so its
status is taken at that level; the port reads the dispatcher at
``trace``."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import analysis as jan
from repro_torch import analysis as tan
from repro_torch.analysis import programs as tprog
from repro_torch.configs import dvnr
from repro_torch.core.trainer import DVNRTrainer
from repro_torch.kernels import budgets
from repro_torch.kernels.hash_encoding import ops as hops

SHARED = ("zero_collectives", "precision_flow", "rng_gather_placement")
LEGS = (("ref", "ref"), ("pallas", "cuda"))
PROGRAMS = ("train_step", "train_chunk", "train_chunk_degraded", "render",
            "render_cached", "serving_tick")


@functools.lru_cache(maxsize=None)
def _jax_statuses(config, leg):
    cfg, shape = jan.get_config(config)
    out = {}
    for p, ctx in jan.config_programs(cfg, shape, backend=leg):
        rep = jan.run_checks(p, ctx, checks=list(SHARED[1:]), max_level="jaxpr")
        zc = jan.run_checks(p, ctx, checks=["zero_collectives"])
        out[p.name.split("[")[0]] = {r.name: r.status
                                     for r in zc.results + rep.results}
    return out


@functools.lru_cache(maxsize=None)
def _port_statuses(config, leg):
    reports = tan.analyze_config(config, backend=leg, device="cpu",
                                 checks=list(SHARED), max_level="trace")
    return {r.program.split("[")[0]: {x.name: x.status for x in r.results}
            for r in reports}


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("legs", LEGS, ids=lambda l: f"{l[0]}-{l[1]}")
@pytest.mark.parametrize("config", ["smoke", "quickstart"])
def test_check_statuses_equal_jax(config, legs, program):
    want = _jax_statuses(config, legs[0])[program]
    got = _port_statuses(config, legs[1])[program]
    assert got == want
    assert "FAIL" not in got.values()


# --------------------------------------------------------------------------- #
# controls that must fail in both packages
# --------------------------------------------------------------------------- #
@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_control(kind):
    if kind == "collective":
        from jax.sharding import Mesh, PartitionSpec as P
        shard_map = getattr(jax, "shard_map", None)
        if shard_map is None:              # jax before 0.8
            from jax.experimental.shard_map import shard_map

        mesh = Mesh(np.asarray(jax.devices()[:1]), ("x",))
        fn = jax.jit(shard_map(lambda v: jax.lax.psum(v, "x"), mesh=mesh,
                               in_specs=P("x"), out_specs=P()))
        return lambda: jan.assert_clean(fn, jnp.ones((4,)),
                                        checks=["zero_collectives"])
    if kind == "f32_product":
        return lambda: jan.assert_clean(lambda x, w: x @ w, jnp.ones((8, 8)),
                                        jnp.ones((8, 8)),
                                        checks=["precision_flow"],
                                        precision="bf16")
    return lambda: jan.assert_clean(lambda k: jax.random.uniform(k, (8,)),
                                    jax.random.PRNGKey(0),
                                    checks=["rng_gather_placement"],
                                    fuse_sampling=True)


def _port_chunk_with(kind):
    """A SMOKE chunk on the cuda backend's plain versions with one planted
    violation after it: an all-reduce of the loss trace (a one-rank gloo
    group), an f32 product under the bf16 policy, or a host RNG draw."""
    cfg = dvnr.SMOKE.replace(precision="bf16" if kind == "f32_product" else "f32")
    trainer = tprog.build_trainer(cfg, backend="cuda", local_shape=(8, 8, 8),
                                  device="cpu")
    prog = tprog.train_chunk_program(trainer)
    inner = prog.fn

    def fn(state, vols):
        out = inner(state, vols)
        if kind == "collective":
            dist.all_reduce(out[1].clone())
        elif kind == "f32_product":
            torch.ones(4, 4) @ torch.ones(4, 4)
        elif kind == "rng":
            torch.rand(8)
        return out

    prog.fn = fn
    return prog, tprog.train_context(trainer)


@pytest.mark.parametrize("kind,check", [("collective", "zero_collectives"),
                                        ("f32_product", "precision_flow"),
                                        ("rng", "rng_gather_placement")])
def test_controls_fail_in_both_packages(kind, check, one_rank_group):
    with pytest.raises(jan.StaticCheckError):
        _jax_control(kind)()
    prog, ctx = _port_chunk_with(kind)
    rep = tan.run_checks(prog, ctx, checks=[check])
    assert rep.result(check).status == "FAIL", rep.render()
    # and the same chunk without the plant passes
    clean, ctx = _port_chunk_with("none")
    assert tan.run_checks(clean, ctx, checks=[check]).result(check).status == "PASS"


def test_precision_flow_master_shadow_rule():
    x = torch.ones(4, 4, dtype=torch.bfloat16)
    with pytest.raises(tan.StaticCheckError, match="master"):
        tan.assert_clean(lambda w: w @ w, x, checks=["precision_flow"],
                         precision="bf16")
    rep = tan.assert_clean(lambda w: (w @ w, (w @ w).float()), x,
                           checks=["precision_flow"], precision="bf16")
    assert rep.result("precision_flow").details["n_products"] == 2
    skip = tan.assert_clean(lambda w: w @ w, x, checks=["precision_flow"])
    assert skip.result("precision_flow").skipped


# --------------------------------------------------------------------------- #
# the trainer's static_checks
# --------------------------------------------------------------------------- #
def _planted(kind):
    """A ``DVNRTrainer._mask_convergence`` that also plants ``kind``."""
    orig = DVNRTrainer._mask_convergence

    def mask(self, loss, loss_ma, active):
        if kind == "collective":
            dist.all_reduce(loss.clone())
        elif kind == "f32_product":
            torch.ones(4, 4) @ torch.ones(4, 4)
        else:
            torch.rand(1)
        return orig(self, loss, loss_ma, active)

    return mask


def test_static_checks_error_mode_passes_on_clean_config():
    cfg = dvnr.SMOKE.replace(static_checks="error")
    for impl in ("ref", "cuda"):
        tr = DVNRTrainer(cfg, 2, impl=impl, device="cpu",
                         volume_shape=(12, 12, 12))
        rep = tr.run_static_checks(strict=True)
        assert rep.passed
        assert rep.result("kernel_budget").skipped       # a trace-level run


@pytest.mark.parametrize("kind", ["collective", "f32_product", "rng"])
def test_static_checks_error_mode_raises_on_each_control(kind, one_rank_group,
                                                         monkeypatch):
    cfg = dvnr.SMOKE.replace(static_checks="error",
                             precision="bf16" if kind == "f32_product" else "f32")
    monkeypatch.setattr(DVNRTrainer, "_mask_convergence", _planted(kind))
    with pytest.raises(tan.StaticCheckError):
        DVNRTrainer(cfg, 2, impl="cuda", device="cpu", volume_shape=(12, 12, 12))


def test_static_checks_warn_mode_warns_and_builds(monkeypatch):
    cfg = dvnr.SMOKE.replace(static_checks="warn")
    monkeypatch.setattr(DVNRTrainer, "_mask_convergence", _planted("rng"))
    with pytest.warns(UserWarning, match="static checks failed"):
        tr = DVNRTrainer(cfg, 2, impl="cuda", device="cpu",
                         volume_shape=(12, 12, 12))
    assert tr is not None
    assert not tr.run_static_checks(strict=False).passed


def test_api_train_declares_the_volume_shape():
    from repro_torch import api
    from repro_torch.data.volume import make_partition

    parts = [make_partition("cloverleaf", p, (1, 1, 2), (6, 6, 6), 0.3,
                            device="cpu") for p in range(2)]
    _, info = api.train(parts, dvnr.SMOKE.replace(static_checks="error"),
                        backend="cuda", steps=2, key=0)
    assert info["trainer"].volume_shape == (8, 8, 8)


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #
def test_cli_exit_codes(capsys, monkeypatch):
    from repro_torch.analysis.__main__ import main

    assert main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for name in tan.available_checks():
        assert name in out
    assert main(["--config", "nope"]) == 2
    assert main(["--config", "smoke", "--checks", "vmem_budget"]) == 2
    assert main(["lock", "verify"]) == 2
    assert main(["--config", "smoke", "--backend", "ref,cuda", "--device",
                 "cpu", "--max-level", "trace"]) == 0
    assert "static analysis: PASS" in capsys.readouterr().out
    monkeypatch.setattr(DVNRTrainer, "_mask_convergence", _planted("rng"))
    assert main(["--config", "smoke", "--backend", "cuda", "--device", "cpu",
                 "--checks", "rng_gather_placement"]) == 1
    assert "static analysis: FAIL" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# kernel_budget on the CPU
# --------------------------------------------------------------------------- #
def test_kernel_budget_cpu_side_skips_with_the_plans_checked():
    reps = tan.analyze_config("smoke", backend="cuda", device="cpu",
                              checks=["kernel_budget"])
    for rep in reps:
        res = rep.result("kernel_budget")
        assert res.skipped and "need the card" in res.skip_reason
        assert res.details["n_plans"] > 0
    # the ref backend launches nothing
    ref = tan.analyze_config("smoke", backend="ref", device="cpu",
                             checks=["kernel_budget"])
    assert all(r.result("kernel_budget").details["n_plans"] == 0 for r in ref)


def test_kernel_budget_flags_a_slab_over_the_limit(monkeypatch):
    """A staged hash-backward level whose slab (8,192 rows x 8 features x
    4 B = 262,144 B) is past the 200 KiB budget and the H100's 232,448 B,
    as a wrapper with a larger staging budget would request it."""
    monkeypatch.setattr(hops, "STAGE_BUDGET_BYTES", 300 * 1024)
    g = torch.zeros((1, 64, 8))
    coords = torch.rand((1, 64, 3), generator=torch.Generator().manual_seed(0))
    prog = tan.capture(hops.hash_encode_bwd_cuda, g, coords, [31], [0],
                       (1, 1, 8192, 8))
    res = tan.run_checks(prog, checks=["kernel_budget"]).result("kernel_budget")
    assert res.status == "FAIL"
    assert "262144" in str(res.violations[0])
    # at the default staging budget the same level goes direct: no slab
    monkeypatch.setattr(hops, "STAGE_BUDGET_BYTES", 200 * 1024)
    prog = tan.capture(hops.hash_encode_bwd_cuda, g, coords, [31], [0],
                       (1, 1, 8192, 8))
    assert tan.run_checks(prog, checks=["kernel_budget"]) \
        .result("kernel_budget").skipped
    # a card with less shared memory than the train step plans
    trainer = tprog.build_trainer(dvnr.SMOKE, backend="cuda",
                                  local_shape=(8, 8, 8), device="cpu")
    ctx = dataclasses.replace(tprog.train_context(trainer), smem_limit_bytes=4096)
    res = tan.run_checks(tprog.train_chunk_program(trainer), ctx,
                         checks=["kernel_budget"]).result("kernel_budget")
    assert res.status == "FAIL" and "train_step_kernel" in str(res.violations[0])


def test_budgets_cover_every_planned_kernel():
    reps = tan.analyze_config("quickstart", backend="cuda", device="cpu",
                              checks=["kernel_budget"])
    assert all(not r.result("kernel_budget").violations for r in reps)
    assert budgets.family_of("_ZN5repro17train_step_kernelIfLi16ELi4ELb1ELb0EEEvNS_8StepArgsE") \
        == "train_step_kernel"
    assert budgets.family_of("flash_attention_kernel_bf16_wgmmaILi128ELb1E") == \
        "flash_attention_kernel_bf16_wgmma"
    assert budgets.family_of("cublas_gemm") is None


# --------------------------------------------------------------------------- #
# capture does not change the program
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_captured_run_is_a_plain_run_bit_for_bit(backend):
    from repro_torch.optim.adamw import tree_leaves

    trainer = tprog.build_trainer(dvnr.SMOKE, backend=backend,
                                  local_shape=(8, 8, 8), device="cpu")
    vols = tprog._placeholder_volumes(trainer)
    plain, plain_trace = trainer.train_chunk(trainer.init(0), vols, 3, key=5)
    prog = tan.capture(lambda s, v: trainer.train_chunk(s, v, 3, key=5),
                       trainer.init(0), vols)
    got, got_trace = prog.outputs
    assert len(prog.ops) > 0 and len(prog.kernels) == (6 if backend == "cuda" else 0)
    assert torch.equal(plain_trace, got_trace)
    for a, b in zip(tree_leaves((plain.params, plain.opt, plain.loss_ma)),
                    tree_leaves((got.params, got.opt, got.loss_ma))):
        assert torch.equal(a, b)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rprog, _ = tprog.render_program(dvnr.SMOKE, backend=backend, device="cpu")
        assert torch.equal(rprog.outputs, rprog.fn(*rprog.args))
