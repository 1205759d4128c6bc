"""The port's named static checks, and ``run_checks`` / ``assert_clean``.

Each check reads the artifacts of :mod:`repro_torch.analysis.ir`: the ops a
run of the program dispatched, its kernel regions, and (on the card) the
kernels it launched. The JAX package's checks of the same names read
jaxprs and compiled HLO (``repro.analysis.checks``); their TPU-only checks
(``vmem_budget``, ``grid_write_safety``, ``hbm_traffic``, ``donation``)
have no counterpart here, and ``kernel_budget`` takes ``vmem_budget``'s
place:

- ``zero_collectives``  the paper's headline claim: the program issues no
                        ``c10d`` / ``_c10d_functional`` operation;
- ``precision_flow``    the declared :class:`~repro_torch.precision.Precision`
                        holds: every floating product outside a kernel, and
                        every kernel region's products, run on the compute
                        dtype; under a mixed policy every narrow parameter
                        output has a master-dtype shadow;
- ``rng_gather_placement`` with in-op sampling, no torch RNG operation
                        outside a kernel region, and on the ``cuda``
                        backend no gather of the volume outside the fused
                        step's region (and at least one such region);
- ``kernel_budget``     each launched CUDA kernel within its declared
                        register, local-memory and shared-memory budget
                        (:mod:`repro_torch.kernels.budgets`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.analysis.ir import ProgramArtifacts, capture
from repro_torch.analysis.registry import available_checks, get_check, register_check
from repro_torch.analysis.report import (CheckResult, Report, StaticCheckError,
                                         Violation)
from repro_torch.kernels import budgets as _budgets
from repro_torch.parallel.collectives import COLLECTIVE_NAMESPACES
from repro_torch.precision import torch_dtype


@dataclass
class CheckContext:
    """What the checks know of a program besides its run. An unset field
    makes the checks that need it SKIP, with the reason (``precision=None``
    skips ``precision_flow``, ``fuse_sampling=False`` skips
    ``rng_gather_placement``)."""

    precision: Optional[object] = None        # repro_torch.precision.Precision
    fuse_sampling: bool = False               # in-op sampling expected?
    expect_kernels: bool = False              # the fused step's region expected
    expect_master_state: Optional[bool] = None  # None -> precision.needs_master
    smem_limit_bytes: int = _budgets.H100_SMEM_OPTIN


# --------------------------------------------------------------------------- #
# (1) zero collectives
# --------------------------------------------------------------------------- #
@register_check(
    "zero_collectives", level="trace",
    description="the program issues no c10d / _c10d_functional operation "
                "(the paper's zero communication)")
def check_zero_collectives(program: ProgramArtifacts,
                           ctx: CheckContext) -> CheckResult:
    violations = [Violation("zero_collectives",
                            f"communication op {s.name!r} in the program",
                            s.region or "<top>")
                  for s in program.ops if s.namespace in COLLECTIVE_NAMESPACES]
    n = len(program.ops)
    return CheckResult("zero_collectives", not violations, violations,
                       details={"note": f"{n} ops walked", "n_ops": n,
                                "n_collectives": len(violations)})


# --------------------------------------------------------------------------- #
# (2) precision flow
# --------------------------------------------------------------------------- #
#: the products: what the dispatcher sees of matmul, einsum, linear, conv
PRODUCT_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "linear", "matmul", "einsum", "_scaled_mm", "convolution",
    "_convolution", "conv1d", "conv2d", "conv3d",
})


@register_check(
    "precision_flow", level="trace",
    description="every floating product and kernel region runs in the "
                "declared compute dtype; declared master state is kept")
def check_precision_flow(program: ProgramArtifacts,
                         ctx: CheckContext) -> CheckResult:
    if ctx.precision is None:
        return CheckResult("precision_flow", True, skipped=True,
                           skip_reason="no precision policy in context")
    prec = ctx.precision
    cdt = prec.compute_torch
    violations = []
    n_products = 0
    for s in program.ops:
        # a region's plain version may widen on purpose (the kernel's f32
        # accumulation): the region is judged by what enters it, below
        if s.region is not None or s.op not in PRODUCT_OPS or not s.dtypes:
            continue
        n_products += 1
        bad = [str(d).replace("torch.", "") for d in s.dtypes if d != cdt]
        if bad:
            violations.append(Violation(
                "precision_flow",
                f"host-side {s.op} runs on {'/'.join(bad)} operands; policy "
                f"{prec.name!r} declares compute dtype "
                f"{str(cdt).replace('torch.', '')}", s.name))
    for k in program.kernels:
        if not k.dtypes:
            continue
        n_products += 1
        bad = [str(d).replace("torch.", "") for d in k.dtypes if d != cdt]
        if bad:
            violations.append(Violation(
                "precision_flow",
                f"kernel {k.name} runs on {'/'.join(bad)} operands; policy "
                f"{prec.name!r} declares compute dtype "
                f"{str(cdt).replace('torch.', '')}", k.name))
    needs_master = (ctx.expect_master_state if ctx.expect_master_state
                    is not None else prec.needs_master)
    if needs_master:
        pdt, mdt = prec.param_torch, torch_dtype(prec.master_dtype)
        outs = program.output_leaves()
        master_shapes = {tuple(t.shape) for t in outs if t.dtype == mdt}
        for t in outs:
            if t.dtype == pdt and t.ndim >= 2 and tuple(t.shape) not in master_shapes:
                violations.append(Violation(
                    "precision_flow",
                    f"{str(pdt).replace('torch.', '')} output {tuple(t.shape)} "
                    f"has no {str(mdt).replace('torch.', '')} master-state "
                    f"shadow, but policy {prec.name!r} declares one",
                    "<outputs>"))
    return CheckResult("precision_flow", not violations, violations,
                       details={"note": f"{n_products} product(s) and kernel "
                                        f"region(s) checked against "
                                        f"{str(cdt).replace('torch.', '')}",
                                "n_products": n_products})


# --------------------------------------------------------------------------- #
# (3) RNG / gather placement
# --------------------------------------------------------------------------- #
#: torch's random draws (aten names): the counter-based sampler uses none
RNG_OPS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "uniform", "uniform_", "normal", "normal_", "bernoulli",
    "bernoulli_", "multinomial", "random", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_", "poisson", "native_dropout",
})
#: reads of a tensor at computed indices
GATHER_OPS = frozenset({"gather", "index", "index_select", "take",
                        "_unsafe_index", "take_along_dim", "embedding"})
#: the kernel region that samples and gathers inside the fused step
FUSED_STEP_REGION = "train_step"


@register_check(
    "rng_gather_placement", level="trace",
    description="with fuse_sampling on: no torch RNG op outside a kernel "
                "region; on the cuda backend no gather of the volume outside "
                "the fused step's region")
def check_rng_gather_placement(program: ProgramArtifacts,
                               ctx: CheckContext) -> CheckResult:
    if not ctx.fuse_sampling:
        return CheckResult("rng_gather_placement", True, skipped=True,
                           skip_reason="fuse_sampling not expected on")
    violations = []
    for s in program.ops:
        if s.region is not None:
            continue                        # inside a kernel: allowed
        if s.op in RNG_OPS:
            violations.append(Violation(
                "rng_gather_placement",
                f"RNG op {s.name!r} outside the fused op (the counter-based "
                "sampler must not draw in the program body)", s.name))
        elif ctx.expect_kernels and s.op in GATHER_OPS and "volume" in s.aliases:
            violations.append(Violation(
                "rng_gather_placement",
                f"{s.name} of the volume outside the fused step (the "
                "trilinear target gather must run in-kernel with "
                "fuse_sampling on)", s.name))
    n_fused = sum(k.name == FUSED_STEP_REGION for k in program.kernels)
    if ctx.expect_kernels and n_fused == 0:
        violations.append(Violation(
            "rng_gather_placement",
            "no fused train-step region in the program (expected the fused "
            "sampling kernel on the cuda backend)", "<top>"))
    return CheckResult("rng_gather_placement", not violations, violations,
                       details={"note": f"{n_fused} fused step region(s), "
                                        f"{len(program.kernels)} kernel "
                                        f"region(s)"})


# --------------------------------------------------------------------------- #
# (4) kernel budget
# --------------------------------------------------------------------------- #
@register_check(
    "kernel_budget", level="device",
    description="each launched CUDA kernel within its declared registers, "
                "stack frame (no spill) and shared memory (on the CPU: the "
                "dynamic shared memory the wrappers would request)")
def check_kernel_budget(program: ProgramArtifacts,
                        ctx: CheckContext) -> CheckResult:
    violations = []
    rows = program.launched
    if rows is not None:                 # the program ran on the card
        for r in rows:
            fam = _budgets.family_of(r["name"])
            where = r["name"] or "<unnamed kernel>"
            if fam is None:
                violations.append(Violation(
                    "kernel_budget", "launched kernel with no declared budget",
                    where))
                continue
            b = _budgets.KERNEL_BUDGETS[fam]
            smem = r["static_smem"] + r["dynamic_smem"]
            # local memory past the declared stack frame is a spill
            for what, got, cap in (("registers", r["registers"], b.registers),
                                   ("local bytes", r["local_bytes"], b.stack_bytes),
                                   ("shared bytes", smem,
                                    min(b.smem_bytes, ctx.smem_limit_bytes))):
                if got > cap:
                    violations.append(Violation(
                        "kernel_budget", f"{fam}: {what} {got} over its "
                        f"budget {cap}", where))
        return CheckResult("kernel_budget", not violations, violations,
                           details={"note": f"{len(rows)} launched kernel(s) "
                                            "read on the card",
                                    "launched": rows})
    n_plans = 0
    for k in program.kernels:
        for fam, smem in k.plan:
            b = _budgets.KERNEL_BUDGETS.get(fam)
            if b is None:
                violations.append(Violation(
                    "kernel_budget", f"kernel {fam} has no declared budget",
                    k.name))
                continue
            if smem is None:
                continue
            n_plans += 1
            cap = min(b.smem_bytes, ctx.smem_limit_bytes)
            if smem > cap:
                violations.append(Violation(
                    "kernel_budget", f"{fam} would request {smem} B of dynamic "
                    f"shared memory a block at these shapes, over "
                    f"{'its budget' if cap == b.smem_bytes else 'the limit'} "
                    f"{cap}", k.name))
    if violations:
        return CheckResult("kernel_budget", False, violations)
    return CheckResult(
        "kernel_budget", True, skipped=True,
        skip_reason=(f"registers, local memory and the launches' shared memory "
                     f"need the card; the dynamic shared memory of {n_plans} "
                     f"planned launch(es) is within budget"),
        details={"n_plans": n_plans})


# --------------------------------------------------------------------------- #
# Runner
# --------------------------------------------------------------------------- #
_LEVEL_ORDER = {"trace": 0, "device": 1}


def run_checks(program: ProgramArtifacts, ctx: Optional[CheckContext] = None,
               checks: Optional[Sequence[str]] = None,
               max_level: Optional[str] = None) -> Report:
    """Run the named ``checks`` (default: every registered one) on
    ``program``. ``max_level="trace"`` runs only the checks of the run's
    ops and regions (what the trainer's build-time hook runs); ``None`` or
    ``"device"`` adds ``kernel_budget``."""
    ctx = ctx or CheckContext()
    names = list(checks) if checks is not None else list(available_checks())
    cap = _LEVEL_ORDER[max_level] if max_level is not None else None
    report = Report(program.name)
    for n in names:
        chk = get_check(n)
        if cap is not None and _LEVEL_ORDER[chk.level] > cap:
            report.results.append(CheckResult(
                n, True, skipped=True,
                skip_reason=f"needs {chk.level} artifacts (max_level="
                            f"{max_level})"))
            continue
        report.results.append(chk(program, ctx))
    return report


def assert_clean(fn, *args, checks: Optional[Sequence[str]] = None,
                 name: Optional[str] = None, precision=None,
                 fuse_sampling: bool = False, expect_kernels: bool = False,
                 watch=None, max_level: Optional[str] = None) -> Report:
    """Run ``fn(*args)`` under capture and assert that the named checks
    pass: raises :class:`StaticCheckError` (an ``AssertionError``) with the
    report on a violation, and returns the report when clean."""
    from repro_torch.precision import resolve_precision

    program = capture(fn, *args, name=name, watch=watch)
    ctx = CheckContext(
        precision=(resolve_precision(precision) if precision is not None
                   else None),
        fuse_sampling=fuse_sampling, expect_kernels=expect_kernels)
    report = run_checks(program, ctx, checks=checks, max_level=max_level)
    if not report.passed:
        raise StaticCheckError(report)
    return report
