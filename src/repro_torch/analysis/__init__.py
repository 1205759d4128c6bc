"""repro_torch.analysis — static checks of the port's programs: the
counterpart of the JAX package's ``repro.analysis`` for torch programs.

A program is run once under a dispatch mode that records each operation
and each kernel wrapper's region (:mod:`~repro_torch.analysis.ir`); named
checks read that record:

============================ ======= ==================================================
check                        level   invariant
============================ ======= ==================================================
``zero_collectives``         trace   no c10d / _c10d_functional op (the paper's
                                     zero communication)
``precision_flow``           trace   every product and kernel region on the policy's
                                     compute dtype; master state shadowed
``rng_gather_placement``     trace   with fuse_sampling on: no RNG op outside a kernel
                                     and (cuda) no gather of the volume outside the
                                     fused step
``kernel_budget``            device  each launched kernel within its declared
                                     registers, local and shared memory
============================ ======= ==================================================

Entry points: ``python -m repro_torch.analysis --config NAME --backend
{ref,cuda}``, ``assert_clean(fn, *args, ...)``, and
``DVNRConfig.static_checks = "warn" | "error"`` at trainer build. The
package root resolves its names lazily (PEP 562), as the JAX package's.
"""
from __future__ import annotations

_LAZY = {
    "Violation": "repro_torch.analysis.report",
    "CheckResult": "repro_torch.analysis.report",
    "Report": "repro_torch.analysis.report",
    "StaticCheckError": "repro_torch.analysis.report",
    "Check": "repro_torch.analysis.registry",
    "register_check": "repro_torch.analysis.registry",
    "get_check": "repro_torch.analysis.registry",
    "available_checks": "repro_torch.analysis.registry",
    "ProgramArtifacts": "repro_torch.analysis.ir",
    "OpSite": "repro_torch.analysis.ir",
    "KernelSite": "repro_torch.analysis.ir",
    "capture": "repro_torch.analysis.ir",
    "CheckContext": "repro_torch.analysis.checks",
    "run_checks": "repro_torch.analysis.checks",
    "assert_clean": "repro_torch.analysis.checks",
    "analyze_config": "repro_torch.analysis.programs",
    "config_programs": "repro_torch.analysis.programs",
    "build_trainer": "repro_torch.analysis.programs",
    "trainer_programs": "repro_torch.analysis.programs",
    "render_program": "repro_torch.analysis.programs",
    "cached_render_program": "repro_torch.analysis.programs",
    "serving_tick_program": "repro_torch.analysis.programs",
    "available_configs": "repro_torch.analysis.programs",
    "get_config": "repro_torch.analysis.programs",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod_name = _LAZY.get(name)
    if mod_name is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no attribute "
                             f"{name!r}")
    import importlib

    # registry lookups must see the checks: load their registration site
    if mod_name == "repro_torch.analysis.registry":
        importlib.import_module("repro_torch.analysis.checks")
    value = getattr(importlib.import_module(mod_name), name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
