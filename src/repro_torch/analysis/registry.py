"""The named checks of the port's static verifier (the JAX package's
``repro.analysis.registry``, with the port's levels).

A check is ``check(program, ctx) -> CheckResult`` registered under a stable
name (the name the CLI, ``assert_clean(checks=...)`` and the trainer's
build-time hook use). Each declares the level of artifact it needs:

- ``"trace"``: the ops one run of the program dispatched and its kernel
  regions (:mod:`repro_torch.analysis.ir`), on any device; what the
  trainer's hook runs;
- ``"device"``: what only the compiled library on the card can say (each
  launched kernel's registers, local and shared memory).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

LEVELS = ("trace", "device")


@dataclass(frozen=True)
class Check:
    name: str
    fn: Callable                      # (ProgramArtifacts, CheckContext) -> CheckResult
    level: str                        # "trace" | "device"
    description: str = ""

    def __call__(self, program, ctx):
        return self.fn(program, ctx)


_CHECKS: Dict[str, Check] = {}


def register_check(name: str, *, level: str, description: str = ""):
    """Decorator: register ``fn`` as the named check (a second registration
    under the same name replaces the first)."""
    if level not in LEVELS:
        raise ValueError(f"check level must be one of {LEVELS}, got {level!r}")

    def deco(fn):
        _CHECKS[name] = Check(name, fn, level, description)
        return fn

    return deco


def get_check(name: str) -> Check:
    try:
        return _CHECKS[name]
    except KeyError:
        raise ValueError(f"unknown check {name!r}; registered: "
                         f"{sorted(_CHECKS)}") from None


def available_checks() -> Tuple[str, ...]:
    """Registered check names, in registration order."""
    return tuple(_CHECKS)
