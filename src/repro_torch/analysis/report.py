"""Result and report types of the port's static checks: the JAX package's
``repro.analysis.report``, kept as the port's own copy.

A :class:`CheckResult` is the outcome of ONE named check on ONE program; a
:class:`Report` gathers them for a program (what the CLI prints and the
trainer's build-time hook reads).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(frozen=True)
class Violation:
    """One violated invariant, with the place in the program it was seen."""

    check: str                 # registered check name
    message: str               # what is wrong, in words a user can act on
    location: str = ""         # the op, kernel region or output it concerns

    def __str__(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.check}{loc}: {self.message}"


@dataclass
class CheckResult:
    """Outcome of one check on one program."""

    name: str
    passed: bool
    violations: List[Violation] = field(default_factory=list)
    details: Dict = field(default_factory=dict)
    skipped: bool = False
    skip_reason: str = ""

    @property
    def status(self) -> str:
        if self.skipped:
            return "SKIP"
        return "PASS" if self.passed else "FAIL"

    def summary(self) -> str:
        head = f"{self.status:4s} {self.name}"
        if self.skipped:
            return f"{head} ({self.skip_reason})"
        if self.passed:
            extra = self.details.get("note", "")
            return f"{head}{f' ({extra})' if extra else ''}"
        return head + "".join(f"\n       - {v}" for v in self.violations)


@dataclass
class Report:
    """Every check's result on one program."""

    program: str
    results: List[CheckResult] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return all(r.passed or r.skipped for r in self.results)

    @property
    def violations(self) -> List[Violation]:
        return [v for r in self.results for v in r.violations]

    def result(self, name: str) -> CheckResult:
        for r in self.results:
            if r.name == name:
                return r
        raise KeyError(f"no result for check {name!r} in program "
                       f"{self.program!r}")

    def render(self) -> str:
        lines = [f"program {self.program}:"]
        lines += [f"  {r.summary()}" for r in self.results]
        return "\n".join(lines)


class StaticCheckError(AssertionError):
    """Raised by ``assert_clean`` and ``static_checks="error"`` on
    violations (an ``AssertionError``, so that pytest reads it naturally)."""

    def __init__(self, report: Report):
        self.report = report
        msgs = "\n".join(str(v) for v in report.violations) or report.render()
        super().__init__(
            f"static analysis failed for program {report.program!r}:\n{msgs}")
