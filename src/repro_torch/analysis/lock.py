"""The port's committed analysis lock: pinned fingerprints of its static
checks (the counterpart of the JAX package's ``repro.analysis.lock``).

The static checks prove invariants; the lock pins their *numbers*.
``src/repro_torch/analysis/lock.json`` records, for every (config,
backend, program) of :data:`LOCK_MATRIX`, each check's outcome and its key
quantities:

- ``zero_collectives``: the collective count;
- ``precision_flow``: the products and kernel regions checked, and the
  compute dtype they were held to;
- ``rng_gather_placement``: the fused-step regions and all kernel regions;
- ``kernel_budget``: the launches the kernel regions planned and each
  one's dynamic shared bytes, with whether each is within its budget.

A change that adds a collective, moves a product off the policy's dtype,
adds a kernel region or changes a launch's shared memory shows up as a
readable per-field diff (``config/backend/program :: check.field:
lock=... current=...``); an intended change is an explicit ``python -m
repro_torch.analysis lock write`` and a reviewed hunk of the file.

Every pinned number is one the host decides, so a lock written on the CPU
holds on the card: the checks' statuses and counts of the trace, and for
``kernel_budget`` the host's launch plans (not the registers or local
memory that only a launch on the card can read: its status here is the
plans' verdict, whatever the level). Op totals ("3932 ops walked"), which
change with the torch build, are never pinned, and neither are times.

Workflow:

- ``python -m repro_torch.analysis lock write [--device cpu]``  re-derive and
  overwrite the lock (the whole matrix)
- ``python -m repro_torch.analysis lock verify [--device cpu]`` re-derive and
  diff: exit 1 on drift with the per-field diff, 2 on a missing or
  malformed lock file

``ANALYSIS_LOCK.json`` at the repo root is the JAX package's and is never
written here.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: lock schema version (bump when the fingerprints change shape)
LOCK_VERSION = 1

#: the port's lock file, beside this module
DEFAULT_LOCK_PATH = str(Path(__file__).with_name("lock.json"))

#: the pinned (config, backends, max_level) matrix: quickstart and smoke on
#: both backends with every check, production256 on the cuda backend at
#: the trace level (its plans are pinned all the same)
LOCK_MATRIX: Tuple[Tuple[str, Tuple[str, ...], str], ...] = (
    ("quickstart", ("ref", "cuda"), "device"),
    ("smoke", ("ref", "cuda"), "device"),
    ("production256", ("cuda",), "trace"),
)


# --------------------------------------------------------------------------- #
# Fingerprints
# --------------------------------------------------------------------------- #
def _fp_zero_collectives(r) -> dict:
    return {"n_collectives": r.details.get("n_collectives", 0)}


def _fp_precision(r) -> dict:
    return {"n_products": r.details.get("n_products", 0),
            "compute_dtype": r.details.get("compute_dtype", "")}


def _fp_rng_gather(r) -> dict:
    return {"n_fused": r.details.get("n_fused", 0),
            "n_regions": r.details.get("n_regions", 0)}


_FINGERPRINTERS = {
    "zero_collectives": _fp_zero_collectives,
    "precision_flow": _fp_precision,
    "rng_gather_placement": _fp_rng_gather,
}


def _fp_plans(plans) -> dict:
    """The planned launches: per kernel family, the count of launches at
    each dynamic shared size (``"-"``: a plan that states none), and the
    verdict of each size against the family's budget."""
    from repro_torch.kernels import budgets

    by_fam: Dict[str, Counter] = {}
    over = 0
    for fam, smem in plans:
        by_fam.setdefault(fam, Counter())["-" if smem is None else str(smem)] += 1
        b = budgets.KERNEL_BUDGETS.get(fam)
        if b is None or (smem is not None and
                         smem > min(b.smem_bytes, budgets.H100_SMEM_OPTIN)):
            over += 1
    return {"status": "fail" if over else "pass", "n_plans": len(plans),
            "plans": {f: dict(c) for f, c in by_fam.items()}}


def fingerprint_report(report) -> dict:
    """Canonical fingerprint of one program's :class:`Report`: per check,
    the pass/fail/skip status plus that check's key numbers."""
    out = {}
    for r in report.results:
        if r.name == "kernel_budget":
            out[r.name] = _fp_plans(report.plans)
            continue
        fp = {"status": "skip" if r.skipped else ("pass" if r.passed else "fail")}
        if not r.skipped:
            extra = _FINGERPRINTERS.get(r.name)
            if extra is not None:
                fp.update(extra(r))
        out[r.name] = fp
    return out


def _program_key(config: str, backend: str, program_name: str) -> str:
    # "train_chunk[cuda]" -> "quickstart/cuda/train_chunk"
    return f"{config}/{backend}/{program_name.split('[')[0]}"


def entries_of(config: str, backend: str, reports) -> Dict[str, dict]:
    """The lock entries of one (config, backend) cell's reports (e.g. the
    reports ``analyze_config`` already gave a caller)."""
    return {_program_key(config, backend, rep.program): fingerprint_report(rep)
            for rep in reports}


# --------------------------------------------------------------------------- #
# Lock computation / IO
# --------------------------------------------------------------------------- #
def compute_lock(matrix=LOCK_MATRIX, *, backends: Optional[Sequence[str]] = None,
                 configs: Optional[Sequence[str]] = None, device="auto",
                 progress=None) -> dict:
    """Re-derive the lock for ``matrix`` (optionally only ``backends`` and
    ``configs``), every program of every cell run on ``device``."""
    from repro_torch.analysis.programs import analyze_config

    entries: Dict[str, dict] = {}
    for config, cfg_backends, max_level in matrix:
        if configs and config not in configs:
            continue
        for b in cfg_backends:
            if backends and b not in backends:
                continue
            if progress:
                progress(f"analyzing {config} [{b}] (max_level={max_level})")
            entries.update(entries_of(config, b, analyze_config(
                config, backend=b, max_level=max_level, device=device)))
    return {
        "version": LOCK_VERSION,
        "matrix": {c: {"backends": list(bs), "max_level": lvl}
                   for c, bs, lvl in matrix},
        "entries": entries,
    }


def dump_lock(lock: dict) -> str:
    """Canonical serialization (sorted keys, stable indent, one trailing
    newline), so that a diff of the file is small and reviewable."""
    return json.dumps(lock, sort_keys=True, indent=2) + "\n"


def write_lock(path: str = DEFAULT_LOCK_PATH, matrix=LOCK_MATRIX, *,
               device="auto", progress=None) -> dict:
    lock = compute_lock(matrix, device=device, progress=progress)
    with open(path, "w") as f:
        f.write(dump_lock(lock))
    return lock


def read_lock(path: str = DEFAULT_LOCK_PATH) -> dict:
    with open(path) as f:
        lock = json.load(f)
    if not isinstance(lock, dict) or not isinstance(lock.get("entries"), dict):
        raise ValueError(f"{path}: not an analysis lock file (no 'entries')")
    return lock


def lock_matrix(lock: dict):
    """The matrix a lock file was written for."""
    try:
        return tuple((c, tuple(m["backends"]), m["max_level"])
                     for c, m in sorted(lock["matrix"].items()))
    except (KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"malformed lock matrix: {e!r}") from None


# --------------------------------------------------------------------------- #
# Diffing
# --------------------------------------------------------------------------- #
def _flatten(d: dict, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for k in sorted(d):
        v = d[k]
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def diff_locks(committed: dict, current: dict,
               backends: Optional[Sequence[str]] = None,
               configs: Optional[Sequence[str]] = None) -> List[str]:
    """Field-level differences between the committed lock and freshly
    derived content, over the entries of ``backends`` and ``configs``
    (default: all). An empty list is a clean verify."""
    def keep(key: str) -> bool:
        config, backend = key.split("/")[:2]
        return (not backends or backend in backends) and \
            (not configs or config in configs)

    a = {k: v for k, v in committed.get("entries", {}).items() if keep(k)}
    b = {k: v for k, v in current.get("entries", {}).items() if keep(k)}
    lines: List[str] = []
    if committed.get("version") != current.get("version"):
        lines.append(f"lock version: committed={committed.get('version')} "
                     f"current={current.get('version')}")
    for key in sorted(set(a) - set(b)):
        lines.append(f"{key}: in the lock file but not derivable from the "
                     f"current code (program removed or renamed?)")
    for key in sorted(set(b) - set(a)):
        lines.append(f"{key}: produced by the current code but missing from "
                     f"the lock file (run `python -m repro_torch.analysis lock "
                     f"write`)")
    for key in sorted(set(a) & set(b)):
        fa, fb = _flatten(a[key]), _flatten(b[key])
        for f in sorted(set(fa) | set(fb)):
            va, vb = fa.get(f, "<absent>"), fb.get(f, "<absent>")
            if va != vb:
                lines.append(f"{key} :: {f}: lock={va} current={vb}")
    return lines


def verify_lock(path: str = DEFAULT_LOCK_PATH, *,
                backends: Optional[Sequence[str]] = None,
                configs: Optional[Sequence[str]] = None, device="auto",
                progress=None) -> List[str]:
    """Diff the committed lock file against fingerprints derived afresh on
    ``device``; the drift lines (empty: verified). Raises
    ``FileNotFoundError`` / ``ValueError`` for a missing or malformed file."""
    committed = read_lock(path)
    current = compute_lock(lock_matrix(committed), backends=backends,
                           configs=configs, device=device, progress=progress)
    return diff_locks(committed, current, backends=backends, configs=configs)
