"""``python -m repro_torch.analysis`` — the port's static checks from the
shell.

Examples::

    # every check over the quickstart config's programs, plain versions on
    # the CPU
    python -m repro_torch.analysis --config quickstart --backend ref --device cpu

    # the kernel wrappers' plain versions on the CPU (the cuda backend's
    # programs; kernel_budget checks only the planned shared memory there)
    python -m repro_torch.analysis --config smoke --backend cuda --device cpu

    # the production-scale programs on the card, each launched kernel read
    python -m repro_torch.analysis --config production256 --backend cuda

    # the committed lock (src/repro_torch/analysis/lock.json): re-derive and
    # diff, or rewrite it after an intended change
    python -m repro_torch.analysis lock verify --device cpu
    python -m repro_torch.analysis lock write --device cpu

Exit codes: 0 clean, 1 violations (``lock verify``: drift), 2 usage errors
(unknown config or check name; a missing or malformed lock file).
"""
from __future__ import annotations

import argparse
import sys

#: exit code for usage errors, apart from 1 ("the invariants failed")
EXIT_USAGE = 2


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static checks of the DVNR port's programs (zero "
                    "communication, precision flow, RNG/gather placement, "
                    "kernel budgets).")
    ap.add_argument("--config", default="quickstart",
                    help="named analysis config (see --list-configs)")
    ap.add_argument("--backend", default="auto",
                    help="backend leg(s), comma-separated (ref, cuda)")
    ap.add_argument("--device", default="auto",
                    help="where the programs run (auto: the card)")
    ap.add_argument("--checks", default=None,
                    help="comma-separated subset of checks (default: all)")
    ap.add_argument("--max-level", default=None, choices=("trace", "device"),
                    help="trace: the ops and kernel regions only; default "
                         "adds the launched kernels' budgets")
    ap.add_argument("--partitions", type=int, default=2,
                    help="partition count (default 2)")
    ap.add_argument("--local-shape", default=None,
                    help="override the config's local volume shape, e.g. "
                         "64,64,64")
    ap.add_argument("--list-checks", action="store_true")
    ap.add_argument("--list-configs", action="store_true")
    return ap.parse_args(argv)


def _parse_lock_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis lock",
        description="Write or verify the port's committed analysis lock "
                    "(pinned fingerprints of every check over the lock "
                    "matrix; see repro_torch.analysis.lock).")
    ap.add_argument("action", choices=("write", "verify"))
    ap.add_argument("--path", default=None,
                    help="lock file (default: src/repro_torch/analysis/lock.json)")
    ap.add_argument("--backend", default=None,
                    help="verify only these backend(s), comma-separated "
                         "(write always covers the whole matrix)")
    ap.add_argument("--config", default=None,
                    help="verify only these config(s), comma-separated")
    ap.add_argument("--device", default="auto",
                    help="where the programs run (auto: the card)")
    return ap.parse_args(argv)


def _lock_main(argv) -> int:
    args = _parse_lock_args(argv)
    from repro_torch.analysis import lock as _lock

    path = args.path or _lock.DEFAULT_LOCK_PATH
    progress = lambda msg: print(f"[lock] {msg}", flush=True)  # noqa: E731
    if args.action == "write":
        lock = _lock.write_lock(path, device=args.device, progress=progress)
        print(f"wrote {path}: {len(lock['entries'])} program fingerprints")
        return 0
    backends = args.backend.split(",") if args.backend else None
    configs = args.config.split(",") if args.config else None
    try:
        drift = _lock.verify_lock(path, backends=backends, configs=configs,
                                  device=args.device, progress=progress)
    except FileNotFoundError:
        print(f"error: lock file {path!r} not found: generate it with "
              f"`python -m repro_torch.analysis lock write`", file=sys.stderr)
        return EXIT_USAGE
    except ValueError as e:
        print(f"error: malformed lock file: {e}", file=sys.stderr)
        return EXIT_USAGE
    if drift:
        print(f"analysis lock DRIFT ({len(drift)} difference(s) vs {path}):")
        for line in drift:
            print(f"  {line}")
        print("if the change is intended, rewrite it with `python -m "
              "repro_torch.analysis lock write` and commit the diff")
        return 1
    print(f"analysis lock verified against {path}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "lock":
        return _lock_main(argv[1:])
    args = _parse_args(argv)
    from repro_torch.analysis import (analyze_config, available_checks,
                                      available_configs, get_check)

    if args.list_checks:
        for name in available_checks():
            chk = get_check(name)
            print(f"{name:<24s} [{chk.level:<6s}] {chk.description}")
        return 0
    if args.list_configs:
        print("\n".join(available_configs()))
        return 0
    if args.config not in available_configs():
        print(f"error: unknown config {args.config!r}; available: "
              f"{', '.join(available_configs())}", file=sys.stderr)
        return EXIT_USAGE
    checks = args.checks.split(",") if args.checks else None
    if checks:
        unknown = sorted(set(checks) - set(available_checks()))
        if unknown:
            print(f"error: unknown check(s): {', '.join(unknown)}; "
                  f"available: {', '.join(available_checks())}",
                  file=sys.stderr)
            return EXIT_USAGE
    local_shape = (tuple(int(d) for d in args.local_shape.split(","))
                   if args.local_shape else None)
    ok = True
    for backend in args.backend.split(","):
        print(f"== backend {backend} ==")
        try:
            reports = analyze_config(
                args.config, backend=backend, local_shape=local_shape,
                n_partitions=args.partitions, checks=checks,
                max_level=args.max_level, device=args.device)
        except (ValueError, RuntimeError) as e:
            # a config the trainer refuses, or no card for "auto": a finding
            print(f"REJECTED:\n{e}")
            ok = False
            reports = []
        for rep in reports:
            print(rep.render())
            ok = ok and rep.passed
    print("static analysis:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
