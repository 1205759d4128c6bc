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

Exit codes: 0 clean, 1 violations, 2 usage errors (unknown config or check
name; the ``lock`` subcommand, which is not ported).
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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "lock":
        print("error: `lock write|verify` is not ported: ANALYSIS_LOCK.json "
              "pins the TPU checks' fingerprints (ROADMAP item 15)",
              file=sys.stderr)
        return EXIT_USAGE
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
