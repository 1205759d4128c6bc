"""Cell diagnostics for the perf loop: the top collectives, products and
traffic operations of one dry-run cell's rank (the port of
``repro.utils.diagnose``), read from one run under
:class:`~repro_torch.utils.opcount.OpCounter` on the fake mesh.

  PYTHONPATH=src python -m repro_torch.utils.diagnose --arch grok_1_314b \\
      --shape train_4k [--mesh single] [--moe-dispatch scatter] [--top 15]
  PYTHONPATH=src python -m repro_torch.utils.diagnose --arch dvnr --shape render
"""
from __future__ import annotations

import argparse
import warnings


def report(an, k: int = 15) -> str:
    """The text of one rank's counts (:class:`OpAnalysis`)."""
    lines = [f"per-device: flops={an.flops:.3e} bytes={an.op_bytes:.3e}B "
             f"wire={an.collective_wire_bytes:.3e}B ({an.n_ops} ops)"]
    lines.append("\n--- collectives (aggregated wire bytes) ---")
    for c in sorted(an.collectives, key=lambda c: -c.wire_bytes_per_call * c.count)[:k]:
        lines.append(f"{c.kind:20s} {c.bytes_per_call / 2**20:10.1f}MiB/call "
                     f"x{c.count:6d} (groups of {c.group_size}) "
                     f"wire={c.wire_bytes_per_call * c.count / 2**30:8.2f}GiB")
    lines.append("\n--- top products (per-device flops) ---")
    for f, cnt, sig in an.top_products[:k]:
        lines.append(f"{f:.3e} flops x{cnt:6d}  {sig[:110]}")
    lines.append("\n--- top traffic ops (inputs + outputs) ---")
    for b, cnt, op, sig in an.top_traffic[:k]:
        lines.append(f"{b / 2**30:8.2f}GiB x{cnt:6d} {op:22s} {sig[:70]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="an LM arch, or dvnr")
    ap.add_argument("--shape", required=True,
                    help="a shape name (dvnr: train or render)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--moe-dispatch", default="scatter")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore", category=FutureWarning)

    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import WORLD, init_fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.utils.opcount import OpCounter

    init_fake_group(WORLD[args.mesh])
    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), device="cpu")
    if args.arch == "dvnr":
        from repro_torch.core.dryrun_cells import build_render_cell, build_train_cell
        build = build_train_cell if args.shape == "train" else build_render_cell
        fn, cargs, _, mode = build(mesh)
    else:
        cell = build_cell(args.arch, args.shape, mesh, moe_dispatch=args.moe_dispatch)
        fn, cargs, mode = cell.fn, cell.args, cell.fake_mode
    with mode, OpCounter(args.top) as counter:
        fn(*cargs)
    print(report(counter.analysis(), args.top))


if __name__ == "__main__":
    main()
