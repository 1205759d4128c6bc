"""Multi-pod dry-run: run rank 0 of every (architecture x input shape) on
the production meshes, recording memory, counts and roofline terms on the
H100's constants (the port of ``repro.launch.dryrun``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--jobs 4] [--mesh both]
  python -m repro_torch.launch.dryrun --dvnr --mesh both   # the paper's own cells

Each cell runs in a process of its own, on a ``"fake"`` process group of
the mesh's world size (256 ranks for ``single``'s (16, 16), 512 for
``multi``'s (2, 16, 16)): a process holds one default group, and a cell
that fails takes only its own process down. Nothing is allocated and
nothing runs on a device (:mod:`repro_torch.launch.cells`).

Records land in ``<out>/<mesh>/<arch>__<shape>.json`` (``--out``, default
``dryrun_torch/`` at the repo root; the JAX package's ``results/dryrun``
is its own). Every count is a rank's: ``counted_flops_per_device`` (the
products, ``torch.utils.flop_counter``'s registry), ``op_bytes_per_device``
(each eager operation's inputs and outputs), ``collective_wire_bytes_per_
device`` with JAX's ring factors, ``collective_breakdown`` by JAX's kind
names; ``roofline`` on :mod:`repro_torch.utils.hw`.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "dryrun_torch"
WORLD = {"single": 256, "multi": 512}


def init_fake_group(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks (collectives complete at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape: str, mesh_name: str, moe_dispatch: str = "scatter",
             out_dir: Path = RESULTS) -> dict:
    """One LM cell on rank 0 of the production mesh (the caller has
    initialised the fake group of its size); its record, saved."""
    from repro_torch.configs import cell_is_applicable, get_config
    from repro_torch.launch.cells import build_cell, measure, roofline_record
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.utils import hw

    ok, reason = cell_is_applicable(arch, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "moe_dispatch": moe_dispatch}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _save(rec, out_dir, mesh_name, arch, shape)
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device="cpu")
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, moe_dispatch=moe_dispatch)
    t_build = time.time() - t0
    _, an, mem = measure(cell.fn, cell.args, cell.fake_mode)
    rec.update(status="ok", build_s=round(t_build, 2),
               run_s=round(time.time() - t0 - t_build, 2),
               **roofline_record(an, mem, cell.meta["model_flops_global"], mesh.size,
                                 hw.peak_flops(get_config(arch).compute_dtype)),
               params=cell.meta["params"], active_params=cell.meta["active_params"])
    for k in ("tokens_global", "cache_bytes_global", "cache_bytes_per_device"):
        if k in cell.meta:
            rec[k] = cell.meta[k]
    _save(rec, out_dir, mesh_name, arch, shape)
    return rec


def _save(rec: dict, out_dir: Path, mesh_name: str, arch: str, shape: str):
    d = Path(out_dir) / mesh_name
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{arch}__{shape}.json").write_text(json.dumps(rec, indent=1))


def _run_all(cells, jobs: int, extra) -> int:
    """One subprocess per cell (each its own fake group; a cell that fails
    takes only its process down). ``cells``: argument lists."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs: list = []
    failures = []
    done = 0

    def launch(argv):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, *extra]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env=env), argv

    pending = list(cells)
    while pending or procs:
        while pending and len(procs) < jobs:
            procs.append(launch(pending.pop(0)))
        for i, (p, key) in enumerate(procs):
            if p.poll() is not None:
                out = p.stdout.read()
                done += 1
                status = "ok" if p.returncode == 0 else "FAIL"
                print(f"[{done}/{len(cells)}] {' '.join(key)} -> {status}", flush=True)
                if p.returncode != 0:
                    failures.append((key, out[-2500:]))
                procs.pop(i)
                break
        else:
            time.sleep(0.2)
    for key, out in failures:
        print(f"\n=== FAILURE {' '.join(key)} ===\n{out}")
    return len(failures)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dvnr", action="store_true", help="run the DVNR (paper) cells")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--moe-dispatch", default="scatter",
                    choices=["scatter", "a2a", "scatter_global", "scatter_gspmd"])
    ap.add_argument("--out", default=str(RESULTS), help="records' directory")
    args = ap.parse_args(argv)
    if not (args.all or args.dvnr or (args.arch and args.shape)):
        ap.error("--arch and --shape required (or --all, or --dvnr)")
    warnings.filterwarnings("ignore", category=FutureWarning)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    extra = ["--moe-dispatch", args.moe_dispatch, "--out", args.out]
    if args.all or len(meshes) > 1:
        if args.dvnr:
            cells = [["--dvnr", "--mesh", m] for m in meshes]
        elif args.all:
            from repro_torch.configs import ARCH_IDS, SHAPES
            cells = [["--arch", a, "--shape", s, "--mesh", m]
                     for m in meshes for a in ARCH_IDS for s in SHAPES]
        else:
            cells = [["--arch", args.arch, "--shape", args.shape, "--mesh", m]
                     for m in meshes]
        sys.exit(1 if _run_all(cells, args.jobs, extra) else 0)

    init_fake_group(WORLD[meshes[0]])
    if args.dvnr:
        from repro_torch.core.dryrun_cells import run_dvnr_cell
        for kind in ("train", "render"):
            rec = run_dvnr_cell(kind, meshes[0], Path(args.out))
            print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "status",
                                                  "collective_calls", "roofline")}))
        return
    rec = run_cell(args.arch, args.shape, meshes[0], args.moe_dispatch, Path(args.out))
    print(json.dumps({k: v for k, v in rec.items()
                      if k in ("arch", "shape", "mesh", "status", "run_s",
                               "roofline", "reason")}, indent=1))


if __name__ == "__main__":
    main()
