"""The subprocess side of ``tests/test_torch_dryrun.py``: cases that need a
process group of their own (the port's ``"fake"`` group of 4 ranks) or 4
JAX host devices. It holds no test of its own.

    python tests/torch_dryrun_cases.py <case>      # prints one JSON line

- ``dvnr``: the port's DVNR train and render cells at SMOKE widths on rank
  0 of a fake (2, 2) mesh (a 32 x 32 frame, 8 samples), their collective
  calls and wire bytes; and the wire bytes of JAX's render cell at the same
  widths, compiled on 4 host devices (``repro.utils.hlo.analyze_hlo``).
  Run with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
- ``dense``: a dense SMOKE train cell (remat ``"none"``) on each of the 4
  ranks of a fake (2, 2) mesh in turn: every rank's product FLOPs by op.
"""
from __future__ import annotations

import json
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FRAME, SAMPLES = 32, 8
DENSE_ARCH = "llama3_8b"
DENSE_SHAPE = ("dense_t", "train", 32, 4)      # (name, kind, seq, global batch)


def _fake_group(rank: int = 0, world: int = 4) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def _mesh():
    from repro_torch.launch.mesh import build_mesh
    return build_mesh((2, 2), ("data", "model"), device="cpu")


def dvnr_case() -> dict:
    from repro_torch.configs.dvnr import SMOKE
    from repro_torch.core.dryrun_cells import dvnr_record
    _fake_group()
    mesh = _mesh()
    out = {}
    for kind, kw in (("train", {"part_n": 8}),
                     ("render", {"width": FRAME, "height": FRAME, "n_samples": SAMPLES})):
        rec = dvnr_record(kind, mesh, SMOKE, **kw)
        out[kind] = {"calls": rec["collective_calls"],
                     "wire": rec["collective_wire_bytes_per_device"],
                     "breakdown": rec["collective_breakdown"]}

    import jax
    from repro.configs.dvnr import SMOKE as JSMOKE
    from repro.core import dryrun_cells as jcells
    from repro.utils.hlo import analyze_hlo
    jcells.FRAME_W = jcells.FRAME_H = FRAME
    jcells.N_SAMPLES = SAMPLES
    jmesh = jax.sharding.Mesh(
        __import__("numpy").array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    fn, args, _ = jcells.build_render_cell(jmesh, JSMOKE)
    with jmesh:
        compiled = jax.jit(fn).lower(*args).compile()
    an = analyze_hlo(compiled.as_text(), jmesh.size)
    out["jax_render"] = {"wire": an.collective_wire_bytes,
                         "breakdown": an.collective_summary()}
    return out


def dense_case() -> dict:
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch.cells import build_cell, measure
    cfg = get_smoke_config(DENSE_ARCH).replace(remat="none", compute_dtype="float32",
                                               param_dtype="float32")
    ranks = []
    for rank in range(4):
        _fake_group(rank)
        cell = build_cell(DENSE_ARCH, DENSE_SHAPE[0], _mesh(), config=cfg,
                          shape=ShapeConfig(*DENSE_SHAPE))
        _, an, _ = measure(cell.fn, cell.args, cell.fake_mode)
        ranks.append({"flops": an.flops,
                      "products": [[f, c, s] for f, c, s in an.top_products]})
    return {"ranks": ranks}


if __name__ == "__main__":
    warnings.filterwarnings("ignore")
    case = sys.argv[1]
    print(json.dumps({"dvnr": dvnr_case, "dense": dense_case}[case]()))
