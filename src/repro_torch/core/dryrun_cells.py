"""DVNR production dry-run cells (the paper's own technique on the target
mesh): the port of ``repro.core.dryrun_cells``.

JAX's cell is one SPMD program over the mesh; the port's is what one rank
of it runs (rank ``mesh.index``, on a ``"fake"`` process group of the
mesh's size: see :mod:`repro_torch.launch.cells`), under a
``FakeTensorMode``, on the plain route (``impl="ref"``):

  - ``train``:  the rank's DVNR training step on its partition (256^3
    voxels + 1 ghost layer, PRODUCTION's INR). It must dispatch ZERO
    collectives: the paper's central claim (communication-free model
    parallelism), asserted here.
  - ``render``: the rank's part of the sort-last production renderer
    (``core.render.make_distributed_render_step``): its INR ray-march of a
    512 x 512 frame at 64 samples, then binary-swap compositing. log2(P)
    ``ppermute`` rounds plus one tiled all-gather are the ONLY collectives.
    A round sends rgba and depth in one message, where JAX sends two: the
    port issues half JAX's permutes for the same bytes.

Roofline terms come from the same counts as the LM cells
(:func:`repro_torch.launch.cells.measure`).
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.dvnr import PRODUCTION, DVNRConfig
from repro_torch.core.inr import param_count

# Production partition: 256^3 owned voxels + 1 ghost layer (paper's CloverLeaf
# strong-scaling per-rank size class).
PART_N = 256
GHOST = 1
FRAME_W = FRAME_H = 512          # 262144 rays; divisible by 512 devices
N_SAMPLES = 64


def _mlp_params(cfg: DVNRConfig) -> int:
    return param_count(cfg) - cfg.n_levels * cfg.table_size * cfg.n_features_per_level


def _enc_flops_fwd(cfg: DVNRConfig) -> float:
    """Per-sample hash-encoding forward FLOPs: per level, 8-corner trilerp of F
    features (7 lerps x 2 flops x F) + corner-weight/hash arithmetic (~36)."""
    return cfg.n_levels * (14.0 * cfg.n_features_per_level + 36.0)


def model_flops_train(cfg: DVNRConfig, n_partitions: int) -> float:
    """Analytic useful FLOPs of one global DVNR training step.

    Per sample: MLP fwd = 2*mlp_params, train = 3x fwd (fwd + 2x bwd);
    encoding fwd+bwd ~ 3x; plus trilinear target sampling (~28 flops) and the
    Adam update (~10 flops/param)."""
    per_sample = 6.0 * _mlp_params(cfg) + 3.0 * _enc_flops_fwd(cfg) + 28.0
    per_part = cfg.batch_size * per_sample + 10.0 * param_count(cfg)
    return n_partitions * per_part


def model_flops_render(cfg: DVNRConfig, n_partitions: int, n_rays: int,
                       n_samples: int) -> float:
    """Analytic useful FLOPs of one distributed render: every device infers
    R*S samples (2*mlp_params + enc fwd) + TF/over compositing (~40/sample)."""
    per_sample = 2.0 * _mlp_params(cfg) + _enc_flops_fwd(cfg) + 40.0
    return n_partitions * n_rays * n_samples * per_sample


def build_train_cell(mesh, cfg: DVNRConfig = PRODUCTION, *,
                     partitions_per_rank: int = 1, part_n: int = PART_N,
                     impl: str = "ref"):
    """``(fn, args, meta, fake_mode)``: the rank's training step on its
    ``partitions_per_rank`` partitions of ``part_n``^3 voxels (plus the
    ghost layer), its state and volumes fake tensors (``mesh=None``: one
    card's trainer)."""
    from repro_torch.core.sampling import step_seeds
    from repro_torch.core.trainer import DVNRTrainer

    n = (1 if mesh is None else mesh.size) * partitions_per_rank
    side = part_n + 2 * GHOST
    mode = FakeTensorMode()
    with mode:
        trainer = DVNRTrainer(cfg, n, mesh=mesh, impl=impl, ghost=GHOST,
                              volume_shape=(side,) * 3, device="cpu")
        st = trainer.init(0)
        vols = torch.empty((trainer.P, side, side, side))
        seeds = step_seeds(0, 0, n, partitions=trainer._global_rows())

    def fn(params, opt, vols, seeds, active, loss_ma):
        return trainer._spmd_step(params, opt, vols, seeds, active, loss_ma, None)

    return fn, (st.params, st.opt, vols, seeds, st.active, st.loss_ma), {
        "arch": "dvnr", "shape": f"train_p{part_n}",
        "partition_voxels": part_n ** 3,
        "partitions_per_device": partitions_per_rank,
        "inr_params_per_partition": param_count(cfg),
        "params": n * param_count(cfg),
        "active_params": n * param_count(cfg),
        "batch_per_partition": cfg.batch_size,
    }, mode


def build_render_cell(mesh, cfg: DVNRConfig = PRODUCTION, *, impl: str = "ref",
                      width: int = FRAME_W, height: int = FRAME_H,
                      n_samples: int = N_SAMPLES):
    """``(fn, args, meta, fake_mode)``: the rank's render step of a
    ``width`` x ``height`` frame."""
    from repro_torch.core.render import make_distributed_render_step
    from repro_torch.core.trainer import init_params

    n = mesh.size
    step = make_distributed_render_step(cfg, mesh, n_samples=n_samples, impl=impl)
    R = width * height
    mode = FakeTensorMode()
    with mode:
        params = init_params(cfg, 0, n, partitions=[mesh.index])
        args = (params,
                torch.empty(3), torch.empty(3), torch.empty(2),   # lo, extent, vrange
                torch.empty(R, 3), torch.empty(R, 3),             # origins, dirs
                torch.empty(64, 4),                                # tf
                (0.0, 1.0))                                        # grange
    return step, args, {
        "arch": "dvnr", "shape": f"render_{width}x{height}",
        "rays": R, "samples_per_ray": n_samples,
        "inr_params_per_partition": param_count(cfg),
        "params": n * param_count(cfg),
        "active_params": n * param_count(cfg),
    }, mode


def dvnr_record(kind: str, mesh, cfg: DVNRConfig = PRODUCTION, **kw) -> dict:
    """Build and run one DVNR cell on ``mesh``; its record, after the
    paper's claim on its collectives is asserted (train: none; render:
    log2(P) permute rounds and one all-gather, nothing else)."""
    from repro_torch.launch.cells import measure, roofline_record
    from repro_torch.utils import hw

    t0 = time.time()
    if kind == "train":
        fn, args, meta, mode = build_train_cell(mesh, cfg, **kw)
        mf = model_flops_train(cfg, meta["params"] // param_count(cfg))
    else:
        fn, args, meta, mode = build_render_cell(mesh, cfg, **kw)
        mf = model_flops_render(cfg, mesh.size, meta["rays"], meta["samples_per_ray"])
    t_build = time.time() - t0
    _, an, mem = measure(fn, args, mode)
    rec = dict(status="ok", **roofline_record(an, mem, mf, mesh.size, hw.PEAK_FLOPS_F32))
    rec.update(meta, build_s=round(t_build, 2), run_s=round(time.time() - t0 - t_build, 2))
    calls = rec["collective_calls"]
    if kind == "train":
        rec["zero_communication"] = not an.collectives
        if an.collectives:
            raise RuntimeError(
                f"DVNR train step must be collective-free, found "
                f"{rec['collective_wire_bytes_per_device']} wire bytes: {calls}")
    else:
        rounds = int(np.log2(mesh.size))
        rec["ppermute_rounds"] = calls.get("collective-permute", 0)
        want = {"collective-permute": rounds, "all-gather": 1} if rounds else {}
        if calls != want:
            raise RuntimeError(f"DVNR render on {mesh.size} ranks: {calls}, "
                               f"want {want}")
    return rec


def run_dvnr_cell(kind: str, mesh_name: str, results_root: Path,
                  cfg: DVNRConfig = PRODUCTION) -> dict:
    """Build and run the DVNR cell on rank 0 of the production mesh (the
    caller has initialised the ``"fake"`` group of its size); save the
    record."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device="cpu")
    rec = dvnr_record(kind, mesh, cfg)
    rec["mesh"] = mesh_name
    d = Path(results_root) / mesh_name
    d.mkdir(parents=True, exist_ok=True)
    (d / f"dvnr__{kind}.json").write_text(json.dumps(rec, indent=1))
    return rec
