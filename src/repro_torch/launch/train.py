"""End-to-end LM training driver: the port of ``repro.launch.train``.

Trains any zoo architecture on one card with the JAX driver's flags,
returned dict and final JSON line: the model from its config, AdamW with a
cosine schedule (10 warm-up steps) and clipping at 1.0 (``make_train_step``),
optional microbatches and int8 error-feedback gradient compression, atomic
async checkpoints every ``--ckpt-every`` steps and a resume from the newest
(``--resume``). The checkpoints are the JAX package's layout, so either
package resumes the other's.

On one process it runs on ``cuda:0``. On a process group of more than one
rank (``torch.distributed`` initialised by the caller, or ``WORLD_SIZE`` >
1 from ``torchrun``, when the driver initialises it from the environment:
``nccl`` on the cards, ``gloo`` with ``--device cpu``) it builds JAX's
mesh, ``make_mesh_for(world)`` (JAX's default ``model_parallel=16``:
(1, 4) on 4 ranks), and trains every family sharded: every rank
draws the same init and keeps its blocks, cut over ``"model"`` and over
``"data"`` (the fsdp split: the AdamW moments follow), cutting each leaf
as it is drawn (``Model.init(..., sharder=)``: a rank never holds the
whole tree), and takes its block of each ``synth_batch`` (each input cut
on its batch dimension, :func:`batch_dims`); checkpoints are
written from the blocks' placements and restored onto whatever mesh
resumes (another shape too).
Rank 0 prints. ``--device cpu`` with ``--impl ref``
(or ``cuda``: the kernel wrappers' plain versions) runs on the CPU, which
the tests use; ``--device`` and ``--impl`` default to ``auto``, which raise
without a GPU rather than falling back to the CPU.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --steps 50 --batch 8 --seq 1024 --ckpt-dir ck --resume
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2_0_5b --steps 50 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \\
      --steps 20 --device cpu --impl ref
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import backends
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_mesh_for, rank_device
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.parallel.sharding import Placement, Sharder, held_shardings
from repro_torch.train import make_train_step


def synth_batch(model, shape: ShapeConfig, step: int, device="auto") -> dict:
    """Fill the model's input_specs with deterministic synthetic data — works
    for every family (tokens, embeds, positions). The numbers are the JAX
    driver's bit for bit (the same ``default_rng(1234 + step)`` draws, cast
    on the host), as tensors on ``device``."""
    dev = backends.resolve_device(device)
    specs = model.input_specs(shape)
    rng = np.random.default_rng(1234 + step)
    out = {}
    for k, s in specs.items():
        if not s.dtype.is_floating_point:
            hi = model.config.vocab if "token" in k or "label" in k else shape.seq_len
            a = rng.integers(0, hi, tuple(s.shape))
        else:
            a = rng.standard_normal(tuple(s.shape)) * 0.02
        out[k] = torch.from_numpy(a).to(s.dtype).to(dev)
    return out


def batch_dims(model, kind: str = "train") -> dict:
    """Each input's batch dimension, read from ``Model.input_specs``: the
    dimension that changes with the global batch (0 for tokens, labels and
    embeddings; 1 for the VLM's M-RoPE ``positions``, (3, B, S))."""
    one, two = (model.input_specs(ShapeConfig("dims", kind, 8, b)) for b in (1, 2))
    return {k: next(d for d, (a, b) in enumerate(zip(one[k].shape, two[k].shape))
                    if a != b) for k in one}


def batch_block(batch: dict, sharder, dims: dict) -> dict:
    """This rank's rows of a global batch: each input's block over the
    sharder's batch axes along its batch dimension (``dims``: key ->
    dimension, :func:`batch_dims`); the whole batch without a mesh or
    without batch axes."""
    if sharder.mesh is None:
        return batch
    axes = sharder.resolve("batch")
    out = {}
    for key, v in batch.items():
        spec = [None] * v.dim()
        spec[dims[key]] = axes
        out[key] = v[Placement(sharder.mesh, tuple(spec)).slices(v.shape)]
    return out


def _world(device) -> int:
    """The ranks this process trains with: the initialised process group's,
    else ``torchrun``'s ``WORLD_SIZE`` (initialising the group from the
    environment: ``nccl`` on the cards, ``gloo`` on the CPU), else 1."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        cpu = str(device) == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if cpu else "nccl")
    return world


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--moe-dispatch", default="scatter")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--device", default="auto",
                    help="'auto' (cuda:0; raises without a GPU) or 'cpu'")
    ap.add_argument("--impl", default="auto",
                    help="the loss's backend: 'auto' (the card's), 'cuda' or 'ref'")
    args = ap.parse_args(argv)

    world = _world(args.device)
    if world > 1:
        dev = rank_device(args.device)
    else:
        dev = backends.resolve_device(args.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, args.moe_dispatch)
    shape = ShapeConfig("driver", "train", args.seq, args.batch)
    mesh = make_mesh_for(world, device=dev) if world > 1 else None
    sharder = Sharder(mesh, args.batch)
    lead = mesh is None or mesh.index == 0
    if mesh is not None and lead:
        print(f"[train] mesh {dict(mesh.shape)} of {world} ranks "
              f"({mesh.backend}), batch axes {sharder.axes('batch')}")

    step_fn = make_train_step(model, OptConfig(lr=args.lr, schedule="cosine",
                                               warmup_steps=10,
                                               total_steps=max(args.steps, 100),
                                               clip_norm=1.0),
                              sharder, impl=args.impl,
                              microbatches=args.microbatches,
                              grad_compress=args.grad_compress)

    # every rank draws the same init, each leaf cut to its blocks as it is
    # drawn; the checkpoints' placements come from the global shapes
    params = model.init(0, device=dev, sharder=sharder)
    opt_state = step_fn.optimizer.init(params)
    specs = model.param_specs()
    places = held_shardings((specs, step_fn.optimizer.init(specs)), cfg, sharder) \
        if mesh else None
    start = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last=3, mesh=mesh)
        if args.resume and mgr.latest_step() is not None:
            (params, opt_state), meta = mgr.restore((params, opt_state),
                                                    shardings=places)
            start = int(meta.get("train_step", mgr.latest_step()))
            if lead:
                print(f"[train] resumed from step {start}")

    dims = batch_dims(model)
    history = []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = batch_block(synth_batch(model, shape, i, dev), sharder, dims)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (i + 1) % args.log_every == 0 or i == start:
            loss = float(metrics["loss"])
            history.append({"step": i + 1, "loss": loss})
            if lead:
                print(f"[train] step {i+1:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0)/(i-start+1):.2f}s/step)")
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, (params, opt_state),
                     metadata={"train_step": i + 1,
                               "loss": float(metrics["loss"])}, shardings=places)
    if mgr is not None:
        mgr.save(args.steps, (params, opt_state),
                 metadata={"train_step": args.steps}, blocking=True,
                 shardings=places)
    result = {"arch": args.arch, "steps": args.steps, "history": history,
              "final_loss": history[-1]["loss"] if history else None}
    if lead:
        print(json.dumps({"final": result["final_loss"], "steps": args.steps}))
    return result


if __name__ == "__main__":
    main()
