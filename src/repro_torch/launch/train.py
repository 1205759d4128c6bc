"""End-to-end LM training driver: the port of ``repro.launch.train``.

Trains any zoo architecture on one card with the JAX driver's flags,
returned dict and final JSON line: the model from its config, AdamW with a
cosine schedule (10 warm-up steps) and clipping at 1.0 (``make_train_step``),
optional microbatches and int8 error-feedback gradient compression, atomic
async checkpoints every ``--ckpt-every`` steps and a resume from the newest
(``--resume``). The checkpoints are the JAX package's layout, so either
package resumes the other's.

It runs on ``cuda:0``. Where more than one card is visible the JAX driver
builds a mesh; the port has no sharded LM execution yet (ROADMAP item 16),
so it trains on one card and says so. ``--device cpu`` with ``--impl ref``
(or ``cuda``: the kernel wrappers' plain versions) runs on the CPU, which
the tests use; ``--device`` and ``--impl`` default to ``auto``, which raise
without a GPU rather than falling back to the CPU.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --steps 50 --batch 8 --seq 1024 --ckpt-dir ck --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \\
      --steps 20 --device cpu --impl ref
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import backends
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.parallel.sharding import Sharder
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

    dev = backends.resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"[train] {torch.cuda.device_count()} cards visible: training on "
              f"{dev} alone (sharded LM execution is ROADMAP item 16)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, args.moe_dispatch)
    shape = ShapeConfig("driver", "train", args.seq, args.batch)
    sharder = Sharder(None, args.batch)

    step_fn = make_train_step(model, OptConfig(lr=args.lr, schedule="cosine",
                                               warmup_steps=10,
                                               total_steps=max(args.steps, 100),
                                               clip_norm=1.0),
                              sharder, impl=args.impl,
                              microbatches=args.microbatches,
                              grad_compress=args.grad_compress)

    params = model.init(0, device=dev)
    opt_state = step_fn.optimizer.init(params)
    start = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last=3)
        if args.resume and mgr.latest_step() is not None:
            (params, opt_state), meta = mgr.restore((params, opt_state))
            start = int(meta.get("train_step", mgr.latest_step()))
            print(f"[train] resumed from step {start}")

    history = []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = synth_batch(model, shape, i, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (i + 1) % args.log_every == 0 or i == start:
            loss = float(metrics["loss"])
            history.append({"step": i + 1, "loss": loss})
            print(f"[train] step {i+1:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)")
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, (params, opt_state),
                     metadata={"train_step": i + 1,
                               "loss": float(metrics["loss"])})
    if mgr is not None:
        mgr.save(args.steps, (params, opt_state),
                 metadata={"train_step": args.steps}, blocking=True)
    result = {"arch": args.arch, "steps": args.steps, "history": history,
              "final_loss": history[-1]["loss"] if history else None}
    print(json.dumps({"final": result["final_loss"], "steps": args.steps}))
    return result


if __name__ == "__main__":
    main()
