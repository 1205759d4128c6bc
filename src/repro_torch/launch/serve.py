"""Render-service entry point: serve a camera orbit to concurrent clients through
:class:`repro_torch.serving.RenderService` and report the brick cache's hit
rate and frame latency.

The model comes from ``--model PATH`` (a msgpack saved by either package's
``DVNRModel.save``) or, without one, is trained first from ``--seed``: the
SMOKE config over the two partitions of a synthetic CloverLeaf volume, as
the JAX package's ``repro.launch.serve`` does:

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --model dvnr.msgpack \\
      --clients 4 --width 256 --height 256 --n-samples 64

Each tick submits one request per client (cameras spread along a fixed
horizontal orbit), so ``--clients N`` exercises the batched path. Frames
sample a brick cache of ``--grid``^3 voxels a partition in bricks of
``--brick-edge``; ``--no-cache`` renders the same requests through INR
inference instead. Runs on the GPU; ``--device cpu --backend ref`` serves
through the plain PyTorch versions on the CPU instead.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed setup (SMOKE config, 2 partitions)")
    ap.add_argument("--model", default=None,
                    help="msgpack of a saved DVNRModel (either package)")
    ap.add_argument("--seed", type=int, default=0,
                    help="training key of the model (when no --model)")
    ap.add_argument("--frames", type=int, default=16,
                    help="orbit frames (ticks) to serve")
    ap.add_argument("--clients", type=int, default=2,
                    help="concurrent requests per tick")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--n-samples", type=int, default=32)
    ap.add_argument("--grid", type=int, default=24,
                    help="brick-cache decode resolution per partition")
    ap.add_argument("--brick-edge", type=int, default=8)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--no-cache", action="store_true",
                    help="serve through INR inference instead")
    ap.add_argument("--device", default="auto")
    args = ap.parse_args(argv)
    if args.smoke:
        args.frames, args.clients = min(args.frames, 6), min(args.clients, 2)
        args.width = args.height = min(args.width, 48)
        args.n_samples, args.grid = min(args.n_samples, 16), min(args.grid, 16)

    from repro_torch import api
    from repro_torch.configs.dvnr import SMOKE
    from repro_torch.data.volume import make_partition
    from repro_torch.serving import RenderService

    train_s = 0.0
    if args.model is not None:
        model = api.load(args.model, device=args.device)
    else:
        parts = [make_partition("cloverleaf", p, (1, 1, 2), (16, 16, 16),
                                t=0.3, device=args.device) for p in range(2)]
        t0 = time.perf_counter()
        model, _ = api.train(parts, SMOKE, key=args.seed, backend=args.backend)
        train_s = time.perf_counter() - t0

    svc = RenderService(model, backend=args.backend,
                        use_cache=not args.no_cache,
                        cache_kw=dict(grid_shape=(args.grid,) * 3,
                                      brick_edge=args.brick_edge))
    cam = api.Camera()
    tick_ms, checksum = [], 0.0
    for f in range(args.frames):
        for c in range(args.clients):
            angle = 2 * np.pi * (f + c / args.clients) / args.frames
            svc.submit(api.RenderRequest(
                camera=cam.orbit(angle), width=args.width, height=args.height,
                n_samples=args.n_samples))
        t0 = time.perf_counter()
        responses = svc.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if len(responses) != args.clients:
            raise SystemExit(f"tick {f}: {len(responses)} responses for "
                             f"{args.clients} requests")
        for r in responses:
            if not np.isfinite(r.frame).all():
                raise SystemExit(f"non-finite frame at tick {f}")
            checksum += float(r.frame.mean())

    stats = svc.stats()
    warm = tick_ms[1:] if len(tick_ms) > 1 else tick_ms
    result = {
        "mode": "uncached" if args.no_cache else "cached",
        "backend": svc.backend.name,
        "train_s": train_s,
        "device": str(model.device), "partitions": model.n_partitions,
        "frames": args.frames, "clients": args.clients,
        "width": args.width, "height": args.height,
        "n_samples": args.n_samples,
        "first_tick_ms": tick_ms[0],
        "warm_tick_ms_median": float(np.median(warm)),
        "cache_hit_rate": stats["cache"]["hit_rate"],
        "cache_pool_bytes": stats["cache"]["pool_bytes"],
        "served": stats["served"],
        "checksum": checksum / max(stats["served"], 1),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
