"""Quickstart of the PyTorch / CUDA port: compress one distributed volume
with DVNR and look at it, entirely through the ``repro_torch.api`` facade
(the lifecycle of ``examples/quickstart.py``):

  1. generate a 2-partition synthetic volume (each partition has ghost cells),
  2. train one INR per partition, with no communication between them,
  3. report PSNR / compression ratio (with model compression),
  4. render the distributed representation (sort-last compositing),
  5. decode back to a grid (the legacy-tools compatibility path),
  6. save / reload the model.

On the card (the CUDA kernels)::

  PYTHONPATH=src python examples/quickstart_torch.py

On the CPU (the plain PyTorch versions)::

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --backend ref
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch import api, backends
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.metrics import psnr
from repro_torch.data.volume import make_partition


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="auto", help="auto (the card) or cpu")
    ap.add_argument("--backend", default="auto", help="auto, cuda or ref")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default: the paper's III-B count)")
    args = ap.parse_args(argv)

    # -- 1. a distributed volume: 2 ranks, 24^3 voxels each, 1 ghost layer --
    grid, local = (1, 1, 2), (24, 24, 24)
    parts = [make_partition("cloverleaf", r, grid, local, t=0.35,
                            device=args.device) for r in range(2)]
    raw = 2 * int(np.prod(local)) * 4
    print(f"volume: 2 partitions x {local} (+ghosts), {raw} bytes raw; "
          f"backend={backends.resolve(args.backend).name}")

    # -- 2. train (paper III-A/B/C: per-rank INR, boundary loss, adaptive) --
    cfg = DVNRConfig(n_levels=3, n_features_per_level=4, log2_hashmap_size=9,
                     base_resolution=8, n_neurons=16, n_hidden_layers=2,
                     epochs=10, batch_size=4096, n_train_min=200,
                     boundary_lambda=0.15, boundary_sigma=0.005)
    model, info = api.train(parts, cfg, backend=args.backend, key=0,
                            steps=args.steps)
    print(f"trained {info['steps']} steps in {info['train_time_s']:.1f}s "
          f"({model.n_partitions} partitions, "
          f"{model.param_count} params, {model.nbytes} bytes)")

    # -- 3. model compression (paper III-D) --------------------------------
    blobs, cinfo = api.compress(model)
    f16 = cinfo["f16_bytes"]
    print(f"compression ratio: {raw/f16:.1f}x (model f16) -> "
          f"{raw/cinfo['bytes']:.1f}x (with model compression)")

    # -- 4. render the DVNR directly (paper IV-C) ---------------------------
    img = api.render(model, api.RenderRequest(
        camera=api.Camera(eye=(1.8, 1.4, 1.6)), width=64, height=64,
        n_samples=48), backend=args.backend)
    print(f"rendered {tuple(img.shape)} frame, mean alpha "
          f"{float(img[..., 3].mean()):.3f}")

    # -- 5. decode one partition back to a grid -----------------------------
    rec = api.decompress(cfg, blobs, parts_meta=parts, device=model.device)
    dec = rec.partition(0).decode_grid(local, backend=args.backend)
    g = parts[0].ghost
    ref = parts[0].normalized()[g:-g, g:-g, g:-g]
    print(f"decoded grid {tuple(dec.shape)}, PSNR vs reference "
          f"{float(psnr(dec[..., 0] if dec.ndim == 4 else dec, ref)):.1f} dB")

    # -- 6. save / reload ---------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "dvnr_model.msgpack"
        model.save(path)
        loaded = api.load(path, device=model.device)
        print(f"saved+reloaded model: {path.stat().st_size} bytes on disk, "
              f"{loaded.n_partitions} partitions")
    print("done.")
    return {"psnr": float(psnr(dec[..., 0] if dec.ndim == 4 else dec, ref)),
            "ratio": raw / cinfo["bytes"], "alpha": float(img[..., 3].mean())}


if __name__ == "__main__":
    main()
