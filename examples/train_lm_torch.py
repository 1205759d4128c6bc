"""Train a small LM from the architecture zoo with the PyTorch port.

The port's counterpart of ``examples/train_lm.py``: config -> model ->
AdamW + cosine schedule -> the train step (microbatches of 2) -> atomic
async checkpoints -> resume, through ``repro_torch.launch.train``. The
default config is the 2-layer, d=64 Llama-style SMOKE config; pass
``--steps 300`` for a longer run.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 60
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --impl ref

It runs on the GPU; ``--device cpu --impl ref`` trains through the plain
PyTorch versions on the CPU instead.
"""
import argparse

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default="build/train_lm_torch")
    ap.add_argument("--device", default="auto")
    ap.add_argument("--impl", default="auto")
    args = ap.parse_args(argv)

    result = train_mod.main([
        "--arch", "llama3_8b", "--smoke",      # the SMOKE config
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "256",
        "--lr", "6e-4", "--microbatches", "2",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--resume", "--log-every", "10",
        "--device", args.device, "--impl", args.impl,
    ])
    h = result["history"]
    print(f"\nloss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} over "
          f"{result['steps']} steps (checkpoints in {args.ckpt_dir})")
    return result


if __name__ == "__main__":
    main()
