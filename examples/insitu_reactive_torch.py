"""End-to-end reactive in situ driver of the PyTorch / CUDA port (the
paper's headline use case; the lifecycle of ``examples/insitu_reactive.py``).

A CloverLeaf-like simulation runs for 24 visualization steps. A DIVA-style
reactive graph watches the published field:

  - DVNR compression happens lazily (only when some consumer demands it);
  - a sliding window caches the last 6 timesteps as *compressed models*;
  - a data-driven trigger (shock front reaches mid-domain) fires a
    volume-render of the CURRENT step AND a look-back over the cached window.

On the card::

  PYTHONPATH=src python examples/insitu_reactive_torch.py

On the CPU::

  PYTHONPATH=src python examples/insitu_reactive_torch.py --device cpu --backend ref
"""
import argparse

import torch

from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.insitu import InSituSession, SimulationConfig
from repro_torch.insitu.actions import render_action
from repro_torch.reactive.dvnr import DVNRValue


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="auto", help="auto (the card) or cpu")
    ap.add_argument("--backend", default="auto", help="auto, cuda or ref")
    ap.add_argument("--steps", type=int, default=24,
                    help="visualization steps of the simulation")
    args = ap.parse_args(argv)

    dvnr_cfg = DVNRConfig(n_levels=3, n_features_per_level=2,
                          log2_hashmap_size=9, base_resolution=6,
                          n_neurons=16, n_hidden_layers=1, epochs=3,
                          batch_size=2048, n_train_min=48)
    sess = InSituSession(
        SimulationConfig("cloverleaf", n_ranks=4, local_shape=(20, 20, 20),
                         dt=0.03),
        dvnr_cfg, window=6, compress=True, impl=args.backend,
        device=args.device)

    frames = {}

    def on_shock(tick):
        # render the current step straight from the DVNR (no decode)
        frames[tick] = sess.render_now(width=48, height=48, n_samples=24,
                                       impl=args.backend)
        # and re-render the cached history (reactive look-back)
        for j, past in enumerate(sess.window.values()):
            if isinstance(past, DVNRValue):
                frames[f"{tick}-hist{j}"] = render_action(
                    past, width=48, height=48, n_samples=24, impl=args.backend)
        print(f"  [trigger] tick {tick}: rendered current + "
              f"{len(sess.window.values())} cached steps")

    # indicator: the expanding shock shell occupies >8% of the domain
    def shock_frac(parts):
        frac = float(torch.stack([(p.data > 3.0).float().mean()
                                  for p in parts]).mean())
        return frac > 0.08

    sess.add_trigger("shock_mid", shock_frac, [on_shock])

    recs = sess.run(args.steps)
    trained = sum(r.dvnr_trained for r in recs)
    fired = [r.cycle for r in recs if r.fired.get("shock_mid")]
    print(f"\n{args.steps} steps: DVNR trained on {trained} "
          f"(lazy: window demands it each step)")
    print(f"trigger fired at cycles {fired}")
    last = recs[-1]
    print(f"cache: {last.cache_len} models, {last.cache_bytes} B "
          f"(raw grids would need {last.raw_equiv_bytes} B -> "
          f"{last.raw_equiv_bytes/max(last.cache_bytes,1):.0f}x saving)")
    print(f"rendered {len(frames)} frames total")
    return {"trained": trained, "fired": fired, "frames": len(frames),
            "saving": last.raw_equiv_bytes / max(last.cache_bytes, 1)}


if __name__ == "__main__":
    main()
