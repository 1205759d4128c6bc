"""Structural sanitization of published partitions.

The port of ``repro.resilience.runtime``. The stacked trainer needs a
(P, nx, ny, nz)-shapeable batch; a dropped rank (``None`` in the published
list), a short list, or a truncated / wrong-shaped partition would fail the
stack before training starts. :func:`sanitize_partitions` repairs the
structure deterministically:

- the healthy majority defines the expected data shape;
- a degraded slot is stood in for by the *previous tick's* clean partition
  when the caller kept one, else by a zero volume on the healthy
  partitions' device with the box placement rebuilt from the rank index;
- the degraded indices are reported so the caller can mask them out of
  training (``api.train(train_mask=)``): their INRs then hold the
  weight-cache warm start (the paper's §III-E restore path).

NaN/Inf *values* are not scrubbed here: a well-shaped partition with
poisoned voxels flows into training, where the non-finite detector and
:class:`repro_torch.resilience.RecoveryPolicy` handle it.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.data.volume import VolumePartition, partition_grid


def _placeholder(rank: int, n_partitions: int, shape, ghost: int,
                 device) -> VolumePartition:
    """Zero volume on ``device`` with the rank's box placement rebuilt from
    the canonical near-cubic decomposition (the synthetic simulation's)."""
    px, py, pz = partition_grid(n_partitions)
    ix = rank % px
    iy = (rank // px) % py
    iz = rank // (px * py)
    ext = (1.0 / px, 1.0 / py, 1.0 / pz)
    org = (ix * ext[0], iy * ext[1], iz * ext[2])
    return VolumePartition(torch.zeros(shape, dtype=torch.float32, device=device),
                           org, ext, ghost, 0.0, 1.0)


def sanitize_partitions(parts: Sequence, n_partitions: int, *,
                        template: Optional[Sequence] = None
                        ) -> Tuple[List[VolumePartition], Tuple[int, ...]]:
    """Repair a published partition list to exactly ``n_partitions`` healthy-
    shaped entries. Returns ``(clean_parts, degraded_ranks)``.

    ``template`` is the previous tick's clean list (same length); a degraded
    rank prefers its template entry over a zero placeholder. Raises only when
    every rank is degraded AND no template exists: there is no shape to
    rebuild from.
    """
    parts = list(parts) if parts is not None else []
    parts += [None] * (n_partitions - len(parts))
    parts = parts[:n_partitions]

    shapes = Counter(tuple(p.data.shape) for p in parts if p is not None)
    if shapes:
        expect = shapes.most_common(1)[0][0]
    elif template is not None and any(t is not None for t in template):
        expect = tuple(next(t for t in template if t is not None).data.shape)
    else:
        raise ValueError("every published partition is degraded and no "
                         "template from a previous tick exists")

    healthy = [p for p in parts if p is not None and tuple(p.data.shape) == expect]
    ghost = next((p.ghost for p in healthy),
                 next((t.ghost for t in (template or []) if t is not None), 1))
    device = next((p.data.device for p in healthy),
                  next((t.data.device for t in (template or []) if t is not None),
                       None))
    degraded, clean = [], []
    for r in range(n_partitions):
        p = parts[r]
        if p is not None and tuple(p.data.shape) == expect:
            clean.append(p)
            continue
        degraded.append(r)
        t = (template[r] if template is not None and r < len(template)
             else None)
        if t is not None and tuple(t.data.shape) == expect:
            clean.append(t)
        else:
            clean.append(_placeholder(r, n_partitions, expect, ghost, device))
    return clean, tuple(degraded)
