"""Ascent-style actions expressed as DIVA operators (paper §IV-D).

The port of ``repro.insitu.actions``. An action list is a declarative
pipeline the session executes per cycle; each action either consumes the
raw published field or a DVNR node:
  - ``compress``   train DVNR for a field (lazy; runs only if demanded)
  - ``render``     sort-last direct volume rendering from the DVNR
  - ``isosurface`` marching-tets extraction from the DVNR
  - ``window``     temporal sliding-window caching of DVNR models
  - ``pathlines``  backward pathline tracing over the window

Each runs on the device its model lives on. One deliberate difference from
JAX: ``impl`` defaults to ``"auto"`` (the card's kernels), where the JAX
package defaults to its ``ref`` backend.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Any, Dict

import torch

from repro_torch import api, backends
from repro_torch.reactive.dvnr import DVNRValue


@dataclass
class Action:
    kind: str                         # compress | render | isosurface | window | pathlines
    field: str
    params: Dict[str, Any] = dfield(default_factory=dict)


def render_action(value: DVNRValue, *, width: int = 128, height: int = 128,
                  eye=(1.8, 1.4, 1.6), n_samples: int = 48,
                  impl: backends.BackendLike = "auto") -> torch.Tensor:
    """Direct volume rendering straight from the DVNR (no decoding)."""
    req = api.RenderRequest(camera=api.Camera(eye=tuple(eye)), width=width,
                            height=height, n_samples=n_samples)
    return api.render(value.model, req, backend=impl)


def isosurface_action(value: DVNRValue, *, iso01: float = 0.5,
                      resolution: int = 32,
                      impl: backends.BackendLike = "auto"):
    """Per-partition marching tets on the INR; returns world-space points."""
    return api.isosurface(value.model, iso01, resolution=resolution,
                          backend=impl)


def compress_action(value: DVNRValue, **codec_kw) -> list:
    """Per-partition compressed weight blobs of the tick's DVNR. Reuses the
    blobs the dvnr_node already produced when available, so demanding the
    action twice never recompresses."""
    if value.compressed is not None and not codec_kw:
        return value.compressed
    return value.model.compress(**codec_kw)


def pathlines_action(values, seeds, dt: float, *, substeps: int = 4,
                     impl: backends.BackendLike = "auto"):
    """Backward pathline tracing over a temporal window of velocity
    DVNRValues in SlidingWindow buffer order (oldest -> newest, as produced
    by ``window.value()``); reversed here to the newest-first order
    :func:`repro_torch.api.trace_pathlines` expects."""
    return api.trace_pathlines([v.model for v in reversed(values)], seeds, dt,
                               substeps=substeps, backend=impl)
