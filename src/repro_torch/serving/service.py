"""Batched render service: many concurrent clients, one batched render per
group per tick.

The port of ``repro.serving.service``'s uncached path. Clients
:meth:`RenderService.submit` :class:`repro_torch.api.RenderRequest` s and get
a ticket back; each :meth:`RenderService.tick` groups the pending requests by
their shape-static fields (width/height/samples/fov/LOD/timestep/TF
shape/density/dtypes) and renders each group as ONE batched call over the
clients' cameras and transfer-function tables (the JAX package ``vmap``s the
frame program over clients; here the clients are a leading axis of every
tensor, so one hash-encode, one MLP and one compositing launch serve the
whole group). The brick-cache path (``use_cache=True``) and the temporal
model cache come with the BrickCache slice.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch.core.render import _render_distributed, rays_from_arrays


def batched_frame_program(cfg, *, fov: float, width: int, height: int,
                          n_samples: int, density: float,
                          compute_dtype=None, out_dtype=None, backend=None):
    """The one-tick frame program of a group: ``fn(eyes, centers, ups,
    tf_tables, metas, grange, stacked_params)`` with eyes/centers/ups
    (C, 3) and tf_tables (C, K, 4) -> frames (C, H, W, 4)."""
    def frames(eyes, centers, ups, tf_tables, metas, grange, params):
        rays = rays_from_arrays(eyes, centers, ups, fov, width, height)
        return _render_distributed(
            cfg, params, None, None, width, height, grange,
            n_samples=n_samples, impl=backend, tf_table=tf_tables,
            density=density, compute_dtype=compute_dtype,
            out_dtype=out_dtype, metas=metas, rays=rays)

    return frames


@dataclass(frozen=True, eq=False)
class RenderResponse:
    """One served frame plus enough context to route it back to its client."""

    ticket: int
    request: Any
    frame: np.ndarray               # (H, W, 4) f32 (or request.out_dtype)
    timestep: Optional[int]
    tick: int
    batch_size: int                 # how many requests shared this program
    render_ms: float                # wall time of the whole batch


class RenderService:
    """Coalesces concurrent requests into one batched render per group per
    tick, on the device the ``model`` lives on.

    ``use_cache=True`` (brick-cache sampling) raises ``NotImplementedError``
    in this slice: frames come from direct INR inference."""

    def __init__(self, model, *, grange=None, use_cache: bool = False,
                 backend: backends.BackendLike = "auto"):
        if use_cache:
            raise NotImplementedError(
                "RenderService(use_cache=True) needs the BrickCache slice "
                "(repro_torch.serving.cache), which is not ported yet; pass "
                "use_cache=False to render through INR inference")
        if model.parts_meta is None:
            raise ValueError("RenderService model needs parts_meta")
        self.model = model
        self.cfg = model.cfg
        self._grange = model.grange if grange is None else grange
        self.backend = backends.resolve(backend)
        self._pending: List[tuple] = []
        self._next_ticket = 0
        self._tick = 0

    def submit(self, request) -> int:
        """Queue a request; returns the ticket its response will carry."""
        t = self._next_ticket
        self._next_ticket += 1
        self._pending.append((t, request))
        return t

    @property
    def pending(self) -> int:
        return len(self._pending)

    def render(self, request) -> np.ndarray:
        """Convenience single-request path: submit + tick, return the frame."""
        ticket = self.submit(request)
        for resp in self.tick():
            if resp.ticket == ticket:
                return resp.frame
        raise RuntimeError("unreachable: submitted request not in tick")

    @staticmethod
    def _group_key(req) -> tuple:
        # everything that fixes tensor shapes; cameras and TF tables vary
        # within a group (they are the batched axis)
        return (req.width, req.height, req.n_samples, req.camera.fov_deg,
                req.lod, req.timestep, req.tf.table_shape, req.tf.density,
                req.compute_dtype, req.out_dtype)

    def tick(self) -> List[RenderResponse]:
        """Render every pending request (one batched call per group) and
        return the responses, submission-ordered."""
        pending, self._pending = self._pending, []
        self._tick += 1
        groups: "OrderedDict[tuple, list]" = OrderedDict()
        for ticket, req in pending:
            groups.setdefault(self._group_key(req), []).append((ticket, req))
        responses: List[RenderResponse] = []
        for key, members in groups.items():
            # a single-model service serves every timestep from its live
            # model, as the JAX service does
            (W, H, S, fov, _lod, ts, _tfk, density, cdt, odt) = key
            model = self.model
            dev = model.device
            reqs = [m[1] for m in members]
            eyes = torch.tensor([r.camera.eye for r in reqs], dtype=torch.float32,
                                device=dev)
            ctrs = torch.tensor([r.camera.center for r in reqs],
                                dtype=torch.float32, device=dev)
            ups = torch.tensor([r.camera.up for r in reqs], dtype=torch.float32,
                               device=dev)
            tfs = torch.stack([r.tf.resolved_table(dev) for r in reqs])
            grange = torch.tensor(self._grange, dtype=torch.float32, device=dev)
            fn = batched_frame_program(
                self.cfg, fov=fov, width=W, height=H, n_samples=S,
                density=density, compute_dtype=cdt, out_dtype=odt,
                backend=self.backend)
            t0 = time.monotonic()
            frames = fn(eyes, ctrs, ups, tfs, model.meta_arrays(), grange,
                        model.stacked_params())
            if frames.is_cuda:
                torch.cuda.synchronize(dev)
            ms = (time.monotonic() - t0) * 1e3
            # numpy has no bfloat16: a bf16 frame is handed out widened to f32
            arr = (frames.float() if frames.dtype == torch.bfloat16
                   else frames).cpu().numpy()
            for i, (ticket, req) in enumerate(members):
                responses.append(RenderResponse(
                    ticket=ticket, request=req, frame=arr[i], timestep=ts,
                    tick=self._tick, batch_size=len(members), render_ms=ms))
        responses.sort(key=lambda r: r.ticket)
        return responses

    def stats(self) -> dict:
        return {"ticks": self._tick, "served": self._next_ticket,
                "pending": len(self._pending), "cache": None}
