"""Batched render service: many concurrent clients, one batched render per
group per tick, in front of a shared brick cache.

The port of ``repro.serving.service``. Clients :meth:`RenderService.submit`
:class:`repro_torch.api.RenderRequest` s and get a ticket back; each
:meth:`RenderService.tick` groups the pending requests by their
shape-static fields (width/height/samples/fov/LOD/timestep/TF
shape/density/dtypes) and renders each group as ONE batched call over the
clients' cameras and transfer-function tables (the JAX package ``vmap``s the
frame program over clients; here the clients are a leading axis of every
tensor). Value samples come from the
:class:`~repro_torch.serving.cache.BrickCache` (warm bricks are reused
across frames and clients; ``use_cache=False`` runs INR inference per
sample instead), and requests for historical ``timestep`` s decode weights
out of a :class:`~repro_torch.core.temporal.TemporalModelCache` with a small
warm-model LRU in front.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch.core.render import (_render_distributed,
                                     _render_distributed_sampled,
                                     rays_from_arrays)
from repro_torch.serving.cache import BrickCache


def batched_frame_program(cfg, *, fov: float, width: int, height: int,
                          n_samples: int, density: float,
                          compute_dtype=None, out_dtype=None, backend=None,
                          cached: bool = True, view_geom=None):
    """The one-tick frame program of a group: ``fn(eyes, centers, ups,
    tf_tables, pool, slots, metas, grange, stacked_params)`` with
    eyes/centers/ups (C, 3) and tf_tables (C, K, 4) -> frames (C, H, W, 4).

    ``cached=True`` samples the :class:`BrickCache` pool (``view_geom`` =
    ``(grid_shape, brick_edge)`` of the cache view; ``params`` unused);
    ``cached=False`` renders through INR inference (``pool``/``slots``
    unused)."""
    def frames(eyes, centers, ups, tf_tables, pool, slots, metas, grange,
               params):
        rays = rays_from_arrays(eyes, centers, ups, fov, width, height)
        if cached:
            grid_shape, brick_edge = view_geom
            return _render_distributed_sampled(
                pool, slots, grid_shape, brick_edge, metas, None, width,
                height, grange, n_samples=n_samples, impl=backend,
                tf_table=tf_tables, density=density,
                compute_dtype=compute_dtype, out_dtype=out_dtype, rays=rays)
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
    tick, in front of a shared brick cache.

    Construct with either a live ``model`` (a
    :class:`repro_torch.api.DVNRModel` with ``parts_meta``) or a
    ``temporal`` :class:`~repro_torch.core.temporal.TemporalModelCache` plus
    the ``cfg``/``parts_meta`` needed to rebuild models from cached weights;
    both may be given (requests with ``timestep=None`` hit the live model).
    ``use_cache=False`` renders through INR inference. Frames are rendered
    on the device the models live on (the live model's, else the temporal
    cache's); a default cache (``cache_kw``) is allocated there.
    """

    def __init__(self, model=None, *, temporal=None, cfg=None, parts_meta=None,
                 grange=None, cache: Optional[BrickCache] = None,
                 use_cache: bool = True, backend: backends.BackendLike = "auto",
                 cache_kw: Optional[dict] = None, max_warm_models: int = 4):
        from repro_torch import api

        if model is None and temporal is None:
            raise ValueError("RenderService needs a model and/or a temporal "
                             "TemporalModelCache")
        if model is not None and model.parts_meta is None:
            raise ValueError("RenderService model needs parts_meta (train via "
                             "repro_torch.api.train or attach PartitionMeta)")
        self.model = model
        self.temporal = temporal
        self.cfg = model.cfg if model is not None else cfg
        if self.cfg is None:
            raise ValueError("temporal-only RenderService needs cfg=")
        self._parts_meta = (model.parts_meta if model is not None
                            else api._meta_tuple(parts_meta))
        if self._parts_meta is None:
            raise ValueError("temporal-only RenderService needs parts_meta=")
        if grange is None:
            grange = model.grange if model is not None else \
                api._grange_of(self._parts_meta)
        self._grange = grange
        self.backend = backends.resolve(backend)
        self.device = model.device if model is not None else temporal.device
        self.use_cache = use_cache
        self.cache = cache if cache is not None else \
            BrickCache(self.cfg, backend=self.backend, device=self.device,
                       **(cache_kw or {}))
        self._warm: "OrderedDict[int, Any]" = OrderedDict()  # ts -> DVNRModel
        self.max_warm_models = max_warm_models
        self._pending: List[tuple] = []                    # (ticket, request)
        self._next_ticket = 0
        self._tick = 0
        self.ticks: List[dict] = []

    # ------------------------------ models ------------------------------ #
    def model_for(self, timestep: Optional[int]):
        """The DVNRModel serving ``timestep`` (None -> the live model).
        Historical timesteps decode out of the temporal cache once and stay
        warm in a small LRU: repeated requests hit warm weights."""
        from repro_torch import api

        if timestep is None:
            if self.model is None:
                raise ValueError("request has timestep=None but the service "
                                 "has no live model")
            return self.model
        ts = int(timestep)
        if ts in self._warm:
            self._warm.move_to_end(ts)
            return self._warm[ts]
        if self.temporal is None:
            if self.model is not None:
                return self.model   # single-model service ignores timestep
            raise KeyError(f"timestep {ts}: no temporal cache attached")
        params = self.temporal.stacked_params(ts)
        m = api.DVNRModel(self.cfg, params, self._parts_meta, self._grange)
        self._warm[ts] = m
        while len(self._warm) > self.max_warm_models:
            self._warm.popitem(last=False)
        return m

    @property
    def warm_timesteps(self) -> list:
        return list(self._warm)

    # ------------------------------ requests ---------------------------- #
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

    # ------------------------------ batching ---------------------------- #
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
            (W, H, S, fov, lod, ts, _tfk, density, cdt, odt) = key
            model = self.model_for(ts)
            dev = model.device
            view = None
            if self.use_cache:
                view = self.cache.ensure(model, level=lod, timestep=ts)
            reqs = [m[1] for m in members]
            eyes = torch.tensor([r.camera.eye for r in reqs], dtype=torch.float32,
                                device=dev)
            ctrs = torch.tensor([r.camera.center for r in reqs],
                                dtype=torch.float32, device=dev)
            ups = torch.tensor([r.camera.up for r in reqs], dtype=torch.float32,
                               device=dev)
            tfs = torch.stack([r.tf.resolved_table(dev) for r in reqs])
            grange = torch.tensor(model.grange, dtype=torch.float32, device=dev)
            fn = batched_frame_program(
                self.cfg, fov=fov, width=W, height=H, n_samples=S,
                density=density, compute_dtype=cdt, out_dtype=odt,
                backend=self.backend, cached=view is not None,
                view_geom=(None if view is None
                           else (view.grid_shape, view.brick_edge)))
            t0 = time.monotonic()
            frames = fn(eyes, ctrs, ups, tfs,
                        None if view is None else view.pool,
                        None if view is None else view.slots,
                        model.meta_arrays(), grange,
                        None if view is not None else model.stacked_params())
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
        self.ticks.append({
            "tick": self._tick, "requests": len(pending),
            "groups": len(groups), "cache": self.cache.stats(),
        })
        responses.sort(key=lambda r: r.ticket)
        return responses

    def stats(self) -> dict:
        return {"ticks": self._tick, "served": self._next_ticket,
                "pending": len(self._pending),
                "warm_models": len(self._warm), "cache": self.cache.stats()}
