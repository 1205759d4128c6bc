"""Device-resident brick cache in front of INR inference (cINR, arxiv
2504.18001): the port of ``repro.serving.cache``.

Rendering a DVNR directly pays one INR inference per ray sample; across an
interactive exploration most of those samples land in regions whose decoded
values have not changed since the previous frame. The :class:`BrickCache`
decodes the model ONCE into fixed-size bricks (cell-centered grids with a
one-voxel overlap row, so each brick is self-contained for trilinear
interpolation) and keeps them in a fixed-budget device pool; the cache-aware
render path (:func:`repro_torch.core.render.sample_bricks`) then replaces
per-sample INR inference with an 8-corner gather from the pool.

Keys are ``(level, brick_index, timestep)``:

- ``level``       multi-resolution LOD — level ``l`` decodes the grid at
                  ``ceil(shape / 2**l)`` (coarser bricks for distant views);
- ``brick_index`` a single linear id over ``partition x brick-grid`` (the
                  partition is recoverable as ``index // bricks_per_level``);
- ``timestep``    the temporal-cache timestep the decoded weights came from
                  (``None`` -> the live model, stored as -1).

Eviction is novelty-prioritized LRU: when the pool is full, the least-
recently-used brick belonging to a *stale* timestep (one not being requested)
is evicted first, then plain LRU order; bricks of the current working set are
never evicted. Freshly filled bricks are marked most-recently-used. The
bookkeeping is host-side and the JAX package's, step for step (the same
event trace and stats); the pool is one device tensor whose size is fixed at
construction and which fills write in place — the closed-form ``pool_bytes``
is its whole device-memory bill. Fills run the INR through
:func:`repro_torch.core.inr._inr_apply`, so on the ``cuda`` backend each
fill chunk is one launch of the INR inference kernel.

Not ported: JAX's ``decode_vmem_closed_form`` / ``decode_vmem_footprint``,
models of the Pallas decode's TPU VMEM blocks with no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import backends
from repro_torch.backends import resolve_device
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import _inr_apply
from repro_torch.precision import torch_dtype

Key = Tuple[int, int, int]          # (level, brick_index, timestep)
_NO_TIMESTEP = -1
#: points decoded per INR launch in a fill (the decode's chunk)
FILL_POINTS = 1 << 22


@dataclass(frozen=True, eq=False)
class CacheView:
    """One consistent snapshot of the cache for a render call: the pool plus
    the (P, nbx, nby, nbz) brick->slot map of every partition at one
    (level, timestep)."""

    pool: Any                       # (n_slots, E, E, E) device tensor
    slots: Any                      # (P, nbx, nby, nbz) int32 device tensor
    grid_shape: Tuple[int, int, int]
    brick_edge: int
    level: int
    timestep: Optional[int]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class BrickCache:
    """Fixed-budget device pool of decoded DVNR bricks with LRU/novelty
    eviction and a hit/miss/evict stats surface.

    ``grid_shape`` is the level-0 decode resolution per partition;
    ``budget_bytes`` defaults to the backend's ``cache_budget_bytes``.
    ``dtype`` is the pool storage dtype; ``compute_dtype`` optionally runs
    the decode (INR inference) reduced, independent of storage. The pool
    lives on ``device`` (``"auto"``: the GPU), where the models it decodes
    must live too.
    """

    def __init__(self, cfg: DVNRConfig, *, grid_shape=(32, 32, 32),
                 brick_edge: int = 16, budget_bytes: Optional[int] = None,
                 dtype="float32", compute_dtype=None,
                 backend: backends.BackendLike = "auto", trace: bool = False,
                 device="auto"):
        if cfg.out_dim != 1:
            raise ValueError("BrickCache currently caches scalar fields "
                             f"(out_dim=1), got out_dim={cfg.out_dim}")
        self.cfg = cfg
        self.backend = backends.resolve(backend)
        self.device = resolve_device(device)
        self.grid_shape = tuple(int(s) for s in grid_shape)
        if min(self.grid_shape) < 2:
            raise ValueError(f"grid_shape {grid_shape} too small to sample")
        self.brick_edge = int(brick_edge)
        if self.brick_edge < 1:
            raise ValueError(f"brick_edge must be >= 1, got {brick_edge}")
        self.dtype = torch_dtype(dtype)
        self.compute_dtype = compute_dtype
        if budget_bytes is None:
            budget_bytes = self.backend.cache_budget_bytes
        self.budget_bytes = int(budget_bytes)
        if self.slot_bytes > self.budget_bytes:
            raise ValueError(
                f"budget_bytes={self.budget_bytes} cannot hold a single "
                f"{self.brick_edge}^3 brick slot ({self.slot_bytes} B); "
                f"shrink brick_edge or raise the budget")
        self.n_slots = self.budget_bytes // self.slot_bytes
        E = self.brick_edge + 1
        self.pool = torch.zeros((self.n_slots, E, E, E), dtype=self.dtype,
                                device=self.device)
        self._slot_of: dict[Key, int] = {}
        self._lru: dict[Key, None] = {}          # insertion order = LRU order
        self._free = list(range(self.n_slots - 1, -1, -1))   # pop() -> slot 0 first
        self._slots_cache: dict[tuple, Any] = {}  # (level, ts, P) -> device map
        self._axis_cache: dict[int, tuple] = {}   # level -> per-axis coords
        self.stats_counters = {"lookups": 0, "hits": 0, "misses": 0,
                               "fills": 0, "evictions": 0}
        self.events: Optional[list] = [] if trace else None

    # ------------------------------ geometry ---------------------------- #
    @property
    def slot_bytes(self) -> int:
        """Closed-form bytes of one pool slot ((edge+1)^3 voxels)."""
        return (self.brick_edge + 1) ** 3 * self.dtype.itemsize

    @property
    def pool_bytes(self) -> int:
        """Closed-form device bytes of the whole pool: by construction
        ``n_slots * slot_bytes <= budget_bytes``."""
        return self.n_slots * self.slot_bytes

    def level_grid(self, level: int) -> Tuple[int, int, int]:
        """Decode resolution at LOD ``level`` (>= 2 voxels per axis)."""
        return tuple(max(2, _ceil_div(s, 1 << level)) for s in self.grid_shape)

    def brick_grid(self, level: int) -> Tuple[int, int, int]:
        return tuple(_ceil_div(s, self.brick_edge)
                     for s in self.level_grid(level))

    def bricks_per_partition(self, level: int) -> int:
        return int(np.prod(self.brick_grid(level)))

    # ------------------------------ stats ------------------------------- #
    def stats(self) -> dict:
        c = dict(self.stats_counters)
        c["resident"] = len(self._slot_of)
        c["n_slots"] = self.n_slots
        c["pool_bytes"] = self.pool_bytes
        c["hit_rate"] = (c["hits"] / c["lookups"]) if c["lookups"] else 0.0
        return c

    def clear(self) -> None:
        """Drop every resident brick (pool bytes stay allocated)."""
        self._slot_of.clear()
        self._lru.clear()
        self._slots_cache.clear()
        self._free = list(range(self.n_slots - 1, -1, -1))

    def _event(self, kind: str, key: Key) -> None:
        if self.events is not None:
            self.events.append((kind, key))

    # ------------------------------ decode ------------------------------ #
    def _axis_coords(self, level: int) -> tuple:
        """Per axis, the f32 cell centre ``(i + 0.5) / g`` of every index
        ``i < g``, computed in float64 and rounded once to f32 as numpy
        computes JAX's ``_brick_coords``."""
        axes = self._axis_cache.get(level)
        if axes is None:
            axes = tuple(((torch.arange(g, dtype=torch.float64,
                                        device=self.device) + 0.5) / g)
                         .to(torch.float32) for g in self.level_grid(level))
            self._axis_cache[level] = axes
        return axes

    def _brick_coords(self, level: int, linear_bricks) -> torch.Tensor:
        """Cell-centered normalized coords (M, E, E, E, 3) f32 of each
        brick's sample block, edge rows clamped to the last cell (replicate
        padding: the rows a clamped trilinear lookup can never address stay
        harmless). Built on the device, the values of JAX's numpy loop."""
        gs = self.level_grid(level)
        nbx, nby, nbz = self.brick_grid(level)
        E = self.brick_edge + 1
        b = torch.as_tensor(np.asarray(linear_bricks, np.int64),
                            device=self.device)
        bz = b % nbz
        by = (b // nbz) % nby
        bx = b // (nby * nbz)
        step = torch.arange(E, device=self.device)
        out = []
        for bi, g, ax in zip((bx, by, bz), gs, self._axis_coords(level)):
            idx = torch.clamp(bi[:, None] * self.brick_edge + step, max=g - 1)
            out.append(ax[idx])                                   # (M, E)
        M = b.shape[0]
        X = out[0][:, :, None, None].expand(M, E, E, E)
        Y = out[1][:, None, :, None].expand(M, E, E, E)
        Z = out[2][:, None, None, :].expand(M, E, E, E)
        return torch.stack([X, Y, Z], -1)

    def _fill(self, params, level: int, bricks: list, slots: list) -> None:
        """Decode ``bricks`` of one partition into pool ``slots``, about
        :data:`FILL_POINTS` points per INR call, written in place."""
        E = self.brick_edge + 1
        per = max(1, FILL_POINTS // E ** 3)
        for i in range(0, len(bricks), per):
            coords = self._brick_coords(level, bricks[i:i + per])
            M = coords.shape[0]
            v = _inr_apply(self.cfg, params, coords.reshape(-1, 3),
                           self.backend, compute_dtype=self.compute_dtype)
            idx = torch.as_tensor(slots[i:i + per], dtype=torch.int64,
                                  device=self.device)
            self.pool.index_copy_(0, idx, v.reshape(M, E, E, E).to(self.dtype))

    # ------------------------------ residency --------------------------- #
    def _take_slot(self, key: Key, working: set) -> int:
        if self._free:
            return self._free.pop()
        victim = None
        # novelty-prioritized LRU: stale-timestep bricks go first, then the
        # least recently used resident outside the current working set
        for k in self._lru:
            if k in working:
                continue
            if k[2] != key[2]:
                victim = k
                break
            if victim is None:
                victim = k
        if victim is None:
            raise ValueError(
                f"BrickCache working set needs more than {self.n_slots} "
                f"slots ({self.pool_bytes} B pool); raise budget_bytes or "
                f"brick the volume coarser")
        slot = self._slot_of.pop(victim)
        del self._lru[victim]
        self.stats_counters["evictions"] += 1
        self._event("evict", victim)
        self._slots_cache.clear()
        return slot

    def ensure(self, model, *, level: int = 0,
               timestep: Optional[int] = None) -> CacheView:
        """Make every brick of ``model`` at ``(level, timestep)`` resident and
        return a :class:`CacheView` for the cache-aware render path.

        ``model``: a :class:`repro_torch.api.DVNRModel` (stacked or single)
        on the cache's device. Misses are decoded partition by partition
        (slots taken in partition, then brick order, as JAX takes them);
        hits cost a dictionary touch. The view's slot map is memoized until
        residency changes.
        """
        ts = _NO_TIMESTEP if timestep is None else int(timestep)
        P = model.n_partitions
        bpp = self.bricks_per_partition(level)
        nb = self.brick_grid(level)
        working = {(level, p * bpp + b, ts)
                   for p in range(P) for b in range(bpp)}
        if len(working) > self.n_slots:
            raise ValueError(
                f"render working set ({len(working)} bricks x "
                f"{self.slot_bytes} B = {len(working) * self.slot_bytes} B) "
                f"exceeds the {self.pool_bytes} B pool "
                f"({self.n_slots} slots); raise budget_bytes")
        missing: dict[int, list] = {}
        for p in range(P):
            for b in range(bpp):
                key = (level, p * bpp + b, ts)
                self.stats_counters["lookups"] += 1
                if key in self._slot_of:
                    self.stats_counters["hits"] += 1
                    self._lru.pop(key)
                    self._lru[key] = None       # MRU
                    self._event("hit", key)
                else:
                    self.stats_counters["misses"] += 1
                    self._event("miss", key)
                    missing.setdefault(p, []).append(b)
        for p, bricks in missing.items():
            part = model.partition(p) if model.stacked else model
            slots = []
            for b in bricks:
                key = (level, p * bpp + b, ts)
                slot = self._take_slot(key, working)
                self._slot_of[key] = slot
                self._lru[key] = None           # novel bricks enter as MRU
                self.stats_counters["fills"] += 1
                self._event("fill", key)
                slots.append(slot)
            self._fill(part.params, level, bricks, slots)
            self._slots_cache.clear()
        cache_key = (level, ts, P)
        slots_map = self._slots_cache.get(cache_key)
        if slots_map is None:
            m = np.empty((P,) + nb, np.int32)
            for p in range(P):
                for b in range(bpp):
                    bz = b % nb[2]
                    by = (b // nb[2]) % nb[1]
                    bx = b // (nb[1] * nb[2])
                    m[p, bx, by, bz] = self._slot_of[(level, p * bpp + b, ts)]
            slots_map = torch.from_numpy(m).to(self.device)
            self._slots_cache[cache_key] = slots_map
        return CacheView(self.pool, slots_map, self.level_grid(level),
                         self.brick_edge, level, timestep)
