"""Deterministic fault injection for the in situ runtime.

The port of ``repro.resilience.faults``. A :class:`FaultPlan` is a seed
plus a list of :class:`FaultSpec` entries; all randomness (which voxels go
NaN, which bytes flip) derives from numpy's
``SeedSequence([seed, kind, cycle, partition])``, exactly as in the JAX
package, so a plan replayed against either package poisons the same voxels
and flips the same bytes.

:class:`FaultySimulation` wraps a
:class:`~repro_torch.insitu.simulation.SyntheticSimulation` transparently:
``publish`` returns *faulted copies* of the clean partitions (device clones:
the wrapped simulation's memoized originals are never written), ``step``
accounts injected tick latency. Structural faults (``drop_partition`` ->
``None`` in the published list, ``truncate_partition`` -> a wrong-shaped
tensor) model rank loss and torn transport; value faults (``nan_field`` /
``inf_field``) poison a seeded voxel subset and are left for the training
side's non-finite detector. ``corrupt_blob`` and ``kernel_exception`` are
*queried* by the session (``blob_targets`` / ``should_raise``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.volume import VolumePartition

FAULT_KINDS: Tuple[str, ...] = (
    "nan_field",           # seeded voxel subset of a partition set to NaN
    "inf_field",           # ... set to +Inf
    "drop_partition",      # rank loss: publish() yields None for the rank
    "truncate_partition",  # torn transport: wrong-shaped partition data
    "slow_tick",           # artificial tick latency (deadline exercises)
    "corrupt_blob",        # bit flips in a compressed model blob
    "kernel_exception",    # forced exception out of the training dispatch
)


class InjectedKernelFault(RuntimeError):
    """The forced training-dispatch exception of a ``kernel_exception`` fault."""


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault. ``cycle`` is the 1-based simulation cycle it fires
    on (``SyntheticSimulation.cycle`` after ``step()``). ``partition`` selects
    the target rank where that makes sense (None = rank 0 for single-target
    kinds). ``magnitude`` is the poisoned-voxel fraction for value faults and
    the flipped-byte fraction for ``corrupt_blob``; ``latency_s`` is the
    injected delay of a ``slow_tick``."""

    kind: str
    cycle: int
    partition: Optional[int] = None
    magnitude: float = 1e-3
    latency_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")


class FaultPlan:
    """A seeded schedule of faults.

    ``realtime=False`` (default) makes ``slow_tick`` latency purely virtual:
    it is *accounted* (``FaultySimulation.injected_latency_s``, consumed by
    the session's ``deadline_clock="injected"`` mode) but not slept.
    ``realtime=True`` actually sleeps.
    """

    def __init__(self, seed: int, faults: List[FaultSpec], *,
                 realtime: bool = False):
        self.seed = int(seed)
        self.faults = tuple(faults)
        self.realtime = bool(realtime)

    def for_cycle(self, cycle: int) -> List[FaultSpec]:
        return [f for f in self.faults if f.cycle == cycle]

    def rng(self, spec: FaultSpec) -> np.random.Generator:
        """Per-fault RNG: a pure function of (plan seed, fault identity)."""
        part = spec.partition if spec.partition is not None else 0xFFFF
        ss = np.random.SeedSequence(
            [self.seed, FAULT_KINDS.index(spec.kind), spec.cycle, part])
        return np.random.default_rng(ss)

    # ---- session-side queries ----------------------------------------- #
    def latency(self, cycle: int) -> float:
        return sum(f.latency_s for f in self.for_cycle(cycle)
                   if f.kind == "slow_tick")

    def should_raise(self, cycle: int) -> bool:
        return any(f.kind == "kernel_exception" for f in self.for_cycle(cycle))

    def blob_targets(self, cycle: int) -> List[FaultSpec]:
        return [f for f in self.for_cycle(cycle) if f.kind == "corrupt_blob"]

    def corrupt_bytes(self, blob: bytes, spec: FaultSpec) -> bytes:
        """Deterministically flip a seeded subset of ``blob``'s bytes."""
        buf = bytearray(blob)
        if not buf:
            return bytes(buf)
        rng = self.rng(spec)
        n_flips = max(1, int(len(buf) * spec.magnitude))
        idx = rng.choice(len(buf), size=min(n_flips, len(buf)), replace=False)
        for i in idx:
            buf[i] ^= int(rng.integers(1, 256))
        return bytes(buf)


def _poison(part: VolumePartition, spec: FaultSpec,
            rng: np.random.Generator) -> VolumePartition:
    """NaN/Inf a seeded voxel subset of a device clone of the partition's
    data (the flat indices drawn on the host by numpy, as the JAX package
    draws them). The vmin/vmax metadata stays the clean values: the fault
    surfaces in the training loss, not as NaN camera ranges downstream."""
    data = part.data.clone()
    flat = data.reshape(-1) if data.ndim == 3 else data.reshape(-1, data.shape[-1])
    n = max(1, int(flat.shape[0] * spec.magnitude))
    idx = rng.choice(flat.shape[0], size=min(n, flat.shape[0]), replace=False)
    flat[torch.as_tensor(idx, device=data.device)] = \
        float("nan") if spec.kind == "nan_field" else float("inf")
    return VolumePartition(data, part.origin, part.extent, part.ghost,
                           part.vmin, part.vmax)


def _truncate(part: VolumePartition) -> VolumePartition:
    """Torn transport: keep only the front half along x (wrong shape)."""
    keep = max(2, part.data.shape[0] // 2)
    return VolumePartition(part.data[:keep].clone(), part.origin, part.extent,
                           part.ghost, part.vmin, part.vmax)


class FaultySimulation:
    """Transparent fault-injecting wrapper over a SyntheticSimulation.

    Everything not overridden here (``cfg``, ``cycle``, ``t``,
    ``field_names``, ``global_shape``, ``raw_bytes_per_step``, ...) delegates
    to the wrapped simulation. ``publish`` memoizes its own faulted copies per
    cycle, mirroring the wrapped simulation's zero-copy-handle semantics.
    """

    def __init__(self, sim, plan: FaultPlan):
        self._sim = sim
        self.plan = plan
        self._faulted: dict = {}
        self.injected_latency_s = 0.0

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_sim"), name)

    def step(self) -> None:
        self._sim.step()
        self._faulted.clear()
        self.injected_latency_s = self.plan.latency(self._sim.cycle)
        if self.injected_latency_s and self.plan.realtime:
            time.sleep(self.injected_latency_s)

    def publish(self, field: str):
        if field in self._faulted:
            return self._faulted[field]
        parts = list(self._sim.publish(field))
        for spec in self.plan.for_cycle(self._sim.cycle):
            if spec.kind in ("nan_field", "inf_field"):
                targets = ([spec.partition] if spec.partition is not None
                           else range(len(parts)))
                for p in targets:
                    if 0 <= p < len(parts) and parts[p] is not None:
                        parts[p] = _poison(parts[p], spec, self.plan.rng(spec))
            elif spec.kind == "drop_partition":
                p = spec.partition if spec.partition is not None else 0
                if 0 <= p < len(parts):
                    parts[p] = None
            elif spec.kind == "truncate_partition":
                p = spec.partition if spec.partition is not None else 0
                if 0 <= p < len(parts) and parts[p] is not None:
                    parts[p] = _truncate(parts[p])
        self._faulted[field] = parts
        return parts
