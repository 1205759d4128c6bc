"""The DIVA<->Ascent in situ session (paper Fig. 5).

The port of ``repro.insitu.session``. ``InSituSession`` wires a synthetic
simulation into the reactive runtime:

  simulation.publish(field) --> Source node --> dvnr_node (lazy training)
        |                                          |-> SlidingWindow (temporal cache)
        |                                          |-> render / isosurface actions
        +--> trigger conditions (data-driven Boolean indicators)

Per visualization step the session feeds the graph, the runtime updates live
windows, and triggers fire actions. Memory accounting per step reproduces the
paper's Fig. 12 study (DVNR cache vs raw data cache vs baseline).

Resilience (repro_torch.resilience): the session accepts a seeded ``fault_plan``
(NaN/Inf fields, dropped/truncated ranks, slow ticks, corrupt blobs, forced
kernel exceptions), a per-cycle training ``deadline_s`` after which the tick
reuses the previous DVNR instead of blocking the simulation, and a
``recovery`` policy for non-finite training. Outcomes are recorded per tick
on :class:`StepRecord` and aggregated by :meth:`InSituSession.health` — the
in situ loop survives every injected fault without ever raising into the
host simulation.

One deliberate difference from JAX: ``impl`` defaults to ``"auto"`` (the
card's kernels) and the session takes a ``device`` (default ``"auto"``: the
card) for the simulation's partitions and the trainer, where the JAX
package defaults to its ``ref`` backend. Without a card, ``"auto"`` raises:
on the CPU pass ``device="cpu"`` and ``impl="ref"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.backends import resolve_device
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.insitu.actions import isosurface_action, render_action
from repro_torch.insitu.simulation import SimulationConfig, SyntheticSimulation
from repro_torch.reactive.dvnr import dvnr_node
from repro_torch.reactive.graph import Runtime


@dataclass
class StepRecord:
    cycle: int
    t: float
    fired: Dict[str, bool]
    cache_bytes: int
    cache_len: int
    raw_equiv_bytes: int
    step_time_s: float
    dvnr_trained: bool
    # resilience surfaces (all defaulted: fault-free records are unchanged)
    retries: int = 0                    # recovery retry chunks spent this tick
    degraded_partitions: tuple = ()     # ranks serving weight-cache fallbacks
    deadline_missed: bool = False       # tick exceeded deadline_s
    fallback: bool = False              # previous tick's DVNR was reused
    blob_repairs: int = 0               # corrupt cache blobs detected+repaired


class InSituSession:
    """One simulation + one reactive graph + an action set."""

    def __init__(self, sim_cfg: SimulationConfig, dvnr_cfg: DVNRConfig, *,
                 window: int = 8, impl="auto", compress: bool = True,
                 cache_mode: str = "dvnr", check_every: int = 0,
                 precision=None, fault_plan=None, deadline_s: float = None,
                 deadline_clock: str = "wall", recovery=None,
                 device="auto"):
        """cache_mode: 'dvnr' (compressed models), 'raw' (uncompressed grids,
        the paper's 'Data Cache' comparison), 'off' (baseline).
        check_every: chunk size of the per-tick device-resident training loop
        (0 = auto; see :meth:`repro_torch.core.trainer.DVNRTrainer.train`).
        precision: mixed-precision policy override for per-tick training
        (e.g. "bf16"; see :mod:`repro_torch.precision`).
        impl / device: the kernel backend and the device of the published
        partitions and the trainer (both "auto": the card).

        fault_plan: a :class:`repro_torch.resilience.FaultPlan`: wraps the
        simulation in a fault injector and arms the session's blob-corruption
        / kernel-exception / latency handling.
        deadline_s: per-cycle training time budget. When the budget is
        already spent before training starts, the tick reuses the previous
        DVNR (``StepRecord.fallback``); a tick whose total work overruns the
        budget is flagged ``deadline_missed``. ``deadline_clock`` selects the
        accounting: "wall" (monotonic host time) or "injected" (only the
        fault plan's virtual slow-tick latency — fully deterministic, for
        bit-reproducible health reports in tests/CI).
        recovery: a :class:`repro_torch.resilience.RecoveryPolicy` for non-finite
        training recovery inside the per-tick training loop."""
        if deadline_clock not in ("wall", "injected"):
            raise ValueError("deadline_clock must be 'wall' or 'injected', "
                             f"got {deadline_clock!r}")
        self.device = resolve_device(device)
        self.sim = SyntheticSimulation(sim_cfg, device=self.device)
        self.fault_plan = fault_plan
        if fault_plan is not None:
            from repro_torch.resilience.faults import FaultySimulation
            self.sim = FaultySimulation(self.sim, fault_plan)
        self.dvnr_cfg = dvnr_cfg
        self.rt = Runtime()
        self.cache_mode = cache_mode
        self.records: List[StepRecord] = []
        self.deadline_s = deadline_s
        self.deadline_clock = deadline_clock
        self.recovery = recovery
        resilient = (fault_plan is not None or recovery is not None
                     or deadline_s is not None)

        fname = self.sim.field_names[0]
        self.field_src = self.rt.source(fname)
        self.dvnr = dvnr_node(self.rt, self.field_src, dvnr_cfg,
                              field_name=fname,
                              n_partitions=sim_cfg.n_ranks, impl=impl,
                              device=self.device, compress=compress, check_every=check_every,
                              precision=precision, recovery=recovery,
                              resilient=resilient)
        if resilient:
            self._guard_dvnr_node()
        if cache_mode == "dvnr":
            self.window = self.dvnr.window(window)
        elif cache_mode == "raw":
            self.window = self.field_src.map(
                lambda parts: _RawCopy(parts), name="raw_copy").window(window)
        else:
            self.window = None
        self._triggers: Dict[str, Callable] = {}
        self._last_value = None         # previous tick's DVNRValue (fallback)
        self._tick_health: dict = {}
        self._tick_t0 = time.monotonic()

    # ------------------------------------------------------------------ #
    def _guard_dvnr_node(self):
        """Wrap the DVNR node's construct fn with the session's fault
        boundary: injected kernel exceptions fire here, a pre-spent deadline
        skips training, and ANY training failure degrades to the previous
        tick's DVNR instead of propagating into the host simulation (a
        failure on the very first tick, with nothing to fall back to, still
        raises — there is no model to serve)."""
        inner = self.dvnr.fn

        def guarded(partitions):
            h = self._tick_health
            cycle = self.sim.cycle
            if self._deadline_spent():
                # budget already burned (e.g. a slow publish): don't start
                # training this tick at all
                if self._last_value is not None:
                    h["fallback"] = True
                    h["deadline_missed"] = True
                    return self._last_value
            try:
                if self.fault_plan is not None \
                        and self.fault_plan.should_raise(cycle):
                    from repro_torch.resilience.faults import InjectedKernelFault
                    raise InjectedKernelFault(
                        f"injected kernel exception at cycle {cycle}")
                value = inner(partitions)
            except Exception:
                if self._last_value is None:
                    raise
                h["fallback"] = True
                return self._last_value
            h["retries"] = value.retries
            h["degraded"] = value.degraded_partitions
            return value

        self.dvnr.fn = guarded

    def _deadline_spent(self) -> bool:
        if self.deadline_s is None:
            return False
        return self._tick_elapsed() > self.deadline_s

    def _tick_elapsed(self) -> float:
        if self.deadline_clock == "injected":
            return float(getattr(self.sim, "injected_latency_s", 0.0))
        return time.monotonic() - self._tick_t0

    # ------------------------------------------------------------------ #
    def add_trigger(self, name: str, cond_fn: Callable[[list], bool],
                    actions: Optional[List[Callable]] = None):
        """cond_fn consumes the published partitions (cheap reduction)."""
        cond = self.field_src.map(cond_fn, name=f"cond[{name}]")
        trig = self.rt.trigger(name, cond)
        for a in actions or []:
            trig.on_fire(a)
        return trig

    def render_now(self, **kw):
        return render_action(self.dvnr.value(), **kw)

    def isosurface_now(self, **kw):
        return isosurface_action(self.dvnr.value(), **kw)

    # ------------------------------------------------------------------ #
    def _apply_blob_faults(self):
        """Corrupt scheduled cache blobs of the newest window entry, then
        sweep: every blob of that entry is CRC-verified and a corrupt one is
        re-encoded from the still-resident model (detection + repair — the
        TemporalModelCache equivalent falls back to the previous entry).
        Returns the number of repairs."""
        if self.cache_mode != "dvnr" or self.window is None \
                or not self.window.buf:
            return 0
        value = self.window.buf[-1]
        if value is None or value.compressed is None:
            return 0
        if self.fault_plan is not None:
            for spec in self.fault_plan.blob_targets(self.sim.cycle):
                p = spec.partition if spec.partition is not None else 0
                if 0 <= p < len(value.compressed):
                    value.compressed[p] = self.fault_plan.corrupt_bytes(
                        value.compressed[p], spec)
        from repro_torch.compress.codec_util import (BlobIntegrityError,
                                                     crc_unframe)
        repairs = 0
        for p, blob in enumerate(value.compressed):
            try:
                crc_unframe(blob)
            except BlobIntegrityError:
                value.compressed[p] = \
                    value.model.partition(p).compress()[0]
                repairs += 1
        return repairs

    def run(self, n_steps: int, *, demand_window: bool = True) -> List[StepRecord]:
        if demand_window and self.window is not None:
            self.window.live = True
        for _ in range(n_steps):
            self._tick_t0 = time.monotonic()
            self._tick_health = {}
            self.sim.step()
            fname = self.sim.field_names[0]
            evals_before = self.dvnr.evaluations
            fired = self.rt.advance({fname: self.sim.publish(fname)})
            h = self._tick_health
            if self.dvnr.evaluations > evals_before \
                    or h.get("fallback", False):
                self._last_value = self.dvnr._cache
                repairs = self._apply_blob_faults()
            else:
                repairs = 0
            deadline_missed = (h.get("deadline_missed", False)
                               or (self.deadline_s is not None
                                   and self._tick_elapsed() > self.deadline_s))
            cache_bytes = self.window.total_bytes if self.window is not None else 0
            cache_len = len(self.window.buf) if self.window is not None else 0
            self.records.append(StepRecord(
                cycle=self.sim.cycle, t=self.sim.t, fired=fired,
                cache_bytes=cache_bytes, cache_len=cache_len,
                raw_equiv_bytes=self.sim.raw_bytes_per_step() * cache_len,
                step_time_s=time.monotonic() - self._tick_t0,
                dvnr_trained=(self.dvnr.evaluations > evals_before
                              and not h.get("fallback", False)),
                retries=h.get("retries", 0),
                degraded_partitions=tuple(h.get("degraded", ())),
                deadline_missed=deadline_missed,
                fallback=h.get("fallback", False),
                blob_repairs=repairs))
        return self.records

    def health(self) -> dict:
        """Deterministic aggregate of the per-tick resilience records: with
        ``deadline_clock="injected"`` two runs of the same seeded fault plan
        produce identical reports, the JAX package's for the same plan."""
        recs = self.records
        return {
            "cycles": len(recs),
            "trained": sum(r.dvnr_trained for r in recs),
            "retries": sum(r.retries for r in recs),
            "retry_cycles": tuple(r.cycle for r in recs if r.retries),
            "degraded": {r.cycle: tuple(r.degraded_partitions)
                         for r in recs if r.degraded_partitions},
            "deadline_missed": tuple(r.cycle for r in recs
                                     if r.deadline_missed),
            "fallbacks": tuple(r.cycle for r in recs if r.fallback),
            "blob_repairs": sum(r.blob_repairs for r in recs),
            "blob_repair_cycles": tuple(r.cycle for r in recs
                                        if r.blob_repairs),
        }


class _RawCopy:
    """Uncompressed device copy of published partitions (the 'Data Cache'
    arm)."""

    def __init__(self, parts):
        self.arrays = [p.data.clone() for p in parts]

    @property
    def bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays)
