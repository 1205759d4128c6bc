"""repro_torch.resilience: fault injection, non-finite recovery,
degradation (the port of ``repro.resilience``).

- :mod:`~repro_torch.resilience.faults`: a seeded, deterministic
  :class:`FaultPlan` (NaN/Inf field values, dropped/truncated partitions,
  tick latency, corrupted compressed blobs, forced kernel exceptions; the
  JAX package's draws, so both packages inject the same faults) and
  :class:`FaultySimulation`, which injects it at ``publish``/``step`` time.
- :mod:`~repro_torch.resilience.recovery`: :class:`RecoveryPolicy` and the
  chunk-granular retry ladder over the trainer's non-finite detector
  (reseed -> moment reset -> lr backoff -> freeze).
- :mod:`~repro_torch.resilience.runtime`: structural sanitization of
  published partitions (missing/truncated ranks stood in for and masked
  out of training).

:class:`repro_torch.insitu.InSituSession` wires the three together
(``fault_plan=``, ``recovery=``, ``deadline_s=``).
"""
from repro_torch.resilience.faults import (FAULT_KINDS, FaultPlan, FaultSpec,
                                           FaultySimulation,
                                           InjectedKernelFault)
from repro_torch.resilience.recovery import (RecoveryPolicy, merge_partitions,
                                             snapshot_state,
                                             train_with_recovery)
from repro_torch.resilience.runtime import sanitize_partitions

__all__ = [
    "FAULT_KINDS", "FaultPlan", "FaultSpec", "FaultySimulation",
    "InjectedKernelFault",
    "RecoveryPolicy", "merge_partitions", "snapshot_state",
    "train_with_recovery",
    "sanitize_partitions",
]
