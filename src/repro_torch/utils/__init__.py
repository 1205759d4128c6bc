"""Dry-run utilities: the H100's constants (:mod:`~repro_torch.utils.hw`),
the count of a run's products, bytes and collectives
(:mod:`~repro_torch.utils.opcount`, the counterpart of the JAX package's
HLO analysis) and a cell's top operations (``python -m
repro_torch.utils.diagnose``)."""
from repro_torch.utils.opcount import OpAnalysis, OpCounter, count_ops

__all__ = ["OpAnalysis", "OpCounter", "count_ops"]
