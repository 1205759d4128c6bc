"""The specialized DVNR reactive constructor (paper §IV-A).

The port of ``repro.reactive.dvnr``. ``dvnr_node`` wraps a volume-field
source node: when pulled, it trains one INR per partition (no
communication) through :func:`repro_torch.api.train` on the partitions'
device, optionally compresses the weights, and returns a ``DVNRValue``
wrapping a :class:`repro_torch.api.DVNRModel`. Training is referentially
transparent: if no trigger demands the node in a tick, nothing trains
(lazy bypass).

Weight caching (§III-E) is applied automatically: the cache entry is keyed by
(field name, network config); a hit warm-starts the next tick's training.
The tick's key is ``fold_in(PRNGKey(seed), tick)``, the JAX package's words,
so both packages draw the same init and batches for the same tick.

One deliberate difference from JAX: ``impl`` defaults to ``"auto"`` (the
card's kernels) and the trainer lives on ``device`` (default: the card),
where the JAX package defaults to its ``ref`` backend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch import api, backends
from repro_torch.backends import resolve_device
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.sampling import as_key, fold_in
from repro_torch.core.temporal import WeightCache
from repro_torch.core.trainer import DVNRTrainer
from repro_torch.reactive.graph import Node, Runtime


@dataclass
class DVNRValue:
    """One tick's trained distributed neural representation."""

    model: api.DVNRModel
    train_time_s: float
    steps: int
    compressed: Optional[list] = None  # per-partition blobs if compression on
    # resilience surfaces (repro_torch.resilience): ranks that did not train
    # this tick (structurally degraded publishes + recovery-frozen
    # partitions: their INRs hold the weight-cache warm start), and the
    # recovery retry count spent on this tick's training
    degraded_partitions: tuple = ()
    retries: int = 0

    @property
    def cfg(self) -> DVNRConfig:
        return self.model.cfg

    @property
    def params(self):
        return self.model.params

    @property
    def parts_meta(self) -> List[api.PartitionMeta]:
        return list(self.model.parts_meta or ())

    @property
    def grange(self) -> tuple:
        return self.model.grange

    @property
    def bytes(self) -> int:
        if self.compressed is not None:
            return sum(len(b) for b in self.compressed)
        return self.model.nbytes


def _train_once(cfg: DVNRConfig, partitions, trainer: DVNRTrainer,
                wcache: Optional[WeightCache], field_name: str,
                key, compress: bool, check_every: int = 0,
                recovery=None, train_mask=None,
                degraded: tuple = ()) -> DVNRValue:
    cached = wcache.get(field_name, cfg) if wcache is not None else None
    model, info = api.train(partitions, cfg, trainer=trainer, key=key,
                            cached_params=cached, check_every=check_every,
                            recovery=recovery, train_mask=train_mask)
    if wcache is not None:
        # cache the highest-precision view (the f32 master under bf16
        # policies): the next tick's warm start seeds both working copy and
        # master from it (degraded/frozen partitions held their warm start,
        # so re-putting them is the identity)
        wcache.put(field_name, cfg, DVNRTrainer.master_params(info["state"]))
    blobs = model.compress() if compress else None
    rec = info.get("recovery", {})
    degraded_all = tuple(sorted(set(degraded)
                                | set(rec.get("frozen_partitions", ()))))
    return DVNRValue(model, info["train_time_s"], info["steps"], blobs,
                     degraded_all, int(rec.get("retries", 0)))


def dvnr_node(runtime: Runtime, field_node: Node, cfg: DVNRConfig, *,
              field_name: str, n_partitions: int, mesh=None,
              impl: backends.BackendLike = "auto", device="auto",
              weight_caching: bool = True, compress: bool = True,
              seed: int = 0, name: Optional[str] = None,
              check_every: int = 0, precision=None,
              recovery=None, resilient: bool = False) -> Node:
    """Reactive constructor: volume partitions -> trained DVNRValue (lazy).

    Each tick's training runs the trainer's chunk path; ``check_every`` sets
    the convergence-check (chunk) granularity. ``precision`` overrides
    ``cfg.precision``. ``impl`` is the kernel backend and ``device`` where
    the trainer's state lives: the device the published partitions lie on.

    ``resilient=True`` structurally sanitizes every published partition list
    (:func:`repro_torch.resilience.sanitize_partitions`): dropped/truncated
    ranks are stood in for by the previous tick's data (or zeros) and masked
    out of training, so their INRs keep the §III-E weight-cache warm start.
    ``recovery`` (a :class:`repro_torch.resilience.RecoveryPolicy`) also
    routes training through the non-finite retry ladder.
    """
    if precision is not None:
        from repro_torch.precision import resolve_precision
        cfg = cfg.replace(precision=resolve_precision(precision).name)
    trainer = DVNRTrainer(cfg, n_partitions, mesh=mesh, impl=impl,
                          device=resolve_device(device))
    wcache = WeightCache() if (weight_caching and cfg.weight_caching) else None
    last_clean: dict = {"parts": None}

    def construct(partitions):
        key = fold_in(as_key(seed), runtime.tick)
        degraded: tuple = ()
        train_mask = None
        if resilient:
            from repro_torch.resilience.runtime import sanitize_partitions
            partitions, degraded = sanitize_partitions(
                partitions, n_partitions, template=last_clean["parts"])
            last_clean["parts"] = list(partitions)
            if degraded:
                train_mask = np.ones(n_partitions, bool)
                train_mask[list(degraded)] = False
        return _train_once(cfg, partitions, trainer, wcache, field_name, key,
                           compress, check_every, recovery=recovery,
                           train_mask=train_mask, degraded=degraded)

    return Node(runtime, name or f"dvnr[{field_name}]", [field_node], construct)
