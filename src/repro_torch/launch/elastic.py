"""Elastic restart: resume a run on a different mesh shape (the port of
``repro.launch.elastic``).

The checkpoint stores *global* (rank-0-gathered) arrays; restoring places
each leaf with the TARGET mesh's placements, so losing ranks (8 -> 4) or
gaining them is a restore onto a new mesh, not a migration. DVNR adds a
second, cheaper safety net in the runtime itself: a rank that publishes
nothing (or garbage) is sanitized out of the batch
(:func:`repro_torch.resilience.sanitize_partitions`), masked from training,
and its INR keeps the §III-E weight-cache warm start.

``plan_restart`` is the control-plane helper: given the surviving rank
count it picks the new mesh (over the first ranks of the restarted process
group) and the sharder to restore with.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.parallel.sharding import (Sharder, held_shardings,
                                           partition_shardings)


@dataclass
class RestartPlan:
    mesh: Any
    sharder: Sharder
    devices: int
    note: str


def plan_restart(surviving_devices: int, global_batch: int, *,
                 model_parallel: int = 16, pods: int = 1,
                 device="auto") -> RestartPlan:
    """Largest power-of-two rank count <= survivors, re-meshed. Every rank
    of the restarted process group calls it (the group must hold at least
    that many ranks)."""
    n = 1
    while n * 2 <= surviving_devices:
        n *= 2
    mesh = make_mesh_for(n, model_parallel=min(model_parallel, n), pods=pods,
                         device=device)
    return RestartPlan(mesh, Sharder(mesh, global_batch), n,
                       f"remeshed {surviving_devices} survivors -> {n} devices "
                       f"{dict(mesh.shape)}")


def elastic_restore(mgr: CheckpointManager, example_tree, cfg, plan: RestartPlan,
                    step: Optional[int] = None, *, shapes=None):
    """Restore a checkpoint onto the new mesh's placements. ``example_tree``
    is this rank's share on the new mesh: for a DVNR config
    (``cfg.n_levels``), a partition-stacked trainer state whose leading axis
    is cut over every mesh axis (:func:`partition_shardings`); for an LM
    config, its blocks of the parameters (and optimizer state) as the LM
    rules cut them over ``"model"`` and ``"data"`` (:func:`held_shardings`,
    the layout the training driver holds and writes), with ``shapes`` the
    same tree's global shapes (e.g. ``Model.param_specs()``): whether a
    block is cut depends on its global length."""
    if hasattr(cfg, "n_levels"):
        shardings = partition_shardings(example_tree, plan.sharder)
    elif shapes is None:
        raise ValueError("elastic_restore of an LM needs shapes=, the global "
                         "tree's shapes")
    else:
        shardings = held_shardings(shapes, cfg, plan.sharder)
    return mgr.restore(example_tree, step, shardings=shardings)
