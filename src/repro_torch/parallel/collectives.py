"""The port's one door to ``torch.distributed``, and a counter of what goes
through the wall beside it.

The JAX package moves data between devices with ``lax.ppermute`` and
``lax.all_gather`` inside ``shard_map``. Here each rank is a process of a
``torch.distributed`` process group, and the two become:

- :func:`ppermute` — one batch of ``isend`` / ``irecv`` in which every rank
  sends ``x`` to the rank its ``(src, dst)`` pair names and receives from
  the rank that names it (a rank named by no pair gets zeros back, as
  ``lax.ppermute`` gives);
- :func:`all_gather` — every rank's tensor, stacked or concatenated.

The wire. Under ``gloo`` (the CPU tests, and ranks that share one card) a
tensor on the card is staged through a host copy before it is sent and
after it arrives: gloo moves host memory only. Under ``nccl`` (one card a
rank) tensors go as they are. The caller names the backend when it builds
the mesh (:func:`repro_torch.launch.mesh.build_mesh`); nothing here falls
back from one backend to another. Compute stays on each rank's device.

:func:`count_collectives` counts every operation of the ``c10d`` and
``_c10d_functional`` namespaces that reaches PyTorch's dispatcher while it
is active — the wrappers here, and also any call that goes round them — so
that a test or ``chip_smoke.py`` can show that a rank's training chunk
issues none (the paper's zero-communication claim).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

#: the dispatcher namespaces of torch.distributed's operations
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


class CollectiveCounter(TorchDispatchMode):
    """A dispatch mode that counts the collective and point-to-point
    operations it sees (``count``)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", "") in COLLECTIVE_NAMESPACES:
            self.count += 1
        return func(*args, **(kwargs or {}))


def count_collectives() -> CollectiveCounter:
    """``with count_collectives() as c: ...`` then ``c.count``: the number
    of ``c10d`` / ``_c10d_functional`` operations the block dispatched."""
    return CollectiveCounter()


def _group_ranks(group) -> List[int]:
    return list(range(dist.get_world_size(group))) if group is None else \
        dist.get_process_group_ranks(group)


def _host_wire(group) -> bool:
    """gloo moves host memory only: tensors on the card go through the host."""
    return dist.get_backend(group) == "gloo"


def ppermute(x: torch.Tensor, pairs: Iterable[Tuple[int, int]], *,
             group=None) -> torch.Tensor:
    """``lax.ppermute`` across the group's ranks: for each ``(src, dst)``
    pair (ranks of ``group``, in its order), ``src``'s ``x`` arrives at
    ``dst``. Each rank is a source at most once and a destination at most
    once; a rank that receives nothing gets zeros. One batch of
    ``isend`` / ``irecv``, waited on before returning."""
    ranks = _group_ranks(group)
    me = ranks.index(dist.get_rank())
    pairs = [(int(s), int(d)) for s, d in pairs]
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a rank may send and receive once, got {pairs}")
    host = _host_wire(group)
    wire = x.detach().to("cpu") if host else x.detach()
    wire = wire.contiguous()
    recv = torch.zeros_like(wire)
    ops = []
    for s, d in pairs:
        if s == me and d == me:
            recv.copy_(wire)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, wire, ranks[d], group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, recv, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if host else recv


def all_gather(x: torch.Tensor, *, group=None, tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``x`` in rank order, stacked on a
    new leading axis, or concatenated on axis 0 when ``tiled``."""
    host = _host_wire(group)
    wire = (x.detach().to("cpu") if host else x.detach()).contiguous()
    out = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    full = torch.cat(out) if tiled else torch.stack(out)
    return full.to(x.device) if host else full


def gather_object(obj, *, dst: int = 0, group=None) -> Optional[Sequence]:
    """Every rank's picklable ``obj`` at rank ``dst`` (a list in rank
    order), None elsewhere."""
    ranks = _group_ranks(group)
    out = [None] * len(ranks) if dist.get_rank() == ranks[dst] else None
    dist.gather_object(obj, out, dst=ranks[dst], group=group)
    return out


def scatter_object(objs: Optional[Sequence], *, src: int = 0, group=None):
    """Rank ``src``'s ``objs[i]`` to the group's i-th rank."""
    ranks = _group_ranks(group)
    box: List[Optional[object]] = [None]
    dist.scatter_object_list(box, list(objs) if objs is not None else None,
                             src=ranks[src], group=group)
    return box[0]


def barrier(*, group=None) -> None:
    dist.barrier(group=group)
