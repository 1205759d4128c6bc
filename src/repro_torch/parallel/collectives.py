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

The LM on a mesh (tensor and sequence parallelism, the MoE's dispatch)
needs collectives over some of the mesh's axes, differentiable. Each is a
``torch.autograd.Function`` on a :class:`~repro_torch.launch.mesh.Mesh` and
its axes (the ranks of :meth:`Mesh.axis_group`), and its backward is the
transpose that JAX's ``shard_map`` (``check_rep=False``) gives it:

- :func:`psum` — all-reduce sum; backward ``psum`` (JAX's psum transpose);
- :func:`pmean` — ``psum / n``; backward ``psum / n``;
- :func:`all_gather_dim` — ``lax.all_gather(tiled=True)``; backward
  ``psum_scatter`` (an all-reduce, then this rank's block);
- :func:`all_to_all` — ``lax.all_to_all(split_axis, concat_axis,
  tiled=True)``; backward the all_to_all with the two axes swapped;
- :func:`enter` — identity; backward ``psum``: what ``shard_map`` does to
  the cotangent of an input that no in_spec maps over the axes (the value
  is replicated and each rank's work adds to its gradient);
- :func:`leave` — identity; backward the cotangent over the axes' size:
  what ``shard_map`` does to an output that no out_spec maps over them;
- :func:`block` — this rank's block of a value replicated over the axes
  (a mapped in_spec); backward ``all_gather``;
- :func:`pmax` — all-reduce max, not differentiated (a softmax's shift);
- :func:`gather_weight` — a weight's block over the ``fsdp`` axes to the
  whole over them (``lax.all_gather(tiled=True)``, ZeRO-3's gather of a
  layer's weights); backward ``psum_scatter`` as one reduce-scatter
  (``dist.reduce_scatter_tensor``) where those axes are batch axes (each
  rank's cotangent is its batch block's), else the cotangent's block with
  no sum (every rank computed the same whole gradient).

The GSPMD side of an LM (what XLA's partitioner inserts round a sharded
product) is two more: :func:`reduce`, ``leave(psum(x))`` (a row-parallel
product's partial sums to the value every rank holds whole), and
:func:`gather`, ``leave(all_gather_dim(x))`` (a block to the whole value).
Their outputs are held whole by every rank, so their cotangent is the same
on every rank, and the composed backward (``psum(ct / n)``, the block of
``psum(ct / n)``) is the cotangent itself, or its block: they skip that
communication, as XLA's partitioner does. A test holds every rule against
``jax.grad`` of the same function on 4 host devices.

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
issues none (the paper's zero-communication claim). It also counts them
by kind (``kinds``: operation name -> count) and the bytes each sends
(``nbytes``: its input tensors', e.g. an all-reduce's tensor, an
all-gather's own block, an all_to_all's or a reduce-scatter's whole
input; ``kind_bytes``: operation name -> bytes).
"""
from __future__ import annotations

from collections import Counter
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
        self.kinds: Counter = Counter()
        self.kind_bytes: Counter = Counter()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", "") in COLLECTIVE_NAMESPACES:
            kind, sent = func._schema.name.split("::")[-1], _sent_bytes(func, args)
            self.count += 1
            self.kinds[kind] += 1
            self.kind_bytes[kind] += sent
            self.nbytes += sent
        return func(*args, **(kwargs or {}))


#: the schema argument that holds what a collective sends
_SENT = ("tensors", "input_tensors", "input_tensor", "input", "tensor")


def _tensors(a) -> list:
    """The tensors of an argument: a tensor, or lists of them at any depth
    (``reduce_scatter_``'s list of lists)."""
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, (list, tuple)):
        return [t for x in a for t in _tensors(x)]
    return []


def _sent_bytes(func, args) -> int:
    """The bytes of the tensors a collective sends (its first argument
    named in ``_SENT``; a barrier's token sends nothing)."""
    if func._schema.name.endswith("barrier"):
        return 0
    for spec, a in zip(func._schema.arguments, args):
        if spec.name in _SENT:
            return sum(t.numel() * t.element_size() for t in _tensors(a))
    return 0


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


# --------------------------------------------------------------------------- #
# Differentiable collectives over mesh axes
# --------------------------------------------------------------------------- #
def _group_of(mesh, axes):
    """(process group or None, size, this rank's index) over ``axes``."""
    return mesh.axis_group(axes), mesh.axis_size(axes), mesh.axis_index(axes)


def _out(x: torch.Tensor, group):
    """The tensor a collective sends and receives in: a contiguous copy, on
    the host under gloo."""
    t = x.detach()
    t = t.to("cpu") if _host_wire(group) else t
    # on the same device t shares x's storage: copy it, never send in place
    return t.contiguous().clone() if t.device == x.device else t.contiguous()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    w = _out(x, group)
    dist.all_reduce(w, op=op, group=group)
    return w.to(x.device)


def _gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    w = _out(x, group)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum over the group's ranks of ``x``, this rank's block of it
    along ``dim``: one reduce-scatter (no all-reduce), on ``dim`` moved
    to the front."""
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter: dimension {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    w = x.detach().movedim(dim, 0)
    w = (w.to("cpu") if _host_wire(group) else w).contiguous()
    got = torch.empty((w.shape[0] // n,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    dist.reduce_scatter_tensor(got, w, group=group)
    return got.movedim(0, dim).to(x.device).contiguous()


def _scatter_dim(x: torch.Tensor, n: int, k: int, dim: int) -> torch.Tensor:
    """Block ``k`` of ``n`` equal blocks of ``x`` along ``dim``."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    return x.narrow(dim, k * (size // n), size // n)


def _a2a(x: torch.Tensor, group, n: int, split: int, concat: int) -> torch.Tensor:
    """JAX's tiled all_to_all: ``x`` cut in ``n`` blocks along ``split``,
    block j to the j-th rank; the blocks received concatenated along
    ``concat`` in rank order."""
    if x.shape[split] % n:
        raise ValueError(f"all_to_all: dimension {split} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    w = torch.stack(x.detach().chunk(n, dim=split))
    w = w.to("cpu").contiguous() if _host_wire(group) else w.contiguous()
    got = torch.empty_like(w)
    dist.all_to_all_single(got, w, group=group)
    return torch.cat(list(got.to(x.device).unbind(0)), dim=concat)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.group, ctx.scale = group, scale
        y = _all_reduce(x, group)
        return y * scale if scale != 1 else y

    @staticmethod
    def backward(ctx, g):
        y = _all_reduce(g, ctx.group)
        return (y * ctx.scale if ctx.scale != 1 else y), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, k, dim):
        ctx.args = (n, k, dim)
        return _gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        n, k, dim = ctx.args
        return _scatter_dim(g, n, k, dim).contiguous(), None, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, k, dim):
        ctx.args = (group, n, k, dim)
        return _gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, k, dim = ctx.args
        return _scatter_dim(_all_reduce(g, group), n, k, dim).contiguous(), \
            None, None, None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, k, dim, summed):
        ctx.args = (group, n, k, dim, summed)
        return _gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, k, dim, summed = ctx.args
        out = _reduce_scatter_dim(g, group, n, dim) if summed else \
            _scatter_dim(g, n, k, dim).contiguous()
        return out, None, None, None, None, None


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, k, dim):
        ctx.args = (group, n, k, dim)
        return _scatter_dim(x, n, k, dim).clone()

    @staticmethod
    def backward(ctx, g):
        group, n, k, dim = ctx.args
        return _gather_dim(g, group, n, dim), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = (group, n, split, concat)
        return _a2a(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat = ctx.args
        return _a2a(g, group, n, concat, split), None, None, None, None


def _dim(x, dim: int) -> int:
    return dim % x.dim()


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.psum(x, axes)``; backward ``psum``."""
    group, n, _ = _group_of(mesh, axes)
    return x if n == 1 else _PSum.apply(x, group, 1)


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.pmean(x, axes)``; backward ``pmean``."""
    group, n, _ = _group_of(mesh, axes)
    return x if n == 1 else _PSum.apply(x, group, 1.0 / n)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.pmax`` of a value that takes no gradient (detached)."""
    group, n, _ = _group_of(mesh, axes)
    return x.detach() if n == 1 else _all_reduce(x, group, dist.ReduceOp.MAX)


def enter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A value replicated over ``axes`` entering work that differs between
    their ranks: identity; backward ``psum`` of the ranks' cotangents."""
    group, n, _ = _group_of(mesh, axes)
    return x if n == 1 else _Enter.apply(x, group)


def leave(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A value each rank of ``axes`` holds whole leaving a ``shard_map``
    whose out_spec maps no dimension over them: identity; backward the
    cotangent over the axes' size."""
    n = mesh.axis_size(axes)
    return x if n == 1 else _Leave.apply(x, n)


def all_gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``; backward
    ``lax.psum_scatter``."""
    group, n, k = _group_of(mesh, axes)
    return x if n == 1 else _AllGather.apply(x, group, n, k, _dim(x, dim))


def gather_weight(x: torch.Tensor, mesh, axes, dim: int, summed: bool) -> torch.Tensor:
    """A weight's block along ``dim`` (its fsdp dimension) to the whole
    over ``axes``: an all-gather. Backward: with ``summed`` (``axes`` are
    batch axes, so each rank's cotangent is its own batch block's) the
    reduce-scatter of the ranks' cotangents, each rank its block of the
    sum; without, the cotangent's block (every rank of ``axes`` computed
    the same whole gradient: a sum would multiply it by their number)."""
    group, n, k = _group_of(mesh, axes)
    return x if n == 1 else _GatherWeight.apply(x, group, n, k, _dim(x, dim), summed)


def block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, held whole by every rank of
    ``axes`` (a ``shard_map`` input mapped over them); backward the
    ``all_gather`` of the blocks' cotangents."""
    group, n, k = _group_of(mesh, axes)
    return x if n == 1 else _Block.apply(x, group, n, k, _dim(x, dim))


def all_to_all(x: torch.Tensor, mesh, axes, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axes, split_axis, concat_axis, tiled=True)``;
    backward the all_to_all back."""
    group, n, _ = _group_of(mesh, axes)
    if n == 1:
        return x
    return _AllToAll.apply(x, group, n, _dim(x, split_axis), _dim(x, concat_axis))


def reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Partial sums (a row-parallel product) to the value every rank holds
    whole: ``leave(psum(x))``, whose backward is the (replicated)
    cotangent itself."""
    group, n, _ = _group_of(mesh, axes)
    return x if n == 1 else _Reduce.apply(x, group)


def gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Blocks along ``dim`` to the value every rank holds whole:
    ``leave(all_gather_dim(x))``, whose backward is this rank's block of
    the (replicated) cotangent."""
    group, n, k = _group_of(mesh, axes)
    return x if n == 1 else _Gather.apply(x, group, n, k, _dim(x, dim))
