"""What one run of a program computes, moves and sends: the counterpart of
the JAX package's ``repro.utils.hlo`` (``HloAnalysis``) for an eager
PyTorch program.

JAX reads the post-SPMD HLO text of a compiled cell. An eager PyTorch
program has no HLO: it is a sequence of operations that reach the
dispatcher, one after another. :class:`OpCounter` is a
``TorchDispatchMode`` that sees each of them once (under a
``FakeTensorMode`` nothing runs and nothing is allocated) and counts:

- ``flops``: each product's FLOPs from ``torch.utils.flop_counter``'s
  registry (matmuls, convolutions, attention), also by the dtype of its
  operands (:attr:`OpAnalysis.flops_by_dtype`: the roofline takes each
  dtype's own peak); an elementwise operation counts no FLOPs, as in the
  registry;
- ``op_bytes``: each operation's inputs read once and outputs written once.
  Eager PyTorch fuses nothing, so this is the eager route's memory traffic
  (views, queries that return no tensor and allocations that write
  nothing move no bytes; a collective's bytes are the collective term's);
- the collectives (every ``c10d`` / ``_c10d_functional`` operation) by
  JAX's kind names, each call's bytes as JAX's HLO states them (the
  result's: an all-gather's whole, a reduce-scatter's block) and its wire
  bytes with JAX's ring factors (``hlo.py``'s ``_wire_factor``): all-gather
  and all-to-all (n-1)/n, all-reduce 2(n-1)/n, reduce-scatter n-1 of the
  block, a permute (each ``send`` of a ``batch_isend_irecv``) 1.0, over the
  call's group of n ranks. A ``recv`` is the partner's send and adds no
  wire bytes.

Not ported, because eager PyTorch has nothing for them to read: the HLO
text parser (``parse_hlo``, ``_split_top_level``, the fusion walkers) and
the trip-count walk (a Python loop runs each iteration's operations, so
every one is seen and counted once).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel.collectives import COLLECTIVE_NAMESPACES, _sent_bytes

#: c10d / functional operation -> JAX's HLO collective kind (a ``recv_``
#: or a barrier has none: it sends nothing of its own)
KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}

#: operations that move no bytes of their own (besides views, and queries
#: that return no tensor, such as ``prim::device``)
NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_unsafe_view", "resize_", "set_",
})


def wire_factor(kind: str, n: int) -> float:
    """JAX's ring factor of a collective over ``n`` ranks, relative to its
    result's bytes (``repro.utils.hlo._wire_factor``)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)       # relative to the (scattered) RESULT shape
    return 1.0


def result_bytes(kind: str, sent: int, n: int) -> float:
    """A call's result bytes from the bytes its rank sends (``_sent_bytes``:
    an all-gather's own block, a reduce-scatter's whole input)."""
    if kind == "all-gather":
        return float(sent * n)
    if kind == "reduce-scatter":
        return sent / max(n, 1)
    return float(sent)


def _group_size(func, args, kwargs) -> int:
    import torch.distributed as dist
    for spec, a in zip(func._schema.arguments, args):
        if spec.name == "process_group":
            from torch._C._distributed_c10d import ProcessGroup
            return int(ProcessGroup.unbox(a).size())
        if spec.name == "group_size":
            return int(a)
    return dist.get_world_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


@dataclass(frozen=True)
class CollectiveStat:
    kind: str                 # JAX's name: "all-gather", "collective-permute", ...
    bytes_per_call: float     # the result's bytes, as JAX's HLO states them
    wire_bytes_per_call: float
    group_size: int
    count: int


@dataclass
class OpAnalysis:
    """A rank's counts of one run (every number a rank's)."""

    flops: float
    op_bytes: float
    collective_wire_bytes: float
    collectives: List[CollectiveStat]
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    top_products: List[tuple] = field(default_factory=list)   # (flops, count, signature)
    top_traffic: List[tuple] = field(default_factory=list)    # (bytes, count, op, signature)
    n_ops: int = 0

    def collective_summary(self) -> Dict[str, float]:
        """Wire bytes by kind (JAX's ``HloAnalysis.collective_summary``)."""
        agg: Dict[str, float] = defaultdict(float)
        for c in self.collectives:
            agg[c.kind] += c.wire_bytes_per_call * c.count
        return dict(agg)

    def collective_calls(self) -> Dict[str, int]:
        """Calls by kind (a ``ppermute`` is one permute call a rank)."""
        agg: Dict[str, int] = defaultdict(int)
        for c in self.collectives:
            agg[c.kind] += c.count
        return dict(agg)


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: fn(...)`` then ``c.analysis()``."""

    def __init__(self, top: int = 15):
        super().__init__()
        self.top = top
        self.flops = 0.0
        self.op_bytes = 0.0
        self.n_ops = 0
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self._coll: Dict[Tuple, int] = defaultdict(int)
        self._products: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        self._traffic: Dict[Tuple, list] = defaultdict(lambda: [0.0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        name = func._overloadpacket.__name__
        if getattr(func, "namespace", "") in COLLECTIVE_NAMESPACES:
            kind = KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None:
                n = _group_size(func, args, kwargs)
                b = result_bytes(kind, _sent_bytes(func, args), n)
                self._coll[(kind, b, n)] += 1
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type == "meta" for t in ins + outs):
            return out             # shapes only (``Model.param_specs``): no work
        pkt = func._overloadpacket
        if pkt in flop_registry:
            f = float(flop_registry[pkt](*args, **kwargs, out_val=out))
            self.flops += f
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
            self.flops_by_dtype[dt] += f
            rec = self._products[f"{name}({', '.join(_sig(t) for t in ins[:3])})"]
            rec[0] += f
            rec[1] += 1
        if outs and not func.is_view and name not in NO_TRAFFIC:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            self.op_bytes += b
            rec = self._traffic[(name, _sig(outs[0]) if outs else "")]
            rec[0] += b
            rec[1] += 1
        return out

    def analysis(self) -> OpAnalysis:
        colls = [CollectiveStat(k, b, b * wire_factor(k, n), n, c)
                 for (k, b, n), c in sorted(self._coll.items())]
        products = sorted(((f, c, s) for s, (f, c) in self._products.items()),
                          reverse=True)[:self.top]
        traffic = sorted(((b, c, op, s) for (op, s), (b, c) in self._traffic.items()),
                         reverse=True)[:self.top]
        return OpAnalysis(
            flops=self.flops, op_bytes=self.op_bytes,
            collective_wire_bytes=sum(c.wire_bytes_per_call * c.count for c in colls),
            collectives=colls, flops_by_dtype=dict(self.flops_by_dtype),
            top_products=products, top_traffic=traffic, n_ops=self.n_ops)


def count_ops(fn, *args, top: int = 15, **kwargs):
    """``(fn(*args, **kwargs), OpAnalysis)`` of one run."""
    with OpCounter(top) as c:
        out = fn(*args, **kwargs)
    return out, c.analysis()
