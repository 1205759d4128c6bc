"""Sharding rules: logical axes -> mesh axes, and a spec for every leaf of a
parameter tree (the port of ``repro.parallel.sharding``).

Logical axis vocabulary
-----------------------
- ``batch``   data-parallel batch dim            -> ("pod", "data") (present subset)
- ``fsdp``    weight shard dim (ZeRO-3 style)    -> "data"
- ``model``   tensor-parallel dim                -> "model"
- ``expert``  expert-parallel dim (MoE)          -> "model"
- ``part``    DVNR partition dim                 -> all mesh axes (flattened)
- ``seq``     sequence-parallel dim (SP decode)  -> "model"
- ``None``    replicated

A spec is a plain tuple with one entry a dimension: None, an axis name, or
a tuple of axis names, entry for entry what JAX's ``PartitionSpec`` holds.
A :class:`Placement` (the counterpart of a ``NamedSharding``) is a spec on
a :class:`~repro_torch.launch.mesh.Mesh`: :meth:`Placement.local` cuts a
global array to this rank's block, which is how a checkpoint is restored
onto another mesh. Executing the LM sharded (``Sharder.constrain`` on a
mesh, every LM ``sharder=`` argument) is tensor parallelism, which the port
does not have (ROADMAP item 16): those raise.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

LOGICAL_DEFAULTS = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "seq": ("model",),
    "part": ("pod", "data", "model"),
}


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad vocab so embedding/head shards divide evenly on any reasonable mesh."""
    return int(-(-vocab // multiple) * multiple)


def require_no_sharder(sharder) -> None:
    """Raise unless ``sharder`` is None: the LM path runs on one card."""
    if sharder is not None:
        raise NotImplementedError(
            "sharded LM execution (tensor parallelism) is not ported yet "
            "(ROADMAP item 16): pass sharder=None")


def batch_axes_for(mesh, global_batch: int) -> tuple:
    """Largest prefix of ("pod","data") present in the mesh that divides the batch."""
    if mesh is None:
        return ()
    axes: list = []
    div = 1
    for name in ("pod", "data"):
        if name in mesh.shape:
            n = mesh.shape[name]
            if global_batch % (div * n) == 0:
                axes.append(name)
                div *= n
    return tuple(axes)


@dataclass(frozen=True)
class Placement:
    """A spec on a mesh: which mesh axes cut each dimension of an array."""

    mesh: Any
    spec: tuple

    def _axes(self, ndim: int) -> list:
        spec = tuple(self.spec[:ndim]) + (None,) * max(0, ndim - len(self.spec))
        return [() if e is None else ((e,) if isinstance(e, str) else tuple(e))
                for e in spec]

    def blocks(self, ndim: int) -> tuple:
        """How many equal blocks each of ``ndim`` dimensions is cut into."""
        return tuple(int(np.prod([self.mesh.shape[a] for a in axes], dtype=np.int64))
                     for axes in self._axes(ndim))

    def slices(self, shape, coords=None) -> tuple:
        """The block of an array of ``shape`` held by the rank at ``coords``
        (axis name -> index; default: this rank): along each dimension, the
        row-major index of the rank's coordinates on that dimension's axes."""
        coords = self.mesh.coords if coords is None else coords
        out = []
        for d, axes, n in zip(shape, self._axes(len(shape)), self.blocks(len(shape))):
            if d % n:
                raise ValueError(f"dimension {d} does not split over {n} ranks")
            k = 0
            for a in axes:
                k = k * self.mesh.shape[a] + int(coords[a])
            out.append(slice(k * (d // n), (k + 1) * (d // n)))
        return tuple(out)

    def local_shape(self, global_shape) -> tuple:
        return tuple(s.stop - s.start for s in self.slices(global_shape))

    def local(self, array):
        """This rank's block of the global ``array`` (numpy or torch)."""
        return array[self.slices(array.shape)]


class Sharder:
    """Resolves logical axis names against a concrete mesh (or no mesh for tests)."""

    def __init__(self, mesh=None, global_batch: int = 0):
        self.mesh = mesh
        self.axis_map: dict = {}
        if mesh is not None:
            for logical, phys in LOGICAL_DEFAULTS.items():
                present = tuple(a for a in phys if a in mesh.shape)
                self.axis_map[logical] = present
            if global_batch:
                self.axis_map["batch"] = batch_axes_for(mesh, global_batch)

    # ------------------------------------------------------------------ #
    def resolve(self, logical: Optional[str]) -> Any:
        if logical is None or self.mesh is None:
            return None
        phys = self.axis_map.get(logical, ())
        if not phys:
            return None
        return phys if len(phys) > 1 else phys[0]

    def spec(self, *logical: Optional[str]) -> tuple:
        return tuple(self.resolve(ax) for ax in logical)

    def sharding(self, *logical: Optional[str]) -> Optional[Placement]:
        if self.mesh is None:
            return None
        return Placement(self.mesh, self.spec(*logical))

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        return int(np.prod([self.mesh.shape[a] for a in self.axis_map.get(logical, ())] or [1]))

    def constrain(self, x, *logical: Optional[str]):
        """A no-op without a mesh, as in the JAX package; on a mesh this is
        the LM's tensor-parallel execution, which is not ported."""
        if self.mesh is None:
            return x
        raise NotImplementedError(
            "Sharder.constrain on a mesh is tensor-parallel LM execution, "
            "which is not ported yet (ROADMAP item 16)")


# --------------------------------------------------------------------------- #
# Parameter-tree rules
# --------------------------------------------------------------------------- #
# Each rule: (path regex, logical axes per dim). Missing leading dims (e.g. the
# stacked-layer dim) are padded with None on the left.
def lm_param_rules(config) -> list:
    moe = getattr(config, "moe", None)
    ep = moe is not None and moe.expert_sharding == "ep"
    rules: list = [
        (r".*embed/tok$", ("model", "fsdp")),
        (r".*head/w$", ("fsdp", "model")),
        (r".*attn/w[qkv]$", ("fsdp", "model")),
        (r".*attn/b[qkv]$", ("model",)),
        (r".*attn/wo$", ("model", "fsdp")),
        (r".*mlp/w[ig]$", ("fsdp", "model")),
        (r".*mlp/wo$", ("model", "fsdp")),
        (r".*moe/router$", (None, None)),
        # SSM (mamba2)
        (r".*ssm/in_proj$", ("fsdp", "model")),
        (r".*ssm/out_proj$", ("model", "fsdp")),
        (r".*ssm/conv_w$", (None, "model")),
        (r".*ssm/(A_log|D|dt_bias)$", ("model",)),
        (r".*norm.*", (None,)),
    ]
    if moe is not None:
        if ep:
            rules[8:8] = [
                (r".*moe/w[ig]$", ("expert", "fsdp", None)),
                (r".*moe/wo$", ("expert", None, "fsdp")),
            ]
        else:  # TP inside each expert (few large experts, e.g. grok-1)
            rules[8:8] = [
                (r".*moe/w[ig]$", (None, "fsdp", "model")),
                (r".*moe/wo$", (None, "model", "fsdp")),
            ]
    return rules


def spec_for_path(path: str, rules: Sequence[tuple], ndim: int,
                  sharder: Sharder) -> tuple:
    for pat, logical in rules:
        if re.match(pat, path):
            axes = (None,) * (ndim - len(logical)) + tuple(logical)
            return sharder.spec(*axes[:ndim])
    return ()


def _flatten_with_path(tree, prefix=()):
    """(path keys, leaf) pairs in ``jax.tree_util``'s order: dict keys
    sorted, sequences in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_path(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _flatten_with_path(t, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def tree_paths(tree) -> list:
    """"a/b/0"-style paths of the leaves, as the JAX package joins
    ``tree_flatten_with_path``'s keys."""
    return ["/".join(kp) for kp, _ in _flatten_with_path(tree)]


def param_shardings(params_tree, config, sharder: Sharder):
    """Map a param tree (arrays, or anything with ``.shape``) to a tree of
    :class:`Placement` (None without a mesh).

    Divisibility guard: any dim that does not divide evenly by its assigned axis
    size falls back to replication for that dim.
    """
    rules = lm_param_rules(config)
    out = []
    for kp, leaf in _flatten_with_path(params_tree):
        spec = spec_for_path("/".join(kp), rules, len(leaf.shape), sharder)
        spec = _guard_divisibility(spec, leaf.shape, sharder)
        out.append(Placement(sharder.mesh, spec) if sharder.mesh is not None else None)
    return _unflatten_like(params_tree, out)


def partition_shardings(tree, sharder: Sharder):
    """A DVNR trainer state's (or any partition-stacked tree's) placements:
    every leaf's leading (P, ...) axis on ``part`` (all mesh axes), a 0-d
    leaf replicated. The counterpart of the JAX trainer's ``shard_map``
    in_specs ``P(axes)`` for the stacked state."""
    out = [Placement(sharder.mesh, (sharder.resolve("part"),) if len(leaf.shape) else ())
           if sharder.mesh is not None else None
           for _, leaf in _flatten_with_path(tree)]
    return _unflatten_like(tree, out)


def _guard_divisibility(spec: tuple, shape, sharder: Sharder) -> tuple:
    if sharder.mesh is None:
        return spec
    dims = []
    for d, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            dims.append(None)
            continue
        names = (ax,) if isinstance(ax, str) else ax
        size = int(np.prod([sharder.mesh.shape[n] for n in names]))
        dims.append(ax if d % size == 0 else None)
    return tuple(dims)
