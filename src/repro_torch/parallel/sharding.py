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
onto another mesh. A ``Sharder`` without a mesh is a no-op, as in the JAX
package.

Executing on a mesh. The JAX package states a layout
(``with_sharding_constraint``) and XLA's partitioner inserts the
collectives. Here every rank holds its block of each tensor and each site
knows the layout it holds; :meth:`Sharder.constrain` takes that layout as
``held=`` (logical names, one a dimension, as the target's) and moves the
tensor to the target through :mod:`repro_torch.parallel.collectives`:
a dimension that gains an axis is cut to this rank's block, one that loses
it is gathered, and a pair that trades one axis is an ``all_to_all``. An
activation holds its batch dimension cut over the batch axes throughout, so
``held`` defaults to the target's ``"batch"`` entries and whole elsewhere.

The parameters a rank holds are :func:`shard_params`'s blocks: each leaf
cut by :func:`param_shardings` (:func:`held_shardings`, the divisibility
guard included), over ``"model"`` and over the ``fsdp`` axes (``"data"``:
ZeRO-3's split of the weights and, through them, of the AdamW moments).
:func:`gather_params` is the inverse. A site that uses a leaf reads from
its placement which dimensions the fsdp axes cut (:func:`fsdp_split`):
those it gathers whole over them just before use
(``collectives.gather_weight``, whose backward reduce-scatters the
gradient over them where they are batch axes), and over the other batch
axes it enters the loss whole (``collectives.enter``, whose backward sums
the gradient). Every model family runs on a mesh (:func:`mesh_sharder`
tells a sharder that holds one from the single-card path).
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


def mesh_sharder(sharder) -> Optional["Sharder"]:
    """``sharder`` when it holds a mesh, None for None or a mesh-less
    :class:`Sharder` (the JAX package's no-op); anything else raises
    ``TypeError``."""
    if sharder is None:
        return None
    if not isinstance(sharder, Sharder):
        raise TypeError(f"sharder must be a Sharder or None, not "
                        f"{type(sharder).__name__}")
    return sharder if sharder.mesh is not None else None


def model_split(sharder, n: int) -> bool:
    """Whether a dimension of ``n`` that the rules put on ``"model"`` is cut
    over it on ``sharder``'s mesh (more than one rank, and divisible: the
    guard of :func:`param_shardings`)."""
    m = sharder.axis_size("model") if sharder is not None else 1
    return m > 1 and n % m == 0


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

    def axes(self, logical: Optional[str]) -> tuple:
        """The mesh axes ``logical`` resolves to, as a tuple."""
        r = self.resolve(logical)
        return () if r is None else ((r,) if isinstance(r, str) else tuple(r))

    def _dims(self, shape, logical) -> list:
        """Per dimension the axes that cut it, where they divide it (JAX's
        ``constrain`` leaves a dimension that does not divide whole)."""
        logical = tuple(logical) + (None,) * (len(shape) - len(logical))
        out = []
        for d, ax in zip(shape, logical):
            axes = self.axes(ax)
            out.append(axes if axes and d % self.mesh.axis_size(axes) == 0 else ())
        return out

    def constrain(self, x, *logical: Optional[str], held=None):
        """This rank's block of ``x`` in the layout ``logical`` (a no-op
        without a mesh, as in the JAX package). ``held``: the layout the
        site holds ``x`` in, in the same logical names (default: the
        target's ``"batch"`` entries, whole elsewhere); where it differs,
        ``x`` is resharded through the collectives (differentiable): a pair
        of dimensions that trade one axis by one ``all_to_all``, else
        gathers and then cuts. Each dimension's length is the global one
        where it is whole and the block's where it is cut."""
        from repro_torch.parallel import collectives as col
        if self.mesh is None:
            return x
        if held is None:
            held = tuple(a if a == "batch" else None for a in logical)
        mesh = self.mesh
        have = self._held_dims(x.shape, held)
        want = self._dims(self._global_shape(x.shape, have), logical)
        moves = [d for d in range(x.dim()) if have[d] != want[d]]
        if len(moves) == 2:
            a, b = moves
            if have[a] and not want[a] and want[b] == have[a] and not have[b]:
                return col.all_to_all(x, mesh, have[a], b, a)
            if have[b] and not want[b] and want[a] == have[b] and not have[a]:
                return col.all_to_all(x, mesh, have[b], a, b)
        for d in moves:
            if have[d]:
                x = col.gather(x, mesh, have[d], d)
            if want[d]:
                x = col.block(x, mesh, want[d], d)
        return x

    def _held_dims(self, shape, held) -> list:
        held = tuple(held) + (None,) * (len(shape) - len(held))
        return [self.axes(h) for h in held]

    def _global_shape(self, shape, have) -> tuple:
        return tuple(n * self.mesh.axis_size(a) for n, a in zip(shape, have))


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
    return _build_like(tree, iter(leaves))


def _build_like(t, it):
    """``t``'s structure with its leaves taken from ``it`` in order. A
    module-level function: a closure that calls itself is a reference
    cycle, which would keep the leaves (a step's gradients, a layer's
    gathered weights) alive until the garbage collector runs."""
    if isinstance(t, dict):
        return {k: _build_like(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build_like(x, it) for x in t)
    return next(it)


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


# --------------------------------------------------------------------------- #
# The blocks a rank holds
# --------------------------------------------------------------------------- #
def held_shardings(params_tree, config, sharder: Sharder):
    """The placements of the blocks a rank holds: :func:`param_shardings`
    (cut over ``"model"`` and the fsdp axes, as JAX places them); a tree of
    None without a mesh. Works on an optimizer state too (its ``m`` /
    ``v`` / ``mw`` subtrees match the rules by path; the step counter is
    replicated). Give it the global shapes (``Model.param_specs()``):
    whether a block is cut depends on its global length."""
    return param_shardings(params_tree, config, sharder)


def fsdp_split(place: Placement, sharder: Sharder) -> tuple:
    """(dims, enter) for a leaf held as ``place`` on ``sharder``'s mesh:
    ``dims``, the dimensions it is cut over the fsdp axes along (each
    gathered whole over them at its use), and ``enter``, the batch axes
    over which it is held whole and enters a loss (its gradient summed
    over them): all the batch axes for a leaf the fsdp axes do not cut
    (a norm, a bias, the router, a dimension the guard left whole), the
    others for one they cut (the gather's backward sums over them)."""
    fsdp = sharder.axes("fsdp")
    dims = tuple(d for d, e in enumerate(place.spec)
                 if e is not None and any(a in fsdp for a in
                                          ((e,) if isinstance(e, str) else e)))
    batch = sharder.axes("batch")
    return dims, tuple(a for a in batch if not (dims and a in fsdp))


def shard_params(params, config, sharder: Sharder):
    """This rank's blocks of the global parameter tree ``params`` (tensors
    or numpy arrays, as the JAX package's ``init`` tree): each leaf cut by
    :func:`held_shardings` into storage of its own (so that the global
    tree's memory goes with it). Without a mesh, ``params`` itself."""
    if sharder.mesh is None:
        return params
    places = held_shardings(params, config, sharder)
    return _unflatten_like(params, [
        p.local(leaf).clone() if hasattr(leaf, "clone") else p.local(leaf).copy()
        for (_, leaf), (_, p) in zip(_flatten_with_path(params),
                                     _flatten_with_path(places))])


def gather_params(local, like, config, sharder: Sharder):
    """The inverse of :func:`shard_params`: the global tree, assembled from
    every rank's blocks over the axes that cut them (a collective: every
    rank of the mesh calls it and gets the whole tree). ``like``: a tree of
    the global shapes (anything with ``.shape``): whether a block is cut
    depends on its global length (the divisibility guard)."""
    from repro_torch.parallel import collectives as col
    if sharder.mesh is None:
        return local
    mesh = sharder.mesh
    places = held_shardings(like, config, sharder)
    out = []
    for (_, leaf), (_, p) in zip(_flatten_with_path(local), _flatten_with_path(places)):
        for d, e in enumerate(p.spec):
            if e is not None:
                leaf = col.all_gather_dim(leaf.detach(), mesh, e, d)
        out.append(leaf)
    return _unflatten_like(local, out)
