"""Meshes of ranks: the port of ``repro.launch.mesh``.

A JAX ``Mesh`` arranges devices of one program on named axes. Here the
devices belong to ranks, the processes of a ``torch.distributed`` process
group, and a :class:`Mesh` is this rank's view of the arrangement: the
shape by axis name, its own coordinates on the axes, the flattened index of
those (row-major, as JAX flattens ``P(all axes)``), the device its tensors
live on and the process group its traffic goes through.

The caller initialises the process group (``init_process_group`` with its
own address, world size and rank: nothing on the machine tells a program of
a cluster) and names its backend. ``gloo`` runs on the CPU and lets several
ranks share one card (NCCL refuses two ranks on one device); ``nccl``
needs a card a rank. Nothing falls back from one to the other.

Axis groups. A collective over some of the mesh's axes (``psum`` over
``"model"``, over the batch axes ``("pod", "data")``) runs among the ranks
that share this rank's coordinates on every other axis. :func:`build_mesh`
creates one process group for each such set of ranks, for every set of
axes, on every rank together (``torch.distributed.new_group`` is collective
over the whole group, even for ranks outside the new one), and
:meth:`Mesh.axis_group` hands out this rank's. A set of axes of size 1
needs no group. No ``torch.distributed.device_mesh`` is built: its CUDA
meshes assume NCCL.

As in the JAX package, the functions build a mesh only when called, and
raise when the process group holds fewer ranks than the shape asks for (or
more: the caller starts as many ranks as the mesh holds).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a mesh of ranks.

    ``shape``: axis name -> size, in axis order; ``coords``: this rank's
    index on each axis; ``index``: their row-major flattening (the rank's
    position in ``P(axis_names)``, the partitions it holds); ``device``:
    where this rank's tensors live; ``group``: the process group of the
    mesh's ranks (None: the default group); ``groups``: this rank's process
    group for each set of axes (a tuple in axis order) of size > 1 below the
    whole mesh (:func:`build_mesh` fills it)."""

    shape: dict
    axis_names: Tuple[str, ...]
    coords: dict
    index: int
    device: torch.device
    group: Optional[object] = None
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (None, a name or names) as the mesh's own axes among
        them, in axis order; names the mesh lacks drop out, as JAX's
        sharder drops them."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self.axes(axes)], dtype=np.int64))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (its block index along
        a dimension those axes cut; JAX's ``axis_index``)."""
        k = 0
        for a in self.axes(axes):
            k = k * self.shape[a] + int(self.coords[a])
        return k

    def axis_group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates on every axis outside ``axes``, ordered by their index
        over ``axes``; None when ``axes`` has size 1 (nothing to talk to)."""
        axes = self.axes(axes)
        if self.axis_size(axes) == 1:
            return None
        if all(self.shape[a] == 1 or a in axes for a in self.axis_names):
            return self.group if self.group is not None else dist.group.WORLD
        live = tuple(a for a in axes if self.shape[a] > 1)
        if live not in self.groups:
            raise RuntimeError(f"mesh {self.shape} has no process group over "
                               f"{axes}: build it with build_mesh")
        return self.groups[live]

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def rank_device(device="auto", rank: Optional[int] = None) -> torch.device:
    """A rank's default device: ``cuda:(rank % device_count)``, so ranks
    beyond the cards share them; the CPU only when asked (``"cpu"``).
    ``"auto"`` raises without a card."""
    if isinstance(device, torch.device):
        return device
    if device != "auto":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("mesh device 'auto' needs a CUDA device; pass "
                           "device='cpu' for ranks on the CPU")
    r = dist.get_rank() if rank is None else rank
    return torch.device("cuda", r % torch.cuda.device_count())


def build_mesh(shape, axis_names, *, device="auto", group=None) -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` (sizes, one per name in
    ``axis_names``) over the ranks of ``group`` (None: the default group),
    which must hold exactly as many ranks as the shape."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh: initialise torch.distributed first "
                           "(init_process_group with its backend, address, "
                           "world size and rank)")
    world = dist.get_world_size(group)
    n = int(np.prod(shape, dtype=np.int64))
    if world != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks but the process "
                           f"group holds {world}")
    index = dist.get_rank(group)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(index, shape))))
    return Mesh(dict(zip(axis_names, shape)), axis_names, coords, index,
                rank_device(device), group, _axis_groups(shape, axis_names,
                                                         index, group))


def _axis_groups(shape, axis_names, index, group) -> dict:
    """This rank's process group for every set of axes of size > 1 (axes of
    size 1 left out) short of all of them. Every rank creates every group,
    in one order."""
    live = [i for i, n in enumerate(shape) if n > 1]
    members = (list(range(int(np.prod(shape, dtype=np.int64)))) if group is None
               else dist.get_process_group_ranks(group))
    grid = np.arange(len(members)).reshape(shape)
    out = {}
    for r in range(1, len(live)):
        for sub in itertools.combinations(live, r):
            rest = [i for i in range(len(shape)) if i not in sub]
            # the ranks of one coset: the subset's axes last, row-major
            cosets = np.transpose(grid, rest + list(sub)).reshape(
                -1, int(np.prod([shape[i] for i in sub])))
            for row in cosets:
                g = dist.new_group([members[int(i)] for i in row])
                if index in row:
                    out[tuple(axis_names[i] for i in sub)] = g
    return out


def make_production_mesh(*, multi_pod: bool = False, pods: int = 2,
                         device="auto") -> Mesh:
    """The JAX package's production shapes: (16, 16) ("data", "model"), or
    (pods, 16, 16) ("pod", "data", "model")."""
    shape = (pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes, device=device)


def make_mesh_for(devices_total: int, model_parallel: int = 16, pods: int = 1,
                  *, device="auto") -> Mesh:
    """Elastic variant: the best (pod, data, model) mesh for any rank count."""
    per_pod = devices_total // pods
    model = min(model_parallel, per_pod)
    data = per_pod // model
    if pods > 1:
        return build_mesh((pods, data, model), ("pod", "data", "model"), device=device)
    return build_mesh((data, model), ("data", "model"), device=device)
