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
needs a card a rank. Nothing falls back from one to the other. The DVNR
path shards only over all axes at once (the partition axis), so no per-axis
subgroup, and no ``torch.distributed.device_mesh`` (whose CUDA meshes
assume NCCL), is built.

As in the JAX package, the functions build a mesh only when called, and
raise when the process group holds fewer ranks than the shape asks for (or
more: the caller starts as many ranks as the mesh holds).
"""
from __future__ import annotations

from dataclasses import dataclass
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
    mesh's ranks (None: the default group)."""

    shape: dict
    axis_names: Tuple[str, ...]
    coords: dict
    index: int
    device: torch.device
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

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
                rank_device(device), group)


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
