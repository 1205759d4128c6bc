"""Ghost-cell halo exchange for post-hoc volumes (the port of
``repro.data.halo``).

In situ, ghost layers come precomputed from the simulation (the paper's
assumption — zero extra communication). For POST-HOC volumes loaded without
ghosts, this module fills them: each partition sends its owned boundary slab
to the face neighbor on the partition grid.

Two implementations with identical semantics:
- :func:`halo_exchange_ref`: the gather reference (any P, no mesh), on the
  stacked (P, ...) tensor;
- :func:`halo_exchange`: one partition a rank, one
  :func:`~repro_torch.parallel.collectives.ppermute` per face (6 in all),
  each moving an (n^2 * ghost)-cell slab; domain-edge ghosts are left
  untouched (non-periodic). The faces go in the reference's order (x, then
  y, then z; low side, then high), so the edge and corner ghosts that a
  later face's slab carries are the ones an earlier face filled, and the two
  agree bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.parallel.collectives import ppermute


def _neighbor_table(grid: Tuple[int, int, int]) -> np.ndarray:
    """(P, 3, 2) neighbor partition index per (axis, direction); -1 = none."""
    px, py, pz = grid
    P = px * py * pz
    out = np.full((P, 3, 2), -1, np.int64)
    for p in range(P):
        ix, iy, iz = p % px, (p // px) % py, p // (px * py)
        coords = [ix, iy, iz]
        dims = [px, py, pz]
        for ax in range(3):
            for d, step in ((0, -1), (1, +1)):
                c = coords.copy()
                c[ax] += step
                if 0 <= c[ax] < dims[ax]:
                    out[p, ax, d] = c[0] + px * (c[1] + py * c[2])
    return out


def _owned_slab(vol: torch.Tensor, ax: int, side: int, g: int) -> torch.Tensor:
    """The owned boundary slab a partition SENDS toward ``side`` of axis ax."""
    n = vol.shape[ax]
    lo = g if side == 0 else n - 2 * g
    return vol.narrow(ax, lo, g)


def _set_ghost(vol: torch.Tensor, slab: torch.Tensor, ax: int, side: int,
               g: int) -> torch.Tensor:
    n = vol.shape[ax]
    out = vol.clone()
    out.narrow(ax, 0 if side == 0 else n - g, g).copy_(slab)
    return out


def halo_exchange_ref(vols: torch.Tensor, grid: Tuple[int, int, int],
                      ghost: int = 1) -> torch.Tensor:
    """vols (P, nx+2g, ny+2g, nz+2g) -> same, interior ghosts filled."""
    g = ghost
    nbr = _neighbor_table(grid)
    out = vols
    for ax in range(3):
        for side in (0, 1):
            # ghost slab on ``side`` comes from the neighbor on that side,
            # which sends the slab facing the OPPOSITE direction
            src = nbr[:, ax, side]
            have = torch.as_tensor(src >= 0, device=vols.device)
            idx = torch.as_tensor(np.where(src >= 0, src, 0), device=vols.device)
            slabs = _owned_slab(out[idx], ax + 1, 1 - side, g)
            new = _set_ghost(out, slabs, ax + 1, side, g)
            out = torch.where(have.view(-1, *([1] * (vols.ndim - 1))), new, out)
    return out


def halo_exchange(vols: torch.Tensor, grid: Tuple[int, int, int], mesh,
                  ghost: int = 1) -> torch.Tensor:
    """The rank's own partition ``vols`` (1, nx+2g, ny+2g, nz+2g) with its
    interior ghosts filled from its face neighbours, one partition a rank of
    ``mesh`` (the rank's partition index is ``mesh.index``). Every rank of
    the mesh calls it; each face is one ``ppermute`` of one slab."""
    g = ghost
    n_dev = mesh.size
    if vols.shape[0] != 1 or int(np.prod(grid)) != n_dev:
        raise ValueError(f"one partition a rank: vols {tuple(vols.shape)} on "
                         f"a mesh of {n_dev} for the grid {tuple(grid)}")
    nbr = _neighbor_table(grid)
    me = mesh.index
    v = vols[0]
    for ax in range(3):
        for side in (0, 1):
            # rank r receives its ``side`` ghost from nbr[r, ax, side], which
            # sends the slab that faces the other way
            pairs = [(int(nbr[r, ax, side]), r) for r in range(n_dev)
                     if nbr[r, ax, side] >= 0]
            got = ppermute(_owned_slab(v, ax, 1 - side, g), pairs,
                           group=mesh.group)
            if nbr[me, ax, side] >= 0:
                v = _set_ghost(v, got, ax, side, g)
    return v[None]
