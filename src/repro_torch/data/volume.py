"""Synthetic simulation volumes and domain decomposition with ghost cells.

The port of ``repro.data.volume``: the same analytic fields (CloverLeaf-,
NekRS-, S3D-, magnetic-like and a velocity field), the same near-cubic
partition grid and cell-centred partitions with a ghost band. The constants
are float64 on the host and enter the float32 arithmetic one rounded scalar
at a time, in the same order as the JAX package, so the fields agree to the
ULP noise of the two frameworks' transcendentals.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.backends import resolve_device


def _octaves(kind_seed: int, n: int = 10):
    rng = np.random.default_rng(kind_seed)
    freqs = 2.0 ** rng.uniform(1.0, 5.0, (n, 3))
    phases = rng.uniform(0, 2 * np.pi, (n, 3))
    amps = rng.uniform(0.3, 1.0, n) / np.arange(1, n + 1)
    return freqs, phases, amps


_FIELDS = {}
_TWO_PI = 2 * np.pi


def _register(name):
    def deco(fn):
        _FIELDS[name] = fn
        return fn
    return deco


@_register("cloverleaf")
def _cloverleaf(x, y, z, t):
    r = torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    front = 0.15 + 0.5 * t
    shock = torch.exp(-((r - front) / 0.03) ** 2) * 4.0
    interior = torch.where(r < front, 2.0 - r / max(front, 1e-3),
                           torch.full_like(r, 0.1))
    return shock + interior + 0.2 * x


@_register("nekrs")
def _nekrs(x, y, z, t):
    freqs, phases, amps = _octaves(7)
    v = torch.zeros_like(x)
    for i in range(len(amps)):
        fx, fy, fz = freqs[i]
        px, py, pz = phases[i]
        v = v + float(amps[i]) * (
            torch.sin(float(_TWO_PI * fx) * x + float(px) + 2.1 * t)
            * torch.sin(float(_TWO_PI * fy) * y + float(py) - 1.3 * t)
            * torch.sin(float(_TWO_PI * fz) * z + float(pz) + 0.7 * t)
        )
    return v


@_register("s3d")
def _s3d(x, y, z, t):
    freqs, phases, amps = _octaves(13, 6)
    wrinkle = torch.zeros_like(x)
    for i in range(len(amps)):
        fx, fy, _ = freqs[i]
        px, py, _ = phases[i]
        wrinkle = wrinkle + float(0.03 * amps[i]) \
            * torch.sin(float(_TWO_PI * fx) * x + float(px) + t) \
            * torch.cos(float(_TWO_PI * fy) * y + float(py) - 0.5 * t)
    sheet = torch.exp(-((z - 0.5 - wrinkle) / 0.02) ** 2)
    hotspots = torch.exp(-(((x - 0.3 - 0.2 * t) / 0.08) ** 2
                           + ((y - 0.6) / 0.08) ** 2
                           + ((z - 0.5) / 0.05) ** 2))
    return sheet + 1.5 * hotspots


@_register("magnetic")
def _magnetic(x, y, z, t):
    b = torch.tanh((y - 0.5) / 0.05)
    island = 0.3 * torch.cos(float(4 * np.pi) * (x + 0.1 * t)) \
        * torch.exp(-((y - 0.5) / 0.1) ** 2)
    return b + island + 0.1 * torch.sin(float(_TWO_PI) * z)


@_register("velocity")
def _velocity(x, y, z, t):
    u = torch.sin(float(_TWO_PI) * x + t) * torch.cos(float(_TWO_PI) * y)
    v = -torch.cos(float(_TWO_PI) * x + t) * torch.sin(float(_TWO_PI) * y)
    w = 0.3 * torch.sin(float(_TWO_PI) * z + 0.5 * t)
    return torch.stack([u, v, w], dim=-1)


def synthetic_field(kind: str, coords: torch.Tensor, t: float = 0.0):
    """coords (..., 3) in global [0,1]^3 -> field values (...,) or (..., 3)."""
    fn = _FIELDS[kind]
    return fn(coords[..., 0], coords[..., 1], coords[..., 2], float(t))


def partition_grid(n_parts: int) -> Tuple[int, int, int]:
    """Near-cubic 3D factorization of n_parts (largest factors first on z)."""
    best = (1, 1, n_parts)
    best_cost = float("inf")
    for px in range(1, n_parts + 1):
        if n_parts % px:
            continue
        rem = n_parts // px
        for py in range(1, rem + 1):
            if rem % py:
                continue
            pz = rem // py
            cost = max(px, py, pz) / min(px, py, pz)
            if cost < best_cost:
                best_cost, best = cost, (px, py, pz)
    return best


@dataclass
class VolumePartition:
    """One rank's box partition (with ghost layer) of the global volume."""

    data: torch.Tensor           # (nx+2g, ny+2g, nz+2g) raw values incl. ghosts
    origin: Tuple[float, ...]    # lower corner in global [0,1]^3
    extent: Tuple[float, ...]    # size in global coords
    ghost: int
    vmin: float
    vmax: float

    @property
    def owned_shape(self) -> Tuple[int, int, int]:
        g = self.ghost
        return tuple(s - 2 * g for s in self.data.shape[:3])

    def normalized(self) -> torch.Tensor:
        """Values scaled to [0,1] using the partition min/max (paper III-A)."""
        scale = max(self.vmax - self.vmin, 1e-12)
        return (self.data - self.vmin) / scale


def make_partition(kind: str, part_idx: int, grid: Tuple[int, int, int],
                   local_shape: Tuple[int, int, int], t: float = 0.0,
                   ghost: int = 1, device="auto") -> VolumePartition:
    """Generate rank ``part_idx``'s partition (cell-centred, ghost included)
    on ``device`` (``"auto"``: the GPU)."""
    dev = resolve_device(device)
    px, py, pz = grid
    ix = part_idx % px
    iy = (part_idx // px) % py
    iz = part_idx // (px * py)
    nx, ny, nz = local_shape
    ext = (1.0 / px, 1.0 / py, 1.0 / pz)
    org = (ix * ext[0], iy * ext[1], iz * ext[2])
    g = ghost

    def centers(n, o, e):
        i = np.arange(-g, n + g) + 0.5
        return torch.as_tensor(o + (i / n) * e, dtype=torch.float32, device=dev)

    X, Y, Z = torch.meshgrid(centers(nx, org[0], ext[0]),
                             centers(ny, org[1], ext[1]),
                             centers(nz, org[2], ext[2]), indexing="ij")
    coords = torch.stack([X, Y, Z], dim=-1)
    data = synthetic_field(kind, coords, t).to(torch.float32)
    owned = data[g:data.shape[0] - g, g:data.shape[1] - g, g:data.shape[2] - g] \
        if g else data
    return VolumePartition(data, org, ext, g, float(owned.min()),
                           float(owned.max()))


_CORNERS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                    -1).reshape(8, 3)


def sample_trilinear(data: torch.Tensor, coords01: torch.Tensor, ghost: int = 1):
    """Trilinear sampling of a local partition at normalized local coords.

    ``data``: (nx+2g, ny+2g, nz+2g[, C]); ``coords01``: (N,3) in [0,1]^3 over
    the *owned* region. Ghost cells extend valid interpolation across
    partition boundaries (paper Fig. 2A)."""
    g = ghost
    dev = coords01.device
    shape = torch.tensor(data.shape[:3], dtype=torch.float32, device=dev)
    owned = shape - 2 * g
    pos = coords01 * owned - 0.5 + g
    lo = torch.minimum(torch.clamp(torch.floor(pos), min=0), shape - 2) \
        .to(torch.int64)
    w = torch.clamp(pos - lo.to(pos.dtype), 0.0, 1.0)
    off = torch.as_tensor(_CORNERS, dtype=torch.int64, device=dev)
    corner = lo[:, None, :] + off[None]                       # (N,8,3)
    nx, ny, nz = data.shape[:3]
    lin = (corner[..., 0] * ny + corner[..., 1]) * nz + corner[..., 2]
    flat = data.reshape(nx * ny * nz, *data.shape[3:])
    vals = flat[lin.reshape(-1)].reshape(*lin.shape, *data.shape[3:])
    wsel = torch.where(off[None] == 1, w[:, None, :], 1.0 - w[:, None, :])
    ww = wsel[..., 0] * wsel[..., 1] * wsel[..., 2]           # (N,8)
    if vals.ndim == 3:
        return torch.einsum("nc,ncd->nd", ww, vals)
    return torch.einsum("nc,nc->n", ww, vals)


def sample_trilinear_batched(vols: torch.Tensor, coords01: torch.Tensor,
                             ghost: int = 1) -> torch.Tensor:
    """:func:`sample_trilinear` of P partitions at once: ``vols``
    (P, nx+2g, ny+2g, nz+2g[, C]), ``coords01`` (P, N, 3) -> (P, N[, C]).
    One gather covers every partition (no Python loop over P); the
    arithmetic is :func:`sample_trilinear`'s."""
    g = ghost
    dev = coords01.device
    P = vols.shape[0]
    nx, ny, nz = vols.shape[1:4]
    shape = torch.tensor((nx, ny, nz), dtype=torch.float32, device=dev)
    owned = shape - 2 * g
    pos = coords01 * owned - 0.5 + g
    lo = torch.minimum(torch.clamp(torch.floor(pos), min=0), shape - 2) \
        .to(torch.int64)
    w = torch.clamp(pos - lo.to(pos.dtype), 0.0, 1.0)
    off = torch.as_tensor(_CORNERS, dtype=torch.int64, device=dev)
    corner = lo[:, :, None, :] + off                          # (P,N,8,3)
    lin = (corner[..., 0] * ny + corner[..., 1]) * nz + corner[..., 2]
    lin = lin + (torch.arange(P, device=dev) * (nx * ny * nz))[:, None, None]
    flat = vols.reshape(P * nx * ny * nz, *vols.shape[4:])
    vals = flat[lin.reshape(-1)].reshape(*lin.shape, *vols.shape[4:])
    wsel = torch.where(off == 1, w[:, :, None, :], 1.0 - w[:, :, None, :])
    ww = wsel[..., 0] * wsel[..., 1] * wsel[..., 2]           # (P,N,8)
    if vals.ndim == 4:
        return torch.einsum("pnc,pncd->pnd", ww, vals)
    return torch.einsum("pnc,pnc->pn", ww, vals)
