"""Isosurface extraction compatible with DVNR models (paper §IV-C, Fig. 11).

The port of ``repro.core.isosurface``. Marching *tetrahedra* over an
on-demand sampled vertex grid: each cell is split into 6 tets; sign changes
on tet edges produce 1-2 triangles with linear edge interpolation. The
output has a fixed size plus a validity mask, in the JAX package's layout
and order, and the same float32 arithmetic, so the two packages give the
same triangles on the same grid bit for bit.

The port walks the cells in chunks (``CELLS_PER_CHUNK``) and concatenates:
every cell is independent, so the triangles and their order are those of
one pass, while the intermediates stay bounded (one pass over 127^3 cells
would build ~6-7 GB of them).

Accuracy is measured as in the paper with the bidirectional Chamfer
distance between extracted surfaces.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import backends
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import _inr_apply

#: cells a pass of :func:`marching_tets` takes (~1 GB of intermediates)
CELLS_PER_CHUNK = 1 << 18

# Cube corner offsets (x,y,z) indexed 0..7.
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int64)

# 6-tet decomposition of the cube (consistent diagonal 0-6).
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int64)

# Tet edges: pairs of local tet-vertex indices.
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# case (4-bit inside mask) -> up to 2 triangles, each 3 edge ids; -1 = unused.
# Standard marching-tetrahedra table (orientation not normalized).
_TRI_TABLE = np.full((16, 2, 3), -1, np.int64)
_TRI_TABLE[0b0001] = [[0, 1, 2], [-1, -1, -1]]           # v0 inside
_TRI_TABLE[0b0010] = [[0, 4, 3], [-1, -1, -1]]           # v1
_TRI_TABLE[0b0100] = [[1, 3, 5], [-1, -1, -1]]           # v2
_TRI_TABLE[0b1000] = [[2, 5, 4], [-1, -1, -1]]           # v3
_TRI_TABLE[0b0011] = [[1, 2, 4], [1, 4, 3]]              # v0 v1
_TRI_TABLE[0b0101] = [[0, 3, 5], [0, 5, 2]]              # v0 v2
_TRI_TABLE[0b1001] = [[0, 1, 5], [0, 5, 4]]              # v0 v3
_TRI_TABLE[0b0110] = [[0, 1, 5], [0, 5, 4]]              # v1 v2 (complement of v0v3)
_TRI_TABLE[0b1010] = [[0, 3, 5], [0, 5, 2]]              # v1 v3
_TRI_TABLE[0b1100] = [[1, 2, 4], [1, 4, 3]]              # v2 v3
_TRI_TABLE[0b0111] = [[2, 5, 4], [-1, -1, -1]]           # all but v3
_TRI_TABLE[0b1011] = [[1, 3, 5], [-1, -1, -1]]           # all but v2
_TRI_TABLE[0b1101] = [[0, 4, 3], [-1, -1, -1]]           # all but v1
_TRI_TABLE[0b1110] = [[0, 1, 2], [-1, -1, -1]]           # all but v0


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _tet_triangles(vals, pos, iso):
    """vals (M,4), pos (M,4,3), iso a 0-d f32 tensor -> tris (M,2,3,3),
    valid (M,2)."""
    dev = vals.device
    inside = (vals > iso).to(torch.int64)                         # (M,4)
    case = (inside[:, 0] * 1 + inside[:, 1] * 2
            + inside[:, 2] * 4 + inside[:, 3] * 8)                # (M,)

    # interpolated crossing point on each of the 6 tet edges
    a = torch.as_tensor(_EDGES[:, 0], device=dev)
    b = torch.as_tensor(_EDGES[:, 1], device=dev)
    va = vals[:, a]                                               # (M,6)
    vb = vals[:, b]
    eps = _f32(1e-12, dev)
    d = vb - va
    t = torch.clamp((iso - va) / torch.where(torch.abs(d) < eps, eps, d),
                    0.0, 1.0)
    pa = pos[:, a]                                                # (M,6,3)
    pb = pos[:, b]
    pts = pa + t[..., None] * (pb - pa)                           # (M,6,3)

    table = torch.as_tensor(_TRI_TABLE, device=dev)               # (16,2,3)
    tri_edges = table[case]                                       # (M,2,3)
    valid = tri_edges[..., 0] >= 0                                # (M,2)
    idx = torch.clamp(tri_edges, min=0)                           # (M,2,3)
    M = vals.shape[0]
    tris = torch.gather(pts[:, None].expand(M, 2, 6, 3), 2,
                        idx[..., None].expand(M, 2, 3, 3))
    return tris, valid


def marching_tets(grid: torch.Tensor, iso: float, origin=(0.0, 0.0, 0.0),
                  extent=(1.0, 1.0, 1.0)):
    """grid (nx,ny,nz) vertex samples -> (tris (K,3,3), valid (K,)) on the
    grid's device.

    K = (nx-1)(ny-1)(nz-1)*6*2 fixed-size; masked rows are degenerate zeros.
    Triangle coordinates are in world space (origin + local*extent/shape).
    """
    grid = torch.as_tensor(grid, dtype=torch.float32)
    dev = grid.device
    nx, ny, nz = grid.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    iso_t = _f32(iso, dev)
    scale = _f32(extent, dev) / _f32([nx - 1, ny - 1, nz - 1], dev)
    org = _f32(origin, dev)
    corner_off = torch.as_tensor(_CORNERS, device=dev)            # (8,3)
    tets = torch.as_tensor(_TETS, device=dev)                     # (6,4)
    n_cells = cx * cy * cz
    tris_all, valid_all = [], []
    for c0 in range(0, n_cells, CELLS_PER_CHUNK):
        cell = torch.arange(c0, min(c0 + CELLS_PER_CHUNK, n_cells),
                            dtype=torch.int64, device=dev)
        base = torch.stack([cell // (cy * cz), (cell // cz) % cy, cell % cz],
                           -1)                                    # (C,3)
        corners = base[:, None] + corner_off[None]                # (C,8,3)
        vals8 = grid[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C,8)
        pos8 = org + corners * scale                              # (C,8,3)
        vals_t = vals8[:, tets].reshape(-1, 4)                    # (C*6,4)
        pos_t = pos8[:, tets].reshape(-1, 4, 3)                   # (C*6,4,3)
        tris, valid = _tet_triangles(vals_t, pos_t, iso_t)
        tris = tris.reshape(-1, 3, 3)
        valid = valid.reshape(-1)
        tris_all.append(torch.where(valid[:, None, None], tris,
                                    torch.zeros((), device=dev)))
        valid_all.append(valid)
    if not tris_all:
        return (torch.zeros((0, 3, 3), device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    return torch.cat(tris_all), torch.cat(valid_all)


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, n)`` in float32, bit for bit: ``i / (n-1)``
    correctly rounded for i < n-1, then 1.0 (``torch.linspace`` fills from
    both ends and can differ by an ulp)."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    return torch.cat([step, torch.ones(1, device=device)])


def inr_vertex_grid(cfg: DVNRConfig, params, shape=(64, 64, 64),
                    impl: backends.BackendLike = "ref",
                    chunk: int = 1 << 16) -> torch.Tensor:
    """The (nx, ny, nz) vertex grid over the partition's [0,1]^3 that
    :func:`isosurface_from_inr` extracts from: INR inference ``chunk``
    points at a time (first output channel) on the params' device."""
    backend = backends.resolve(impl)
    dev = params["tables"].device
    nx, ny, nz = shape
    X, Y, Z = torch.meshgrid(_linspace01(nx, dev), _linspace01(ny, dev),
                             _linspace01(nz, dev), indexing="ij")
    coords = torch.stack([X, Y, Z], -1).reshape(-1, 3)
    outs = []
    with torch.no_grad():
        for i in range(0, coords.shape[0], chunk):
            outs.append(_inr_apply(cfg, params, coords[i:i + chunk],
                                   backend)[..., 0])
    return torch.cat(outs).float().reshape(nx, ny, nz)


def isosurface_from_inr(cfg: DVNRConfig, params, iso: float,
                        shape=(64, 64, 64), origin=(0.0, 0.0, 0.0),
                        extent=(1.0, 1.0, 1.0),
                        impl: backends.BackendLike = "ref",
                        chunk: int = 1 << 16):
    """On-demand INR inference -> marching tets, never materializing more than
    ``chunk`` samples at once beyond the (small) vertex grid itself."""
    grid = inr_vertex_grid(cfg, params, shape, impl, chunk)
    return marching_tets(grid, iso, origin, extent)


def surface_points(tris, valid, max_points: int = 0) -> np.ndarray:
    """Valid triangle vertices as a point cloud (N,3) (numpy, host-side)."""
    tris = torch.as_tensor(tris)
    valid = torch.as_tensor(valid)
    pts = tris[valid].reshape(-1, 3).cpu().numpy()
    if max_points and pts.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(pts.shape[0], max_points, False)
        pts = pts[idx]
    return pts


def chamfer_distance(a, b, chunk: int = 2048) -> float:
    """Bidirectional Chamfer distance between point clouds (paper Fig. 11).
    ``a`` / ``b``: (N,3) numpy arrays or tensors; computed with PyTorch on
    the device of ``a`` (numpy: the CPU), in float64. A surface's vertices
    repeat (a tet edge's crossing is a vertex of every triangle on it), so
    each cloud's distinct points are matched once and weighted by their
    count: the same mean as over every point, at a fraction of the pairs."""
    a = torch.as_tensor(a).to(torch.float64)
    b = torch.as_tensor(b).to(device=a.device, dtype=torch.float64)
    if len(a) == 0 or len(b) == 0:
        return float("inf")
    ua, ia = torch.unique(a, dim=0, return_inverse=True)
    ub, ib = torch.unique(b, dim=0, return_inverse=True)
    # at most 2^28 distances at once (2 GiB), whatever the clouds' sizes
    rows = max(1, min(chunk, (1 << 28) // len(ub)))
    to_b, to_a = [], torch.full((len(ub),), float("inf"), dtype=torch.float64,
                                device=a.device)
    for i in range(0, len(ua), rows):
        d = torch.cdist(ua[i:i + rows], ub)
        to_b.append(d.min(dim=1).values)
        to_a = torch.minimum(to_a, d.min(dim=0).values)
    return 0.5 * (float(torch.cat(to_b)[ia].mean()) + float(to_a[ib].mean()))
