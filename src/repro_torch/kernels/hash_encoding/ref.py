"""Plain PyTorch multi-resolution hash encoding (instant-ngp style).

The port of ``repro.kernels.hash_encoding.ref``. Layout: level ``l`` owns
``tables[l] : (T, F)``. Levels whose dense grid fits the table
((R_l+1)^3 <= T) are indexed densely; larger levels use the spatial hash
``idx = (x * p0 ^ y * p1 ^ z * p2) mod T`` in uint32 arithmetic.

PyTorch's uint32 arithmetic is incomplete on the CPU, so the hash runs in
int64 and is masked with ``& 0xFFFFFFFF`` after each product: every corner
coordinate is below 2^31 and every prime below 2^32, so no product leaves
int64 and the masked value is the uint32 wraparound exactly.
"""
from __future__ import annotations

from typing import Optional

import torch

PRIMES = (1, 2_654_435_761, 805_459_861)
_MASK32 = 0xFFFFFFFF


def corner_indices(ijk: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """ijk (..., 3) integer corner coords in [0, res] -> (...,) int64 index."""
    n_dense = (res + 1) ** 3
    u = ijk.to(torch.int64)
    if n_dense <= table_size:
        return u[..., 0] + (res + 1) * (u[..., 1] + (res + 1) * u[..., 2])
    h = ((u[..., 0] * PRIMES[0]) & _MASK32) \
        ^ ((u[..., 1] * PRIMES[1]) & _MASK32) \
        ^ ((u[..., 2] * PRIMES[2]) & _MASK32)
    return h % table_size


def _level_corners(coords: torch.Tensor, res: int):
    """(lo (N,3) int64, w (N,3) f32): the clamped lower corner and the
    UNclamped fractional offset (coordinates outside [0,1] extrapolate, as in
    the JAX package)."""
    pos = coords * float(res)
    lo_f = torch.clamp(torch.floor(pos), 0, max(res - 1, 0))
    return lo_f.to(torch.int64), pos - lo_f


def _corner_weight(w: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    return ((w[..., 0] if dx else 1 - w[..., 0])
            * (w[..., 1] if dy else 1 - w[..., 1])
            * (w[..., 2] if dz else 1 - w[..., 2]))


def encode_level(coords: torch.Tensor, table: torch.Tensor, res: int, *,
                 table_size: Optional[int] = None,
                 row_base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """coords (N,3); table (T,F) -> (N,F) trilinearly blended features.

    The 8-corner blend is accumulated in float32 and cast to the table dtype
    once at the end; each corner weight is first rounded to the table dtype
    (the JAX package's ``ww.astype(table.dtype)``). For float32 tables this is
    the JAX reference's arithmetic step for step.

    ``table`` may hold several partitions' level tables one after another
    ((P*T, F)): then ``table_size`` is one partition's T and ``row_base`` (N,)
    the offset of each point's partition in it."""
    T = table.shape[0] if table_size is None else table_size
    lo, w = _level_corners(coords, res)
    out = torch.zeros((coords.shape[0], table.shape[1]), dtype=torch.float32,
                      device=coords.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = lo + torch.tensor([dx, dy, dz], device=lo.device)
                idx = corner_indices(corner, res, T)
                if row_base is not None:
                    idx = idx + row_base
                ww = _corner_weight(w, dx, dy, dz).to(table.dtype)
                out = out + ww[:, None].float() * table[idx].float()
    return out.to(table.dtype)


def hash_encode_ref(coords: torch.Tensor, tables: torch.Tensor,
                    resolutions) -> torch.Tensor:
    """coords (N,3) in [0,1]; tables (L,T,F) -> (N, L*F) in the table dtype."""
    feats = [encode_level(coords, tables[l], int(resolutions[l]))
             for l in range(tables.shape[0])]
    return torch.cat(feats, dim=-1)


def hash_encode_batched_ref(coords: torch.Tensor, tables: torch.Tensor,
                            resolutions, part: torch.Tensor) -> torch.Tensor:
    """The plain version of the batched kernel: coords (B,N,3) against
    partition-stacked tables (P,L,T,F); batch row ``b`` reads the tables of
    partition ``part[b]``. Returns (B, N, L*F). One gather per (level,
    corner) covers every row, through the flattened (P*T, F) level table."""
    B, N, _ = coords.shape
    P, L, T, F = tables.shape
    row_base = (part.to(device=coords.device, dtype=torch.int64) * T) \
        .repeat_interleave(N)
    x = coords.reshape(B * N, 3)
    feats = [encode_level(x, tables[:, l].reshape(P * T, F), int(resolutions[l]),
                          table_size=T, row_base=row_base) for l in range(L)]
    return torch.cat(feats, dim=-1).reshape(B, N, L * F)
