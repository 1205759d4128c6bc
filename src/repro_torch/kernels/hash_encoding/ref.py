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


def encode_level(coords: torch.Tensor, table: torch.Tensor, res: int,
                 table_size: int, row_base: torch.Tensor) -> torch.Tensor:
    """coords (N,3) -> (N,F) trilinearly blended features of one level.

    ``table`` holds several partitions' level tables one after another
    ((P*T, F)): ``table_size`` is one partition's T and ``row_base`` (N,)
    the offset of each point's partition in it.

    The 8-corner blend is accumulated in float32 and cast to the table dtype
    once at the end; each corner weight is first rounded to the table dtype
    (the JAX package's ``ww.astype(table.dtype)``). For float32 tables this is
    the JAX reference's arithmetic step for step."""
    T = table_size
    lo, w = _level_corners(coords, res)
    out = torch.zeros((coords.shape[0], table.shape[1]), dtype=torch.float32,
                      device=coords.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = lo + torch.tensor([dx, dy, dz], device=lo.device)
                idx = corner_indices(corner, res, T) + row_base
                ww = _corner_weight(w, dx, dy, dz).to(table.dtype)
                out = out + ww[:, None].float() * table[idx].float()
    return out.to(table.dtype)


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
                          T, row_base) for l in range(L)]
    return torch.cat(feats, dim=-1).reshape(B, N, L * F)


def hash_encode_batched_bwd_ref(g: torch.Tensor, coords: torch.Tensor,
                                resolutions, part: torch.Tensor,
                                table_shape) -> torch.Tensor:
    """The plain backward of :func:`hash_encode_batched_ref`: the 8-corner
    scatter-add of the feature cotangent ``g`` (B,N,L*F) into a table
    gradient of ``table_shape`` (P,L,T,F). A cotangent narrower than
    float32 (bf16) is widened first, so the corner weights, the products
    and the sums are float32 and the gradient is float32 (float64 stays
    float64): the function of the CUDA backward, which reads a bf16
    cotangent and adds into a float32 gradient. (JAX's ``_bwd`` rounds each
    weight and sums in ``g``'s dtype; ROADMAP §C.) ``index_add_`` covers
    every row of a (level, corner) at once through the flattened
    (P*L*T, F) gradient."""
    B, N, _ = coords.shape
    P, L, T, F = table_shape
    g = g.to(torch.promote_types(g.dtype, torch.float32))
    x = coords.reshape(B * N, 3)
    gl = g.reshape(B * N, L, F)
    base = (part.to(device=coords.device, dtype=torch.int64) * (L * T)) \
        .repeat_interleave(N)
    gt = torch.zeros((P * L * T, F), dtype=g.dtype, device=g.device)
    for l in range(L):
        res = int(resolutions[l])
        lo, w = _level_corners(x, res)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corner = lo + torch.tensor([dx, dy, dz], device=lo.device)
                    idx = corner_indices(corner, res, T) + base + l * T
                    ww = _corner_weight(w, dx, dy, dz).to(g.dtype)
                    gt.index_add_(0, idx, ww[:, None] * gl[:, l])
    return gt.reshape(P, L, T, F)


def hash_encode_batched_bwd_fx_ref(g: torch.Tensor, coords: torch.Tensor,
                                   resolutions, part: torch.Tensor,
                                   table_shape):
    """The plain version of the backward's deterministic route
    (``repro_hash_encode_bwd_fx``): every contribution ``w * g`` (float32)
    rounded once to a multiple of ``2**-FX_SHIFT`` and summed in int64
    (the kernel first sums same-row lanes of a warp, then rounds: the two
    agree within a quantum an add). Returns ``(fx (P,L,T,F) int64, flags
    (P,) int64)``: a partition gets ``FX_OVER`` for a contribution above
    ``FX_BOUND / M`` (M: its points, N times its rows in ``part``) and
    ``FX_NONFINITE`` for a NaN or Inf one."""
    from repro_torch.kernels import fixed_point as fx

    B, N, _ = coords.shape
    P, L, T, F = table_shape
    part = part.to(device=coords.device, dtype=torch.int64).reshape(-1)
    g = g.float()
    x = coords.reshape(B * N, 3)
    gl = g.reshape(B * N, L, F)
    rows = torch.bincount(part, minlength=P)
    vmax = torch.tensor(fx.FX_BOUND / (N * max(int(rows.max()), 1)),
                        dtype=torch.float32)
    point_part = part.repeat_interleave(N)
    base = point_part * (L * T)
    acc = torch.zeros((P * L * T, F), dtype=torch.int64, device=g.device)
    over = torch.zeros(P, dtype=torch.int64, device=g.device)
    nonfinite = torch.zeros_like(over)
    for l in range(L):
        res = int(resolutions[l])
        lo, w = _level_corners(x, res)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corner = lo + torch.tensor([dx, dy, dz], device=lo.device)
                    idx = corner_indices(corner, res, T) + base + l * T
                    v = _corner_weight(w, dx, dy, dz)[:, None] * gl[:, l]
                    m = v.abs()
                    fin = torch.isfinite(m)
                    over.scatter_reduce_(0, point_part, ((m > vmax) & fin)
                                         .any(1).long(), reduce="amax")
                    nonfinite.scatter_reduce_(0, point_part, (~fin).any(1).long(),
                                              reduce="amax")
                    q = torch.round(torch.nan_to_num(v) * 2.0 ** fx.FX_SHIFT) \
                        .to(torch.int64)
                    acc.index_add_(0, idx, q)
    return (acc.reshape(P, L, T, F),
            over * fx.FX_OVER | nonfinite * fx.FX_NONFINITE)


def fx_to_float(fx_sums: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """The route's conversion: each int64 entry times ``2**-FX_SHIFT`` in
    float64, rounded once to float32; NaN for a flagged partition."""
    from repro_torch.kernels.fixed_point import FX_SHIFT

    out = (fx_sums.double() * 2.0 ** -FX_SHIFT).float()
    bad = (flags != 0).reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(bad, torch.full_like(out, float("nan")), out)
