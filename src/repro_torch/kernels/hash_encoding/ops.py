"""Hash encoding: backend dispatch, the autograd function, and the CUDA
kernels' wrappers.

``hash_encode`` is the single-model op (coords (N,3) against tables
(L,T,F)); ``hash_encode_batched`` is the hot-path form: coordinate rows
(B,N,3) against partition-stacked tables (P,L,T,F), where row ``b`` reads
partition ``part[b]`` — one launch covers every partition and every client
of a render. Both are differentiable in the tables (the coordinates get no
gradient, as in the JAX package): the backward is the 8-corner scatter-add
of the feature cotangent, ``index_add_`` in the plain version and the
scatter of ``repro_hash_encode_bwd`` (``csrc/hash_encode.cu``) on the card,
routed per level by ``bwd_plan``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch import backends
from repro_torch.kernels import build
from repro_torch.kernels.hash_encoding import ref as _ref


#: shared memory a backward block may give one level's gradient slab
#: (rows x F float32): the H100 offers a block 227 KB
STAGE_BUDGET_BYTES = 200 * 1024
#: levels a kernel takes (its resolutions travel as a kernel argument)
MAX_LEVELS = 32


def level_rows(res: int, T: int) -> int:
    """The rows of its table a level uses: (res+1)^3 when they fit T (a
    dense level), else T (hashed); ``level_rows`` of ``csrc/hash_grid.cuh``."""
    return min((int(res) + 1) ** 3, int(T))


def bwd_plan(resolutions: Sequence[int], T: int, F: int) -> list:
    """The backward kernel's route per level: True (stage the level's
    rows x F float32 gradient slab in shared memory, flush it once per
    block) exactly when the slab fits ``STAGE_BUDGET_BYTES``, else False
    (each row goes straight to the device gradient as one vector atomic).
    A level uses (res+1)^3 rows of its table when they fit T, else T."""
    return [level_rows(r, T) * F * 4 <= STAGE_BUDGET_BYTES for r in resolutions]


def levels_arg(resolutions: Sequence[int]):
    """The resolutions as the C entries take them: an int32 array in host
    memory (at most ``MAX_LEVELS``)."""
    if len(resolutions) > MAX_LEVELS:
        raise ValueError(f"{len(resolutions)} levels: the kernels take at "
                         f"most {MAX_LEVELS}")
    return (ctypes.c_int * len(resolutions))(*(int(r) for r in resolutions))


def _res_tensor(resolutions, device) -> torch.Tensor:
    return torch.as_tensor([int(r) for r in resolutions], dtype=torch.int32) \
        .to(device)


def hash_encode_cuda(coords: torch.Tensor, tables: torch.Tensor,
                     resolutions: Sequence[int], part) -> torch.Tensor:
    """The forward kernel's wrapper: coords (B,N,3) f32, tables (P,L,T,F)
    f32/bf16, ``part`` (B,) partition of each row -> (B, N, L*F) in the
    table dtype.

    CPU tensors take the plain version; CUDA tensors launch
    ``repro_hash_encode_fwd`` (``csrc/hash_encode.cu``: one (point, level)
    pair per thread, each corner row one vector load) or raise."""
    B, N, three = coords.shape
    P, L, T, F = tables.shape
    if three != 3:
        raise ValueError(f"coords must be (B,N,3), got {tuple(coords.shape)}")
    if len(resolutions) != L:
        raise ValueError(f"{len(resolutions)} resolutions for {L} levels")
    if coords.device.type == "cpu":
        return _ref.hash_encode_batched_ref(coords, tables, resolutions,
                                            torch.as_tensor(part))
    if coords.device.type != "cuda" or tables.device != coords.device:
        raise ValueError("hash_encode_cuda: coords and tables must lie on one "
                         "CUDA device")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if tables.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tables must be float32 or bfloat16, got {tables.dtype}")
    if F not in (1, 2, 4, 8) or T >= 2**32 or B > 65535:
        raise ValueError(f"unsupported shape: F={F} (1, 2, 4 or 8), T={T} "
                         f"(< 2^32), B={B} (<= 65535)")
    coords = coords.contiguous()
    tables = tables.contiguous()
    if tables.data_ptr() % 16:
        raise ValueError("hash_encode_cuda: the tables must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    part_d = build.part_tensor(part, B, P, coords.device)
    res_d = _res_tensor(resolutions, coords.device)
    out = torch.empty((B, N, L * F), dtype=tables.dtype, device=coords.device)
    lib = build.library()
    err = lib.repro_hash_encode_fwd(
        coords.data_ptr(), tables.data_ptr(), res_d.data_ptr(),
        part_d.data_ptr(), out.data_ptr(), B, N, L, T, F,
        int(tables.dtype == torch.bfloat16),
        torch.cuda.current_stream(coords.device).cuda_stream)
    build.check(err, "repro_hash_encode_fwd")
    hash_encode_cuda.launches += 1
    return out


hash_encode_cuda.launches = 0


def hash_encode_bwd_cuda(g: torch.Tensor, coords: torch.Tensor,
                         resolutions: Sequence[int], part,
                         table_shape) -> torch.Tensor:
    """The backward kernel's wrapper: feature cotangent ``g`` (B,N,L*F),
    float32 or bfloat16, coords (B,N,3), ``part`` (B,) -> the table gradient
    (P,L,T,F) in float32 (``table_shape`` = (P,L,T,F)).

    CPU tensors take the plain version (a bf16 ``g`` widened to float32
    first: the kernel's function); CUDA tensors launch
    ``repro_hash_encode_bwd`` (``csrc/hash_encode.cu``: one launch per
    level, same-row lanes summed per warp, then shared-memory staging or
    vector atomics into a zeroed f32 gradient as ``bwd_plan`` says; a bf16
    ``g`` read as one vector per (row, level) and widened) or raise (also
    under ``torch.use_deterministic_algorithms(True)``: its atomics);
    ``launches`` counts the L kernel launches of each call."""
    B, N, three = coords.shape
    P, L, T, F = (int(d) for d in table_shape)
    if three != 3 or tuple(g.shape) != (B, N, L * F):
        raise ValueError(f"coords (B,N,3) and g (B,N,L*F) expected, got "
                         f"{tuple(coords.shape)} and {tuple(g.shape)}")
    if len(resolutions) != L:
        raise ValueError(f"{len(resolutions)} resolutions for {L} levels")
    if coords.device.type == "cpu":
        return _ref.hash_encode_batched_bwd_ref(g, coords, resolutions,
                                                torch.as_tensor(part),
                                                (P, L, T, F))
    build.refuse_nondeterministic("hash_encode_bwd_cuda")
    if coords.device.type != "cuda" or g.device != coords.device:
        raise ValueError("hash_encode_bwd_cuda: g and coords must lie on one "
                         "CUDA device")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if F not in (1, 2, 4, 8) or T >= 2**32 or B > 65535:
        raise ValueError(f"unsupported shape: F={F} (1, 2, 4 or 8), T={T} "
                         f"(< 2^32), B={B} (<= 65535)")
    g = g.contiguous()
    if g.dtype == torch.bfloat16 and g.data_ptr() % 16:
        raise ValueError("hash_encode_bwd_cuda: a bf16 g must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    coords = coords.contiguous()
    part_d = build.part_tensor(part, B, P, coords.device)
    res_h = (ctypes.c_int * L)(*(int(r) for r in resolutions))
    staged_h = (ctypes.c_int * L)(*bwd_plan(resolutions, T, F))
    grad = torch.zeros((P, L, T, F), dtype=torch.float32, device=g.device)
    lib = build.library()
    err = lib.repro_hash_encode_bwd(
        g.data_ptr(), coords.data_ptr(), ctypes.addressof(res_h),
        ctypes.addressof(staged_h), part_d.data_ptr(),
        grad.data_ptr(), B, N, L, T, F, int(g.dtype == torch.bfloat16),
        torch.cuda.current_stream(coords.device).cuda_stream)
    build.check(err, "repro_hash_encode_bwd")
    hash_encode_bwd_cuda.launches += L   # one kernel launch per level
    hash_encode_bwd_cuda.bf16_launches += L * (g.dtype == torch.bfloat16)
    return grad


#: launches of the kernel, and of its bf16-cotangent instantiation among them
hash_encode_bwd_cuda.launches = hash_encode_bwd_cuda.bf16_launches = 0


class _HashEncodeBatched(torch.autograd.Function):
    """Forward through the backend's encode; backward the corner scatter
    (the CUDA backward kernel on the ``cuda`` backend)."""

    @staticmethod
    def forward(ctx, coords, tables, resolutions, part, backend):
        part_t = torch.as_tensor(part, dtype=torch.int64, device="cpu") \
            .reshape(-1)
        ctx.save_for_backward(coords)
        ctx.part, ctx.resolutions, ctx.backend = part_t, resolutions, backend
        ctx.table_shape, ctx.table_dtype = tuple(tables.shape), tables.dtype
        if backend.is_cuda:
            return hash_encode_cuda(coords, tables, resolutions, part_t)
        return _ref.hash_encode_batched_ref(coords, tables, resolutions,
                                            part_t.to(coords.device))

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        if ctx.backend.is_cuda:
            grad = hash_encode_bwd_cuda(g, coords, ctx.resolutions, ctx.part,
                                        ctx.table_shape)
        else:
            grad = _ref.hash_encode_batched_bwd_ref(
                g, coords, ctx.resolutions, ctx.part.to(coords.device),
                ctx.table_shape)
        return None, grad.to(ctx.table_dtype), None, None, None


def hash_encode_batched(coords, tables, resolutions: Sequence[int], part,
                        impl: backends.BackendLike = "ref", *,
                        compute_dtype=None):
    """coords (B,N,3); tables (P,L,T,F); part (B,) -> (B, N, L*F),
    differentiable in ``tables``."""
    backend = backends.resolve(impl)
    if compute_dtype is not None:
        tables = tables.to(backend.require_dtype(compute_dtype))
    return _HashEncodeBatched.apply(coords, tables, tuple(resolutions), part,
                                    backend)


def hash_encode(coords, tables, resolutions: Sequence[int],
                impl: backends.BackendLike = "ref", *, compute_dtype=None):
    """coords (N,3) in [0,1]; tables (L,T,F) -> (N, L*F) in the table dtype
    (or ``compute_dtype``'s: the tables are cast first; coords stay f32).
    Differentiable in ``tables``."""
    return hash_encode_batched(coords[None], tables[None], resolutions, [0],
                               impl, compute_dtype=compute_dtype)[0]
