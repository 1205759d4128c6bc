"""Hash encoding: backend dispatch and the CUDA kernel's wrapper.

``hash_encode`` is the single-model op (coords (N,3) against tables (L,T,F));
``hash_encode_batched`` is the hot-path form: coordinate rows (B,N,3)
against partition-stacked tables (P,L,T,F), where row ``b`` reads partition
``part[b]`` — one launch covers every partition and every client of a render.
Forward only in this slice (the backward scatter comes with training).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import backends
from repro_torch.kernels import build
from repro_torch.kernels.hash_encoding import ref as _ref


def hash_encode_cuda(coords: torch.Tensor, tables: torch.Tensor,
                     resolutions: Sequence[int], part) -> torch.Tensor:
    """The kernel's wrapper: coords (B,N,3) f32, tables (P,L,T,F) f32/bf16,
    ``part`` (B,) partition of each row -> (B, N, L*F) in the table dtype.

    CPU tensors take the plain version; CUDA tensors launch
    ``repro_hash_encode_fwd`` (``csrc/hash_encode.cu``) or raise."""
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
    part_d = build.part_tensor(part, B, P, coords.device)
    res_d = torch.as_tensor([int(r) for r in resolutions], dtype=torch.int32) \
        .to(coords.device)
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


def hash_encode_batched(coords, tables, resolutions: Sequence[int], part,
                        impl: backends.BackendLike = "ref", *,
                        compute_dtype=None):
    """coords (B,N,3); tables (P,L,T,F); part (B,) -> (B, N, L*F)."""
    backend = backends.resolve(impl)
    if compute_dtype is not None:
        tables = tables.to(backend.require_dtype(compute_dtype))
    if backend.is_cuda:
        return hash_encode_cuda(coords, tables, resolutions, part)
    return _ref.hash_encode_batched_ref(
        coords, tables, resolutions,
        torch.as_tensor(part, device=coords.device))


def hash_encode(coords, tables, resolutions: Sequence[int],
                impl: backends.BackendLike = "ref", *, compute_dtype=None):
    """coords (N,3) in [0,1]; tables (L,T,F) -> (N, L*F) in the table dtype
    (or ``compute_dtype``'s: the tables are cast first; coords stay f32)."""
    backend = backends.resolve(impl)
    if compute_dtype is not None:
        tables = tables.to(backend.require_dtype(compute_dtype))
    if backend.is_cuda:
        return hash_encode_cuda(coords[None], tables[None], resolutions, [0])[0]
    return _ref.hash_encode_ref(coords, tables, resolutions)
