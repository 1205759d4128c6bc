"""The INR inference kernel's wrapper: the hash encode and the MLP forward
in one launch (``csrc/inr_forward.cu``), with no feature array in device
memory. ``core/inr.py`` routes decode, evaluate and render through it on
the ``cuda`` backend when no gradient is needed."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp.ops import (KERNEL_WIDTHS, MAX_OUT,
                                              SMEM_LIMIT, _stack,
                                              fwd_smem_bytes, mma_smem_bytes)
from repro_torch.kernels.hash_encoding.ops import MAX_LEVELS, _res_tensor
from repro_torch.kernels.inr_forward import ref as _ref
from repro_torch.precision import torch_dtype

#: features per level the kernel is instantiated for
KERNEL_FEATURES = (1, 2, 4, 8)


def _dtype(tables, compute_dtype) -> torch.dtype:
    return tables.dtype if compute_dtype is None else torch_dtype(compute_dtype)


def refusal(coords, tables, weights, compute_dtype=None) -> Optional[tuple]:
    """The kernel's shape and dtype rule: None when it takes these operands,
    else ``(exception type, reason)``. It takes coords (B,N,3) float32 with
    B <= 65535; tables (P,L,T,F) with L <= 32, F in {1,2,4,8}, T < 2^32;
    weights ``[w_in (P,L*F,W), hidden (P,W,W)..., w_out (P,W,D_out)]`` with
    W in {16,32,64} and D_out <= 8; a compute dtype (or, without one,
    the tables' dtype, which every weight must share) of float32 or
    bfloat16; and the weights' fragments plus one warp's 32-row feature tile
    within the 227 KB of shared memory a block may use."""
    dt = _dtype(tables, compute_dtype)
    if dt not in (torch.float32, torch.bfloat16):
        return TypeError, f"compute dtype {dt}: the kernel takes float32 or bfloat16"
    if coords.dtype != torch.float32:
        return TypeError, f"coords must be float32, got {coords.dtype}"
    if compute_dtype is None and any(w.dtype != tables.dtype for w in weights):
        return TypeError, ("tables and weights must share one dtype without a "
                           "compute dtype")
    if coords.ndim != 3 or coords.shape[-1] != 3 or tables.ndim != 4 or \
            len(weights) < 2:
        return ValueError, (f"coords (B,N,3), tables (P,L,T,F) and >= 2 weights "
                            f"expected, got {tuple(coords.shape)}, "
                            f"{tuple(tables.shape)}, {len(weights)}")
    B = coords.shape[0]
    P, L, T, F = tables.shape
    W, D_out, H = weights[0].shape[-1], weights[-1].shape[-1], len(weights) - 1
    shapes = [(P, L * F, W)] + [(P, W, W)] * (H - 1) + [(P, W, D_out)]
    if [tuple(w.shape) for w in weights] != shapes:
        return ValueError, (f"weights {[tuple(w.shape) for w in weights]} do "
                            f"not chain from L*F = {L * F} through W = {W}")
    if F not in KERNEL_FEATURES or W not in KERNEL_WIDTHS or L > MAX_LEVELS \
            or D_out > MAX_OUT or B > 65535 or T >= 2**32 or \
            mma_smem_bytes(L * F, W, H, dt.itemsize, 1) + 4 * MAX_LEVELS > SMEM_LIMIT:
        return ValueError, (f"unsupported shape: F={F} (in {KERNEL_FEATURES}), "
                            f"W={W} (in {KERNEL_WIDTHS}), L={L} (<= {MAX_LEVELS}), "
                            f"D_out={D_out} (<= {MAX_OUT}), B={B} (<= 65535), "
                            f"T={T} (< 2^32), H={H}: weights and one 32-row "
                            f"tile within {SMEM_LIMIT} B of shared memory")
    return None


def launch_plan(tables, weights, compute_dtype=None) -> list:
    """The kernel's launch at these shapes: ``[(kernel, dynamic shared
    bytes)]`` (the weights, the resolutions and one 32-row tile a warp)."""
    _, L, _, F = tables.shape
    return [("inr_forward_kernel", fwd_smem_bytes(
        L * F, weights[0].shape[-1], len(weights) - 1,
        _dtype(tables, compute_dtype).itemsize, extra=4 * MAX_LEVELS,
        tiles_per_warp=1))]


def inr_forward_cuda(coords: torch.Tensor, tables: torch.Tensor, weights, part,
                     resolutions: Sequence[int], compute_dtype=None) -> torch.Tensor:
    """coords (B,N,3) f32, tables (P,L,T,F), partition-stacked MLP weights,
    ``part`` (B,) -> (B,N,D_out) in the compute dtype (default: the tables').

    The operands must pass :func:`refusal`'s rule, on every device. CPU
    tensors then take the plain version; CUDA tensors launch
    ``repro_inr_forward`` (``csrc/inr_forward.cu``: each lane encodes one
    point into a shared-memory tile, the warp runs the tile through the MLP
    on the tensor cores) or raise. Tables and weights are cast to the
    compute dtype first, as the two-kernel route casts them."""
    with build.kernel_region("inr_forward", _dtype(tables, compute_dtype),
                             plan=lambda: launch_plan(tables, weights,
                                                      compute_dtype)):
        bad = refusal(coords, tables, weights, compute_dtype)
        if bad is not None:
            raise bad[0](f"inr_forward_cuda: {bad[1]}")
        if len(resolutions) != tables.shape[1]:
            raise ValueError(f"{len(resolutions)} resolutions for {tables.shape[1]} "
                             f"levels")
        if coords.device.type == "cpu":
            return _ref.inr_forward_ref(coords, tables, weights, part, resolutions,
                                        compute_dtype)
        if coords.device.type != "cuda" or tables.device != coords.device or \
                any(w.device != coords.device for w in weights):
            raise ValueError("inr_forward_cuda: coords, tables and weights must lie "
                             "on one CUDA device")
        dt = _dtype(tables, compute_dtype)
        B, N, _ = coords.shape
        P, L, T, F = tables.shape
        w_in, w_hid, w_out, n_hidden = _stack([w.to(dt) for w in weights])
        coords, tables, w_in, w_hid, w_out = (
            t.contiguous() for t in (coords, tables.to(dt), w_in, w_hid, w_out))
        if tables.data_ptr() % 16:   # the corner gathers' vector loads
            tables = tables.clone()
        part_d = build.part_tensor(part, B, P, coords.device)
        res_d = _res_tensor(resolutions, coords.device)
        out = torch.empty((B, N, w_out.shape[-1]), dtype=dt, device=coords.device)
        lib = build.library()
        err = lib.repro_inr_forward(
            coords.data_ptr(), tables.data_ptr(), res_d.data_ptr(), part_d.data_ptr(),
            w_in.data_ptr(), w_hid.data_ptr(), w_out.data_ptr(), out.data_ptr(),
            B, N, L, T, F, w_in.shape[-1], n_hidden, w_hid.shape[1],
            w_out.shape[-1], int(dt == torch.bfloat16),
            torch.cuda.current_stream(coords.device).cuda_stream)
        build.check(err, "repro_inr_forward")
        inr_forward_cuda.launches += 1
        inr_forward_cuda.bf16_launches += int(dt == torch.bfloat16)
        return out


#: launches of the kernel, and of its bf16 instantiation among them
inr_forward_cuda.launches = inr_forward_cuda.bf16_launches = 0
