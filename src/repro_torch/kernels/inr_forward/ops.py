"""The INR inference kernel's wrapper: the hash encode and the MLP forward
in one launch (``csrc/inr_forward.cuh``), with no feature array in device
memory. ``core/inr.py`` routes decode, evaluate and render through it on
the ``cuda`` backend when no gradient is needed."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp.ops import (KERNEL_WIDTHS, MAX_OUT,
                                              SMEM_LIMIT, _stack,
                                              mma_smem_bytes)
from repro_torch.kernels.hash_encoding.ops import MAX_LEVELS, level_rows
from repro_torch.kernels.inr_forward import ref as _ref
from repro_torch.precision import torch_dtype

#: features per level the kernel is instantiated for
KERNEL_FEATURES = (1, 2, 4, 8)
#: the most shared memory a block takes while some level stays in device
#: memory: 195 KiB, with the KiB CUDA reserves a block the H100's 196 KiB
#: carve-out, which leaves the L1 60 KiB for the direct levels' rows (one
#: byte more takes the 228 KiB carve-out, 28 KiB of L1)
SMEM_KEEP_L1 = 195 * 1024
#: the stages of the kernel's clock, in the order of
#: :func:`inr_forward_stage_cycles` (then the warps' summed lifetimes in ns)
INR_STAGES = ("dense gathers", "hashed gathers", "feature stores",
              "MLP products", "output stores")
#: the kernel's designs (``repro_inr_forward_with``): the persistent one
#: every path launches, and its yardstick, the grid-stride one-warp design
#: before it, at the widths (W, F) of ``GRID_WIDTHS``
DESIGNS = {"persistent": 0, "grid": 1}
GRID_WIDTHS = ((16, 4), (64, 8))


def _dtype(tables, compute_dtype) -> torch.dtype:
    return tables.dtype if compute_dtype is None else torch_dtype(compute_dtype)


def _round16(v: int) -> int:
    return -(-int(v) // 16) * 16


def _level_bytes(resolutions, T: int, F: int, itemsize: int) -> list:
    return [_round16(level_rows(r, T) * F * itemsize) for r in resolutions]


def block_threads(W: int, F: int, itemsize: int) -> int:
    """The threads of the kernel's block (one an SM): as many warps as the
    one-warp design held an SM at these widths without spilling, or fewer
    where the persistent loop's own registers would spill
    (``csrc/inr_forward.cuh`` ``Block``)."""
    if W == 16:
        return 768 if itemsize == 4 and F == 8 else 1024
    if W == 32:
        return 512
    return 512 if itemsize == 2 else 256


def fwd_plan(resolutions: Sequence[int], T: int, F: int, itemsize: int,
             budget: int) -> str:
    """The kernel's route per level, one letter a level: ``s`` (the
    partition's rows of the level staged in shared memory, one bulk copy
    per batch row a block enters) or ``d`` (gathered from device memory
    through the read-only path). Levels in order, each staged when its
    rows fit what is left of ``budget`` bytes (a level's (res+1)^3 rows
    when they fit T, else T, of F values, rounded up to 16 bytes); none
    when a level's rows do not start 16-byte aligned in the table (T * F *
    itemsize not a multiple of 16)."""
    if T * F * itemsize % 16:
        return "d" * len(resolutions)
    letters = []
    for b in _level_bytes(resolutions, T, F, itemsize):
        take = b <= budget
        letters.append("s" if take else "d")
        budget -= b if take else 0
    return "".join(letters)


def fwd_layout(resolutions: Sequence[int], T: int, F: int, W: int,
               n_hidden: int, itemsize: int, plan: Optional[str] = None) -> dict:
    """The kernel's use of a block at these shapes (``plan_layout`` of
    ``csrc/inr_forward.cuh``): ``plan`` (the levels' letters: the given
    ones, none staged where a level's rows are not 16-byte aligned, or
    else :func:`fwd_plan`'s with the budget beside the weights' fragments,
    the resolutions and level offsets, the tables' barrier and one 32-row
    tile for every warp of the block: all the room left where every level
    fits it, else that room within ``SMEM_KEEP_L1``), ``warps`` (warps
    that then have a tile, up to the block's; 0: the kernel does not take
    the shape), ``bytes`` (the shared memory the layout uses, which a
    launch asks for) and ``threads`` (the block's)."""
    L = len(resolutions)
    D_in = L * F
    stride = (D_in + 7) // 16 * 16 + 8
    tab_off = mma_smem_bytes(D_in, W, n_hidden, itemsize, 0) + 8 * MAX_LEVELS + 16
    tile = 32 * stride * itemsize
    threads = block_threads(W, F, itemsize)
    if plan is None:
        fixed = tab_off + threads // 32 * tile
        budget = SMEM_LIMIT - fixed
        if sum(_level_bytes(resolutions, T, F, itemsize)) > budget:
            budget = min(budget, SMEM_KEEP_L1 - fixed)
        plan = fwd_plan(resolutions, T, F, itemsize, budget)
    elif T * F * itemsize % 16:
        plan = "d" * L
    chosen = sum(b for b, c in zip(_level_bytes(resolutions, T, F, itemsize), plan)
                 if c == "s")
    warps = min(threads // 32, max(SMEM_LIMIT - tab_off - chosen, 0) // tile)
    return {"plan": plan, "warps": warps, "bytes": tab_off + chosen + warps * tile,
            "threads": threads}


def native_layout(resolutions: Sequence[int], T: int, F: int, W: int,
                  n_hidden: int, itemsize: int, plan: Optional[str] = None) -> dict:
    """:func:`fwd_layout`'s keys as the kernel library computes them
    (``repro_inr_forward_plan``): the check that the two agree."""
    res = _res_host(resolutions)
    out = (ctypes.c_longlong * 4)()
    force = -1 if plan is None else _mask(plan)
    err = build.library().repro_inr_forward_plan(
        ctypes.addressof(res), len(resolutions), T, F, W, n_hidden,
        int(itemsize == 2), force, ctypes.addressof(out))
    build.check(err, "repro_inr_forward_plan")
    mask, warps, nbytes, threads = list(out)
    letters = "".join("s" if mask >> l & 1 else "d" for l in range(len(resolutions)))
    return {"plan": letters, "warps": warps, "bytes": nbytes, "threads": threads}


def _mask(plan: str) -> int:
    return sum(1 << l for l, c in enumerate(plan) if c == "s")


def refusal(coords, tables, weights, compute_dtype=None) -> Optional[tuple]:
    """The kernel's shape and dtype rule: None when it takes these operands,
    else ``(exception type, reason)``. It takes coords (B,N,3) float32 with
    B <= 65535; tables (P,L,T,F) with L <= 32, F in {1,2,4,8}, T < 2^32;
    weights ``[w_in (P,L*F,W), hidden (P,W,W)..., w_out (P,W,D_out)]`` with
    W in {16,32,64} and D_out <= 8; a compute dtype (or, without one,
    the tables' dtype, which every weight must share) of float32 or
    bfloat16; and the weights' fragments, the resolutions and level offsets,
    the tables' barrier and one warp's 32-row feature tile within the 227
    KB of shared memory a block may use (:func:`fwd_layout` with no level
    staged finds room for a warp)."""
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
            fwd_layout([0] * L, T, F, W, H, dt.itemsize, "d" * L)["warps"] < 1:
        return ValueError, (f"unsupported shape: F={F} (in {KERNEL_FEATURES}), "
                            f"W={W} (in {KERNEL_WIDTHS}), L={L} (<= {MAX_LEVELS}), "
                            f"D_out={D_out} (<= {MAX_OUT}), B={B} (<= 65535), "
                            f"T={T} (< 2^32), H={H}: weights and one 32-row "
                            f"tile within {SMEM_LIMIT} B of shared memory")
    return None


def launch_plan(tables, weights, resolutions, compute_dtype=None) -> list:
    """The kernel's launch at these shapes: ``[(kernel, dynamic shared
    bytes)]``, the bytes of :func:`fwd_layout`'s block by the rule."""
    _, L, T, F = tables.shape
    lay = fwd_layout(resolutions, T, F, weights[0].shape[-1], len(weights) - 1,
                     _dtype(tables, compute_dtype).itemsize)
    return [("inr_forward_kernel", lay["bytes"])]


def _res_host(resolutions):
    """The resolutions as the C entries take them: int32 in host memory."""
    return (ctypes.c_int * len(resolutions))(*[int(r) for r in resolutions])


def _launch(entry: str, coords, tables, weights, part, resolutions, dt, *extra):
    """Cast, lay out and launch one of the kernel's C entries; the output."""
    B, N, _ = coords.shape
    P, L, T, F = tables.shape
    w_in, w_hid, w_out, n_hidden = _stack([w.to(dt) for w in weights])
    coords, tables, w_in, w_hid, w_out = (
        t.contiguous() for t in (coords, tables.to(dt), w_in, w_hid, w_out))
    if tables.data_ptr() % 16:   # the corner gathers' vector loads, the bulk copies
        tables = tables.clone()
    part_d = build.part_tensor(part, B, P, coords.device)
    res = _res_host(resolutions)
    out = torch.empty((B, N, w_out.shape[-1]), dtype=dt, device=coords.device)
    err = getattr(build.library(), entry)(
        coords.data_ptr(), tables.data_ptr(), ctypes.addressof(res), part_d.data_ptr(),
        w_in.data_ptr(), w_hid.data_ptr(), w_out.data_ptr(), out.data_ptr(),
        B, N, L, T, F, w_in.shape[-1], n_hidden, w_hid.shape[1],
        w_out.shape[-1], int(dt == torch.bfloat16), *extra,
        torch.cuda.current_stream(coords.device).cuda_stream)
    build.check(err, entry)
    return out


def _check_operands(name, coords, tables, weights, compute_dtype, resolutions):
    bad = refusal(coords, tables, weights, compute_dtype)
    if bad is not None:
        raise bad[0](f"{name}: {bad[1]}")
    if len(resolutions) != tables.shape[1]:
        raise ValueError(f"{len(resolutions)} resolutions for {tables.shape[1]} "
                         f"levels")


def inr_forward_cuda(coords: torch.Tensor, tables: torch.Tensor, weights, part,
                     resolutions: Sequence[int], compute_dtype=None) -> torch.Tensor:
    """coords (B,N,3) f32, tables (P,L,T,F), partition-stacked MLP weights,
    ``part`` (B,) -> (B,N,D_out) in the compute dtype (default: the tables').

    The operands must pass :func:`refusal`'s rule, on every device. CPU
    tensors then take the plain version; CUDA tensors launch
    ``repro_inr_forward`` (``csrc/inr_forward.cuh``: persistent blocks,
    one an SM, whose warps encode 32-row tiles into shared memory, from
    the levels :func:`fwd_plan` stages in shared memory and the others in
    device memory, and run each tile through the MLP on the tensor cores)
    or raise. Tables and weights are
    cast to the compute dtype first, as the two-kernel route casts them."""
    with build.kernel_region("inr_forward", _dtype(tables, compute_dtype),
                             plan=lambda: launch_plan(tables, weights, resolutions,
                                                      compute_dtype)):
        _check_operands("inr_forward_cuda", coords, tables, weights,
                        compute_dtype, resolutions)
        if coords.device.type == "cpu":
            return _ref.inr_forward_ref(coords, tables, weights, part, resolutions,
                                        compute_dtype)
        if coords.device.type != "cuda" or tables.device != coords.device or \
                any(w.device != coords.device for w in weights):
            raise ValueError("inr_forward_cuda: coords, tables and weights must lie "
                             "on one CUDA device")
        dt = _dtype(tables, compute_dtype)
        out = _launch("repro_inr_forward", coords, tables, weights, part,
                      resolutions, dt)
        inr_forward_cuda.launches += 1
        inr_forward_cuda.bf16_launches += int(dt == torch.bfloat16)
        return out


#: launches of the kernel, and of its bf16 instantiation among them
inr_forward_cuda.launches = inr_forward_cuda.bf16_launches = 0


def inr_forward_with(coords, tables, weights, part, resolutions, *,
                     design: str = "persistent", plan: Optional[str] = None,
                     clocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A measurement launch on CUDA operands that :func:`inr_forward_cuda`
    takes, in the tables' dtype (``repro_inr_forward_with``): the kernel's
    design under :func:`fwd_plan`'s rule or with ``plan``'s letters forced,
    or its yardstick (``design="grid"``, at ``GRID_WIDTHS``); ``clocks``
    (int64 zeros on the device, ``len(INR_STAGES) + 1``) takes the clocked
    instantiation (W = 16, F = 4) and receives its counts. Not a launch of
    any path: no count."""
    _check_operands("inr_forward_with", coords, tables, weights, None, resolutions)
    if coords.device.type != "cuda":
        raise ValueError("inr_forward_with: a measurement on the card")
    _, L, T, F = tables.shape
    W, H = weights[0].shape[-1], len(weights) - 1
    if plan is not None and (design != "persistent" or
                             fwd_layout(resolutions, T, F, W, H, tables.element_size(),
                                        plan)["warps"] < 1):
        raise ValueError(f"inr_forward_with: plan {plan} leaves no warp room, or "
                         f"is forced on the {design} design")
    if (design == "grid" and (W, F) not in GRID_WIDTHS) or \
            (clocks is not None and (W, F) != (16, 4)):
        raise ValueError(f"inr_forward_with: no {design} instantiation "
                         f"{'with a clock ' if clocks is not None else ''}at W={W}, F={F}")
    return _launch("repro_inr_forward_with", coords, tables, weights, part,
                   resolutions, tables.dtype, DESIGNS[design],
                   -1 if plan is None else _mask(plan),
                   None if clocks is None else clocks.data_ptr())


def inr_forward_stage_cycles(coords, tables, weights, part, resolutions, *,
                             design: str = "persistent") -> list:
    """Where the kernel's time goes: one launch of the clocked W = 16, F = 4
    instantiation of ``design``, on CUDA operands that
    :func:`inr_forward_cuda` takes; returns the warps' summed cycles in each
    of ``INR_STAGES``, then their summed lifetimes in ns. Not a launch of
    any path: no count."""
    clocks = torch.zeros(len(INR_STAGES) + 1, dtype=torch.int64, device=coords.device)
    inr_forward_with(coords, tables, weights, part, resolutions, design=design,
                     clocks=clocks)
    return clocks.tolist()


def residency(resolutions: Sequence[int], T: int, F: int, W: int, n_hidden: int,
              itemsize: int, design: str = "persistent") -> dict:
    """A design's residency on this card at these shapes
    (``repro_inr_forward_occupancy``, the CUDA occupancy calculator on the
    instantiation and shared bytes a launch takes): ``blocks`` an SM, the
    block's ``threads``, the dynamic shared ``bytes`` a launch asks for, and
    the ``warps`` an SM then holds."""
    out = (ctypes.c_longlong * 3)()
    res = _res_host(resolutions)
    err = build.library().repro_inr_forward_occupancy(
        ctypes.addressof(res), len(resolutions), T, F, W, n_hidden, int(itemsize == 2),
        DESIGNS[design], ctypes.addressof(out))
    build.check(err, "repro_inr_forward_occupancy")
    blocks, threads, nbytes = list(out)
    return {"blocks": blocks, "threads": threads, "bytes": nbytes,
            "warps": blocks * threads // 32}
