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
routed per level by ``bwd_plan``. Under
``torch.use_deterministic_algorithms(True)`` the backward takes its
deterministic route (``repro_hash_encode_bwd_fx``: int64 fixed-point sums,
:mod:`repro_torch.kernels.fixed_point`), whose bits do not depend on the
order of the adds or on the partitions stacked beside one.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch import backends
from repro_torch.kernels import build
from repro_torch.kernels import fixed_point as fx
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
    (each row goes straight to the device gradient: one vector atomic). A
    level uses (res+1)^3 rows of its table when they fit T, else T. The
    deterministic route plans by :func:`fx_plan`."""
    return [level_rows(r, T) * F * 4 <= STAGE_BUDGET_BYTES for r in resolutions]


#: the deterministic route's scatter (``csrc/fx_scatter.cuh``): shared memory
#: a block may give its int64 slab, the cluster sizes tried, and the threads
#: and points of a slab block ('s', 'c') and of a direct one ('d')
FX_STAGE_BUDGET = 200 * 1024
FX_CLUSTERS = (2, 4, 8)
FX_SLAB_THREADS, FX_DIRECT_THREADS = 1024, 512


@dataclass(frozen=True)
class FxLevel:
    """One level's plan on the deterministic route (``fx_level_plan`` of
    ``csrc/hash_encode.cu``): ``site`` 's' (its rows x F int64 slab in one
    block's shared memory), 'c' (split over a cluster of ``cluster`` blocks,
    each owning ``span`` consecutive rows, added to through distributed
    shared memory) or 'd' (straight to device memory); ``points`` a block
    takes, ``threads`` a block, ``smem`` the slab's bytes a block."""
    site: str
    cluster: int
    rows: int
    span: int
    points: int
    threads: int
    smem: int

    def grid_x(self, N: int) -> int:
        """Blocks along x for N points a row (a cluster's multiple: padding
        blocks carry no point); with the rows of the batch, the grid."""
        unit = self.points * self.cluster
        return -(-int(N) // unit) * self.cluster


def _slab_points(span: int) -> int:
    ppb = 1024
    while ppb < span and ppb < 4096:
        ppb *= 2
    return ppb


def fx_level(res: int, T: int, F: int, force=None) -> FxLevel:
    """The plan of one level: the slab (rows x F x 8 bytes) in one block
    when it fits ``FX_STAGE_BUDGET``, else across the fewest blocks of
    ``FX_CLUSTERS`` whose share fits, else direct. ``force``: None (the
    rule), 'd', 's', or ('c', cluster). Raises on a force that is no plan."""
    rows = level_rows(res, T)
    row_bytes = 8 * int(F)
    if force is None:
        site, cluster = "d", 1
        if rows * row_bytes <= FX_STAGE_BUDGET:
            site = "s"
        else:
            for c in FX_CLUSTERS:
                if -(-rows // c) * row_bytes <= FX_STAGE_BUDGET:
                    site, cluster = "c", c
                    break
    else:
        site, cluster = (force, 1) if isinstance(force, str) else tuple(force)
        if site in ("s", "d"):
            cluster = 1
        if site not in ("s", "c", "d") or (site == "c" and cluster not in FX_CLUSTERS):
            raise ValueError(f"not a plan: {force!r} (a letter 's', 'd' or "
                             f"('c', cluster in {FX_CLUSTERS}))")
    if site == "d":
        return FxLevel("d", 1, rows, 0, FX_DIRECT_THREADS, FX_DIRECT_THREADS, 0)
    span = -(-rows // cluster)
    return FxLevel(site, cluster, rows, span, _slab_points(span), FX_SLAB_THREADS,
                   span * row_bytes)


def fx_plan(resolutions: Sequence[int], T: int, F: int, force=None) -> list:
    """Each level's :class:`FxLevel` (``force``: None, or one force a level
    for :func:`fx_level`)."""
    force = [None] * len(resolutions) if force is None else list(force)
    return [fx_level(r, T, F, f) for r, f in zip(resolutions, force)]


def fx_letters(plan) -> str:
    """A plan's letters, a cluster's size after its 'c' ("sssc2c2")."""
    return "".join(p.site + (str(p.cluster) if p.site == "c" else "") for p in plan)


def fx_force_arg(force, L: int):
    """A force as the C entries take it (L int32 in host memory: 0, the
    letter's code, or 'c' + 256 x cluster), or None for the rule."""
    if force is None:
        return None
    codes = []
    for f in force:
        if f is None:
            codes.append(0)
        elif isinstance(f, str):
            codes.append(ord(f))
        else:
            codes.append(ord(f[0]) + 256 * int(f[1]))
    if len(codes) != L:
        raise ValueError(f"{len(codes)} forced letters for {L} levels")
    return (ctypes.c_int * L)(*codes)


def bwd_launch_plan(resolutions: Sequence[int], table_shape) -> list:
    """The backward's launches at these shapes, as ``(kernel, dynamic
    shared bytes)``: the per-level kernel with its largest staged slab
    (``bwd_plan``); on the deterministic route one launch a level with its
    slab's bytes (:func:`fx_plan`: 's' one block's, 'c' each block's of the
    cluster, 'd' none), then the conversion."""
    _, _, T, F = (int(d) for d in table_shape)
    if torch.are_deterministic_algorithms_enabled():
        return [("hash_encode_bwd_fx_kernel", p.smem)
                for p in fx_plan(resolutions, T, F)] + [("fx_to_float_kernel", 0)]
    slabs = [level_rows(r, T) * F * 4 for r, staged in
             zip(resolutions, bwd_plan(resolutions, T, F)) if staged]
    return [("hash_encode_bwd_kernel", max(slabs, default=0))]


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
    with build.kernel_region("hash_encode", tables,
                             plan=lambda: [("hash_encode_fwd_kernel", 0)]):
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
    ``g`` read as one vector per (row, level) and widened) or raise;
    ``launches`` counts the L kernel launches of each call.

    Under ``torch.use_deterministic_algorithms(True)`` both take the
    deterministic route: the plain version
    :func:`ref.hash_encode_batched_bwd_fx_ref` on the CPU, and on the card
    ``repro_hash_encode_bwd_fx`` (the adds as int64 fixed point, one
    launch a level on its :func:`fx_plan` (one block's slab, a cluster's,
    or direct), then one conversion launch; counted in
    ``det_launches`` too). A partition whose contribution leaves the bound
    raises :class:`~repro_torch.kernels.fixed_point.FixedPointOverflowError`
    (one host read of the flags a call)."""
    with build.kernel_region("hash_encode_bwd", g, plan=lambda: bwd_launch_plan(
            resolutions, table_shape)):
        B, N, three = coords.shape
        P, L, T, F = (int(d) for d in table_shape)
        if three != 3 or tuple(g.shape) != (B, N, L * F):
            raise ValueError(f"coords (B,N,3) and g (B,N,L*F) expected, got "
                             f"{tuple(coords.shape)} and {tuple(g.shape)}")
        if len(resolutions) != L:
            raise ValueError(f"{len(resolutions)} resolutions for {L} levels")
        det = torch.are_deterministic_algorithms_enabled()
        if coords.device.type == "cpu":
            if det:
                sums, flags = _ref.hash_encode_batched_bwd_fx_ref(
                    g, coords, resolutions, torch.as_tensor(part), (P, L, T, F))
                fx.raise_on_overflow(flags, "hash_encode_bwd_cuda")
                return _ref.fx_to_float(sums, flags)
            return _ref.hash_encode_batched_bwd_ref(g, coords, resolutions,
                                                    torch.as_tensor(part),
                                                    (P, L, T, F))
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
        lib = build.library()
        if det:
            return _bwd_fx(lib, g, coords, res_h, part, part_d, B, N, P, L, T, F)
        staged_h = (ctypes.c_int * L)(*bwd_plan(resolutions, T, F))
        grad = torch.zeros((P, L, T, F), dtype=torch.float32, device=g.device)
        err = lib.repro_hash_encode_bwd(
            g.data_ptr(), coords.data_ptr(), ctypes.addressof(res_h),
            ctypes.addressof(staged_h), part_d.data_ptr(),
            grad.data_ptr(), B, N, L, T, F, int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream(coords.device).cuda_stream)
        build.check(err, "repro_hash_encode_bwd")
        hash_encode_bwd_cuda.launches += L   # one kernel launch per level
        hash_encode_bwd_cuda.bf16_launches += L * (g.dtype == torch.bfloat16)
        return grad


def _fx_rows(part, P: int) -> int:
    """The most batch rows any partition has in ``part`` (at least 1)."""
    return max(int(torch.bincount(torch.as_tensor(part, dtype=torch.int64)
                                  .reshape(-1).cpu(), minlength=P).max()), 1)


def _fx_launch(lib, entry, g, coords, res_h, part_d, rows, B, N, P, L, T, F,
               force=None, convert=True):
    """One launch of a deterministic route's C entry (``entry``: the
    scatter layer's ``repro_hash_encode_bwd_fx`` or its yardstick
    ``repro_hash_encode_bwd_fx_block``): ``(sums (P,L,T,F) int64, flags
    (P,) int64, grad (P,L,T,F) f32 or None)``."""
    if N * rows >= 2**40:
        raise ValueError("the deterministic route's fixed-point bound needs "
                         f"N times a partition's rows < 2^40, got {N * rows}")
    buf = torch.zeros(P * L * T * F + P, dtype=torch.int64, device=g.device)
    sums, flags = buf[:P * L * T * F], buf[P * L * T * F:]
    grad = torch.empty((P, L, T, F), dtype=torch.float32, device=g.device) \
        if convert else None
    head = [g.data_ptr(), coords.data_ptr(), ctypes.addressof(res_h)]
    force_h = fx_force_arg(force, L)   # kept alive through the call
    if entry == "repro_hash_encode_bwd_fx":
        head.append(None if force_h is None else ctypes.addressof(force_h))
    err = getattr(lib, entry)(
        *head, part_d.data_ptr(), sums.data_ptr(), flags.data_ptr(),
        None if grad is None else grad.data_ptr(),
        B, N, L, P, T, F, fx.FX_BOUND / (N * rows), int(g.dtype == torch.bfloat16),
        torch.cuda.current_stream(coords.device).cuda_stream)
    build.check(err, entry)
    return sums.view(P, L, T, F), flags, grad


def _bwd_fx(lib, g, coords, res_h, part, part_d, B, N, P, L, T, F):
    """The deterministic route's launch (see :func:`hash_encode_bwd_cuda`)."""
    _, flags, grad = _fx_launch(lib, "repro_hash_encode_bwd_fx", g, coords, res_h,
                                part_d, _fx_rows(part, P), B, N, P, L, T, F)
    hash_encode_bwd_cuda.launches += L
    hash_encode_bwd_cuda.bf16_launches += L * (g.dtype == torch.bfloat16)
    hash_encode_bwd_cuda.det_launches += L
    fx.raise_on_overflow(flags, "hash_encode_bwd_cuda")
    return grad


def hash_encode_bwd_fx_with(g, coords, resolutions: Sequence[int], part,
                            table_shape, *, design: str = "cluster", plan=None,
                            convert: bool = True):
    """The deterministic route's backward on the card, for measurement (no
    count, no overflow raise): ``design`` "cluster" (the scatter layer,
    ``plan`` None for the rule or one force a level, see :func:`fx_level`)
    or "block" (its yardstick: the design before the clusters, F = 4).
    Returns ``(sums (P,L,T,F) int64, flags (P,) int64, grad f32 or None)``."""
    B, N, _ = coords.shape
    P, L, T, F = (int(d) for d in table_shape)
    if coords.device.type != "cuda" or g.device != coords.device:
        raise ValueError("hash_encode_bwd_fx_with runs on the card")
    if design not in ("cluster", "block") or (design == "block" and plan is not None):
        raise ValueError(f"design 'cluster' (with a plan) or 'block', got {design!r}")
    g, coords = g.contiguous(), coords.contiguous()
    part_d = build.part_tensor(part, B, P, coords.device)
    res_h = levels_arg(resolutions)
    entry = "repro_hash_encode_bwd_fx" if design == "cluster" \
        else "repro_hash_encode_bwd_fx_block"
    return _fx_launch(build.library(), entry, g, coords, res_h, part_d,
                      _fx_rows(part, P), B, N, P, L, T, F,
                      force=plan, convert=convert)


def native_fx_plan(resolutions: Sequence[int], T: int, F: int, force=None) -> list:
    """The C library's own plan (``repro_hash_encode_bwd_fx_plan``), as
    :class:`FxLevel` s: what :func:`fx_plan` mirrors."""
    L = len(resolutions)
    out = (ctypes.c_longlong * (7 * L))()
    res_h, force_h = levels_arg(resolutions), fx_force_arg(force, L)
    build.check(build.library().repro_hash_encode_bwd_fx_plan(
        ctypes.addressof(res_h), None if force_h is None else ctypes.addressof(force_h),
        L, T, F, ctypes.addressof(out)), "repro_hash_encode_bwd_fx_plan")
    rows = [list(out[7 * l:7 * l + 7]) for l in range(L)]
    return [FxLevel(chr(r[0]) if r[0] else "", *r[1:]) for r in rows]


#: launches of the kernel, of its bf16-cotangent instantiation and of its
#: deterministic route among them
hash_encode_bwd_cuda.launches = hash_encode_bwd_cuda.bf16_launches = 0
hash_encode_bwd_cuda.det_launches = 0


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
