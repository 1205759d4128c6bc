"""Fused MLP: backend dispatch, the autograd function, and the CUDA
kernels' wrappers.

``fused_mlp`` is the single-model op (x (N,D_in), weights
``[w_in, hidden..., w_out]``); ``fused_mlp_batched`` is the hot-path form:
rows (B,N,D_in) against partition-stacked weights, one launch for every
partition and client. Both are differentiable in x and the weights: the
backward recomputes the activations and runs the layer stack in reverse,
the plain VJP on the ``ref`` backend and ``repro_fused_mlp_bwd``
(``csrc/fused_mlp.cu``, every product on the tensor cores) on the card;
under ``torch.use_deterministic_algorithms(True)`` its deterministic route
(``repro_fused_mlp_bwd_det``: per-block dW rows summed in a fixed order).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import backends
from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp import ref as _ref

#: hidden widths the kernel is instantiated for (a layer's sums live in
#: tensor-core fragments, W/8 n-tiles of them per warp)
KERNEL_WIDTHS = (16, 32, 64)
#: output columns one launch computes (one n = 8 tensor-core tile)
MAX_OUT = 8
#: shared memory a block may use on the H100
SMEM_LIMIT = 232448


def mma_smem_bytes(D_in: int, W: int, n_hidden: int, itemsize: int,
                   tiles: int) -> int:
    """Shared memory of the tensor-core MLP (``csrc/mlp_mma.cuh``) for one
    warp: the weights as B fragments (bf16: k-tiles of 16, one 32-bit word
    pair per lane; float32: k-tiles of 8, head and tail words; n-tiles of
    8, one for the output) plus ``tiles`` 32-row input tiles of row stride
    ``tile_stride(D_in)``; the C side's ``weight_words`` and
    ``tile_stride``."""
    ks, lw = (16, 2) if itemsize == 2 else (8, 4)
    kt0 = -(-D_in // ks)
    words = 32 * lw * (kt0 * (W // 8) + (n_hidden - 1) * (W // ks) * (W // 8)
                       + W // ks)
    stride = (D_in + 7) // 16 * 16 + 8
    return 4 * words + tiles * 32 * stride * itemsize


def mma_bwd_smem_bytes(D_in: int, W: int, n_hidden: int, D_out: int,
                       itemsize: int, warps: int) -> int:
    """Shared memory of the tensor-core MLP backward (``csrc/mlp_mma.cuh``
    ``bwd_layout``) for ``warps`` warps: the weights as B fragments, the
    forward's (w_in, the hidden layers) and the transposed ones (w_out^T
    with K = D_out <= 8, the hidden layers', w_in^T with N = D_in), in
    ``mma_smem_bytes``'s layout but at W = 64 under float32 (two words a
    lane, split when loaded); then per warp its float32 dW as C fragments
    (512 bytes a 16 x 8 tile: dW_in's ceil(D_in/16) x W/8, each hidden
    layer's W/16 x W/8, dW_out's W/16), two 32-row x tiles (row stride
    ``tile_stride(D_in)``) and two cotangent tiles (row stride 8, or 2 for
    float32 with D_out <= 2), and H activation tiles and two delta tiles of
    16 rows (a pass) with row stride W + 8."""
    ks, lw = (16, 2) if itemsize == 2 else (8, 2 if W == 64 else 4)
    nt, ktw, mw = W // 8, W // ks, W // 16
    kt0, nx, mi = -(-D_in // ks), -(-D_in // 8), -(-D_in // 16)
    frags = kt0 * nt + 2 * (n_hidden - 1) * ktw * nt + nt + ktw * nx
    dw_tiles = mi * nt + (n_hidden - 1) * mw * nt + mw
    xs = (D_in + 7) // 16 * 16 + 8
    gs = 2 if itemsize == 4 and D_out <= 2 else 8
    per_warp = dw_tiles * 512 + itemsize * (2 * 32 * (xs + gs)
                                            + (n_hidden + 2) * 16 * (W + 8))
    return 4 * 32 * lw * frags + warps * per_warp


def fwd_smem_bytes(D_in: int, W: int, n_hidden: int, itemsize: int,
                   extra: int = 0, tiles_per_warp: int = 2):
    """The dynamic shared memory a forward launch asks for (``mlp_mma.cuh``
    ``pick_warps``): the weights (plus ``extra`` bytes) and
    ``tiles_per_warp`` input tiles a warp for the most of 8, 4, 2 and 1
    warps that fit ``SMEM_LIMIT``; None when none fits."""
    for warps in (8, 4, 2, 1):
        b = mma_smem_bytes(D_in, W, n_hidden, itemsize,
                           tiles_per_warp * warps) + extra
        if b <= SMEM_LIMIT:
            return b
    return None


def bwd_pick(D_in: int, W: int, n_hidden: int, D_out: int, itemsize: int):
    """``(warps a block, dynamic shared bytes)`` of a backward launch
    (``mlp_mma.cuh`` ``bwd_pick_warps``: of 8, 4, 2 and 1 warps within
    ``SMEM_LIMIT``, the count that keeps the most warps resident); (0,
    None) when none fits."""
    best, resident = (0, None), 0
    for warps in (8, 4, 2, 1):
        b = mma_bwd_smem_bytes(D_in, W, n_hidden, D_out, itemsize, warps)
        if b <= SMEM_LIMIT and (233472 // (b + 1024)) * warps > resident:
            best, resident = (warps, b), (233472 // (b + 1024)) * warps
    return best


def bwd_smem_bytes(D_in: int, W: int, n_hidden: int, D_out: int,
                   itemsize: int):
    """The dynamic shared memory a backward launch asks for (:func:`bwd_pick`);
    None when no count of warps fits."""
    return bwd_pick(D_in, W, n_hidden, D_out, itemsize)[1]


#: the deterministic route's most blocks a batch row (``fused_mlp.cu``
#: ``DET_BLOCKS``)
DET_BLOCKS = 64


def det_plan(N: int, D_in: int, W: int, n_hidden: int, D_out: int, itemsize: int):
    """``(blocks a batch row, floats a block's dW row)`` of the
    deterministic route at these shapes: the Python mirror of
    ``repro_fused_mlp_bwd_det_shape`` (``fused_mlp.cu`` ``det_blocks``:
    enough blocks of the picked warps for the row's 32-row tiles, at most
    ``DET_BLOCKS``; a row of C-fragment tiles of 128 floats: dW_in's
    ceil(D_in/16) x W/8, each hidden layer's W/16 x W/8, dW_out's W/16). A
    function of the shapes alone, so the dW rows, their order and the bits
    stay; (0, 0) when no count of warps fits."""
    warps, _ = bwd_pick(D_in, W, n_hidden, D_out, itemsize)
    if not warps:
        return 0, 0
    n_tiles = -(-N // 32)
    blocks = min(-(-n_tiles // warps), DET_BLOCKS)
    nt, mw, mi = W // 8, W // 16, -(-D_in // 16)
    return blocks, (mi * nt + (n_hidden - 1) * mw * nt + mw) * 128


def fwd_launch_plan(x, weights) -> list:
    """The forward's launch at these shapes: ``[(kernel, dynamic shared
    bytes)]``."""
    return [("fused_mlp_fwd_kernel",
             fwd_smem_bytes(x.shape[-1], weights[0].shape[-1], len(weights) - 1,
                            x.element_size()))]


def bwd_launch_plan(x, weights, g) -> list:
    """The backward's launches at these shapes (the deterministic route
    adds its ordered sum)."""
    plan = [("fused_mlp_bwd_kernel",
             bwd_smem_bytes(x.shape[-1], weights[0].shape[-1], len(weights) - 1,
                            g.shape[-1], x.element_size()))]
    if torch.are_deterministic_algorithms_enabled():
        plan.append(("mlp_dw_ordered_kernel", 0))
    return plan


def _stack(weights):
    """[w_in, h1..h_{H-1}, w_out] -> (w_in, w_hid, w_out, n_hidden), with
    ``w_hid`` (..., max(H-1,1), W, W): an all-zero dummy slab when H == 1,
    which the kernel's layer loop (n_hidden) never reads. Works on single
    (2-D) and partition-stacked (3-D) weights alike."""
    w_in, *hid, w_out = weights
    n_hidden = len(hid) + 1
    W = w_in.shape[-1]
    if hid:
        w_hid = torch.stack(hid, dim=-3)
    else:
        w_hid = torch.zeros((*w_in.shape[:-2], 1, W, W), dtype=w_in.dtype,
                            device=w_in.device)
    return w_in, w_hid, w_out, n_hidden


def fused_mlp_cuda(x: torch.Tensor, weights, part) -> torch.Tensor:
    """The kernel's wrapper: x (B,N,D_in), partition-stacked weights
    ``[w_in (P,D_in,W), hidden (P,W,W)..., w_out (P,W,D_out)]`` in x's dtype,
    ``part`` (B,) -> (B,N,D_out).

    CPU tensors take the plain version; CUDA tensors launch
    ``repro_fused_mlp_fwd`` (``csrc/fused_mlp.cu``: rows copied a 32-row
    tile per warp into shared memory, the layers on the tensor cores; one
    launch per ``MAX_OUT`` output columns) or raise."""
    with build.kernel_region("fused_mlp_fwd", x, weights,
                             plan=lambda: fwd_launch_plan(x, weights)):
        if x.device.type == "cpu":
            return _ref.fused_mlp_batched_ref(x, weights, torch.as_tensor(part))
        *hidden, w_last = weights
        if w_last.shape[-1] > MAX_OUT:
            return torch.cat([fused_mlp_cuda(x, [*hidden, w_last[..., j:j + MAX_OUT]], part)
                              for j in range(0, w_last.shape[-1], MAX_OUT)], -1)
        w_in, w_hid, w_out, n_hidden = _stack(weights)
        B, N, D_in = x.shape
        P, D_in_w, W = w_in.shape
        D_out = w_out.shape[-1]
        if x.device.type != "cuda" or any(w.device != x.device for w in weights):
            raise ValueError("fused_mlp_cuda: x and weights must lie on one CUDA "
                             "device")
        if x.dtype not in (torch.float32, torch.bfloat16) or \
                any(w.dtype != x.dtype for w in weights):
            raise TypeError("fused_mlp_cuda: x and weights must share one dtype, "
                            f"float32 or bfloat16 (x is {x.dtype})")
        if D_in_w != D_in or W not in KERNEL_WIDTHS or B > 65535 or \
                tuple(w_out.shape[:2]) != (P, W) or \
                mma_smem_bytes(D_in, W, n_hidden, x.element_size(), 2) > SMEM_LIMIT:
            raise ValueError(f"unsupported shapes: x {tuple(x.shape)}, w_in "
                             f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)} "
                             f"(W in {KERNEL_WIDTHS}, B <= 65535, weights and two "
                             f"32-row tiles within {SMEM_LIMIT} B of shared memory)")
        x = aligned16(x)
        w_in, w_hid, w_out = (t.contiguous() for t in (w_in, w_hid, w_out))
        part_d = build.part_tensor(part, B, P, x.device)
        out = torch.empty((B, N, D_out), dtype=x.dtype, device=x.device)
        lib = build.library()
        err = lib.repro_fused_mlp_fwd(
            x.data_ptr(), w_in.data_ptr(), w_hid.data_ptr(), w_out.data_ptr(),
            part_d.data_ptr(), out.data_ptr(), B, N, D_in, W, n_hidden,
            w_hid.shape[1], D_out, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "repro_fused_mlp_fwd")
        fused_mlp_cuda.launches += 1
        return out


fused_mlp_cuda.launches = 0


def bwd_refusal(x: torch.Tensor, weights, g: torch.Tensor):
    """None if the backward kernel takes these operands, else ``(exception
    class, message)``: x (B,N,D_in), partition-stacked weights ``[w_in
    (P,D_in,W), hidden (P,W,W)..., w_out (P,W,D_out)]`` and g (B,N,D_out),
    all float32 or all bfloat16, with W in ``KERNEL_WIDTHS``, 1 <= D_out <=
    ``MAX_OUT`` (one n = 8 tile; the wrapper does not split wider outputs,
    since the bf16 deltas' rounding does not add up over column blocks), B
    <= 65535, and the weights' fragments plus one warp's tiles within
    ``SMEM_LIMIT`` (:func:`mma_bwd_smem_bytes`)."""
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != x.dtype for t in (g, *weights)):
        return TypeError, ("x, g and weights must share one dtype, float32 or "
                           f"bfloat16 (x is {x.dtype})")
    if x.ndim != 3 or len(weights) < 2 or any(w.ndim != 3 for w in weights):
        return ValueError, (f"x (B,N,D_in) and >= 2 stacked weights expected, got "
                            f"{tuple(x.shape)} and {len(weights)} weights")
    B, N, D_in = x.shape
    P, W, D_out = weights[0].shape[0], weights[0].shape[-1], weights[-1].shape[-1]
    H = len(weights) - 1
    shapes = [(P, D_in, W)] + [(P, W, W)] * (H - 1) + [(P, W, D_out)]
    if [tuple(w.shape) for w in weights] != shapes or tuple(g.shape) != (B, N, D_out):
        return ValueError, (f"weights {[tuple(w.shape) for w in weights]} and g "
                            f"{tuple(g.shape)} do not chain from x {tuple(x.shape)}")
    if W not in KERNEL_WIDTHS or not 1 <= D_out <= MAX_OUT or B > 65535 or \
            mma_bwd_smem_bytes(D_in, W, H, D_out, x.element_size(), 1) > SMEM_LIMIT:
        return ValueError, (f"unsupported shape: W={W} (in {KERNEL_WIDTHS}), "
                            f"D_out={D_out} (1..{MAX_OUT}), B={B} (<= 65535), "
                            f"D_in={D_in}, H={H}: the weights' fragments and one "
                            f"warp's tiles within {SMEM_LIMIT} B of shared memory")
    return None


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (a copy where it is
    not): the kernels copy rows with 16-byte cp.async."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def fused_mlp_bwd_cuda(x: torch.Tensor, weights, g: torch.Tensor, part):
    """The backward kernel's wrapper: x (B,N,D_in) and partition-stacked
    weights as for :func:`fused_mlp_cuda`, cotangent ``g`` (B,N,D_out), all
    float32 or all bfloat16 -> ``(dx (B,N,D_in) in x's dtype, [dW (P, ...)
    ...] float32)``, every dW the float32 sum over the rows of its
    partition.

    CPU tensors take the plain version; CUDA tensors must pass
    :func:`bwd_refusal` and launch ``repro_fused_mlp_bwd``
    (``csrc/fused_mlp.cu``: x and g rows copied a 32-row tile per warp into
    shared memory; the recompute, the delta chain, dx and dW on the tensor
    cores; each block's dW summed in shared memory, one atomic add per
    weight per block into zeroed f32 gradients; bf16 operands rounded where
    the plain version rounds them) or raise.

    Under ``torch.use_deterministic_algorithms(True)`` a CUDA call takes
    the deterministic route, ``repro_fused_mlp_bwd_det`` (counted in
    ``det_launches`` too): the same kernel on a grid of ``det_plan``'s
    blocks a batch row (a function of N and the shapes alone), each
    block's dW written to a row of its own, then a second launch,
    ``mlp_dw_ordered_kernel``, that sums a partition's rows in a fixed
    order. Its bits do not depend on the run or on the partitions stacked
    beside one. The CPU's plain version is deterministic as it is."""
    with build.kernel_region("fused_mlp_bwd", x, g, weights,
                             plan=lambda: bwd_launch_plan(x, weights, g)):
        if x.device.type == "cpu":
            return _ref.fused_mlp_batched_bwd_ref(x, weights, g, torch.as_tensor(part))
        det = torch.are_deterministic_algorithms_enabled()
        dx, dws = _bwd_launch("repro_fused_mlp_bwd_det" if det else
                              "repro_fused_mlp_bwd", x, weights, g, part,
                              *((DET_DESIGNS["ordered"],) if det else ()), det=det)
        fused_mlp_bwd_cuda.launches += 1
        fused_mlp_bwd_cuda.bf16_launches += int(x.dtype == torch.bfloat16)
        fused_mlp_bwd_cuda.det_launches += int(det)
        return dx, dws


#: the deterministic route's ordered-sum designs (``repro_fused_mlp_bwd_det``'s
#: design): the route, and the design before it, kept as its yardstick
DET_DESIGNS = {"ordered": 0, "reduce": 1}


def fused_mlp_bwd_det_with(x, weights, g, part, design: str = "ordered"):
    """The deterministic route of :func:`fused_mlp_bwd_cuda` on the card,
    for measurement (no count): the backward on the deterministic grid,
    then ``design``'s ordered sum, "ordered" (the route,
    ``mlp_dw_ordered_kernel``: a block per 32 columns of a partition, the
    rows staged in shared memory) or "reduce" (its yardstick, the design
    before it: ``mlp_dw_reduce_kernel``, a thread a column). Both give the
    same bits. Returns ``(dx, [dW ...])``."""
    if design not in DET_DESIGNS:
        raise ValueError(f"design 'ordered' or 'reduce', got {design!r}")
    if x.device.type != "cuda":
        raise ValueError("fused_mlp_bwd_det_with runs on the card")
    return _bwd_launch("repro_fused_mlp_bwd_det", x, weights, g, part,
                       DET_DESIGNS[design], det=True)


@functools.lru_cache(maxsize=64)
def det_shape(N: int, D_in: int, W: int, n_hidden: int, D_out: int,
              is_bf16: bool):
    """(blocks a batch row, floats a block's row) of the deterministic
    route's dW rows at these shapes, from the library (a pure function of
    ints: the blocks depend on N and the shapes, never on the card)."""
    out = (ctypes.c_longlong * 2)()
    build.check(build.library().repro_fused_mlp_bwd_det_shape(
        N, D_in, W, n_hidden, D_out, int(is_bf16), ctypes.addressof(out)),
        "repro_fused_mlp_bwd_det_shape")
    return int(out[0]), int(out[1])


def _bwd_launch(entry: str, x, weights, g, part, *extra, det: bool = False,
                clocked: bool = False):
    """Check CUDA operands against :func:`bwd_refusal` and run the backward
    C entry ``entry`` on them (``extra``: its arguments before the
    stream; ``det``: the deterministic grid, which also takes its dW rows
    and P, before ``extra`` in the deterministic entry, after it in the
    clock's, which takes a null and 0 on the default grid): ``(dx, [dW
    ...])``."""
    if x.device.type != "cuda" or g.device != x.device or \
            any(w.device != x.device for w in weights):
        raise ValueError("fused_mlp_bwd_cuda: x, g and weights must lie on "
                         "one CUDA device")
    bad = bwd_refusal(x, weights, g)
    if bad is not None:
        raise bad[0](f"fused_mlp_bwd_cuda: {bad[1]}")
    w_in, w_hid, w_out, n_hidden = _stack(weights)
    B, N, D_in = x.shape
    P, _, W = w_in.shape
    D_out = w_out.shape[-1]
    x, g = aligned16(x), aligned16(g)
    w_in, w_hid, w_out = (t.contiguous() for t in (w_in, w_hid, w_out))
    part_d = build.part_tensor(part, B, P, x.device)
    dx = torch.empty_like(x)
    dw_in, dw_hid, dw_out = (torch.zeros_like(w, dtype=torch.float32)
                             for w in (w_in, w_hid, w_out))
    bf16 = x.dtype == torch.bfloat16
    ptrs = [x.data_ptr(), w_in.data_ptr(), w_hid.data_ptr(), w_out.data_ptr(),
            g.data_ptr(), part_d.data_ptr(), dx.data_ptr(), dw_in.data_ptr(),
            dw_hid.data_ptr(), dw_out.data_ptr()]
    rows = (None, 0)
    if det:
        blocks, E = det_shape(N, D_in, W, n_hidden, D_out, bf16)
        partials = torch.empty((B, blocks, E), dtype=torch.float32,
                               device=x.device)
        rows = (partials.data_ptr(), P)
    if det and not clocked:
        ptrs += [rows[0], B, N, P]
    else:
        ptrs += [B, N]
        if clocked:
            extra = extra + rows
    err = getattr(build.library(), entry)(
        *ptrs, D_in, W, n_hidden, w_hid.shape[1], D_out, int(bf16), *extra,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, entry)
    return dx, [dw_in] + [dw_hid[:, k] for k in range(n_hidden - 1)] + [dw_out]


#: the backward's stages, in the order of ``fused_mlp_bwd_stage_cycles``
BWD_STAGES = ("waiting for rows", "recompute", "delta chain", "dW", "dx products",
              "dx out", "block dW sum")


def fused_mlp_bwd_stage_cycles(x, weights, g, part, grid: str = "default") -> list:
    """A measurement of where the backward kernel's time goes: one launch
    of its W = 16 instantiation with a clock on each warp
    (``repro_fused_mlp_bwd_stages``), on CUDA operands that
    :func:`fused_mlp_bwd_cuda` takes; returns the warps' summed cycles in
    each of ``BWD_STAGES`` and then their summed lifetimes in ns (so the
    SM clock is the cycles over the ns). ``grid`` "default" (one wave of
    blocks, float atomics: refused under the deterministic switch) or
    "det" (the deterministic route's grid and ordered dW sum). Not a
    launch of the main path: no count."""
    if grid not in ("default", "det"):
        raise ValueError(f"grid 'default' or 'det', got {grid!r}")
    if grid == "default":
        build.refuse_nondeterministic("fused_mlp_bwd_stage_cycles")
    clocks = torch.zeros(len(BWD_STAGES) + 1, dtype=torch.int64, device=x.device)
    _bwd_launch("repro_fused_mlp_bwd_stages", x, weights, g, part, clocks.data_ptr(),
                det=grid == "det", clocked=True)
    return clocks.tolist()


#: launches of the kernel, of its bf16 instantiation and of its
#: deterministic route among them
fused_mlp_bwd_cuda.launches = fused_mlp_bwd_cuda.bf16_launches = 0
fused_mlp_bwd_cuda.det_launches = 0


class _FusedMLPBatched(torch.autograd.Function):
    """Forward through the backend's MLP; backward the recomputing VJP (the
    CUDA backward kernel on the ``cuda`` backend)."""

    @staticmethod
    def forward(ctx, x, part, backend, *weights):
        part_t = torch.as_tensor(part, dtype=torch.int64, device="cpu") \
            .reshape(-1)
        ctx.save_for_backward(x, *weights)
        ctx.part, ctx.backend = part_t, backend
        if backend.is_cuda:
            return fused_mlp_cuda(x, list(weights), part_t)
        return _ref.fused_mlp_batched_ref(x, list(weights),
                                          part_t.to(x.device))

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        if ctx.backend.is_cuda:
            dx, dws = fused_mlp_bwd_cuda(x, weights, g, ctx.part)
        else:
            dx, dws = _ref.fused_mlp_batched_bwd_ref(x, weights, g,
                                                     ctx.part.to(x.device))
        return (dx.to(x.dtype), None, None,
                *(d.to(w.dtype) for d, w in zip(dws, weights)))


def _cast(x, weights, backend, compute_dtype):
    if compute_dtype is None:
        return x, list(weights)
    dt = backend.require_dtype(compute_dtype)
    return x.to(dt), [w.to(dt) for w in weights]


def fused_mlp_batched(x, weights, part, impl: backends.BackendLike = "ref", *,
                      compute_dtype=None):
    """x (B,N,D_in); partition-stacked weights; part (B,) -> (B,N,D_out),
    differentiable in x and the weights."""
    backend = backends.resolve(impl)
    x, weights = _cast(x, weights, backend, compute_dtype)
    return _FusedMLPBatched.apply(x, part, backend, *weights)


def fused_mlp(x, weights, impl: backends.BackendLike = "ref", *,
              compute_dtype=None):
    """x (N, D_in); weights [w_in, hidden..., w_out] -> (N, D_out) in the
    input dtype (or ``compute_dtype``'s: activations and weights are cast
    first). Differentiable in x and the weights."""
    return fused_mlp_batched(x[None], [w[None] for w in weights], [0], impl,
                             compute_dtype=compute_dtype)[0]
