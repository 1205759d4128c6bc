"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``repro_torch/csrc`` is compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together) and linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/`` at the root of the checkout, named by a hash of
the sources and flags, so a changed source builds anew and an unchanged one
is loaded as it is. Nothing is built when the package is imported: the first
kernel launch builds, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v") + ARCH_FLAGS

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C entry points: name -> argtypes (every entry returns cudaError_t as int)
SIGNATURES = {
    # coords, tables, res, part, out, B, N, L, T, F, is_bf16, stream
    "repro_hash_encode_fwd": [_P, _P, _P, _P, _P, _L, _L, _I, _L, _I, _I, _P],
    # x, w_in, w_hid, w_out, part, out, B, N, D_in, W, n_hidden, n_hid_slab,
    # D_out, is_bf16, stream
    "repro_fused_mlp_fwd": [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                            _I, _I, _P],
    # coords, tables, res (host memory), part, w_in, w_hid, w_out, out, B, N,
    # L, T, F, W, n_hidden, n_hid_slab, D_out, is_bf16, stream
    "repro_inr_forward": [_P] * 8 + [_L, _L, _I, _L, _I, _I, _I, _I, _I, _I, _P],
    # the same operands, then design, forced staging mask (< 0: the rule),
    # clocks (or null), stream
    "repro_inr_forward_with": [_P] * 8 + [_L, _L, _I, _L, _I, _I, _I, _I, _I, _I,
                                          _I, _L, _P, _P],
    # res (host memory), L, T, F, W, n_hidden, is_bf16, force, layout out (4
    # int64 in host memory)
    "repro_inr_forward_plan": [_P, _I, _L, _I, _I, _I, _I, _L, _P],
    # res (host memory), L, T, F, W, n_hidden, is_bf16, design, out (3 int64
    # in host memory)
    "repro_inr_forward_occupancy": [_P, _I, _L, _I, _I, _I, _I, _I, _P],
    # rgba, out, R, S, is_bf16, stream
    "repro_composite": [_P, _P, _L, _I, _I, _P],
    # grad_out, coords, res, staged (the two in host memory), part,
    # grad_tables, B, N, L, T, F, is_bf16, stream
    "repro_hash_encode_bwd": [_P] * 6 + [_L, _L, _I, _L, _I, _I, _P],
    # the deterministic route: g, coords, res, force (the two in host memory;
    # force may be null), part, grad_fx, flags, grad_tables (or null), B, N,
    # L, P, T, F, vmax, is_bf16, stream
    "repro_hash_encode_bwd_fx": [_P] * 8 + [_L, _L, _I, _L, _L, _I, _F, _I, _P],
    # its yardstick: the same without force
    "repro_hash_encode_bwd_fx_block": [_P] * 7 + [_L, _L, _I, _L, _L, _I, _F, _I, _P],
    # res, force (host memory; force may be null), L, T, F, plan out ((L, 7)
    # int64 in host memory)
    "repro_hash_encode_bwd_fx_plan": [_P, _P, _I, _L, _I, _P],
    # res, staged, L, T, points per block out (host memory)
    "repro_hash_encode_bwd_points_per_block": [_P, _P, _I, _L, _P],
    # x, w_in, w_hid, w_out, g, part, dx, dw_in, dw_hid, dw_out, B, N, D_in,
    # W, n_hidden, n_hid_slab, D_out, is_bf16, stream
    "repro_fused_mlp_bwd": [_P] * 10 + [_L, _L, _I, _I, _I, _I, _I, _I, _P],
    # the deterministic route: the same operands, then partials, B, N, P,
    # D_in, W, n_hidden, n_hid_slab, D_out, is_bf16, stream
    "repro_fused_mlp_bwd_det": [_P] * 11 + [_L, _L, _L, _I, _I, _I, _I, _I, _I, _P],
    # N, D_in, W, n_hidden, D_out, is_bf16, (blocks, E) out (host memory)
    "repro_fused_mlp_bwd_det_shape": [_L, _I, _I, _I, _I, _I, _P],
    # the same, then clocks (8 uint64), stream
    "repro_fused_mlp_bwd_stages": [_P] * 10 + [_L, _L, _I, _I, _I, _I, _I, _I, _P, _P],
    # coords, target, volumes, seeds, tab, win, whid, wout, g_tab, g_win,
    # g_whid, g_wout, loss_sum, g_feat, g_tab_fx, partials, flags, g_coords,
    # clocks, res (host memory), P, N, L, T, F, W, n_hidden, n_hid_slab,
    # D_out, nx, ny, nz, ghost, n_uniform, sigma, sampling, is_bf16, det,
    # stream
    "repro_train_step": [_P] * 20 + [_L, _L, _I, _L, _I, _I, _I, _I, _I,
                                     _L, _L, _L, _I, _L, _F, _I, _I, _I, _P],
    # P, N, L, F, W, n_hidden, D_out, det, shape out (4 int64 in host memory)
    "repro_train_step_shape": [_L, _L, _I, _I, _I, _I, _I, _I, _P],
    # 4 x (params, m, v, grad, master, n per partition), scalars, loss_sum,
    # loss, P, loss_div, b1, 1-b1, b2, 1-b2, eps, wd, master, partials,
    # groups, cols, tab_fx, flags, overflow, stream
    "repro_adamw_apply": [_P, _P, _P, _P, _P, _L] * 4
    + [_P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _F, _I, _P, _L, _I, _P, _P, _P,
       _P],
    # index (< 0: forget the notes), attrs (5 int64 out), name buffer, its
    # length: the kernels launched since the last reset (launch_notes.cu)
    "repro_kernel_launches": [_I, _P, _P, _I],
    # q, k, v, out, B, Sq, Sk, Hq, Hkv, dh, causal, has_window, window,
    # is_bf16, stream
    "repro_flash_attention": [_P] * 4 + [_L, _L, _L] + [_I] * 7 + [_P],
    # q, k, v, out, p_dump, B, Sq, Sk, Hq, Hkv, dh, causal, has_window,
    # window, stream
    "repro_flash_attention_bf16_p": [_P] * 5 + [_L, _L, _L] + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None
#: what the last build printed (register / shared-memory use per kernel) and
#: how long it took; empty when the library came from an earlier build
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit under CUDA_HOME or "
                       "/usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source tree has not been built; return
    its path. Raises ``RuntimeError`` with the compiler's output on failure."""
    global build_log, build_seconds
    sources = _sources()
    target = BUILD_DIR / f"librepro_torch_{_digest(sources)}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        done = {}

        def finish(src, proc):          # each source's own finishing time
            out, _ = proc.communicate()
            done[src] = (out, time.perf_counter() - t0)

        waits = [threading.Thread(target=finish, args=p) for p in procs]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        logs, failed = [], []
        for src, proc in procs:
            out, t = done[src]
            logs.append(f"== {src.name} (done after {t:.1f} s)\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so = Path(tmp) / target.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(so),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(so, target)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry's
    ``argtypes`` / ``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not say so)."""
    if err:
        msg = _lib.repro_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({msg})")


def refuse_nondeterministic(name: str) -> None:
    """Raise, as PyTorch's own non-deterministic CUDA operations do, when
    ``torch.use_deterministic_algorithms(True)`` is on: for a launch whose
    sums land through float atomics in an order that changes run to run and
    that has no deterministic route (the MLP backward's clocked measurement
    launch; every training kernel has one)."""
    import torch

    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError(
            f"{name} does not have a deterministic implementation (float "
            "atomics), but torch.use_deterministic_algorithms(True) is set")


#: the active program recorders (:mod:`repro_torch.analysis.ir`): while one
#: is, each kernel wrapper's call is recorded as a region
_recorders: list = []


class _Region:
    __slots__ = ("name", "operands", "plan")

    def __init__(self, name, operands, plan):
        self.name, self.operands, self.plan = name, operands, plan

    def __enter__(self):
        for r in _recorders:
            r.enter_region(self.name, self.operands, self.plan)
        return self

    def __exit__(self, *exc):
        for r in reversed(_recorders):
            r.exit_region()
        return False


class _NoRegion:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_REGION = _NoRegion()


def kernel_region(name: str, *operands, plan=None):
    """``with kernel_region("hash_encode_bwd", g, coords, plan=...):`` around
    a kernel wrapper's body: the counterpart of the JAX package's
    ``pallas_call`` for the static checks (ctypes launches never reach
    PyTorch's dispatcher). While a recorder is active it records one kernel
    site with the floating dtypes of ``operands`` and marks every operation
    inside (the CPU's plain version) as the kernel's; ``plan`` (a callable)
    gives the kernels the wrapper would launch at these shapes, as
    ``(family, dynamic shared bytes or None)`` pairs. Free when no recorder
    is active."""
    if not _recorders:
        return _NO_REGION
    return _Region(name, operands, plan)


def part_tensor(part, B: int, P: int, device):
    """A kernel's row -> partition map as an int32 tensor on ``device``,
    range-checked on the host (``part``: a sequence of ints or a CPU tensor)
    so that no kernel reads another partition's weights out of bounds."""
    import torch

    part_cpu = torch.as_tensor(part, dtype=torch.int32, device="cpu").reshape(-1)
    if part_cpu.numel() != B:
        raise ValueError(f"part has {part_cpu.numel()} entries for {B} rows")
    if B and (int(part_cpu.min()) < 0 or int(part_cpu.max()) >= P):
        raise ValueError(f"part entries must lie in [0, {P})")
    return part_cpu.to(device)
