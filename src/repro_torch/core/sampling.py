"""Training-sample generation: stochastic uniform + boundary half-Gaussian (III-C).

The port of ``repro.core.sampling``. The generator is COUNTER-BASED: every
random word is a pure function of ``(seed words, sample row, word index)``
through a hand-written Threefry-2x32 block cipher, so the same draws come
out of the plain PyTorch code here and out of the CUDA train-step kernel
(``csrc/train_step.cuh``), and the port draws exactly the JAX package's
batches for the same key.

PyTorch's uint32 arithmetic is incomplete on the CPU, so words are carried
as int64 tensors holding values in [0, 2^32): every add, rotate and xor is
masked with ``& 0xFFFFFFFF``, which is the uint32 wraparound exactly (the
same emulation as :mod:`repro_torch.kernels.hash_encoding.ref`).

Keys are JAX's raw ``PRNGKey`` layout: a (2,) pair of uint32 words. An
integer seed ``s`` means ``PRNGKey(s)`` = ``[0, s]``; :func:`split` and
:func:`random_uniform` reproduce ``jax.random.split``,
``jax.random.fold_in`` (:func:`fold_in`) and ``jax.random.uniform``
(threefry, ``jax_threefry_partitionable``) bit for bit, which is what makes the port's random init equal JAX's.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_N_PAIRS = 4                  # 4 Threefry blocks = 8 words per sample row
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x, device=None) -> torch.Tensor:
    """Python ints / numpy / tensors -> int64 tensor of uint32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK32
    a = np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64) & _MASK32
    return torch.as_tensor(a, dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(k0, k1, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard 20-round Threefry-2x32: counters (c0, c1) -> two words.

    All arguments broadcast (int64 tensors holding uint32 values, or ints);
    returns ``(x0, x1)`` as int64 tensors of the broadcast shape."""
    dev = next((t.device for t in (k0, k1, c0, c1)
                if isinstance(t, torch.Tensor)), None)
    k0, k1, c0, c1 = (_u32(t, dev) for t in (k0, k1, c0, c1))
    x0 = (c0 + k0) & _MASK32
    x1 = (c1 + k1) & _MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def as_key(key, device=None) -> torch.Tensor:
    """An int seed (``PRNGKey(s)`` = ``[0, s]``) or a (2,) pair of uint32
    words (numpy, tensor, list) -> the (2,) int64 key tensor."""
    if isinstance(key, (int, np.integer)):
        s = int(key)
        return _u32([(s >> 32) & _MASK32, s & _MASK32], device)
    k = _u32(key, device).reshape(-1)
    if k.numel() != 2:
        raise ValueError(f"a key is two uint32 words, got {k.numel()}")
    return k


def key_words(key):
    """A key (see :func:`as_key`) -> ``(k0, k1)`` 0-d int64 tensors."""
    k = as_key(key)
    return k[0], k[1]


def split(key, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (n, 2) words, row i = threefry(key, (0, i))."""
    k0, k1 = key_words(key)
    x0, x1 = threefry2x32(k0, k1, 0, torch.arange(n, dtype=torch.int64,
                                                  device=k0.device))
    return torch.stack([x0, x1], dim=1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``, bit for bit: the two words of
    threefry(key, (0, data)), ``data`` taken as a uint32. Returns the (2,)
    int64 key tensor (see :func:`as_key`) on the key's device."""
    k0, k1 = key_words(key)
    x0, x1 = threefry2x32(k0, k1, 0, int(data) & _MASK32)
    return torch.stack([x0, x1])


def random_bits(key, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits`` (partitionable threefry): the words of
    threefry(key, (hi, lo)) of each element's flat index, xored together."""
    k0, k1 = key_words(key)
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64)
    x0, x1 = threefry2x32(k0, k1, lo >> 32, lo & _MASK32)
    return (x0 ^ x1).reshape(shape)


def random_uniform(key, shape, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for
    bit: 23 random mantissa bits under exponent 0 give [1, 2), minus 1,
    scaled and shifted in float32 (as one fused multiply-add, which is what
    XLA compiles ``floats * (max - min) + min`` to), clamped below at
    ``minval``. Returns a CPU float32 tensor."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    # a float32 product is exact in float64; one rounding of the sum to
    # float32 after it is the fused multiply-add's single rounding except in
    # double-rounding ties, which need the float64 sum to land exactly
    # between two float32 values
    out = (f.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, out)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> f32 uniforms in [0, 1) (top 24 bits, exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def n_boundary(n_batch: int, boundary_lambda: float) -> int:
    """Static split of the batch (paper III-C): lambda*N boundary samples."""
    return int(round(boundary_lambda * n_batch))


def counter_coords(k0, k1, rows: torch.Tensor, n_uniform: int,
                   sigma: float) -> torch.Tensor:
    """Global sample ids -> training coordinates (the shared sampling stage).

    ``rows`` is an (N, 1) integer column of GLOBAL sample indices; ``k0`` /
    ``k1`` are seed words (0-d, or (B, 1, 1) to draw B batches at once, then
    the result is (B, N, 3)). Rows ``< n_uniform`` draw uniformly in
    [0,1)^3, rows ``>= n_uniform`` the paper's Eq. 2 boundary mixture
    (uniform face/side, |N(0, sigma)| offset via Box-Muller). The float32
    arithmetic is the JAX package's, operation for operation."""
    n = rows.shape[0]
    dev = rows.device
    c0 = rows.to(torch.int64).expand(n, _N_PAIRS)
    c1 = torch.arange(_N_PAIRS, dtype=torch.int64, device=dev).expand(n, _N_PAIRS)
    a, b = threefry2x32(k0, k1, c0, c1)

    u3 = uniform01(a[..., :3])                                   # (.., N, 3)
    axis = torch.clamp((uniform01(a[..., 3]) * 3.0).to(torch.int32), max=2)
    side = torch.clamp((uniform01(b[..., 0]) * 2.0).to(torch.int32),
                       max=1).to(torch.float32)
    u_r = uniform01(b[..., 1])
    u_t = uniform01(b[..., 2])
    mag = torch.sqrt(-2.0 * torch.log(1.0 - u_r)) * sigma
    two_pi = float(np.float32(2.0 * np.pi))
    off = torch.clamp(torch.abs(mag * torch.cos(two_pi * u_t)), 0.0, 1.0)
    coord = side * (1.0 - off) + (1.0 - side) * off              # near 0 or 1
    onehot = (torch.arange(3, device=dev) == axis[..., None]).to(torch.float32)
    boundary = u3 * (1.0 - onehot) + coord[..., None] * onehot
    is_b = (rows >= n_uniform).to(torch.float32)                 # (N, 1)
    return u3 * (1.0 - is_b) + boundary * is_b


def batch_coords(seeds, n_batch: int, n_uniform: int,
                 sigma: float) -> torch.Tensor:
    """(P, 2) seed rows -> the (P, N, 3) batches, rows ``< n_uniform``
    uniform (what the train-step kernel draws, block by block)."""
    s = _u32(seeds)
    rows = torch.arange(n_batch, dtype=torch.int64, device=s.device)[:, None]
    return counter_coords(s[:, 0, None, None], s[:, 1, None, None], rows,
                          n_uniform, sigma)


def training_coords_counter(seed, n_batch: int, boundary_lambda: float,
                            sigma: float, device=None) -> torch.Tensor:
    """Counter-based batch: (2,) seed words -> (N, 3) coords, or (P, 2)
    seed rows -> (P, N, 3). First ``N - round(lambda*N)`` rows uniform, the
    rest boundary: the layout the in-kernel sampler produces."""
    seed = _u32(seed, device)
    n_u = n_batch - n_boundary(n_batch, boundary_lambda)
    if seed.ndim == 2:
        return batch_coords(seed, n_batch, n_u, sigma)
    rows = torch.arange(n_batch, dtype=torch.int64, device=seed.device)[:, None]
    return counter_coords(seed[0], seed[1], rows, n_u, sigma)


def step_seeds(key, step, n_partitions: int, device=None,
               partitions=None) -> torch.Tensor:
    """(P, 2) per-partition seed words of one training step:
    ``threefry(key, (step, p))``. ``step`` may be a 1-D tensor of S steps,
    then the result is the (S, P, 2) table of a whole chunk. ``partitions``
    gives the GLOBAL indices p of the rows (default ``range(n_partitions)``):
    a rank of a mesh draws its partitions' words, the same as in a run of
    all partitions in one process."""
    k = as_key(key, device)
    p = torch.arange(n_partitions, dtype=torch.int64, device=k.device) \
        if partitions is None else \
        torch.as_tensor(partitions, dtype=torch.int64).to(k.device)
    st = _u32(step, k.device)
    if st.ndim:
        st, p = st[:, None], p[None, :]
    s0, s1 = threefry2x32(k[0], k[1], st, p)
    return torch.stack(torch.broadcast_tensors(s0, s1), dim=-1)


def gather_trilinear_bricked(vol: torch.Tensor, coords: torch.Tensor,
                             ghost: int, brick) -> torch.Tensor:
    """The oracle of the JAX package's brick-TILED in-kernel gather: visit
    the ghost-padded volume one ``brick`` = (bx, by, bz) block at a time,
    bank the raw values of the 8 trilinear corners OWNED by each brick
    (``corner // brick == brick_index`` per axis), then combine them in the
    canonical (dx, dy, dz) corner order with the cell-centre weights of
    :func:`repro_torch.data.volume.sample_trilinear`.

    ``vol``: (nx, ny, nz[, C]); ``coords``: (N, 3) f32 over the owned
    region. Returns (N, C) f32. Any brick gives the same values: the CUDA
    train-step kernel gathers straight from device memory and is held to
    this function for every brick."""
    vol = vol if vol.ndim == 4 else vol[..., None]
    nx, ny, nz, C = vol.shape
    bx, by, bz = (min(int(b), int(n)) for b, n in zip(brick, (nx, ny, nz)))
    los, ws = [], []
    for ax, n in enumerate((nx, ny, nz)):
        owned = float(n - 2 * ghost)
        pos = coords[:, ax].to(torch.float32) * owned - 0.5 + float(ghost)
        lo = torch.clamp(torch.floor(pos), 0.0, float(n - 2))
        los.append(lo.to(torch.int64))
        ws.append(torch.clamp(pos - lo, 0.0, 1.0))
    n_samples = coords.shape[0]
    corners = [torch.zeros((n_samples, C), dtype=torch.float32,
                           device=coords.device) for _ in range(8)]
    offsets = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    for bxi in range(-(-nx // bx)):
        for byi in range(-(-ny // by)):
            for bzi in range(-(-nz // bz)):
                sub = vol[bxi * bx:(bxi + 1) * bx, byi * by:(byi + 1) * by,
                          bzi * bz:(bzi + 1) * bz]
                sx, sy, sz = sub.shape[:3]
                flat = sub.reshape(sx * sy * sz, C).to(torch.float32)
                for k, (dx, dy, dz) in enumerate(offsets):
                    cx, cy, cz = los[0] + dx, los[1] + dy, los[2] + dz
                    own = ((cx // bx == bxi) & (cy // by == byi)
                           & (cz // bz == bzi))
                    rx = torch.clamp(cx - bxi * bx, 0, sx - 1)
                    ry = torch.clamp(cy - byi * by, 0, sy - 1)
                    rz = torch.clamp(cz - bzi * bz, 0, sz - 1)
                    vals = flat[(rx * sy + ry) * sz + rz]
                    corners[k] = torch.where(own[:, None], vals, corners[k])
    acc = None
    for k, (dx, dy, dz) in enumerate(offsets):
        ww = (ws[0] if dx else 1.0 - ws[0]) \
            * (ws[1] if dy else 1.0 - ws[1]) \
            * (ws[2] if dz else 1.0 - ws[2])
        term = ww[:, None] * corners[k]
        acc = term if acc is None else acc + term
    return acc
