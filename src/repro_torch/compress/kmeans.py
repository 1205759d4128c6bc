"""K-means weight quantization (paper VI-C comparison, after Han et al. /
Lu et al.): cluster each weight group with Lloyd's algorithm, store B-bit
labels + fp16 centers. Better ratio/accuracy than transform coding but much
slower — a benchmark, not the default path (the paper's conclusion).

The port of ``repro.compress.kmeans``: the Lloyd step in PyTorch (float32,
on the CPU: the arrays are host-side weights), the blob layout byte for
byte. The step's center sums are a float32 matmul, as JAX's; the two
libraries may order that sum differently, so a center can land one f16
ulp apart and a point at a tie between two centers take the other label.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compress.codec_util import (definalize, finalize, pack_codes,
                                             unpack_codes)


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor):
    d = torch.abs(x[:, None] - centers[None, :])            # (N, K)
    assign = torch.argmin(d, dim=1)                         # first minimum
    onehot = torch.nn.functional.one_hot(assign, centers.shape[0]) \
        .to(torch.float32)
    counts = onehot.sum(0)
    sums = onehot.T @ x
    new = torch.where(counts > 0, sums / torch.clamp(counts, min=1), centers)
    return new, assign


def kmeans_quantize_array(x: np.ndarray, bits: int, iters: int = 10,
                          seed: int = 0):
    """Returns (labels int64, centers f32, reconstructed)."""
    flat = np.asarray(x, np.float32).ravel()
    k = min(2**bits, flat.size)
    qs = np.linspace(0, 100, k)
    centers = torch.from_numpy(np.percentile(flat, qs).astype(np.float32))
    xt = torch.from_numpy(flat.copy())
    assign = None
    for _ in range(iters):
        centers, assign = _lloyd_step(xt, centers)
    c = centers.numpy().astype(np.float32)
    a = assign.numpy().astype(np.int64)
    return a, c, c[a]


def kmeans_encode(arrays: dict, bits: int, iters: int = 10) -> bytes:
    groups = {}
    for name, arr in arrays.items():
        labels, centers, _ = kmeans_quantize_array(arr, bits, iters)
        groups[name] = {"shape": list(np.asarray(arr).shape),
                        "labels": pack_codes(labels),
                        "centers": centers.astype(np.float16).tobytes()}
    return finalize({"kind": "kmeans", "bits": bits, "groups": groups})


def kmeans_decode(blob: bytes) -> dict:
    d = definalize(blob)
    if d.get("kind") != "kmeans":
        raise ValueError(f"not a kmeans blob (kind {d.get('kind')!r})")
    out = {}
    for name, g in d["groups"].items():
        centers = np.frombuffer(g["centers"], np.float16).astype(np.float32)
        labels = unpack_codes(g["labels"])
        out[name] = centers[labels].reshape(g["shape"])
    return out
