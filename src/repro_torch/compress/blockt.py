"""ZFP-like error-bounded 1D block-transform coder.

64-element blocks, orthonormal DCT-II basis, uniform coefficient quantization.
Orthonormality gives the spatial bound |err_x|_inf <= sqrt(B) * tol_c, so we
quantize coefficients at tol_c = tol / sqrt(B) to guarantee the user's absolute
error bound. High-frequency coefficients quantize to long zero runs that the
zstd stage removes (the role bit-planes play in real ZFP).
"""
from __future__ import annotations

import numpy as np

from repro_torch.compress.codec_util import definalize, finalize, pack_codes, unpack_codes

BLOCK = 64


def _dct_matrix(b: int = BLOCK) -> np.ndarray:
    k = np.arange(b)[:, None]
    n = np.arange(b)[None, :]
    m = np.sqrt(2.0 / b) * np.cos(np.pi * (n + 0.5) * k / b)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float64)          # orthonormal: m @ m.T = I


_DCT = _dct_matrix()


def blockt_encode(x: np.ndarray, tol: float, level: int = 6) -> bytes:
    x = np.asarray(x, np.float32).ravel()
    n = x.size
    pad = (-n) % BLOCK
    xb = np.pad(x, (0, pad)).reshape(-1, BLOCK).astype(np.float64)
    coef = xb @ _DCT.T
    tol_c = tol / np.sqrt(BLOCK)
    q = np.round(coef / (2 * tol_c)).astype(np.int64)
    return finalize({"kind": "blockt", "tol": float(tol), "n": int(n),
                     "codes": pack_codes(q)}, level)


def blockt_decode(blob: bytes) -> np.ndarray:
    d = definalize(blob)
    if d.get("kind") != "blockt":
        raise ValueError(f"not a blockt blob (kind {d.get('kind')!r})")
    tol_c = d["tol"] / np.sqrt(BLOCK)
    coef = unpack_codes(d["codes"]).astype(np.float64) * (2 * tol_c)
    xb = coef @ _DCT
    return xb.ravel()[:d["n"]].astype(np.float32)
