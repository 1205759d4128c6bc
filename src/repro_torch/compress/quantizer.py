"""Error-bounded uniform quantizer: |x - decode(encode(x, tol))| <= tol."""
from __future__ import annotations

import numpy as np

from repro_torch.compress.codec_util import definalize, finalize, pack_codes, unpack_codes


def _quantize(x: np.ndarray, tol: float) -> np.ndarray:
    return np.round(np.asarray(x, np.float64) / (2.0 * tol)).astype(np.int64)


def _dequantize(q: np.ndarray, tol: float) -> np.ndarray:
    return (q * np.float64(2.0 * tol)).astype(np.float32)


def quant_encode(x: np.ndarray, tol: float, level: int = 6) -> bytes:
    q = _quantize(x, tol)
    return finalize({"kind": "quant", "tol": float(tol),
                     "codes": pack_codes(q)}, level)


def quant_decode(blob: bytes) -> np.ndarray:
    d = definalize(blob)
    if d.get("kind") != "quant":
        raise ValueError(f"not a quant blob (kind {d.get('kind')!r})")
    return _dequantize(unpack_codes(d["codes"]), d["tol"])
