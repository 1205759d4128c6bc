"""SZ3-like error-bounded compressor: hierarchical linear-interpolation predictor.

Encoding walks a resolution pyramid from a coarse subsampling to the full grid;
each level predicts the finer grid by separable linear interpolation of the
*reconstructed* coarser level and stores uniformly quantized residuals. Both
encode and decode are fully vectorized (unlike raster-order Lorenzo), matching
SZ3's dynamic-spline-interpolation design [Zhao et al., ICDE 2021].

Guarantee: max |x - decode(encode(x, tol))| <= tol at every grid point (each
point's residual is quantized against its true value).
"""
from __future__ import annotations

import numpy as np

from repro_torch.compress.codec_util import definalize, finalize, pack_codes, unpack_codes


def _level_shapes(shape: tuple[int, ...], spatial: int):
    """Shapes of the pyramid from coarse to fine, halving strides (spatial dims)."""
    strides = [1]
    while all((s - 1) // (strides[-1] * 2) + 1 >= 2 for s in shape[:spatial]) \
            and strides[-1] < max(shape):
        strides.append(strides[-1] * 2)
    shapes = []
    for st in reversed(strides):
        shapes.append(tuple((s - 1) // st + 1 for s in shape[:spatial]) + shape[spatial:])
    return shapes, list(reversed(strides))


def _upsample_axis(a: np.ndarray, new_len: int, axis: int) -> np.ndarray:
    """Linear interp from coarse samples (stride-2 positions) to the finer grid."""
    a = np.moveaxis(a, axis, 0)
    m = a.shape[0]
    out_shape = (new_len,) + a.shape[1:]
    out = np.empty(out_shape, a.dtype)
    idx = np.arange(new_len)
    even = idx % 2 == 0
    out[even] = a[idx[even] // 2]
    odd = idx[~even]
    lo = odd // 2
    hi = np.minimum(lo + 1, m - 1)
    out[odd] = 0.5 * (a[lo] + a[hi])
    return np.moveaxis(out, 0, axis)


def _predict(coarse: np.ndarray, fine_shape: tuple[int, ...], spatial: int):
    pred = coarse
    for ax in range(spatial):
        if pred.shape[ax] != fine_shape[ax]:
            pred = _upsample_axis(pred, fine_shape[ax], ax)
    return pred


def _subsample(x: np.ndarray, stride: int, spatial: int) -> np.ndarray:
    sl = tuple(slice(None, None, stride) for _ in range(spatial))
    return x[sl]


def interp_encode(x: np.ndarray, tol: float, spatial: int | None = None,
                  level: int = 6) -> bytes:
    """x: nD float array; trailing dims beyond ``spatial`` are channels."""
    x = np.asarray(x, np.float64)   # internal f64: keeps the bound tight
    if spatial is None:
        spatial = min(x.ndim, 3)
    shapes, strides = _level_shapes(x.shape, spatial)
    q0 = np.round(_subsample(x, strides[0], spatial) / (2 * tol)).astype(np.int64)
    rec = q0 * (2.0 * tol)
    streams = [pack_codes(q0)]
    for li in range(1, len(shapes)):
        actual = _subsample(x, strides[li], spatial)
        pred = _predict(rec, actual.shape, spatial)
        q = np.round((actual - pred) / (2 * tol)).astype(np.int64)
        rec = pred + q * (2.0 * tol)
        streams.append(pack_codes(q))
    return finalize({"kind": "interp", "tol": float(tol), "spatial": spatial,
                     "shape": list(x.shape), "levels": streams}, level)


def interp_decode(blob: bytes) -> np.ndarray:
    d = definalize(blob)
    if d.get("kind") != "interp":
        raise ValueError(f"not an interp blob (kind {d.get('kind')!r})")
    tol, spatial = d["tol"], d["spatial"]
    shapes, _ = _level_shapes(tuple(d["shape"]), spatial)
    rec = unpack_codes(d["levels"][0]) * (2.0 * tol)
    for li in range(1, len(d["levels"])):
        pred = _predict(rec, shapes[li], spatial)
        rec = pred + unpack_codes(d["levels"][li]) * (2.0 * tol)
    return rec.astype(np.float32)
