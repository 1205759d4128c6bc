"""Model compression (paper III-D): compress trained INR weights with
error-bounded floating-point codecs, exploiting latent-grid/data correlation.

The port of ``repro.compress.model_compress``; its blobs are the JAX
package's byte for byte, and either package decodes the other's.

- dense grid levels ((R+1)^3 <= T): reinterpret as (R+1)^3 x F 4D grids and
  compress with the 3D interpolation codec (the paper uses SZ3) at accuracy r1;
- hashed levels: reinterpret as T x F 2D arrays, 1D block-transform codec
  (paper: ZFP-1D) at accuracy r2 (= r1 = r_enc);
- MLP weights: flattened 1D block-transform at accuracy r3 (= r_mlp);
- all streams merged and entropy-coded.

Codecs are selected by name through :mod:`repro_torch.compress.registry`
(the codec used per stream is recorded in the blob, so decoding needs no
configuration). The codecs run on the host in numpy: the weights are read
back from the device once per partition. Ratios are reported against fp16
weight storage (the paper's on-disk format).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backends import resolve_device
from repro_torch.compress.codec_util import definalize, finalize
from repro_torch.compress.registry import get_codec
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import param_bytes_f16


def _is_dense(res: int, table_size: int) -> bool:
    return (res + 1) ** 3 <= table_size


def _host_f32(t) -> np.ndarray:
    """A parameter (tensor on any device, any float dtype, or array) as a
    host float32 array."""
    if torch.is_tensor(t):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def compress_model(cfg: DVNRConfig, params, r_enc: float | None = None,
                   r_mlp: float | None = None, *,
                   dense_codec: str = "interp", hash_codec: str = "blockt",
                   mlp_codec: str = "blockt") -> tuple[bytes, dict]:
    r1 = cfg.zfp_enc if r_enc is None else r_enc
    r3 = cfg.zfp_mlp if r_mlp is None else r_mlp
    dense_c = get_codec(dense_codec)
    hash_c = get_codec(hash_codec)
    mlp_c = get_codec(mlp_codec)
    tables = _host_f32(params["tables"])                 # (L, T, F)
    L, T, F = tables.shape
    res = cfg.level_resolutions()
    levels = []
    for l in range(L):
        if _is_dense(res[l], T):
            r = res[l] + 1
            if dense_c.name == "interp":
                # the interpolation predictor exploits the 3D grid structure
                grid = tables[l, :r**3].reshape(r, r, r, F)
                payload = dense_c.encode(grid, r1, spatial=3)
            else:
                # generic codecs get the dense rows as a flat stream
                payload = dense_c.encode(tables[l, :r**3].reshape(-1), r1)
            levels.append({"dense": True, "codec": dense_c.name,
                           "rows": r**3, "payload": payload})
        else:
            levels.append({"dense": False, "codec": hash_c.name,
                           "payload": hash_c.encode(tables[l].reshape(-1), r1)})
    mlp_np = [_host_f32(w) for w in params["mlp"]]
    mlp = [mlp_c.encode(w.ravel(), r3) for w in mlp_np]
    mlp_shapes = [list(w.shape) for w in mlp_np]
    blob = finalize({"kind": "dvnr_model", "levels": levels, "mlp": mlp,
                     "mlp_codec": mlp_c.name, "mlp_shapes": mlp_shapes,
                     "L": L, "T": T, "F": F, "res": list(res)})
    info = {
        "bytes": len(blob),
        "f16_bytes": param_bytes_f16(cfg),
        "model_cr": param_bytes_f16(cfg) / max(len(blob), 1),
    }
    return blob, info


def decompress_model(cfg: DVNRConfig, blob: bytes, *, device="auto") -> dict:
    """A blob of :func:`compress_model` (either package's) -> float32 params
    on ``device`` (``"auto"``: the GPU)."""
    dev = resolve_device(device)
    d = definalize(blob)
    if d.get("kind") != "dvnr_model":
        raise ValueError(f"not a compressed DVNR model (kind {d.get('kind')!r})")
    L, T, F = d["L"], d["T"], d["F"]
    tables = np.zeros((L, T, F), np.float32)
    for l, lev in enumerate(d["levels"]):
        codec = get_codec(lev.get("codec") or ("interp" if lev["dense"] else "blockt"))
        if lev["dense"]:
            dec = codec.decode(lev["payload"])
            if codec.name == "interp":
                rows = dec.shape[0] ** 3
                tables[l, :rows] = dec.reshape(rows, F)
            else:
                rows = lev["rows"]
                tables[l, :rows] = np.asarray(dec).reshape(-1)[:rows * F] \
                    .reshape(rows, F)
        else:
            tables[l] = codec.decode(lev["payload"]).reshape(T, F)
    mlp_c = get_codec(d.get("mlp_codec", "blockt"))
    mlp = [mlp_c.decode(b).reshape(s) for b, s in zip(d["mlp"], d["mlp_shapes"])]
    return {"tables": torch.from_numpy(tables).to(dev),
            "mlp": [torch.from_numpy(np.ascontiguousarray(w)).to(dev)
                    for w in mlp]}


def compress_stacked(cfg: DVNRConfig, stacked_params, **kw) -> list[tuple[bytes, dict]]:
    """Compress every partition model of a stacked (P, ...) DVNR state."""
    host = {"tables": _host_f32(stacked_params["tables"]),
            "mlp": [_host_f32(w) for w in stacked_params["mlp"]]}
    P = host["tables"].shape[0]
    return [compress_model(cfg, {"tables": host["tables"][p],
                                 "mlp": [w[p] for w in host["mlp"]]}, **kw)
            for p in range(P)]
