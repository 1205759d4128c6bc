"""Error-bounded compressed checkpoints — the paper's §III-D model-compression
idea applied at checkpoint granularity (the port of
``repro.checkpoint.compressed``).

Each leaf is routed by shape exactly like DVNR model compression routes INR
weights: big >=2-D tensors through the interpolation-predictor coder;
small/1-D tensors through the uniform quantizer; streams merged and
entropy-coded. Codecs are resolved by name through the port's codec
registry (the JAX package's codecs, byte for byte) and the chosen name is
recorded per leaf. Tolerances are *relative* to each leaf's value range, so
the same knob serves fp32 and bf16 states; integer and bool leaves are kept
raw, losslessly. Leaves are tensors (any device) or numpy arrays, in the
JAX package's leaf order (dict keys sorted).
"""
from __future__ import annotations

from typing import Any

import msgpack
import numpy as np
import torch

from repro_torch.compress.codec_util import compress_bytes, decompress_bytes
from repro_torch.compress.registry import get_codec
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel.sharding import _unflatten_like

_BF16 = "bfloat16"


def _route(a: np.ndarray) -> str:
    """Codec name for one leaf (shape-based routing, as in model_compress)."""
    if a.ndim >= 2 and a.size >= 4096:
        return "interp"
    return "quantizer"


def _host(x):
    """(numpy array, dtype token) of a leaf: bfloat16 as float32 values
    under the token ``"bfloat16"`` (no numpy bfloat16 is needed)."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), _BF16
        a = t.numpy()
    else:
        a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == _BF16:
        return a.astype(np.float32), _BF16
    return a, a.dtype.str


def compress_tree(tree: Any, rel_tol: float = 1e-3, level: int = 6) -> bytes:
    """Returns one self-describing blob; lossy with per-leaf |err| <= rel_tol *
    range(leaf). dtype round-trips; bf16 (and other sub-f32 float) leaves are
    promoted to fp32 for coding and cast back on decode, so their extra error
    is at most one target-dtype ulp on top of the codec tolerance."""
    items = []
    for x in tree_leaves(tree):
        a, dt = _host(x)
        if dt != _BF16 and not np.issubdtype(a.dtype, np.floating):
            items.append({"mode": "raw", "dtype": dt, "shape": list(a.shape),
                          "blob": a.tobytes()})
            continue
        work = a.astype(np.float32) if a.dtype != np.float32 else a
        rng = float(work.max() - work.min()) if work.size else 0.0
        tol = max(rel_tol * rng, 1e-12)
        codec = get_codec(_route(work))
        # the sub-coders entropy-code internally at level 1; the outer stage
        # does the rest
        items.append({"mode": codec.name, "dtype": dt, "shape": list(a.shape),
                      "blob": codec.encode(work, tol, level=1)})
    payload = msgpack.packb({"treedef": "repro_torch", "items": items})
    return compress_bytes(payload, level)


def decompress_tree(blob: bytes, example_tree: Any) -> Any:
    """The tree of :func:`compress_tree` in ``example_tree``'s structure,
    as CPU tensors of the recorded dtypes (bfloat16 rounded from the
    decoded float32, to nearest even)."""
    payload = msgpack.unpackb(decompress_bytes(blob), raw=False)
    out = []
    for item in payload["items"]:
        if item["mode"] == "raw":
            a = np.frombuffer(item["blob"], np.dtype(item["dtype"])).copy()
        else:
            # legacy blobs stored "quant"; the registry aliases it
            a = np.asarray(get_codec(item["mode"]).decode(item["blob"]))
        if item["dtype"] == _BF16:
            t = torch.from_numpy(np.asarray(a, np.float32).reshape(item["shape"]))
            out.append(t.to(torch.bfloat16))
        else:
            out.append(torch.from_numpy(
                np.asarray(a, np.dtype(item["dtype"])).reshape(item["shape"])))
    if len(out) != len(tree_leaves(example_tree)):
        raise ValueError(f"blob has {len(out)} leaves, template has "
                         f"{len(tree_leaves(example_tree))}")
    return _unflatten_like(example_tree, out)


def compression_report(tree: Any, rel_tol: float = 1e-3) -> dict:
    raw = sum(_host(x)[0].nbytes if _host(x)[1] != _BF16 else _host(x)[0].size * 2
              for x in tree_leaves(tree))
    blob = compress_tree(tree, rel_tol)
    return {"raw_bytes": raw, "compressed_bytes": len(blob),
            "ratio": raw / max(len(blob), 1)}
