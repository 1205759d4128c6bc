"""Lossless baseline codec (the paper's Zstandard comparison point).

Uses ``zstandard`` when installed, stdlib ``zlib`` otherwise (see
:mod:`repro_torch.compress.codec_util`).
"""
from __future__ import annotations

import msgpack
import numpy as np

from repro_torch.compress.codec_util import compress_bytes, decompress_bytes


def zstd_encode(x: np.ndarray, level: int = 6) -> bytes:
    x = np.asarray(x)
    hdr = msgpack.packb({"dtype": x.dtype.str, "shape": list(x.shape)})
    return len(hdr).to_bytes(4, "little") + hdr + \
        compress_bytes(np.ascontiguousarray(x).tobytes(), level)


def zstd_decode(blob: bytes) -> np.ndarray:
    n = int.from_bytes(blob[:4], "little")
    hdr = msgpack.unpackb(blob[4:4 + n], raw=False)
    raw = decompress_bytes(blob[4 + n:])
    return np.frombuffer(raw, np.dtype(hdr["dtype"])).reshape(hdr["shape"]).copy()
