"""Shared serialization helpers for the compressor stack (msgpack framing).

The port's copy of ``repro.compress.codec_util``, byte for byte in what it
writes. The lossless entropy stage prefers ``zstandard``; when it is not
installed the stdlib ``zlib`` takes over (worse ratio, same API). Every blob
is prefixed with a one-byte coder tag so blobs written on one installation
decode on another, or fail with an actionable error when the zstd coder is
required but absent.

Integrity: every blob written through :func:`compress_bytes` carries a CRC32
frame (``b"C"`` + 4-byte big-endian CRC of the rest). :func:`decompress_bytes`
verifies it and raises :class:`BlobIntegrityError` on mismatch, so a
bit-rotted cache entry is detected instead of decoding into garbage params
(the temporal model cache falls back to the previous clean entry on it).
Legacy unframed blobs still decode, unverified.
"""
from __future__ import annotations

import zlib as _zlib

import msgpack
import numpy as np

try:
    import zstandard as _zstd

    HAVE_ZSTD = True
except ModuleNotFoundError:
    _zstd = None
    HAVE_ZSTD = False

# one-byte coder tags; chosen to collide with neither a zlib stream header
# (0x78) nor a zstd frame magic (0x28) so legacy untagged blobs are detected
_TAG_ZSTD = b"Z"
_TAG_ZLIB = b"L"
# CRC32 integrity frame: b"C" + crc32(rest).to_bytes(4) + rest (0x43 collides
# with no coder tag, no zlib header and no zstd magic)
_TAG_CRC = b"C"


class BlobIntegrityError(ValueError):
    """A blob's CRC32 integrity tag does not match its payload."""


def crc_frame(data: bytes) -> bytes:
    """Wrap ``data`` in a CRC32 integrity frame (see :func:`crc_unframe`)."""
    return _TAG_CRC + (_zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "big") + data


def crc_unframe(data: bytes) -> bytes:
    """Verify and strip a CRC32 frame; unframed (legacy) blobs pass through.

    Raises :class:`BlobIntegrityError` when the stored checksum does not
    match the payload (bit rot, truncation, torn write)."""
    if data[:1] != _TAG_CRC:
        return data
    want = int.from_bytes(data[1:5], "big")
    body = data[5:]
    got = _zlib.crc32(body) & 0xFFFFFFFF
    if got != want:
        raise BlobIntegrityError(
            f"blob integrity check failed: stored CRC32 {want:#010x} != "
            f"computed {got:#010x} over {len(body)} payload bytes")
    return body


def _need_zstd() -> None:
    if not HAVE_ZSTD:
        raise RuntimeError(
            "blob was compressed with zstandard, which is not installed "
            "here — `pip install zstandard` to read it")


def compress_bytes(data: bytes, level: int = 6) -> bytes:
    if HAVE_ZSTD:
        body = _TAG_ZSTD + _zstd.ZstdCompressor(level=level).compress(data)
    else:
        body = _TAG_ZLIB + _zlib.compress(data, min(max(level, 1), 9))
    return crc_frame(body)


def decompress_bytes(data: bytes) -> bytes:
    data = crc_unframe(data)
    tag, body = data[:1], data[1:]
    if tag == _TAG_ZSTD:
        _need_zstd()
        return _zstd.ZstdDecompressor().decompress(body)
    if tag == _TAG_ZLIB:
        return _zlib.decompress(body)
    # legacy untagged blob (pre-tag format): raw zstd frame or zlib stream
    if data[:4] == b"\x28\xb5\x2f\xfd":
        _need_zstd()
        return _zstd.ZstdDecompressor().decompress(data)
    return _zlib.decompress(data)


def dtype_token(dtype) -> str:
    """Serializable dtype tag: the registered name of an extension float
    dtype (``'bfloat16'``, whose ``.str`` is an opaque ``'<V2'``), the
    byte-order-explicit ``.str`` of a standard one (``'<f4'``)."""
    dtype = np.dtype(dtype)
    return dtype.name if dtype.kind == "V" else dtype.str


def pack_codes(q: np.ndarray) -> dict:
    """Store integer codes in the narrowest dtype that fits."""
    lo, hi = (int(q.min()), int(q.max())) if q.size else (0, 0)
    for dt in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return {"dtype": np.dtype(dt).str, "shape": list(q.shape),
                    "data": q.astype(dt).tobytes()}
    raise ValueError("codes out of int64 range")


def unpack_codes(d: dict) -> np.ndarray:
    return np.frombuffer(d["data"], np.dtype(d["dtype"])) \
        .reshape(d["shape"]).astype(np.int64)


def finalize(obj: dict, level: int = 6) -> bytes:
    return compress_bytes(msgpack.packb(obj, use_bin_type=True), level)


def definalize(blob: bytes) -> dict:
    return msgpack.unpackb(decompress_bytes(blob), raw=False)
