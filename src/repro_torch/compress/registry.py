"""Codec registry: every error-bounded (and lossless) codec under one uniform
named ``encode(arr, tol) / decode(blob)`` interface.

Consumers (``model_compress``, the temporal model cache) select codecs by
name instead of hard-importing the codec modules, so new codecs plug in
with one ``register_codec`` call:

- ``interp``     SZ3-like multilevel interpolation predictor (nD)
- ``blockt``     ZFP-like orthonormal 1D block-transform coder
- ``quantizer``  plain error-bounded uniform quantizer (alias: ``quant``)
- ``zstd``       lossless entropy baseline (``tol`` ignored; zlib fallback)

Lossy codecs guarantee ``max |x - decode(encode(x, tol))| <= tol``.

Integrity: finalized blobs (everything written through
:func:`repro_torch.compress.codec_util.compress_bytes` — model blobs, temporal
cache entries) carry a CRC32 frame; decoding a corrupted blob raises
:class:`BlobIntegrityError` (re-exported here) instead of returning garbage,
and the temporal model cache uses it to fall back to the previous clean
entry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.compress.blockt import blockt_decode, blockt_encode
from repro_torch.compress.codec_util import BlobIntegrityError  # noqa: F401 — re-export
from repro_torch.compress.interp import interp_decode, interp_encode
from repro_torch.compress.quantizer import quant_decode, quant_encode
from repro_torch.compress.zstd_codec import zstd_decode, zstd_encode


@dataclass(frozen=True)
class Codec:
    """A named codec with the uniform encode/decode calling convention."""

    name: str
    lossy: bool
    encode_fn: Callable[..., bytes]
    decode_fn: Callable[[bytes], np.ndarray]
    description: str = ""

    def encode(self, arr, tol: Optional[float] = None, **kw) -> bytes:
        """arr -> blob. ``tol`` is the absolute error bound (lossy codecs);
        lossless codecs accept and ignore it."""
        if self.lossy:
            if tol is None:
                raise ValueError(f"codec {self.name!r} is lossy: tol required")
            return self.encode_fn(arr, tol, **kw)
        return self.encode_fn(arr, **kw)

    def decode(self, blob: bytes) -> np.ndarray:
        return self.decode_fn(blob)


CodecLike = Union[str, Codec]

_REGISTRY: Dict[str, Codec] = {}
_ALIASES: Dict[str, str] = {}


def register_codec(codec: Codec, *, aliases: Tuple[str, ...] = ()) -> Codec:
    _REGISTRY[codec.name] = codec
    for a in aliases:
        _ALIASES[a] = codec.name
    return codec


def get_codec(name: CodecLike) -> Codec:
    if isinstance(name, Codec):
        return name
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: "
            f"{sorted(set(_REGISTRY) | set(_ALIASES))}") from None


def available_codecs() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register_codec(Codec(
    name="interp", lossy=True, encode_fn=interp_encode, decode_fn=interp_decode,
    description="SZ3-like hierarchical interpolation predictor (nD grids)",
))
register_codec(Codec(
    name="blockt", lossy=True, encode_fn=blockt_encode, decode_fn=blockt_decode,
    description="ZFP-like orthonormal 1D block-transform coder",
))
register_codec(Codec(
    name="quantizer", lossy=True, encode_fn=quant_encode, decode_fn=quant_decode,
    description="error-bounded uniform quantizer",
), aliases=("quant",))
register_codec(Codec(
    name="zstd", lossy=False, encode_fn=zstd_encode, decode_fn=zstd_decode,
    description="lossless entropy baseline (zlib fallback when zstandard "
                "is unavailable)",
))
