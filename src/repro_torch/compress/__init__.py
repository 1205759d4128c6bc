"""Error-bounded lossy compressors: the port's copy of ``repro.compress``.

- ``interp``   : SZ3-like multilevel interpolation predictor (nD, vectorized)
- ``blockt``   : ZFP-like orthonormal block-transform coder (1D)
- ``quantizer``: plain error-bounded uniform quantizer
- ``zstd_codec``: lossless baseline
- ``model_compress``: the paper's III-D model-weight pipeline
- ``kmeans``   : K-means weight quantization (paper VI-C comparison)

The codecs are numpy on the host (K-means' Lloyd step is PyTorch) and write
the JAX package's blobs byte for byte, so either package decodes the
other's. All lossy codecs guarantee max |x - decode(encode(x))| <= tol
(absolute mode).

``registry`` exposes every codec under a uniform named
``encode(arr, tol)/decode(blob)`` interface (``get_codec("interp")`` etc.);
new codecs plug in via ``register_codec``.
"""
from repro_torch.compress.quantizer import quant_encode, quant_decode
from repro_torch.compress.interp import interp_encode, interp_decode
from repro_torch.compress.blockt import blockt_encode, blockt_decode
from repro_torch.compress.zstd_codec import zstd_encode, zstd_decode
from repro_torch.compress.model_compress import (compress_model,
                                                 compress_stacked,
                                                 decompress_model)
from repro_torch.compress.registry import (Codec, available_codecs, get_codec,
                                           register_codec)

__all__ = [
    "quant_encode", "quant_decode",
    "interp_encode", "interp_decode",
    "blockt_encode", "blockt_decode",
    "zstd_encode", "zstd_decode",
    "compress_model", "compress_stacked", "decompress_model",
    "Codec", "get_codec", "register_codec", "available_codecs",
]
