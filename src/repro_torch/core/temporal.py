"""Temporal model caching (paper §IV-B): sliding window of compressed DVNR
models replacing raw-grid history buffers.

The port of ``repro.core.temporal``. Entries are keyed by timestep; each
append adds the newest model and evicts beyond the window size. Byte
accounting mirrors the paper's Fig. 12 memory study: the cache holds
*compressed* models (kilobytes) instead of raw grids (gigabytes). The blobs
(compressed, or the raw-f16 ablation flavor) are the JAX package's byte for
byte; decoded params land on the cache's ``device``.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Optional

import msgpack
import numpy as np
import torch

from repro_torch.backends import resolve_device
from repro_torch.compress.codec_util import (BlobIntegrityError, crc_frame,
                                             crc_unframe)
from repro_torch.compress.model_compress import compress_model, decompress_model
from repro_torch.configs.dvnr import DVNRConfig

_RAW_KIND = "dvnr_raw_f16"
# dtype tokens of the JAX package's blobs (``codec_util.dtype_token``):
# numpy's ``.str`` of a standard dtype, the name of bfloat16
_TOKENS = {torch.float32: "<f4", torch.float16: "<f2", torch.float64: "<f8",
           torch.bfloat16: "bfloat16"}
_DTYPES = {v: k for k, v in _TOKENS.items()}


def _raw_leaf(t: torch.Tensor) -> dict:
    """f16 bytes + the shape/dtype needed to rebuild the leaf."""
    a = t.detach().to("cpu", torch.float32).numpy()
    return {"dtype": _TOKENS[t.dtype], "shape": list(t.shape),
            "data": a.astype(np.float16).tobytes()}


def _raw_decode_leaf(d, device) -> torch.Tensor:
    arr = np.frombuffer(d["data"], np.float16).reshape(d["shape"])
    return torch.from_numpy(arr.astype(np.float32)).to(device, _DTYPES[d["dtype"]])


def _decode_blob(cfg: DVNRConfig, blob: bytes, device) -> dict:
    """Decode either blob flavor: the raw-f16 msgpack payload of
    ``append(compress=False)`` (ablation: "uncomp") or a compressed model.
    Both carry a CRC32 frame; a corrupted blob raises
    :class:`BlobIntegrityError` here rather than decoding into garbage."""
    body = crc_unframe(blob)
    try:
        d = msgpack.unpackb(body, raw=False)
    except Exception:   # a compressed model is not a msgpack payload
        d = None
    if isinstance(d, dict) and d.get("kind") == _RAW_KIND:
        return {"tables": _raw_decode_leaf(d["tables"], device),
                "mlp": [_raw_decode_leaf(w, device) for w in d["mlp"]]}
    return decompress_model(cfg, body, device=device)


def _stack(parts: list) -> dict:
    return {"tables": torch.stack([p["tables"] for p in parts]),
            "mlp": [torch.stack(ws) for ws in zip(*(p["mlp"] for p in parts))]}


@dataclass
class CacheEntry:
    timestep: int
    blobs: list                 # one compressed model per partition
    meta: dict                  # vmin/vmax per partition, config hash, ...

    @property
    def bytes(self) -> int:
        return sum(len(b) for b in self.blobs)


class TemporalModelCache:
    """Sliding window over timesteps of per-partition compressed DVNR models.

    The per-stream codecs of the model-compression pipeline are selected by
    registry name (``dense_codec``/``hash_codec``/``mlp_codec``). Decoded
    params are float32 (compressed) or the appended dtype (raw) on
    ``device`` (``"auto"``: the GPU)."""

    def __init__(self, cfg: DVNRConfig, window: int, *,
                 dense_codec: str = "interp", hash_codec: str = "blockt",
                 mlp_codec: str = "blockt", device="auto"):
        self.cfg = cfg
        self.window = window
        self.device = resolve_device(device)
        self.codecs = {"dense_codec": dense_codec, "hash_codec": hash_codec,
                       "mlp_codec": mlp_codec}
        self._entries: deque[CacheEntry] = deque()

    def append(self, timestep: int, stacked_params, meta: Optional[dict] = None,
               compress: bool = True) -> CacheEntry:
        # one device->host transfer of the whole stacked tree; the
        # per-partition codec work below is host-side byte munging
        stacked_params = {"tables": stacked_params["tables"].detach().cpu(),
                          "mlp": [w.detach().cpu() for w in stacked_params["mlp"]]}
        P = stacked_params["tables"].shape[0]
        blobs = []
        for p in range(P):
            one = {"tables": stacked_params["tables"][p],
                   "mlp": [w[p] for w in stacked_params["mlp"]]}
            if compress:
                blob, _ = compress_model(self.cfg, one, **self.codecs)
            else:  # raw f16 serialization (ablation: "uncomp"); per-leaf
                # shape/dtype ride along so the blob decodes back
                blob = crc_frame(msgpack.packb({
                    "kind": _RAW_KIND,
                    "tables": _raw_leaf(one["tables"]),
                    "mlp": [_raw_leaf(w) for w in one["mlp"]],
                }))
            blobs.append(blob)
        entry = CacheEntry(timestep, blobs, meta or {})
        self._entries.append(entry)
        while len(self._entries) > self.window:
            self._entries.popleft()        # evict the oldest (paper IV-B)
        return entry

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def timesteps(self) -> list[int]:
        return [e.timestep for e in self._entries]

    @property
    def total_bytes(self) -> int:
        return sum(e.bytes for e in self._entries)

    def _index(self, timestep: int) -> int:
        idx = next((i for i, e in enumerate(self._entries)
                    if e.timestep == timestep), None)
        if idx is None:
            raise KeyError(f"timestep {timestep} not in window {self.timesteps}")
        return idx

    def get(self, timestep: int, partition: int) -> dict:
        """Decode one partition's model at ``timestep``.

        A corrupted blob (CRC mismatch) falls back to the newest OLDER clean
        entry for the same partition (the window is temporally coherent).
        Raises :class:`BlobIntegrityError` only when no clean fallback
        exists."""
        idx = self._index(timestep)
        last_err = None
        for i in range(idx, -1, -1):       # requested entry, then older ones
            try:
                return _decode_blob(self.cfg, self._entries[i].blobs[partition],
                                    self.device)
            except BlobIntegrityError as err:
                last_err = err
        raise last_err

    def stacked_params(self, timestep: int) -> dict:
        """Decode EVERY partition's model at ``timestep`` into the
        partition-stacked layout (``tables (P,L,T,F)``) the render path
        consumes, with :meth:`get`'s fallback per partition."""
        P = len(self._entries[self._index(timestep)].blobs)
        return _stack([self.get(timestep, p) for p in range(P)])

    def window_params(self, partition: int) -> list[dict]:
        """All cached models of one partition, oldest->newest. A corrupted
        entry is replaced by its nearest older clean neighbor (newer, for a
        corrupt oldest entry) so the trace length always matches the window;
        raises only when every entry is corrupt."""
        decoded: list = []
        bad: list[int] = []
        for i, e in enumerate(self._entries):
            try:
                decoded.append(_decode_blob(self.cfg, e.blobs[partition],
                                            self.device))
            except BlobIntegrityError:
                decoded.append(None)
                bad.append(i)
        if len(bad) == len(decoded):
            raise BlobIntegrityError(
                f"all {len(decoded)} cached blobs for partition {partition} "
                "failed integrity checks; no clean fallback")
        for i in bad:
            j = next((k for k in range(i - 1, -1, -1) if decoded[k] is not None),
                     None)
            if j is None:
                j = next(k for k in range(i + 1, len(decoded))
                         if decoded[k] is not None)
            decoded[i] = decoded[j]
        return decoded


class WeightCache:
    """Paper §III-E: warm-start initialization keyed by (field, config).

    Entries stay on the device the params live on (the warm-start path runs
    every in situ tick); stored tensors are copies, so the trainer's buffers
    never alias the cache."""

    def __init__(self, max_entries: int = 16):
        self._store: OrderedDict[tuple, dict] = OrderedDict()
        self.max_entries = max_entries

    @staticmethod
    def _key(field_name: str, cfg: DVNRConfig) -> tuple:
        return (field_name, cfg.n_levels, cfg.n_features_per_level,
                cfg.log2_hashmap_size, cfg.resolved_base_resolution,
                cfg.n_neurons, cfg.n_hidden_layers, cfg.out_dim)

    def put(self, field_name: str, cfg: DVNRConfig, stacked_params) -> None:
        key = self._key(field_name, cfg)
        self._store[key] = {"tables": stacked_params["tables"].detach().clone(),
                            "mlp": [w.detach().clone()
                                    for w in stacked_params["mlp"]]}
        self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def get(self, field_name: str, cfg: DVNRConfig):
        return self._store.get(self._key(field_name, cfg))
