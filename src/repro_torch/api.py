"""repro_torch.api — the serving subset of the DVNR facade.

The port of ``repro.api``'s inference side: :class:`DVNRModel` (config +
single or partition-stacked params + partition metadata) with ``init`` /
``partition`` / ``stacked_params`` / ``meta_arrays`` / ``apply`` /
``decode_grid`` / ``save`` / ``load``, the frozen request objects, and the
uncached :func:`render`. Training, compression, isosurfaces and pathlines
come with later slices.

Models saved by either package load in the other: :meth:`DVNRModel.save`
writes the JAX package's msgpack format byte for byte (``msgpack`` is
imported only by ``save`` / ``load``).

Everything runs on the GPU unless the caller asks for the CPU:
``device="auto"`` and ``backend="auto"`` raise when there is no CUDA device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import backends
from repro_torch.backends import BackendLike, resolve_device
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import (_decode_grid, _inr_apply, init_inr,
                                  param_count)
from repro_torch.core.render import Camera
from repro_torch.precision import Precision, resolve_precision

__all__ = [
    "DVNRModel", "PartitionMeta", "Camera", "TransferFunction",
    "RenderRequest", "render", "save", "load", "DVNRConfig", "Precision",
    "resolve_precision",
]

_SAVE_KIND = "dvnr_model_v1"


@dataclass(frozen=True)
class PartitionMeta:
    """Host-side metadata of one partition: box placement + value range."""

    origin: Tuple[float, float, float]
    extent: Tuple[float, float, float]
    vmin: float
    vmax: float

    def __getitem__(self, key: str):
        return getattr(self, key)

    def to_dict(self) -> dict:
        return {"origin": list(self.origin), "extent": list(self.extent),
                "vmin": self.vmin, "vmax": self.vmax}

    @classmethod
    def of(cls, obj) -> "PartitionMeta":
        """Coerce a dict / VolumePartition / PartitionMeta."""
        if isinstance(obj, PartitionMeta):
            return obj
        if isinstance(obj, dict):
            return cls(tuple(obj["origin"]), tuple(obj["extent"]),
                       float(obj["vmin"]), float(obj["vmax"]))
        return cls(tuple(obj.origin), tuple(obj.extent),
                   float(obj.vmin), float(obj.vmax))


def _meta_tuple(parts_meta) -> Optional[Tuple[PartitionMeta, ...]]:
    if parts_meta is None:
        return None
    return tuple(PartitionMeta.of(m) for m in parts_meta)


def _grange_of(metas: Sequence[PartitionMeta]) -> Tuple[float, float]:
    return (min(m.vmin for m in metas), max(m.vmax for m in metas))


@dataclass(frozen=True, eq=False)
class TransferFunction:
    """An RGBA transfer function over the GLOBAL normalized value range:
    ``table`` (K, 4) (``None``: the built-in cool-to-warm table) and the
    opacity ``density``."""

    table: Any = None
    density: float = 50.0

    @property
    def table_shape(self) -> Optional[Tuple[int, ...]]:
        return None if self.table is None else tuple(np.shape(self.table))

    def resolved_table(self, device="cpu") -> torch.Tensor:
        from repro_torch.core.render import default_tf
        if self.table is None:
            return default_tf(device=device)
        return torch.as_tensor(np.asarray(self.table), dtype=torch.float32,
                               device=device)


@dataclass(frozen=True, eq=False)
class RenderRequest:
    """One render ask: camera, transfer function, image and ray-march
    resolution, and the reduced inference / output dtypes. ``iso``,
    ``timestep`` and ``lod`` are carried for the later slices (isosurface,
    temporal cache, brick cache) and group requests in the service."""

    camera: Camera = Camera()
    tf: TransferFunction = TransferFunction()
    width: int = 128
    height: int = 128
    n_samples: int = 64
    iso: Optional[float] = None
    timestep: Optional[int] = None
    lod: int = 0
    compute_dtype: Optional[str] = None
    out_dtype: Optional[str] = None


def _tree_map(fn, params: dict) -> dict:
    return {"tables": fn(params["tables"]), "mlp": [fn(w) for w in params["mlp"]]}


@dataclass
class DVNRModel:
    """One DVNR: config + INR params (+ distributed partition metadata).

    ``params`` is a single model (``tables (L,T,F)``) or the
    partition-stacked form (``tables (P,L,T,F)``), on the device the model
    lives on."""

    cfg: DVNRConfig
    params: Any
    parts_meta: Optional[Tuple[PartitionMeta, ...]] = None
    grange: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        if self.parts_meta is not None:
            self.parts_meta = _meta_tuple(self.parts_meta)
            if self.grange is None:
                self.grange = _grange_of(self.parts_meta)

    @classmethod
    def init(cls, cfg: DVNRConfig, seed=0, n_partitions: Optional[int] = None,
             parts_meta=None, *, device="auto") -> "DVNRModel":
        """Random-init a single model, or a stacked one for P partitions.
        ``seed`` is an int or a CPU ``torch.Generator``; partitions draw one
        after another from it."""
        dev = resolve_device(device)
        g = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        if n_partitions is None:
            return cls(cfg, init_inr(cfg, g, device=dev), _meta_tuple(parts_meta))
        parts = [init_inr(cfg, g, device=dev) for _ in range(n_partitions)]
        params = {"tables": torch.stack([p["tables"] for p in parts]),
                  "mlp": [torch.stack(ws) for ws in
                          zip(*(p["mlp"] for p in parts))]}
        return cls(cfg, params, _meta_tuple(parts_meta))

    @property
    def device(self) -> torch.device:
        return self.params["tables"].device

    @property
    def stacked(self) -> bool:
        return self.params["tables"].ndim == 4

    @property
    def n_partitions(self) -> int:
        return int(self.params["tables"].shape[0]) if self.stacked else 1

    def partition(self, p: int) -> "DVNRModel":
        """Partition ``p`` as a single (unstacked) model."""
        if not self.stacked:
            if p != 0:
                raise IndexError("model is not partition-stacked")
            return self
        meta = (self.parts_meta[p],) if self.parts_meta is not None else None
        return DVNRModel(self.cfg, _tree_map(lambda t: t[p], self.params),
                         meta, self.grange)

    def stacked_params(self) -> dict:
        """Params with a leading partition axis (added if single)."""
        if self.stacked:
            return self.params
        return _tree_map(lambda t: t[None], self.params)

    def meta_arrays(self):
        """Partition metadata batched to ``(los, exts, vrs)`` tensors on the
        model's device, derived once per model instance."""
        cached = self.__dict__.get("_meta_arrays_cache")
        if cached is None:
            if self.parts_meta is None:
                raise ValueError("meta_arrays() needs model.parts_meta")
            from repro_torch.core.render import meta_arrays
            cached = meta_arrays(self.parts_meta, self.device)
            self.__dict__["_meta_arrays_cache"] = cached
        return cached

    @property
    def param_count(self) -> int:
        return self.n_partitions * param_count(self.cfg)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in [self.params["tables"], *self.params["mlp"]])

    def apply(self, coords, backend: BackendLike = "auto", *,
              compute_dtype=None):
        """coords (N,3) in [0,1]^3 -> (N, out_dim). Single-partition models
        only: use :meth:`partition` first on stacked models."""
        if self.stacked:
            raise ValueError("apply() on a stacked model: select a partition "
                             "first (model.partition(p).apply(coords))")
        return _inr_apply(self.cfg, self.params, coords,
                          backends.resolve(backend),
                          compute_dtype=compute_dtype)

    def decode_grid(self, shape: Sequence[int], backend: BackendLike = "auto",
                    chunk: int = 1 << 22, *, compute_dtype=None,
                    out_dtype=None):
        """Decode back to a cell-centred grid (compatibility path)."""
        if self.stacked:
            raise ValueError("decode_grid() on a stacked model: select a "
                             "partition first (model.partition(p))")
        return _decode_grid(self.cfg, self.params, shape,
                            backends.resolve(backend), chunk,
                            compute_dtype=compute_dtype, out_dtype=out_dtype)

    # ------------------------------ persistence ------------------------- #
    def save(self, path) -> None:
        """Serialize config + params + metadata to ``path`` in the JAX
        package's msgpack format (same keys, dtype tokens and bytes)."""
        import msgpack

        payload = {
            "kind": _SAVE_KIND,
            "cfg": dataclasses.asdict(self.cfg),
            "tables": _array_record(self.params["tables"]),
            "mlp": [_array_record(w) for w in self.params["mlp"]],
            "parts_meta": ([m.to_dict() for m in self.parts_meta]
                           if self.parts_meta is not None else None),
            "grange": list(self.grange) if self.grange is not None else None,
        }
        with open(path, "wb") as f:
            f.write(msgpack.packb(payload, use_bin_type=True))

    @classmethod
    def load(cls, path, *, device="auto") -> "DVNRModel":
        """Read a model saved by either package onto ``device``."""
        import msgpack

        dev = resolve_device(device)
        with open(path, "rb") as f:
            try:
                payload = msgpack.unpackb(f.read(), raw=False)
            except Exception as e:
                raise ValueError(f"{path}: not a saved DVNRModel ({e})") from e
        if not isinstance(payload, dict) or payload.get("kind") != _SAVE_KIND:
            raise ValueError(f"{path}: not a saved DVNRModel")
        cfg = DVNRConfig(**payload["cfg"])
        params = {"tables": _array_from_record(payload["tables"], dev),
                  "mlp": [_array_from_record(w, dev) for w in payload["mlp"]]}
        meta = (_meta_tuple(payload["parts_meta"])
                if payload["parts_meta"] is not None else None)
        grange = tuple(payload["grange"]) if payload["grange"] else None
        return cls(cfg, params, meta, grange)


# dtype tokens of the JAX package's format: numpy's ``dtype.str`` for
# standard types ('<f4'), the registered name for extension types
# ('bfloat16'), which numpy alone cannot parse — bf16 travels as raw uint16
_BF16 = "bfloat16"


def _array_record(t: torch.Tensor) -> dict:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        a, token = t.view(torch.int16).numpy(), _BF16
    else:
        a = t.numpy()
        token = a.dtype.str
    return {"dtype": token, "shape": list(t.shape), "data": a.tobytes()}


def _array_from_record(d: dict, device) -> torch.Tensor:
    if d["dtype"] == _BF16:
        a = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
        return torch.from_numpy(a.copy()).view(torch.bfloat16).to(device)
    a = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])
    return torch.from_numpy(a.copy()).to(device)


def render(model: DVNRModel, request: Optional[RenderRequest] = None, *,
           backend: BackendLike = "auto", cache=None):
    """Sort-last direct volume rendering of the DVNR, through INR inference
    (never decodes a grid). Returns the (H, W, 4) frame, f32 unless
    ``request.out_dtype`` says otherwise. ``cache`` (the brick cache) comes
    with a later slice."""
    from repro_torch.core.render import _render_distributed

    if cache is not None:
        raise NotImplementedError("render(cache=...) needs the BrickCache "
                                  "slice, which is not ported yet")
    if model.parts_meta is None:
        raise ValueError("render() needs model.parts_meta")
    r = RenderRequest() if request is None else request
    return _render_distributed(
        model.cfg, model.stacked_params(), None, r.camera, r.width, r.height,
        model.grange, n_samples=r.n_samples, impl=backends.resolve(backend),
        tf_table=r.tf.resolved_table(model.device), density=r.tf.density,
        compute_dtype=r.compute_dtype, out_dtype=r.out_dtype,
        metas=model.meta_arrays())


def save(model: DVNRModel, path) -> None:
    model.save(path)


def load(path, *, device="auto") -> DVNRModel:
    return DVNRModel.load(path, device=device)
