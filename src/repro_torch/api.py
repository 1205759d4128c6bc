"""repro_torch.api — the DVNR facade.

The port of ``repro.api``: :func:`train` (one INR per partition, no
communication; ``recovery=`` runs the non-finite retry ladder),
:class:`DVNRModel` (config + single or partition-stacked params + partition
metadata) with ``init`` / ``from_state`` / ``from_compressed`` /
``partition`` / ``stacked_params`` / ``meta_arrays`` / ``apply`` /
``decode_grid`` / ``compress`` / ``save`` / ``load``, the frozen request
objects, :func:`render` (through INR inference, or from a
:class:`repro_torch.serving.BrickCache` with ``cache=``),
:func:`isosurface` (marching tetrahedra on INR inference),
:func:`trace_pathlines` (backward pathlines over a window of velocity
models) and :func:`compress` / :func:`decompress` (the JAX package's
blobs, byte for byte).

Models saved by either package load in the other: :meth:`DVNRModel.save`
writes the JAX package's msgpack format byte for byte (``msgpack`` is
imported only by ``save`` / ``load``).

Everything runs on the GPU unless the caller asks for the CPU:
``device="auto"`` and ``backend="auto"`` raise when there is no CUDA device.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import backends
from repro_torch.backends import BackendLike, resolve_device
from repro_torch.compress.model_compress import (compress_stacked,
                                                 decompress_model)
from repro_torch.compress.registry import (available_codecs, get_codec,
                                           register_codec)
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import (_decode_grid, _inr_apply, init_inr,
                                  param_bytes_f16, param_count)
from repro_torch.core.render import Camera
from repro_torch.core.sampling import as_key, split
from repro_torch.core.trainer import DVNRState, DVNRTrainer, train_iterations
from repro_torch.precision import Precision, resolve_precision

__all__ = [
    "DVNRModel", "PartitionMeta", "Camera", "TransferFunction",
    "RenderRequest", "train", "render", "isosurface", "trace_pathlines",
    "compress", "decompress", "save", "load", "get_codec", "register_codec", "available_codecs", "DVNRConfig",
    "DVNRTrainer", "Precision", "resolve_precision",
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
    resolution, and the reduced inference / output dtypes. ``timestep``
    selects a model of the render service's temporal cache, ``lod`` the
    brick cache's level of detail (level ``l`` decodes at
    ``ceil(shape / 2**l)``; cache path only); ``iso`` is the value
    :func:`isosurface` takes from a request. All of them group requests in the service."""

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

    @classmethod
    def from_state(cls, cfg: DVNRConfig, state: DVNRState,
                   parts_meta=None) -> "DVNRModel":
        """Wrap a trainer state's stacked params."""
        return cls(cfg, state.params, _meta_tuple(parts_meta))

    @classmethod
    def from_compressed(cls, cfg: DVNRConfig, blobs, parts_meta=None,
                        grange=None, *, device="auto") -> "DVNRModel":
        """Rebuild a model from :meth:`compress` output (list of blobs, one
        per partition; a single ``bytes`` blob is accepted too), either
        package's, onto ``device``."""
        if isinstance(blobs, (bytes, bytearray)):
            blobs = [bytes(blobs)]
        dev = resolve_device(device)
        parts = [decompress_model(cfg, b, device=dev) for b in blobs]
        if len(parts) == 1:
            params = parts[0]
        else:
            params = {"tables": torch.stack([p["tables"] for p in parts]),
                      "mlp": [torch.stack(ws) for ws in
                              zip(*(p["mlp"] for p in parts))]}
        return cls(cfg, params, _meta_tuple(parts_meta), grange)

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

    # ------------------------------ compression ------------------------- #
    def compress(self, r_enc: Optional[float] = None,
                 r_mlp: Optional[float] = None, **codec_kw) -> list:
        """Error-bounded weight compression (paper III-D) of every partition.
        Returns one blob per partition. Codec selection by name via
        ``dense_codec=`` / ``hash_codec=`` / ``mlp_codec=``."""
        blobs, _ = compress(self, r_enc=r_enc, r_mlp=r_mlp, **codec_kw)
        return blobs

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


def train(partitions, cfg: DVNRConfig, *, backend: BackendLike = "auto",
          mesh=None, steps: Optional[int] = None, key=None,
          cached_params=None, trainer: Optional[DVNRTrainer] = None,
          ghost: Optional[int] = None, volumes=None,
          log_every: int = 0, check_every: int = 0,
          precision=None,
          fuse_train_step: Optional[str] = None,
          fuse_sampling: Optional[str] = None,
          sampling_brick=None,
          recovery=None, train_mask=None) -> Tuple[DVNRModel, dict]:
    """Train one INR per partition (no communication) and return the model.

    ``partitions``: :class:`~repro_torch.data.volume.VolumePartition`
    objects (anything with ``normalized()``, ``owned_shape``, ``origin``,
    ``extent``, ``vmin``, ``vmax``, ``ghost``); training runs on the device
    their data lies on (``make_partition(device=...)``). ``steps`` defaults
    to the paper's III-B iteration count. ``key`` is an int seed or a (2,)
    pair of uint32 words (JAX's ``PRNGKey`` layout; default 0): it is split
    into the init and training keys as the JAX package splits it, so both
    packages draw the same init and the same batches. ``backend="auto"``
    trains through the CUDA kernels and raises without a card; ``"ref"``
    runs the plain PyTorch versions on any device.

    The rest is the JAX signature: a pre-built ``trainer`` to reuse,
    ``volumes`` (stacked (P, ...) normalized data) to train on instead of
    the partitions' own, ``log_every`` / ``check_every`` (see
    :meth:`DVNRTrainer.train`), and overrides of ``cfg.precision``,
    ``cfg.fuse_train_step``, ``cfg.fuse_sampling`` and
    ``cfg.sampling_brick``. ``train_mask`` ((P,) bool) keeps partitions out
    of training from step 0. ``recovery`` (a
    :class:`repro_torch.resilience.RecoveryPolicy`) routes training through
    the non-finite recovery loop: partitions tripping the detector are
    retried (reseed -> moment reset -> lr backoff) and frozen at their
    last-good params when the ladder is exhausted; ``info`` then carries a
    ``"recovery"`` entry.

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`; every rank calls
    ``train`` with it) trains across ranks with no communication: a rank
    passes only its OWN partitions, the global partitions
    ``mesh.index * k ... mesh.index * k + k - 1`` (k = ``len(partitions)``,
    the same on every rank), and never another rank's volume (the in situ
    premise). Its init and batches are those partitions' rows of a
    single-process run of all ``k * mesh.size``; it returns a
    :class:`DVNRModel` of its partitions.
    """
    k_init, k_train = split(as_key(0 if key is None else key))
    P = len(partitions) * (1 if mesh is None else mesh.size)
    g = partitions[0].ghost if ghost is None else ghost
    if fuse_train_step is not None:
        cfg = cfg.replace(fuse_train_step=fuse_train_step)
        if trainer is not None and \
                trainer.fuse_train_step != trainer._resolve_fuse(fuse_train_step):
            raise ValueError(
                f"fuse_train_step={fuse_train_step!r} conflicts with the "
                f"pre-built trainer's {trainer.cfg.fuse_train_step!r}")
    if fuse_sampling is not None:
        cfg = cfg.replace(fuse_sampling=fuse_sampling)
        if trainer is not None and \
                trainer.fuse_sampling != trainer._resolve_fuse_sampling(fuse_sampling):
            raise ValueError(
                f"fuse_sampling={fuse_sampling!r} conflicts with the "
                f"pre-built trainer's {trainer.cfg.fuse_sampling!r}")
    if sampling_brick is not None:
        cfg = cfg.replace(sampling_brick=sampling_brick)
        if trainer is not None and trainer.cfg.sampling_brick != sampling_brick:
            raise ValueError(
                f"sampling_brick={sampling_brick!r} conflicts with the "
                f"pre-built trainer's {trainer.cfg.sampling_brick!r}")
    if precision is not None:
        cfg = cfg.replace(precision=resolve_precision(precision).name)
        if trainer is not None and trainer.precision != resolve_precision(precision):
            raise ValueError(
                f"precision={precision!r} conflicts with the pre-built "
                f"trainer's policy {trainer.cfg.precision!r}")
    vols = torch.stack([p.normalized() for p in partitions]) \
        if volumes is None else volumes
    if trainer is None:
        # the declared volume shape sizes cfg.static_checks' program
        trainer = DVNRTrainer(cfg, P, mesh=mesh, impl=backend, ghost=g,
                              device=vols.device,
                              volume_shape=tuple(vols.shape[1:]))
    state = trainer.init(k_init, cached_params=cached_params)
    if train_mask is not None:
        mask = torch.as_tensor(np.asarray(train_mask, bool),
                               device=state.active.device)
        state = dataclasses.replace(state, active=state.active & mask)
    nvox = int(np.prod(partitions[0].owned_shape))
    n_steps = train_iterations(cfg, nvox) if steps is None else steps
    if vols.device.type == "cuda":
        torch.cuda.synchronize(vols.device)
    t0 = time.perf_counter()
    state, hist = trainer.train(state, vols, steps=n_steps, key=k_train,
                                log_every=log_every, check_every=check_every,
                                recovery=recovery)
    if vols.device.type == "cuda":
        torch.cuda.synchronize(vols.device)
    train_time_s = time.perf_counter() - t0
    model = DVNRModel(cfg, state.params, _meta_tuple(partitions))
    info = {"train_time_s": train_time_s, "steps": int(state.step),
            "loss_history": hist.get("loss", []), "state": state,
            "trainer": trainer, "partitions": trainer.partitions}
    if "recovery" in hist:
        info["recovery"] = hist["recovery"]
    return model, info


_LEGACY_RENDER_KW = ("camera", "eye", "center", "up", "fov_deg", "width",
                     "height", "n_samples", "tf_table", "density",
                     "compute_dtype", "out_dtype")


def _request_from_legacy(kw: dict) -> RenderRequest:
    """The keyword form of ``render`` from before :class:`RenderRequest`:
    warns (``DeprecationWarning``, the JAX package's text) and builds the
    request it stands for."""
    import warnings

    bad = set(kw) - set(_LEGACY_RENDER_KW)
    if bad:
        raise TypeError(f"render() got unexpected keyword arguments "
                        f"{sorted(bad)}")
    warnings.warn(
        "api.render(eye=..., width=..., ...) kwargs are deprecated; pass a "
        "request: api.render(model, RenderRequest(camera=Camera(eye=...), "
        "width=...))", DeprecationWarning, stacklevel=3)
    cam = kw.pop("camera", None)
    if cam is None:
        d = Camera()
        cam = Camera(eye=tuple(kw.pop("eye", d.eye)),
                     center=tuple(kw.pop("center", d.center)),
                     up=tuple(kw.pop("up", d.up)),
                     fov_deg=float(kw.pop("fov_deg", d.fov_deg)))
    else:
        for k in ("eye", "center", "up", "fov_deg"):
            kw.pop(k, None)
    tf = TransferFunction(table=kw.pop("tf_table", None),
                          density=float(kw.pop("density", 50.0)))
    return RenderRequest(camera=cam, tf=tf, **kw)


def render(model: DVNRModel, request: Optional[RenderRequest] = None, *,
           backend: BackendLike = "auto", mesh=None, cache=None, **legacy):
    """Sort-last direct volume rendering of the DVNR (never decodes a grid).
    Returns the (H, W, 4) frame, f32 unless ``request.out_dtype`` says
    otherwise. ``cache`` (a :class:`repro_torch.serving.BrickCache`) swaps
    per-frame INR inference for trilinear sampling of its decoded brick pool
    (``request.lod`` / ``request.timestep`` select the cached level);
    without it every frame runs INR inference. ``mesh`` is accepted and, as
    in the JAX package (whose ``_render_distributed`` does not use it),
    changes nothing: the model's partitions are rendered and composited in
    this process. Across ranks, each holding its own partition, use
    :func:`repro_torch.core.render.make_distributed_render_step`.

    The old keyword form ``render(model, eye=..., width=...)`` renders the
    same frame and warns (``DeprecationWarning``)."""
    from repro_torch.core.render import (_render_distributed,
                                         _render_distributed_sampled)

    if model.parts_meta is None:
        raise ValueError("render() needs model.parts_meta")
    if legacy:
        if request is not None:
            raise TypeError("render() takes a RenderRequest OR legacy "
                            "kwargs, not both")
        request = _request_from_legacy(dict(legacy))
    r = RenderRequest() if request is None else request
    b = backends.resolve(backend)
    tf_table = r.tf.resolved_table(model.device)
    if cache is not None:
        view = cache.ensure(model, level=r.lod, timestep=r.timestep)
        return _render_distributed_sampled(
            view.pool, view.slots, view.grid_shape, view.brick_edge,
            model.meta_arrays(), r.camera, r.width, r.height, model.grange,
            n_samples=r.n_samples, impl=b, tf_table=tf_table,
            density=r.tf.density, compute_dtype=r.compute_dtype,
            out_dtype=r.out_dtype)
    return _render_distributed(
        model.cfg, model.stacked_params(), None, r.camera, r.width, r.height,
        model.grange, n_samples=r.n_samples, impl=b, tf_table=tf_table,
        density=r.tf.density, compute_dtype=r.compute_dtype,
        out_dtype=r.out_dtype, metas=model.meta_arrays())


def isosurface(model: DVNRModel, iso01=0.5, *, resolution: int = 32,
               backend: BackendLike = "auto") -> np.ndarray:
    """Per-partition marching tets on the INR; returns world-space points
    (a host-side (N, 3) float32 array). ``iso01`` is in GLOBAL normalized
    units: a float or a :class:`RenderRequest` whose ``iso`` field carries
    the value. The vertex grid is sampled through INR inference on the
    model's device (the inference kernel on the ``cuda`` backend)."""
    from repro_torch.core.isosurface import isosurface_from_inr, surface_points

    if isinstance(iso01, RenderRequest):
        if iso01.iso is None:
            raise ValueError("isosurface() from a RenderRequest needs "
                             "request.iso set")
        iso01 = float(iso01.iso)
    if model.parts_meta is None:
        raise ValueError("isosurface() needs model.parts_meta")
    b = backends.resolve(backend)
    gmin, gmax = model.grange
    clouds = []
    for p in range(model.n_partitions):
        meta = model.parts_meta[p]
        iso_raw = gmin + iso01 * (gmax - gmin)
        denom = max(meta.vmax - meta.vmin, 1e-12)
        iso_local = (iso_raw - meta.vmin) / denom
        if not (0.0 <= iso_local <= 1.0):
            continue                   # the isosurface misses this partition
        part = model.partition(p)
        tris, valid = isosurface_from_inr(
            model.cfg, part.params, float(iso_local),
            shape=(resolution,) * 3, origin=meta.origin,
            extent=meta.extent, impl=b)
        pts = surface_points(tris, valid)
        if len(pts):
            clouds.append(pts)
    if not clouds:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(clouds, axis=0)


def trace_pathlines(models: Sequence[DVNRModel], seeds, dt: float, *,
                    substeps: int = 4, backend: BackendLike = "auto"):
    """Backward pathline tracing over a temporal window of velocity DVNRs
    (newest -> oldest). Returns the (T*substeps+1, N, 3) trajectory on the
    models' device."""
    from repro_torch.core.pathlines import trace_backward

    if not models:
        raise ValueError("empty model window")
    if any(m.parts_meta is None for m in models):
        raise ValueError("trace_pathlines() needs parts_meta on every model "
                         "in the window (train via repro_torch.api.train or "
                         "attach PartitionMeta)")
    cfg = models[0].cfg
    window = [m.stacked_params() for m in models]
    metas = [list(m.parts_meta) for m in models]
    return trace_backward(cfg, window, metas, seeds, dt, substeps=substeps,
                          impl=backends.resolve(backend))


def compress(model: DVNRModel, *, r_enc: Optional[float] = None,
             r_mlp: Optional[float] = None, **codec_kw) -> Tuple[list, dict]:
    """Compress every partition; returns (blobs, info) where info aggregates
    byte counts and the model compression ratio vs fp16 storage."""
    pairs = compress_stacked(model.cfg, model.stacked_params(),
                             r_enc=r_enc, r_mlp=r_mlp, **codec_kw)
    blobs = [b for b, _ in pairs]
    total = sum(len(b) for b in blobs)
    f16 = model.n_partitions * param_bytes_f16(model.cfg)
    info = {"bytes": total, "f16_bytes": f16,
            "model_cr": f16 / max(total, 1),
            "per_partition": [i for _, i in pairs]}
    return blobs, info


def decompress(cfg: DVNRConfig, blobs, *, parts_meta=None, grange=None,
               device="auto") -> DVNRModel:
    """Inverse of :func:`compress`, onto ``device``."""
    return DVNRModel.from_compressed(cfg, blobs, parts_meta, grange,
                                     device=device)


def save(model: DVNRModel, path) -> None:
    model.save(path)


def load(path, *, device="auto") -> DVNRModel:
    return DVNRModel.load(path, device=device)
