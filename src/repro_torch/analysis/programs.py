"""The standard analyzed programs of a DVNR config (the JAX package's
``repro.analysis.programs``): each a (program, context) pair.

- ``train_step``   one training step of the trainer;
- ``train_chunk``  a chunk of steps (the in situ hot path);
- ``train_chunk_degraded``  the chunk with a degraded-partition mask and
                   the last-good merge of :mod:`repro_torch.resilience`
                   (the resilience path adds no communication);
- ``render``       the sort-last render of the stacked partitions (ray
                   march plus depth compositing);
- ``render_cached``  the same frame from a :class:`BrickCache`'s pool;
- ``serving_tick``  one :class:`RenderService` tick of several clients.

Each runs once on a throwaway state at the config's declared shapes (the
trainer's ``volume_shape``; JAX's 8^3 placeholder when none is declared),
with made-up volume values: the checks read which operations run, not the
numbers. Render and serving contexts carry the config's policy with
``expect_master_state=False`` (inference keeps no optimizer state).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.checks import CheckContext, run_checks
from repro_torch.analysis.ir import ProgramArtifacts, capture


# --------------------------------------------------------------------------- #
# Named configs (the CLI's --config NAME)
# --------------------------------------------------------------------------- #
def _named_configs() -> dict:
    from repro_torch.configs.dvnr import (PRODUCTION, PRODUCTION256, SMOKE,
                                          DVNRConfig)

    # examples/quickstart_torch.py's setup: 2 partitions x 24^3 voxels
    quickstart = (DVNRConfig(n_levels=3, n_features_per_level=4,
                             log2_hashmap_size=9, base_resolution=8,
                             n_neurons=16, n_hidden_layers=2, epochs=10,
                             batch_size=4096, n_train_min=200,
                             boundary_lambda=0.15, boundary_sigma=0.005),
                  (24, 24, 24))
    return {"quickstart": quickstart,
            "smoke": (SMOKE, (10, 10, 10)),
            "production": (PRODUCTION, (64, 64, 64)),
            "production256": (PRODUCTION256, (256, 256, 256))}


def get_config(name: str):
    """``(DVNRConfig, local_shape)`` of a named analysis config."""
    configs = _named_configs()
    try:
        return configs[name]
    except KeyError:
        raise ValueError(f"unknown config {name!r}; available: "
                         f"{sorted(configs)}") from None


def available_configs() -> Tuple[str, ...]:
    return tuple(_named_configs())


# --------------------------------------------------------------------------- #
# Program construction
# --------------------------------------------------------------------------- #
def build_trainer(cfg, *, backend="auto", n_partitions: int = 2,
                  local_shape=(16, 16, 16), ghost: int = 1, device="auto"):
    """A trainer declared with its volume shape, as ``api.train`` builds it
    (``cfg.static_checks`` is not run here: the caller analyzes)."""
    from repro_torch.core.trainer import DVNRTrainer

    vshape = tuple(int(d) + 2 * ghost for d in local_shape)
    return DVNRTrainer(cfg.replace(static_checks="off"), n_partitions,
                       impl=backend, ghost=ghost, volume_shape=vshape,
                       device=device)


def _placeholder_volumes(trainer) -> torch.Tensor:
    """(P, *volume_shape) of values in [0, 1] on the trainer's device: a
    ramp, so that no step sees a constant field."""
    vshape = trainer.volume_shape or (8 + 2 * trainer.ghost,) * 3
    n = 1
    for d in vshape:
        n *= int(d)
    ramp = torch.arange(n, dtype=torch.float32, device=trainer.device) / max(n - 1, 1)
    vols = ramp.reshape(vshape).expand(trainer.P, *vshape).contiguous()
    if trainer.cfg.out_dim > 1:
        vols = vols[..., None].expand(*vols.shape, trainer.cfg.out_dim).contiguous()
    return vols


def train_context(trainer) -> CheckContext:
    return CheckContext(precision=trainer.precision,
                        fuse_sampling=trainer.fuse_sampling,
                        expect_kernels=trainer.backend.is_cuda
                        and trainer.fuse_train_step)


def train_chunk_program(trainer, *, n_steps: int = 2, volumes=None,
                        state=None, name=None) -> ProgramArtifacts:
    """The trainer's chunk of ``n_steps`` steps on a throwaway state (or
    ``state``, which the CUDA step advances in place) and ``volumes``."""
    vols = _placeholder_volumes(trainer) if volumes is None else volumes
    st = trainer.init(0) if state is None else state
    return capture(lambda s, v: trainer.train_chunk(s, v, n_steps, key=0),
                   st, vols, name=name or f"train_chunk[{trainer.backend.name}]",
                   watch={"volume": vols})


def trainer_programs(trainer, *, n_steps: int = 2
                     ) -> List[Tuple[ProgramArtifacts, CheckContext]]:
    """The (program, context) pairs of a built trainer: one step, a chunk,
    and the degraded chunk."""
    from repro_torch.core.sampling import step_seeds

    tag = trainer.backend.name
    ctx = train_context(trainer)
    vols = _placeholder_volumes(trainer)
    st = trainer.init(0)
    seeds = step_seeds(0, 0, trainer.P, partitions=trainer._global_rows()) \
        .to(trainer.device)

    def step(s, v, sd):
        return trainer._spmd_step(s.params, s.opt, v, sd, s.active, s.loss_ma,
                                  None)

    progs = [capture(step, st, vols, seeds, name=f"train_step[{tag}]",
                     watch={"volume": vols}),
             train_chunk_program(trainer, n_steps=n_steps, volumes=vols,
                                 state=trainer.init(0)),
             capture(degraded_chunk_fn(trainer, n_steps=n_steps),
                     *degraded_chunk_args(trainer, vols),
                     name=f"train_chunk_degraded[{tag}]",
                     watch={"volume": vols})]
    return [(p, ctx) for p in progs]


def degraded_chunk_fn(trainer, *, n_steps: int = 2):
    """The degraded-partition program of the resilience layer: masked
    partitions are held out of training by the convergence gate and merged
    back to their last-good snapshot after the chunk (the ``frozen`` merge
    of :func:`repro_torch.resilience.recovery.train_with_recovery`); only
    per-partition selects over the stacked axis."""
    from repro_torch.core.trainer import DVNRState
    from repro_torch.resilience.recovery import merge_partitions

    def fn(state, vols, mask, snap):
        masked = dataclasses.replace(state, active=state.active & mask)
        new, losses = trainer.train_chunk(masked, vols, n_steps, key=0)
        params = merge_partitions(~mask, snap.params, new.params)
        opt = merge_partitions(~mask, snap.opt, new.opt)
        return DVNRState(params, opt, new.loss_ma, new.active, new.step,
                         new.finite), losses

    return fn


def degraded_chunk_args(trainer, vols):
    """A throwaway state, the volumes, a (P,) healthy mask with the last
    partition degraded, and a snapshot of the state."""
    from repro_torch.resilience.recovery import snapshot_state

    st = trainer.init(0)
    mask = torch.ones(trainer.P, dtype=torch.bool, device=trainer.device)
    mask[-1] = False
    return st, vols, mask, snapshot_state(st)


def _render_ctx(cfg) -> CheckContext:
    from repro_torch.precision import resolve_precision

    return CheckContext(precision=resolve_precision(cfg.precision),
                        expect_master_state=False)


def _metas(n_partitions: int):
    return [{"origin": (0.0, 0.0, p / n_partitions),
             "extent": (1.0, 1.0, 1.0 / n_partitions),
             "vmin": 0.0, "vmax": 1.0} for p in range(n_partitions)]


def _model(cfg, n_partitions: int, device):
    from repro_torch.api import DVNRModel, PartitionMeta
    from repro_torch.core.trainer import init_params
    from repro_torch.optim.adamw import tree_map
    from repro_torch.precision import resolve_precision

    pdt = resolve_precision(cfg.precision).param_torch
    params = tree_map(lambda x: x.to(device=device, dtype=pdt),
                      init_params(cfg, 0, n_partitions))
    return DVNRModel(cfg, params, tuple(PartitionMeta(**m)
                                        for m in _metas(n_partitions)))


def render_program(cfg, *, backend="auto", n_partitions: int = 2,
                   width: int = 16, height: int = 16, n_samples: int = 8,
                   device="auto") -> Tuple[ProgramArtifacts, CheckContext]:
    """The sort-last render of the stacked partitions as an analyzed
    program, in the policy's compute dtype."""
    from repro_torch import backends
    from repro_torch.core.render import Camera, _render_distributed
    from repro_torch.precision import resolve_precision

    b = backends.resolve(backend)
    dev = backends.resolve_device(device)
    cdt = resolve_precision(cfg.precision).compute_dtype
    model = _model(cfg, n_partitions, dev)
    cam = Camera(eye=(1.8, 1.4, 1.6))

    def fn(params):
        return _render_distributed(cfg, params, _metas(n_partitions), cam,
                                   width, height, (0.0, 1.0),
                                   n_samples=n_samples, impl=b,
                                   compute_dtype=cdt)

    return capture(fn, model.params, name=f"render[{b.name}]"), _render_ctx(cfg)


def cached_render_program(cfg, *, backend="auto", n_partitions: int = 2,
                          width: int = 16, height: int = 16,
                          n_samples: int = 8, grid_shape=(16, 16, 16),
                          brick_edge: int = 8, device="auto"
                          ) -> Tuple[ProgramArtifacts, CheckContext]:
    """The frame through a :class:`BrickCache`: the cache is filled first,
    then the program samples its pool (no INR inference on the frame)."""
    from repro_torch import backends
    from repro_torch.core.render import (Camera, _render_distributed_sampled,
                                         meta_arrays)
    from repro_torch.precision import resolve_precision
    from repro_torch.serving.cache import BrickCache

    b = backends.resolve(backend)
    dev = backends.resolve_device(device)
    cdt = resolve_precision(cfg.precision).compute_dtype
    model = _model(cfg, n_partitions, dev)
    cache = BrickCache(cfg, grid_shape=grid_shape, brick_edge=brick_edge,
                       backend=b, device=dev)
    view = cache.ensure(model)
    metas = meta_arrays(_metas(n_partitions), dev)
    cam = Camera(eye=(1.8, 1.4, 1.6))

    def fn(pool, slots):
        return _render_distributed_sampled(
            pool, slots, view.grid_shape, view.brick_edge, metas, cam, width,
            height, (0.0, 1.0), n_samples=n_samples, impl=b, compute_dtype=cdt)

    return (capture(fn, view.pool, view.slots, name=f"render_cached[{b.name}]"),
            _render_ctx(cfg))


def serving_tick_program(cfg, *, backend="auto", n_partitions: int = 2,
                         n_clients: int = 3, width: int = 16, height: int = 16,
                         n_samples: int = 8, grid_shape=(16, 16, 16),
                         brick_edge: int = 8, device="auto"
                         ) -> Tuple[ProgramArtifacts, CheckContext]:
    """One :class:`RenderService` tick of ``n_clients`` orbiting cameras
    over one brick cache (its fills and the batched frame program)."""
    from repro_torch import backends
    from repro_torch.api import RenderRequest
    from repro_torch.core.render import Camera
    from repro_torch.precision import resolve_precision
    from repro_torch.serving.service import RenderService

    b = backends.resolve(backend)
    dev = backends.resolve_device(device)
    cdt = resolve_precision(cfg.precision).compute_dtype
    model = _model(cfg, n_partitions, dev)
    svc = RenderService(model, backend=b,
                        cache_kw={"grid_shape": grid_shape,
                                  "brick_edge": brick_edge})
    cam = Camera(eye=(1.8, 1.4, 1.6))

    def fn(service):
        for c in range(n_clients):
            service.submit(RenderRequest(
                camera=cam.orbit(0.3 * c), width=width, height=height,
                n_samples=n_samples,
                compute_dtype=None if cdt == "float32" else cdt))
        return [r.frame for r in service.tick()]

    return capture(fn, svc, name=f"serving_tick[{b.name}]"), _render_ctx(cfg)


def config_programs(cfg, local_shape, *, backend="auto", n_partitions: int = 2,
                    ghost: int = 1, n_steps: int = 2, device="auto") -> List[Tuple[ProgramArtifacts, CheckContext]]:
    """Every standard program of one config: the step, the chunk (healthy
    and degraded), the render (INR and brick-cached) and a serving tick."""
    trainer = build_trainer(cfg, backend=backend, n_partitions=n_partitions,
                            local_shape=local_shape, ghost=ghost, device=device)
    kw = dict(backend=trainer.backend, n_partitions=n_partitions,
              device=trainer.device)
    return trainer_programs(trainer, n_steps=n_steps) + [
        render_program(cfg, **kw), cached_render_program(cfg, **kw),
        serving_tick_program(cfg, **kw)]


def analyze_config(name_or_cfg, *, backend="auto", local_shape=None,
                   n_partitions: int = 2, checks: Optional[List[str]] = None,
                   max_level: Optional[str] = None, device="auto") -> List:
    """Run the registered checks over every standard program of a config:
    a named config or a ``DVNRConfig`` (with ``local_shape``). Returns one
    :class:`Report` per program."""
    if isinstance(name_or_cfg, str):
        cfg, shape = get_config(name_or_cfg)
        if local_shape is not None:
            shape = tuple(local_shape)
    else:
        cfg, shape = name_or_cfg, tuple(local_shape or (16, 16, 16))
    pairs = config_programs(cfg, shape, backend=backend,
                            n_partitions=n_partitions, device=device)
    return [run_checks(p, ctx, checks=checks, max_level=max_level)
            for p, ctx in pairs]
