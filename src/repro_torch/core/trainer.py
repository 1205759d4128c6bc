"""DVNR training (paper §III): the port of ``repro.core.trainer``.

- ``adaptive_config`` / ``train_iterations``: the §III-B scaling rules;
- :class:`DVNRTrainer` trains P partition models as one stacked tree with
  no communication between partitions; per-partition early stopping is
  convergence MASKING (a converged partition's update is gated to 0);
- a chunk (:meth:`DVNRTrainer.train_chunk`) is ``n_steps`` steps launched
  back to back with no host synchronisation: the (n_steps, P, 2) seed table
  and the (n_steps, P, 4) schedule table are built once per chunk, the loss
  trace stays on the device, and convergence is checked on the host only
  between chunks (``check_every``);
- the step (``cfg.fuse_train_step`` / ``cfg.fuse_sampling``, both
  ``"auto"`` by default) is the fused op with the sampling inside
  (:func:`repro_torch.kernels.fused_train_step.fused_train_step_sampling`:
  on the ``cuda`` backend two kernel launches per step, the train step and
  AdamW), the fused op with a host-sampled batch, or the unfused step
  (``"off"``: autograd through the encode and MLP ops, then AdamW — on the
  ``cuda`` backend through the hash-encode and MLP forward and backward
  kernels). All three draw the same batches: the sampler is counter-based
  (:mod:`repro_torch.core.sampling`), seeded ``step_seeds(key, step, p)``.
- the random init and every batch are the JAX package's for the same key
  (:func:`init_params`), so both packages train the same trajectory.

On the ``cuda`` backend the fused step updates params and moments in place:
a state passed to :meth:`DVNRTrainer.train_chunk` is advanced, not kept.
``train(recovery=...)`` runs the non-finite retry ladder
(:func:`repro_torch.resilience.recovery.train_with_recovery`).

On a mesh (:class:`repro_torch.launch.mesh.Mesh`, ``DVNRTrainer(mesh=)``)
each rank holds the slice of the stacked (P, ...) state of its own global
partitions, ``P / mesh.size`` of them (``partitions``: the JAX trainer's
``shard_map`` over the partition axis, with a rank in place of a device).
Its init is that slice of the single-process init, and its batches are
drawn with the global partition indices, so a partition's draws do not
depend on the world size. The step, the chunk and its non-finite flags
stay per rank and issue no collective (the paper's zero communication:
:func:`repro_torch.parallel.collectives.count_collectives` reads 0 over a
chunk); so does early stopping (``cfg.target_loss > 0``): a rank stops when
its own partitions have converged, where the JAX trainer waits for all of
them. Under ``torch.use_deterministic_algorithms(True)`` the CUDA step
takes its deterministic route, and a rank's partitions train to the same
bits as in one stacked run; a chunk then ends with one host read of the
route's fixed-point overflow flags (raising
:class:`~repro_torch.kernels.fused_train_step.ops.FixedPointOverflowError`).
Not ported yet (raises ``NotImplementedError``): static checks (ROADMAP
item 15).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch.backends import resolve_device
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import _inr_apply_batched
from repro_torch.core.metrics import psnr_from_mses
from repro_torch.core.sampling import random_uniform, split, step_seeds
from repro_torch.kernels.fused_train_step import ops as fts
from repro_torch.kernels.fused_train_step.ref import sample_batch, train_step_ref
from repro_torch.optim.adamw import AdamW, OptConfig, tree_leaves, tree_map
from repro_torch.precision import Precision, resolve_precision, torch_dtype


# --------------------------------------------------------------------------- #
# III-B: adaptive parameters
# --------------------------------------------------------------------------- #
def train_iterations(cfg: DVNRConfig, nvox: int) -> int:
    """N_train^max = max(N_train^min, ceil(Nvox/Nbatch) * Nepoch)."""
    return max(cfg.n_train_min, math.ceil(nvox / cfg.batch_size) * cfg.epochs)


def adaptive_config(cfg: DVNRConfig, nvox_local: int, nvox_global: int) -> DVNRConfig:
    """T = max(Tmin, Tref * ceil(Nvox/Nvox_global)); R0 = floor(Rref * cbrt(T/Tref))."""
    t_ref = cfg.table_size
    frac = nvox_local / max(nvox_global, 1)
    t = max(1 << cfg.t_min_log2, int(2 ** round(math.log2(max(t_ref * frac, 1)))))
    r_ref = cfg.resolved_base_resolution
    r0 = max(2, int(r_ref * (t / t_ref) ** (1.0 / 3.0)))
    return cfg.replace(log2_hashmap_size=int(round(math.log2(t))), base_resolution=r0)


def _opt_config(cfg: DVNRConfig, prec: Precision) -> OptConfig:
    return OptConfig(
        lr=cfg.lrate,
        beta1=cfg.adam_beta1, beta2=cfg.adam_beta2, eps=cfg.adam_eps,
        weight_decay=cfg.weight_decay,
        schedule="exp" if cfg.lrate_decay > 0 else "constant",
        decay_rate=0.33, decay_steps=max(cfg.lrate_decay, 1),
        clip_norm=0.0,
        master_dtype=prec.master_dtype if prec.needs_master else "",
    )


def init_params(cfg: DVNRConfig, key, n_partitions: int,
                partitions=None) -> dict:
    """The JAX package's ``vmap(init_inr)(jax.random.split(key, P))``, bit
    for bit, as CPU float32 tensors: tables U(-1e-4, 1e-4) (instant-ngp),
    MLP He-uniform, each drawn with :func:`random_uniform`. ``partitions``
    (global indices) draws only those rows of the P."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    W, H = cfg.n_neurons, cfg.n_hidden_layers
    dims = [L * F] + [W] * H + [cfg.out_dim]
    tables, mlps = [], []
    keys = split(key, n_partitions)
    if partitions is not None:
        keys = keys[torch.as_tensor(partitions, dtype=torch.int64)]
    for k in keys:
        k_t, k_m = split(k)
        tables.append(random_uniform(k_t, (L, T, F), -1e-4, 1e-4))
        ks = split(k_m, len(dims) - 1)
        mlps.append([random_uniform(ks[i], (din, dout),
                                    -float(np.sqrt(6.0 / din)),
                                    float(np.sqrt(6.0 / din)))
                     for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:]))])
    return {"tables": torch.stack(tables),
            "mlp": [torch.stack(ws) for ws in zip(*mlps)]}


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #
@dataclass
class DVNRState:
    params: dict           # stacked (P, ...) INR params
    opt: dict              # stacked AdamW state: step (P,), m, v[, mw]
    loss_ma: torch.Tensor  # (P,) moving-average loss
    active: torch.Tensor   # (P,) bool convergence mask
    step: int = 0
    # (P,) bool non-finite detector of the last chunk (None before any chunk
    # ran): False means the partition saw a NaN/Inf loss while active, or
    # holds NaN/Inf params
    finite: Optional[torch.Tensor] = None


class DVNRTrainer:
    def __init__(self, cfg: DVNRConfig, n_partitions: int, *, mesh=None,
                 impl: backends.BackendLike = "auto", ghost: int = 1,
                 device="auto"):
        """``impl``: the kernel backend (``"auto"``: the CUDA kernels, and a
        ``RuntimeError`` without a card); ``device``: where the state lives
        (``"auto"``: the current CUDA device, or the mesh's device for this
        rank). ``n_partitions`` is the global count; on a ``mesh`` this rank
        trains ``n_partitions / mesh.size`` of them (``partitions``, its
        global indices) and ``P`` is that local count. The JAX trainer's
        ``volume_shape`` has no counterpart: it sizes a TPU VMEM budget,
        and the CUDA kernels read the volume from device memory."""
        self.mesh = mesh
        self.n_partitions = int(n_partitions)
        if mesh is not None:
            if not all(hasattr(mesh, a) for a in ("size", "index", "device")):
                raise TypeError("mesh must be a repro_torch.launch.mesh.Mesh, "
                                f"got {type(mesh).__name__}")
            if n_partitions % mesh.size:
                raise ValueError(f"{n_partitions} partitions do not split over "
                                 f"a mesh of {mesh.size} ranks")
            k = n_partitions // mesh.size
            self.partitions = tuple(range(mesh.index * k, (mesh.index + 1) * k))
            if device == "auto":
                device = mesh.device
        else:
            self.partitions = tuple(range(self.n_partitions))
        if cfg.static_checks not in ("off", "warn", "error"):
            raise ValueError(f"static_checks must be 'off', 'warn' or "
                             f"'error', got {cfg.static_checks!r}")
        if cfg.static_checks != "off":
            raise NotImplementedError(
                f"static_checks={cfg.static_checks!r}: the static checks of "
                "the trainer's program are not ported yet (ROADMAP §A item 15)")
        self.cfg = cfg
        self.P = len(self.partitions)
        self.backend = backends.resolve(impl)
        self.device = resolve_device(device)
        self.ghost = ghost
        self.precision = resolve_precision(cfg.precision)
        self.backend.require_dtype(self.precision.param_dtype, "param")
        self.backend.require_dtype(self.precision.compute_dtype, "compute")
        # None = the full-f32 policy: no casts at all
        self._compute_dtype = (None if self.precision == resolve_precision("f32")
                               else self.precision.compute_dtype)
        self.adam = AdamW(_opt_config(cfg, self.precision))
        self.fuse_train_step = self._resolve_fuse(cfg.fuse_train_step)
        self.fuse_sampling = self._resolve_fuse_sampling(cfg.fuse_sampling)
        fts.validate_sampling_brick(cfg.sampling_brick)
        self._spmd_step = self._build_spmd_step()

    def _resolve_fuse(self, mode: str) -> bool:
        """``cfg.fuse_train_step`` ("auto"/"on"/"off") -> use the fused step?"""
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"fuse_train_step must be 'auto', 'on' or 'off', "
                             f"got {mode!r}")
        advertised = self.backend.supports("fused_train_step")
        if mode == "on" and not advertised:
            raise ValueError(f"fuse_train_step='on' but backend "
                             f"{self.backend.name!r} does not implement it")
        return mode != "off" and advertised

    def _resolve_fuse_sampling(self, mode: str) -> bool:
        """``cfg.fuse_sampling`` -> sample inside the fused op? Requires the
        fused step itself ("auto" degrades, "on" raises)."""
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"fuse_sampling must be 'auto', 'on' or 'off', "
                             f"got {mode!r}")
        advertised = self.backend.supports("fused_sampling")
        if mode == "on":
            if not advertised:
                raise ValueError(f"fuse_sampling='on' but backend "
                                 f"{self.backend.name!r} does not implement it")
            if not self.fuse_train_step:
                raise ValueError("fuse_sampling='on' requires the fused train "
                                 "step (fuse_train_step resolved off)")
            return True
        return mode == "auto" and advertised and self.fuse_train_step

    @staticmethod
    def master_params(state: "DVNRState"):
        """The f32 AdamW master when the policy keeps one, else the working
        params: what a warm-start cache (§III-E) should store."""
        if isinstance(state.opt, dict) and "mw" in state.opt:
            return state.opt["mw"]
        return state.params

    # -------------------------- init ---------------------------------- #
    def init(self, key, cached_params: Optional[dict] = None) -> DVNRState:
        """Random init (the JAX package's draws for the same ``key``: an
        int seed or a (2,) pair of uint32 words), or a warm start from
        ``cached_params`` (§III-E), copied, so that the in-place CUDA step
        never writes into the caller's cache."""
        pdt = self.precision.param_torch
        dev = self.device
        if cached_params is not None:
            params = tree_map(lambda x: torch.as_tensor(x).to(
                device=dev, dtype=pdt, copy=True), cached_params)
        else:
            params = tree_map(lambda x: x.to(device=dev, dtype=pdt),
                              init_params(self.cfg, key, self.n_partitions,
                                          self._global_rows()))
        opt = self.adam.init(params, self.P)
        if cached_params is not None and "mw" in opt:
            # seed the f32 master from the cache itself, not from the bf16
            # working copy: a warm start must not add a tick of rounding
            wdt = opt["mw"]["tables"].dtype
            opt["mw"] = tree_map(lambda x: torch.as_tensor(x).to(
                device=dev, dtype=wdt, copy=True), cached_params)
        return DVNRState(params, opt,
                         torch.full((self.P,), float("inf"), device=dev),
                         torch.ones((self.P,), dtype=torch.bool, device=dev), 0)

    def _global_rows(self):
        """The global indices of this rank's partitions, or None when it
        holds all of them."""
        return None if self.mesh is None else self.partitions

    def _det_route(self, device) -> bool:
        """Does a fused step on ``device`` take the CUDA step's
        deterministic route (and its overflow flags)?"""
        return (self.fuse_train_step and self.backend.is_cuda and
                torch.device(device).type == "cuda" and fts.deterministic())

    # -------------------------- one step ------------------------------- #
    def _mask_convergence(self, loss, loss_ma, active):
        loss_ma = torch.where(torch.isinf(loss_ma), loss,
                              0.95 * loss_ma + 0.05 * loss)
        if self.cfg.target_loss > 0:
            active = active & (loss_ma > self.cfg.target_loss)
        return loss_ma, active

    def _build_spmd_step(self, adam: Optional[AdamW] = None):
        """The per-step body ``(params, opt, vols, seeds, active, loss_ma,
        scalars) -> (params, opt, loss, loss_ma, active)``. ``seeds`` is the
        (P, 2) counter-seed table of the step; ``scalars`` the (P, 4)
        schedule rows of the fused op (``None``: derived from the state).
        ``adam`` replaces the trainer's optimizer (the lr-backoff rung)."""
        cfg, ghost, backend = self.cfg, self.ghost, self.backend
        adam = self.adam if adam is None else adam
        compute_dtype = self._compute_dtype
        resolutions = cfg.level_resolutions()
        draw = dict(n_batch=cfg.batch_size, boundary_lambda=cfg.boundary_lambda,
                    sigma=cfg.boundary_sigma, ghost=ghost)

        if self.fuse_train_step and self.fuse_sampling:
            def base_step(params, opt, vols, seeds, active, loss_ma, scalars,
                          overflow=None):
                vols_c = vols if vols.ndim == 5 else vols[..., None]
                params, opt, loss = fts.fused_train_step_sampling(
                    params, opt, vols_c, seeds, active.float(),
                    resolutions=resolutions, opt_cfg=adam.cfg, impl=backend,
                    compute_dtype=compute_dtype,
                    sampling_brick=cfg.sampling_brick, scalars=scalars,
                    overflow=overflow, **draw)
                return (params, opt, loss,
                        *self._mask_convergence(loss, loss_ma, active))
        elif self.fuse_train_step:
            def base_step(params, opt, vols, seeds, active, loss_ma, scalars,
                          overflow=None):
                coords, target = sample_batch(vols, seeds, **draw)
                params, opt, loss = fts.fused_train_step(
                    params, opt, coords, target, active.float(),
                    resolutions=resolutions, opt_cfg=adam.cfg, impl=backend,
                    compute_dtype=compute_dtype, scalars=scalars,
                    overflow=overflow)
                return (params, opt, loss,
                        *self._mask_convergence(loss, loss_ma, active))
        else:
            # the unfused step (the fused path's parity baseline): autograd
            # through the backend's encode and MLP ops, then AdamW
            def base_step(params, opt, vols, seeds, active, loss_ma, scalars,
                          overflow=None):
                coords, target = sample_batch(vols, seeds, **draw)
                params, opt, loss = train_step_ref(
                    params, opt, coords, target, active.float(), resolutions,
                    adam, backend, compute_dtype)
                return (params, opt, loss,
                        *self._mask_convergence(loss, loss_ma, active))
        return base_step

    # -------------------------- a chunk --------------------------------- #
    def train_chunk(self, state: DVNRState, volumes, n_steps: int, *,
                    key, lr_scale: float = 1.0) -> tuple:
        """Run ``n_steps`` steps with no host synchronisation: the seed and
        schedule tables are built once, the steps are launched back to back,
        and the (n_steps, P) loss trace stays on the device. ``state.finite``
        of the result carries the non-finite detector (all True with
        ``cfg.guard_nonfinite`` off). ``lr_scale != 1`` runs the chunk with
        an AdamW of ``lr * lr_scale`` (the lr-backoff rung of
        :class:`repro_torch.resilience.RecoveryPolicy`): the fused op's
        schedule table takes its lr column from that optimizer."""
        n_steps = int(n_steps)
        P, guard = self.P, self.cfg.guard_nonfinite
        dev = state.loss_ma.device
        if lr_scale == 1.0:
            adam, spmd_step = self.adam, self._spmd_step
        else:
            adam = AdamW(dataclasses.replace(
                self.adam.cfg, lr=self.adam.cfg.lr * float(lr_scale)))
            spmd_step = self._build_spmd_step(adam)
        seeds = step_seeds(key, torch.arange(state.step, state.step + n_steps),
                           P, partitions=self._global_rows()).to(dev)
        overflow = torch.zeros((P,), dtype=torch.int64, device=dev) \
            if self._det_route(dev) else None
        sched = (fts.schedule_table(state.opt["step"], adam.cfg, adam, n_steps)
                 if self.fuse_train_step else None)
        params, opt = state.params, state.opt
        active, loss_ma = state.active, state.loss_ma
        finite = torch.ones((P,), dtype=torch.bool, device=dev)
        losses = []
        for i in range(n_steps):
            scalars = None
            if sched is not None:
                scalars = sched[i]
                scalars[:, 3] = active
            active_in = active
            params, opt, loss, loss_ma, active = spmd_step(
                params, opt, volumes, seeds[i], active, loss_ma, scalars,
                overflow=overflow)
            if guard:
                finite = finite & (torch.isfinite(loss) | ~active_in)
            losses.append(loss)
        if guard:
            for x in tree_leaves(params):
                finite = finite & torch.isfinite(x.float()).reshape(P, -1).all(1)
        if overflow is not None:
            over = (overflow & fts.FX_OVER).cpu().numpy()   # one read a chunk
            if over.any():
                raise fts.FixedPointOverflowError(
                    f"partitions {[self.partitions[p] for p in np.flatnonzero(over)]}: "
                    "a table-gradient contribution left the deterministic "
                    f"route's fixed-point bound (N |w g| <= {fts.FX_BOUND})")
        trace = torch.stack(losses) if losses else \
            torch.zeros((0, P), device=dev)
        return DVNRState(params, opt, loss_ma, active, state.step + n_steps,
                         finite), trace

    # -------------------------- training loops -------------------------- #
    def train(self, state: DVNRState, volumes, *, steps: int, key,
              log_every: int = 0, check_every: int = 0,
              recovery=None) -> tuple:
        """The chunked training loop. ``volumes``: (P, nx+2g, ny+2g, nz+2g)
        normalized partitions. ``check_every`` is the chunk size, the
        granularity of the host's convergence checks (0: the whole run as
        one chunk when early stopping is off, else 64-step chunks).

        ``recovery`` (a :class:`repro_torch.resilience.RecoveryPolicy`)
        routes the run through the non-finite recovery loop: each chunk is
        snapshotted (cloned) before it runs, partitions whose detector flag
        trips are retried on a reseed -> moment-reset -> lr-backoff ladder
        and frozen at their last-good params once attempts are exhausted;
        healthy partitions keep their first attempt's results."""
        if recovery is not None:
            from repro_torch.resilience.recovery import train_with_recovery
            return train_with_recovery(self, state, volumes, steps=steps,
                                       key=key, log_every=log_every,
                                       check_every=check_every,
                                       policy=recovery)
        if steps <= 0:
            return state, {"loss": [], "final_step": state.step}
        if check_every <= 0:
            check_every = steps if self.cfg.target_loss <= 0 else min(steps, 64)
        losses, done = [], 0
        while done < steps:
            n = min(check_every, steps - done)
            start = state.step
            state, trace = self.train_chunk(state, volumes, n, key=key)
            if log_every:
                mean = trace.mean(dim=1).cpu()        # one transfer per chunk
                losses += [(start + i + 1, float(mean[i])) for i in range(n)
                           if (done + i + 1) % log_every == 0]
            done += n
            if self.cfg.target_loss > 0 and not bool(state.active.any()):
                break
        return state, {"loss": losses, "final_step": state.step}

    def train_looped(self, state: DVNRState, volumes, *, steps: int, key,
                     log_every: int = 0) -> tuple:
        """The per-step loop (seeds derived and convergence read on the
        host every step): the parity reference of :meth:`train_chunk`."""
        losses = []
        for i in range(steps):
            seeds = step_seeds(key, state.step, self.P,
                               partitions=self._global_rows()).to(state.loss_ma.device)
            params, opt, loss, loss_ma, active = self._spmd_step(
                state.params, state.opt, volumes, seeds, state.active,
                state.loss_ma, None)
            state = DVNRState(params, opt, loss_ma, active, state.step + 1)
            if log_every and (i + 1) % log_every == 0:
                losses.append((state.step, float(loss.mean())))
            if self.cfg.target_loss > 0 and not bool(active.any()):
                break
        return state, {"loss": losses, "final_step": state.step}

    # -------------------------- evaluation ----------------------------- #
    @torch.no_grad()
    def evaluate(self, state: DVNRState, volumes, owned_shape, *,
                 out_dtype=None, chunk: int = 1 << 20) -> dict:
        """Decode every partition on its cell-centred grid and compute the
        PSNR against the normalized reference (MSE averaged over partitions
        first, paper V-B). Each chunk of grid points is one batched decode
        of all P partitions through ``_inr_apply_batched`` (one launch of
        each kernel); the squared errors are summed on the device and cross
        to the host once. The decode runs in the policy's compute dtype and
        is rounded to ``out_dtype`` (default: the policy's output dtype)."""
        g, cfg, P = self.ghost, self.cfg, self.P
        odt = self.precision.output_torch if out_dtype is None else \
            torch_dtype(out_dtype)
        nx, ny, nz = (int(d) for d in owned_shape)
        dev = volumes.device
        axes = [(torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
                for n in (nx, ny, nz)]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        refs = volumes[:, g:g + nx, g:g + ny, g:g + nz].reshape(P, nx * ny * nz, -1)
        sq = torch.zeros((P,), dtype=torch.float64, device=dev)
        part = list(range(P))
        for s in range(0, grid.shape[0], chunk):
            c = grid[s:s + chunk]
            dec = _inr_apply_batched(cfg, state.params,
                                     c.expand(P, *c.shape), part,
                                     self.backend,
                                     compute_dtype=self._compute_dtype)
            err = dec.to(odt).float() - refs[:, s:s + chunk]
            sq += torch.square(err).sum(dim=(1, 2)).double()
        mses = (sq / (nx * ny * nz * refs.shape[2])).cpu().numpy()
        return {"psnr": float(psnr_from_mses(mses)),
                "mse_per_partition": [float(m) for m in mses]}
