"""Non-finite recovery for chunked DVNR training.

The port of ``repro.resilience.recovery``. The trainer's non-finite
detector (``cfg.guard_nonfinite``) reports a (P,) ``finite`` flag with
every chunk. :func:`train_with_recovery` (reached through
``DVNRTrainer.train(recovery=...)`` / ``api.train(recovery=)``) turns that
flag into a bounded retry ladder, chunk by chunk:

1. **skip-and-reseed**: rerun the chunk for the tripped partitions from the
   pre-chunk snapshot with a folded-in retry key (a sparse NaN/Inf
   poisoning of the volume is usually dodged by resampling);
2. **rollback + moment reset**: also reinitialize the tripped partitions'
   AdamW moments;
3. **lr-backoff**: also scale the learning rate by ``policy.lr_backoff``
   per further attempt.

After ``policy.max_retries`` attempts a partition is **frozen**: restored to
its last-good params and masked out of training (``active=False``); the
other partitions keep training.

Healthy partitions keep their FIRST attempt's results: retries rerun the
whole stacked step, and only the tripped partitions' columns are merged
back. Training is zero-communication, so a kept column is the trajectory of
a fault-free run (bit for bit on the plain path; on the card up to the
order of the train step's atomic adds).

The CUDA train step advances params and moments IN PLACE, so every
snapshot here is a clone: :func:`snapshot_state` clones every leaf before
the chunk runs, every attempt starts from a fresh clone of the pre-chunk
snapshot, and :func:`merge_partitions` returns fresh tensors that alias
neither input. The only device-to-host reads are the per-chunk ``finite``
flags.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.sampling import fold_in
from repro_torch.optim.adamw import tree_map


@dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs of the retry ladder (see the module docstring for the rungs).

    ``max_retries`` bounds attempts per chunk per partition; ``reseed=False``
    disables the resample rung (retries then rerun the identical chunk);
    ``rollback=False`` disables the moment-reset rung; ``lr_backoff`` is the
    per-attempt lr multiplier of rung 3 (1.0 disables);
    ``freeze_on_failure=False`` raises instead of degrading when the ladder
    is exhausted."""

    max_retries: int = 3
    reseed: bool = True
    rollback: bool = True
    lr_backoff: float = 0.5
    freeze_on_failure: bool = True


class NonFiniteTrainingError(RuntimeError):
    """Raised when recovery is exhausted and ``freeze_on_failure`` is off."""


def snapshot_state(state):
    """A copy of ``state`` that shares no tensor with it: the in-place CUDA
    step may advance the original without touching the snapshot."""
    from repro_torch.core.trainer import DVNRState

    params, opt, loss_ma, active = tree_map(
        lambda t: t.clone(), (state.params, state.opt, state.loss_ma,
                              state.active))
    finite = None if state.finite is None else state.finite.clone()
    return DVNRState(params, opt, loss_ma, active, state.step, finite)


def merge_partitions(mask, take, keep):
    """Per-partition tree select: ``mask[p] ? take[p] : keep[p]``.

    Every leaf carries the stacked partition axis first (trainer invariant),
    so the (P,) bool ``mask`` broadcasts against it. ``torch.where`` makes
    fresh tensors: the output aliases neither input."""

    def sel(a, b):
        m = mask.to(a.device).reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(m, a, b)

    return tree_map(sel, take, keep)


def _fold_retry_key(key, attempt: int):
    # a large odd constant keeps retry keys disjoint from the per-tick
    # fold_in(seed, tick) stream of the reactive layer
    return fold_in(key, 1000003 + attempt)


def _reset_moments(trainer, opt, params):
    """Fresh AdamW state for every partition (merged per mask by callers):
    zero moments and step counters, and under a master-weight policy an f32
    master rebuilt from the working params, which for a partition being
    rolled back is the restore from the snapshot."""
    return trainer.adam.init(params, trainer.P)


def _mask(flags, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(flags, bool), device=device)


def train_with_recovery(trainer, state, volumes, *, steps: int, key,
                        log_every: int = 0, check_every: int = 0,
                        policy: Optional[RecoveryPolicy] = None):
    """Chunked training loop with the non-finite retry ladder.

    Mirrors :meth:`repro_torch.core.trainer.DVNRTrainer.train` (same
    chunking, loss-log format and early stop) and also returns a
    ``"recovery"`` entry in the info dict: total retries, per-chunk events,
    and the recovered / frozen partition sets.
    """
    from repro_torch.core.trainer import DVNRState

    policy = policy or RecoveryPolicy()
    if not trainer.cfg.guard_nonfinite:
        raise ValueError("recovery requires cfg.guard_nonfinite=True (the "
                         "non-finite detector is the signal it acts on)")
    if steps <= 0:
        return state, {"loss": [], "final_step": state.step,
                       "recovery": {"retries": 0, "events": [],
                                    "recovered_partitions": (),
                                    "frozen_partitions": ()}}
    if check_every <= 0:
        check_every = (steps if trainer.cfg.target_loss <= 0
                       else min(steps, 64))

    P = trainer.P
    # the events name global partitions (a rank of a mesh holds a slice)
    gid = np.asarray(getattr(trainer, "partitions", range(P)), np.int64)
    dev = state.loss_ma.device
    frozen = np.zeros(P, bool)
    recovered: set = set()
    retries_total = 0
    events: list = []
    losses, done = [], 0

    while done < steps:
        n = min(check_every, steps - done)
        start = state.step
        pre = snapshot_state(state)
        cand, trace = trainer.train_chunk(state, volumes, n, key=key)
        finite = cand.finite.cpu().numpy()
        bad = ~finite & ~frozen

        if bad.any():
            event = {"step": int(start), "tripped": tuple(gid[np.flatnonzero(bad)]),
                     "attempts": 0}
            for attempt in range(1, policy.max_retries + 1):
                base = snapshot_state(pre)
                if attempt >= 2 and policy.rollback:
                    fresh = _reset_moments(trainer, base.opt, base.params)
                    base = DVNRState(
                        base.params,
                        merge_partitions(_mask(bad, dev), fresh, base.opt),
                        base.loss_ma, base.active, base.step, base.finite)
                k = _fold_retry_key(key, attempt) if policy.reseed else key
                lr_scale = (policy.lr_backoff ** max(attempt - 2, 0)
                            if policy.lr_backoff != 1.0 else 1.0)
                r_state, r_trace = trainer.train_chunk(
                    base, volumes, n, key=k, lr_scale=lr_scale)
                retries_total += 1
                event["attempts"] = attempt
                r_finite = r_state.finite.cpu().numpy()
                fixed = bad & r_finite
                if fixed.any():
                    m = _mask(fixed, dev)
                    cand = DVNRState(
                        merge_partitions(m, r_state.params, cand.params),
                        merge_partitions(m, r_state.opt, cand.opt),
                        torch.where(m, r_state.loss_ma, cand.loss_ma),
                        torch.where(m, r_state.active, cand.active),
                        cand.step,
                        torch.where(m, r_state.finite, cand.finite))
                    trace = torch.where(m[None, :], r_trace, trace)
                    recovered.update(int(p) for p in gid[np.flatnonzero(fixed)])
                    bad = bad & ~r_finite
                if not bad.any():
                    break

            if bad.any():
                if not policy.freeze_on_failure:
                    raise NonFiniteTrainingError(
                        f"partitions {sorted(gid[np.flatnonzero(bad)])} stayed "
                        f"non-finite after {policy.max_retries} recovery "
                        f"attempts at step {start}")
                frozen |= bad
                event["frozen"] = tuple(int(p) for p in gid[np.flatnonzero(bad)])
            events.append(event)

        if frozen.any():
            # frozen partitions are pinned at their last-good state every
            # chunk: pre holds it by induction, and the restore also scrubs
            # the NaN that the gated update of a frozen partition with
            # poisoned data lets through (0 x NaN), whether the gate
            # multiplies or selects
            m = _mask(frozen, dev)
            safe_ma = torch.where(torch.isfinite(pre.loss_ma), pre.loss_ma,
                                  torch.zeros_like(pre.loss_ma))
            cand = DVNRState(
                merge_partitions(m, pre.params, cand.params),
                merge_partitions(m, pre.opt, cand.opt),
                torch.where(m, safe_ma, cand.loss_ma),
                torch.where(m, torch.zeros_like(cand.active), cand.active),
                cand.step,
                torch.where(m, torch.ones_like(cand.finite), cand.finite))
            trace = torch.where(m[None, :], safe_ma[None, :], trace)

        state = cand
        if log_every:
            mean = trace.mean(dim=1).cpu()        # one transfer per chunk
            losses += [(start + i + 1, float(mean[i])) for i in range(n)
                       if (done + i + 1) % log_every == 0]
        done += n
        if trainer.cfg.target_loss > 0 and not bool(state.active.any()):
            break

    info = {"loss": losses, "final_step": state.step,
            "recovery": {"retries": retries_total, "events": events,
                         "recovered_partitions": tuple(sorted(recovered)),
                         "frozen_partitions": tuple(
                             int(p) for p in gid[np.flatnonzero(frozen)])}}
    return state, info
