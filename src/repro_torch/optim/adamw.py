"""AdamW with exponential / cosine / constant LR schedules and global-norm
clipping: the port of ``repro.optim.adamw``.

The paper trains DVNR with Adam and exponential learning-rate decay
(beta1=0.9, beta2=0.999, eps=1e-8, weight decay 1e-9). Parameters are trees
of tensors (dicts, lists, tuples). The optimizer works on the trainer's
partition-stacked trees directly: ``state["step"]`` may be a (P,) tensor,
one counter per partition, and the schedule scalars and the ``gate``
broadcast over each leaf's leading axis, which is what ``jax.vmap(AdamW)``
gives the JAX package.

Mixed precision: with ``OptConfig.master_dtype`` set and narrower params
(bf16 training), ``init`` keeps a full-precision master copy (``"mw"``);
:meth:`AdamW.step` updates the master and re-derives the working params by
casting, so bf16 rounding never feeds back into the trajectory.

The float32 arithmetic is the JAX package's, operation for operation.
:meth:`AdamW.update`, :meth:`AdamW.apply_updates` and :meth:`AdamW.step`
build new tensors; :meth:`AdamW.apply_` is ``update`` then
``apply_updates`` (with ``clip_by_global_norm``'s scaling before them)
written into the params and moments in place, a slice of a leaf at a time,
which is how the LM train step spends no memory beyond params, grads and
moments (the counterpart of the JAX driver's buffer donation); the CUDA
train step (``csrc/adamw.cu``) applies the same update in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.precision import torch_dtype


@dataclass(frozen=True)
class OptConfig:
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-9
    schedule: str = "constant"          # constant | exp | cosine
    decay_rate: float = 0.33            # exp: lr *= decay_rate every decay_steps
    decay_steps: int = 1000
    warmup_steps: int = 0
    total_steps: int = 10_000           # cosine horizon
    clip_norm: float = 1.0              # 0 = off
    moments_dtype: str = "float32"
    master_dtype: str = ""              # "" = params are their own master


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves (tensors) of dict / list / tuple trees of
    one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_schedule(cfg: OptConfig):
    """step (int tensor) -> float32 learning rate of the same shape."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        base = torch.full_like(step, cfg.lr)
        if cfg.schedule == "exp" and cfg.decay_steps > 0:
            base = base * torch.pow(_f32(cfg.decay_rate, step.device),
                                    step / float(cfg.decay_steps))
        elif cfg.schedule == "cosine":
            frac = torch.clamp(step / float(max(cfg.total_steps, 1)), 0.0, 1.0)
            base = base * 0.5 * (1.0 + torch.cos(float(math.pi) * frac))
        if cfg.warmup_steps > 0:
            base = base * torch.clamp((step + 1.0) / float(cfg.warmup_steps),
                                      0.0, 1.0)
        return base

    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` multiplies every leaf by."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    if max_norm <= 0:
        return tree, norm
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def _bcast(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-partition (P,) scalar (or a 0-d one) shaped to broadcast over
    a (P, ...) leaf."""
    return s.reshape(s.shape + (1,) * (x.ndim - s.ndim))


def bias_corrections(cfg: OptConfig, step: torch.Tensor):
    """``(1 - beta1^t, 1 - beta2^t)`` in float32 for the step counter(s)."""
    t = step.to(torch.float32)
    b1 = _f32(cfg.beta1, t.device)
    b2 = _f32(cfg.beta2, t.device)
    return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


def adamw_leaf(cfg: OptConfig, g, m, v, master, lr, bc1, bc2):
    """One leaf's update: ``(u, m32, v32)`` with ``u = -lr * delta`` in the
    master's dtype. ``lr`` / ``bc1`` / ``bc2`` broadcast over the leaf."""
    b1, b2 = cfg.beta1, cfg.beta2
    g32 = g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
    # the square root correctly rounded on every device, as XLA's and the
    # kernel's (__fsqrt_rn) are: PyTorch's vectorised CPU root can miss the
    # float32 rounding by one ulp, and the float64 root of a float32 value,
    # rounded to float32, is the correctly rounded float32 root
    vhat = v32 / bc2
    root = torch.sqrt(vhat.double()).to(vhat.dtype)
    delta = (m32 / bc1) / (root + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * master.float()
    return (-lr * delta).to(master.dtype), m32, v32


class AdamW:
    """Functional AdamW: ``init(params) -> state``,
    ``update(grads, state, params)``, ``step(grads, state, params, gate)``."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def _wants_master(self, params) -> bool:
        if not self.cfg.master_dtype:
            return False
        wdt = torch_dtype(self.cfg.master_dtype)
        return any(x.dtype != wdt for x in tree_leaves(params))

    def init(self, params, n_partitions=None):
        """Zero moments (and the master copy where wanted). With
        ``n_partitions`` the step counter is a (P,) tensor, one per
        partition of a stacked tree; otherwise a 0-d tensor."""
        mdt = torch_dtype(self.cfg.moments_dtype)
        dev = tree_leaves(params)[0].device
        shape = () if n_partitions is None else (int(n_partitions),)
        state = {
            "step": torch.zeros(shape, dtype=torch.int32, device=dev),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                                device=p.device), params),
        }
        if self._wants_master(params):
            wdt = torch_dtype(self.cfg.master_dtype)
            state["mw"] = tree_map(lambda p: p.to(wdt).clone(), params)
        return state

    def update(self, grads, state, params):
        cfg = self.cfg
        step = state["step"] + 1
        lr = self.schedule(step)
        bc1, bc2 = bias_corrections(cfg, step)
        mdt = torch_dtype(cfg.moments_dtype)

        def upd(g, m, v, p):
            u, m32, v32 = adamw_leaf(cfg, g, m, v, p, _bcast(lr, p),
                                     _bcast(bc1, p), _bcast(bc2, p))
            return u, m32.to(mdt), v32.to(mdt)

        out = tree_map(upd, grads, state["m"], state["v"], params)
        return _pick(out, 0), {**state, "step": step, "m": _pick(out, 1),
                               "v": _pick(out, 2)}

    def step(self, grads, state, params, gate=None):
        """One full optimizer step -> (new_params, new_state). With a
        master copy the (gated) update goes to the master and the working
        params are re-derived by casting; without one this is exactly
        ``params + gate * update``. ``gate`` is a 0-d or (P,) float tensor
        (0 freezes a converged partition; its moments still advance)."""
        master = state.get("mw", params)
        updates, state = self.update(grads, state, master)
        if gate is None:
            apply = lambda p, u: p + u
        else:
            apply = lambda p, u: p + (_bcast(gate, p) * u).to(p.dtype)
        master = tree_map(apply, master, updates)
        if "mw" in state:
            state = {**state, "mw": master}
            params = tree_map(lambda w, p: w.to(p.dtype), master, params)
        else:
            params = master
        return params, state

    @staticmethod
    def apply_updates(params, updates):
        return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)

    #: elements of a leaf that :meth:`apply_` updates at once (bounds its
    #: float32 temporaries on the largest embedding and expert leaves)
    CHUNK = 1 << 26

    def apply_(self, grads, state, params, grad_scale=None):
        """``update(grads * grad_scale, state, params)`` then
        ``apply_updates``, in place: the params, ``state["m"]`` and
        ``state["v"]`` (contiguous tensors) are overwritten, leaf by leaf
        and ``CHUNK`` elements at a time, with the values the functional
        pair gives (element-wise, so the slicing changes no bit).
        ``grad_scale`` (a 0-d tensor, or None) is ``clip_by_global_norm``'s
        factor, applied as it applies it. Returns the new state (``step``
        advanced; every other entry, the master copy included, as given)."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = self.schedule(step)
        bc1, bc2 = bias_corrections(cfg, step)
        mdt = torch_dtype(cfg.moments_dtype)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
            for a in range(0, p.numel(), self.CHUNK):
                sl = slice(a, a + self.CHUNK)
                gs = g[sl]
                if grad_scale is not None:
                    gs = (gs.float() * grad_scale).to(gs.dtype)
                u, m32, v32 = adamw_leaf(cfg, gs, m[sl], v[sl], p[sl], lr, bc1, bc2)
                m[sl] = m32.to(mdt)
                v[sl] = v32.to(mdt)
                p[sl] = p[sl] + u
        return {**state, "step": step}


def _pick(tree_of_tuples, i):
    """Component ``i`` of a tree whose leaves are tuples."""
    if isinstance(tree_of_tuples, dict):
        return {k: _pick(v, i) for k, v in tree_of_tuples.items()}
    if isinstance(tree_of_tuples, list):
        return [_pick(v, i) for v in tree_of_tuples]
    return tree_of_tuples[i]
