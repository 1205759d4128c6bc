"""Shared neural-net layers: norms, activations, RoPE / M-RoPE, initializers.

The same functions as ``repro.models.layers``, in PyTorch. Initializers draw
from an explicit ``torch.Generator`` (the distribution of JAX's, not its
bits); everything else computes what the JAX function computes, in the same
dtypes.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import mesh_sharder, model_split


# --------------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------------- #
#: elements drawn at once by ``truncated_normal`` for a non-float32 dtype
_DRAW_CHUNK = 1 << 28
#: set by ``shapes_only`` / ``cut_draws``: (kind, its state) or None
_DRAW_HOOK: list = [None]


@contextlib.contextmanager
def _hooked(kind: str, state):
    _DRAW_HOOK[0] = (kind, state)
    try:
        yield
    finally:
        _DRAW_HOOK[0] = None


def shapes_only(drawn: Optional[list] = None):
    """Within the block, ``truncated_normal`` and ``normal`` draw nothing
    and return tensors on the meta device of their shape and dtype (an
    ``init`` then gives its tree's shapes, as ``jax.eval_shape`` does); each
    is appended to ``drawn`` when given."""
    return _hooked("shapes", drawn)


def cut_draws(cuts):
    """Within the block, the i-th draw of ``truncated_normal`` or ``normal``
    returns only the block ``cuts[i]`` (a tuple of slices, one a dimension)
    of what it draws outside the block, the same values.
    A draw made in chunks holds one chunk of the whole at a time."""
    return _hooked("cut", iter(cuts))


def _draw_hook(shape, dtype):
    """(meta stand-in or None, cut or None) of the next draw under the hook."""
    hook = _DRAW_HOOK[0]
    if hook is None:
        return None, None
    kind, state = hook
    if kind == "cut":
        return None, next(state)
    t = torch.empty(shape, dtype=dtype, device="meta")
    if state is not None:
        state.append(t)
    return t, None


def _row_boxes(shape, lo: int, hi: int, prefix=()):
    """The flat range [lo, hi) of a row-major array of ``shape`` as boxes
    (prefix, a, b): the elements whose index starts with ``prefix``, lies in
    [a, b) along the next dimension and is whole along the rest."""
    if lo >= hi:
        return
    row = int(np.prod(shape[1:]))
    a, b = -(-lo // row), hi // row              # the whole rows in the range
    if a > b:                                    # within the one row b
        yield from _row_boxes(shape[1:], lo - b * row, hi - b * row, prefix + (b,))
        return
    if lo < a * row:
        yield from _row_boxes(shape[1:], lo - (a - 1) * row, row, prefix + (a - 1,))
    if a < b:
        yield prefix, a, b
    if b * row < hi:
        yield from _row_boxes(shape[1:], 0, hi - b * row, prefix + (b,))


def _copy_cut(out, cut, shape, lo: int, vals) -> None:
    """Copy into ``out``, the block ``cut`` of an array of ``shape``, what
    it holds of that array's flat elements ``[lo, lo + vals.numel())``,
    given as the flat ``vals``."""
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    for prefix, a, b in _row_boxes(shape, lo, lo + vals.numel()):
        k = len(prefix)
        if any(not c.start <= i < c.stop for i, c in zip(prefix, cut)):
            continue
        a2, b2 = max(a, cut[k].start), min(b, cut[k].stop)
        if a2 >= b2:
            continue
        at = sum(i * s for i, s in zip(prefix, strides)) + a2 * strides[k] - lo
        src = vals[at:at + (b2 - a2) * strides[k]].view(b2 - a2, *shape[k + 1:])
        dst = tuple(i - c.start for i, c in zip(prefix, cut)) + (
            slice(a2 - cut[k].start, b2 - cut[k].start),)
        out[dst].copy_(src[(slice(None),) + tuple(cut[k + 1:])])


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype=torch.float32) -> torch.Tensor:
    """``std`` times a unit normal truncated at +-3, drawn in float32 on the
    generator's device and cast to ``dtype`` (JAX's
    ``std * truncated_normal(key, -3, 3, shape)``). A narrower ``dtype``
    over ``_DRAW_CHUNK`` elements is drawn a chunk at a time, so that the
    float32 draw never holds twice the tensor (grok's and arctic's bf16
    expert stacks on one card); under ``cut_draws`` each chunk goes
    straight to the block."""
    shape = tuple(shape)
    meta, cut = _draw_hook(shape, dtype)
    if meta is not None:
        return meta
    n = int(np.prod(shape))
    if dtype == torch.float32 or n <= _DRAW_CHUNK:
        t = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                    generator=gen)
        return t.to(dtype) if cut is None else t[cut].to(dtype, copy=True)
    out = torch.empty(shape if cut is None else tuple(c.stop - c.start for c in cut),
                      dtype=dtype, device=gen.device)
    for lo in range(0, n, _DRAW_CHUNK):
        t = torch.empty(min(_DRAW_CHUNK, n - lo), dtype=torch.float32,
                        device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                    generator=gen)
        if cut is None:
            out.view(-1)[lo:lo + t.numel()].copy_(t)
        else:
            _copy_cut(out, cut, shape, lo, t)
        del t                                    # one chunk held at a time
    return out


def normal(gen: torch.Generator, shape, std: float, dtype=torch.float32) -> torch.Tensor:
    """``std`` times a unit normal, drawn in float32 on the generator's
    device and cast to ``dtype`` (JAX's ``(std * normal(key, shape))
    .astype(dtype)``)."""
    meta, cut = _draw_hook(tuple(shape), dtype)
    if meta is not None:
        return meta
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    t = (std * t).to(dtype)
    return t if cut is None else t[cut].clone()


def dense_init(gen: torch.Generator, shape, in_dim: Optional[int] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (as used by most released LMs)."""
    if in_dim is None:
        in_dim = shape[0]
    return truncated_normal(gen, shape, 1.0 / np.sqrt(in_dim), dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return truncated_normal(gen, shape, 0.02, dtype)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x, scale=None, eps: float = 1e-6, var=None):
    """``var``: where the last dimension is a block of the normalised one,
    the function from the block (float32) to the whole's mean of squares
    (keepdim); by default the block's own."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True) if var is None else var(x)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dtype)


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def init_norm(cfg, d: int, device=None) -> dict:
    if cfg.norm == "nonparam_ln":
        return {}
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg, p: dict, x):
    if cfg.norm == "nonparam_ln":
        return layer_norm(x)
    if cfg.norm == "layernorm":
        return layer_norm(x, p.get("scale"), p.get("bias"))
    return rms_norm(x, p.get("scale"))


# --------------------------------------------------------------------------- #
# Activations
# --------------------------------------------------------------------------- #
def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return F.softplus(x)


# --------------------------------------------------------------------------- #
# RoPE / M-RoPE
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, dtype=torch.float32,
                     device=None):
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps).to(dtype)


def rope_angles(positions, head_dim: int, theta: float,
                mrope_sections: Optional[tuple] = None):
    """positions: (..., S) int, or (3, ..., S) for M-RoPE. Returns (..., S, half)."""
    half = head_dim // 2
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    if mrope_sections is None:
        return positions[..., None].float() * freqs
    # M-RoPE: each frequency slot i takes its position from section s(i) in (t,h,w)
    assert positions.shape[0] == 3, "M-RoPE needs (3, ..., S) positions"
    sec = np.asarray(mrope_sections)
    assert int(sec.sum()) == half, (mrope_sections, half)
    sel = torch.as_tensor(np.repeat(np.arange(3), sec), device=positions.device)
    pos_pf = torch.movedim(positions[sel], 0, -1)            # (..., S, half)
    return pos_pf.float() * freqs


def apply_rope(x, angles):
    """x: (B, S, H, dh); angles: (B, S, half) -> rotate-half convention."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


# --------------------------------------------------------------------------- #
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, cfg, d: int, f: int, dtype) -> dict:
    p = {"wi": dense_init(gen, (d, f), d, dtype),
         "wo": dense_init(gen, (f, d), f, dtype)}
    if cfg.act == "swiglu":
        p["wg"] = dense_init(gen, (d, f), d, dtype)
    return p


def apply_mlp(cfg, p: dict, x, sharder=None):
    """The FFN. On a mesh (``sharder`` with one) whose model axis cuts
    ``d_ff``, ``p`` holds this rank's columns of ``wi`` / ``wg`` and rows of
    ``wo`` (the Megatron split): the partial products are summed over
    ``"model"`` after ``wo`` (JAX's partitioner, ``layers.py``)."""
    sh = mesh_sharder(sharder)
    split = sh is not None and model_split(sh, cfg.d_ff)
    if split:
        x = col.enter(x, sh.mesh, "model")
    cdt = x.dtype
    h = x @ p["wi"].to(cdt)
    if cfg.act == "swiglu":
        h = silu(x @ p["wg"].to(cdt)) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    y = h @ p["wo"].to(cdt)
    return col.reduce(y, sh.mesh, "model") if split else y


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #
def softmax_xent(logits, labels, mask=None, z_loss: float = 1e-4):
    """Cross-entropy with optional z-loss; logits (..., V) any dtype, labels int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
