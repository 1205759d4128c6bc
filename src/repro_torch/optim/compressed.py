"""Int8 gradient compression with error feedback: the port of
``repro.optim.compressed``.

Compressing the cross-pod gradient all-reduce 4x (f32 -> int8, or 2x from
bf16) cuts the dominant wire term at scale. Error feedback keeps SGD / Adam
convergence: the quantization error of step t is added back into step
t+1's gradient before quantizing (Karimireddy et al., "EF-SGD").

Pass ``make_ef_int8_transform(...)`` as ``grad_transform`` to
``train.make_train_step``, or ``grad_compress=True``, which threads the
residual through ``opt_state["ef_residual"]``. On one card this is the pure
quantization round trip. ``axis=`` (JAX's psum of the int8 values inside
``shard_map``) is the mesh's collective, which the port does not have yet:
it raises naming ROADMAP item 16.

``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q``,
``scale`` and the residual are JAX's bit for bit on the same inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel.sharding import _unflatten_like


def _no_axis(axis) -> None:
    if axis is not None:
        raise NotImplementedError(
            f"ef_compress_decompress(axis={axis!r}): the int8 all-reduce over a "
            "mesh axis is not ported yet (ROADMAP item 16): pass axis=None")


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params) -> dict:
    """Residual buffers, same structure as grads (fp32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_decompress(grads, residual, *, axis: Optional[str] = None):
    """Quantize (grad + residual) to int8, dequantize, and return
    (new_grads, new_residual) in the grads' structure and dtypes."""
    _no_axis(axis)

    def one(g, r):
        target = g.float() + r
        q, scale = quantize_int8(target)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), target - deq

    out = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    return (_unflatten_like(grads, [a for a, _ in out]),
            _unflatten_like(grads, [b for _, b in out]))


def make_ef_int8_transform(residual_ref: dict, axis: Optional[str] = None):
    """Stateful-by-closure grad transform for ``make_train_step``. The
    residual lives in ``residual_ref['value']`` and must be threaded by the
    caller (functional training loops carry it in the train state)."""
    _no_axis(axis)

    def transform(grads):
        new_g, new_r = ef_compress_decompress(grads, residual_ref["value"])
        residual_ref["value"] = new_r
        return new_g

    return transform
