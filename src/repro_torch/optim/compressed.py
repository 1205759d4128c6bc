"""Int8 gradient compression with error feedback: the port of
``repro.optim.compressed``.

Compressing the cross-pod gradient all-reduce 4x (f32 -> int8, or 2x from
bf16) cuts the dominant wire term at scale. Error feedback keeps SGD / Adam
convergence: the quantization error of step t is added back into step
t+1's gradient before quantizing (Karimireddy et al., "EF-SGD").

Pass ``make_ef_int8_transform(...)`` as ``grad_transform`` to
``train.make_train_step``, or ``grad_compress=True``, which threads the
residual through ``opt_state["ef_residual"]``. On one card this is the pure
quantization round trip. On a mesh:

- ``axis=`` (with ``mesh=``) is JAX's psum of the int8 values inside
  ``shard_map``: each rank quantizes its own tensor with its own scale,
  the codes are summed as int32 over the axis, and the sum times the local
  scale over the axis's size is the new gradient; the residual is the
  local one;
- without ``axis``, ``placements`` (a tree of the leaves'
  :class:`~repro_torch.parallel.sharding.Placement`, the blocks a rank
  holds) makes each leaf's scale the whole tensor's, a pmax over the axes
  that cut it (``"model"``, ``"data"``) of the blocks' maxima: what ``jnp.max`` of a sharded array
  gives under JAX's partitioner (the train step's ``grad_compress`` on a
  mesh).

``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q``,
``scale`` and the residual are JAX's bit for bit on the same inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import _unflatten_like


def _need_mesh(axis, mesh) -> None:
    if axis is not None and mesh is None:
        raise ValueError(f"ef_compress_decompress(axis={axis!r}) needs the mesh "
                         "(mesh=) whose axis the codes are summed over")


def quantize_int8(x: torch.Tensor, *, mesh=None,
                  amax_axes=()) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale). ``x`` a block of a
    tensor cut over ``amax_axes`` of ``mesh``: the scale is the whole
    tensor's."""
    amax = x.abs().max().float()
    if mesh is not None and amax_axes:
        amax = col.pmax(amax, mesh, amax_axes)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def cut_axes(placement) -> tuple:
    """The mesh axes a placement cuts any dimension over."""
    out = []
    for e in placement.spec:
        out += [] if e is None else ([e] if isinstance(e, str) else list(e))
    return tuple(out)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params) -> dict:
    """Residual buffers, same structure as grads (fp32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_decompress(grads, residual, *, axis: Optional[str] = None,
                           mesh=None, placements=None):
    """Quantize (grad + residual) to int8, optionally psum the codes over
    ``axis`` of ``mesh`` (JAX's inside ``shard_map``), dequantize, and
    return (new_grads, new_residual) in the grads' structure and dtypes.
    ``placements``: a tree like ``grads`` of the blocks' placements (None:
    every leaf whole)."""
    _need_mesh(axis, mesh)
    if placements is not None:
        mesh = tree_leaves(placements)[0].mesh

    def one(g, r, cut):
        target = g.float() + r
        q, scale = quantize_int8(target, mesh=mesh, amax_axes=cut)
        if axis is not None and mesh.axis_size(axis) > 1:
            q32 = col.psum(q.to(torch.int32), mesh, axis)
            n = torch.tensor(float(mesh.axis_size(axis)), device=q.device)
            deq = q32.float() * scale / n
        else:
            deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), target - dequantize_int8(q, scale)

    cuts = [cut_axes(p) for p in tree_leaves(placements)] \
        if placements is not None else [()] * len(tree_leaves(grads))
    out = [one(g, r, c) for g, r, c in zip(tree_leaves(grads),
                                           tree_leaves(residual), cuts)]
    return (_unflatten_like(grads, [a for a, _ in out]),
            _unflatten_like(grads, [b for _, b in out]))


def make_ef_int8_transform(residual_ref: dict, axis: Optional[str] = None,
                           mesh=None):
    """Stateful-by-closure grad transform for ``make_train_step``. The
    residual lives in ``residual_ref['value']`` and must be threaded by the
    caller (functional training loops carry it in the train state)."""
    _need_mesh(axis, mesh)

    def transform(grads):
        new_g, new_r = ef_compress_decompress(grads, residual_ref["value"],
                                              axis=axis, mesh=mesh)
        residual_ref["value"] = new_r
        return new_g

    return transform
