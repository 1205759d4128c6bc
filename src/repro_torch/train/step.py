"""Train step factory: the port of ``repro.train.step``.

``make_train_step``: the loss's gradient (``torch.autograd.grad``) -> the
optional grad transform -> the optional int8 error-feedback compression ->
global-norm clipping -> AdamW, in the JAX package's order, with optional
microbatch gradient accumulation (a loop in the place of ``lax.scan``).

On a mesh (a ``sharder`` with one; every model family) the params
and moments are the rank's blocks (``parallel.sharding.shard_params``: cut
over ``"model"`` and over ``"data"``, ZeRO-3) and the batch its block of
the global batch: the model's loss already gives each rank its block of
the global-batch gradient (reduce-scattered over ``"data"`` for the
leaves it cuts, summed over the batch axes for those held whole over
them), the clip's norm is taken over every block (a psum of the cut
leaves' squares over the axes that cut them), int8 compression scales
each leaf by the whole tensor's maximum (a pmax over the same axes), and
AdamW runs on the local blocks.

Params are the model's tree of tensors (no ``nn.Module``). The step writes
the new params and moments into the tensors it is given and returns them
(the PyTorch counterpart of the JAX driver's ``donate_argnums=(0, 1)``), so
a step holds params, grads and moments and little else: pass copies to
keep the old values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import backends
from repro_torch.optim.adamw import (
    AdamW, OptConfig, clip_scale, global_norm, tree_leaves, tree_map,
)
from repro_torch.optim.compressed import (cut_axes, ef_compress_decompress,
                                          init_error_feedback)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import _unflatten_like, held_shardings, mesh_sharder


@dataclass
class TrainState:
    params: Any
    opt_state: Any

    def tree_flatten(self):
        return (self.params, self.opt_state), None


def _split(batch: dict, microbatches: int) -> list:
    """The batch's leading dim cut into ``microbatches`` equal slices (the
    rows of JAX's ``reshape(microbatches, B // microbatches, ...)``)."""
    def cut(x, i):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"a leading dim of {b} does not split into "
                             f"{microbatches} microbatches")
        n = b // microbatches
        return x[i * n:(i + 1) * n]

    return [{k: cut(x, i) for k, x in batch.items()} for i in range(microbatches)]


def make_train_step(model, opt_cfg: OptConfig, sharder=None, impl="auto",
                    microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    grad_compress: bool = False):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with ``step.optimizer`` the :class:`AdamW` whose ``init``
    makes ``opt_state``.

    ``impl``: the backend of the model's loss (``"auto"``: the card's;
    raises without a GPU). ``sharder``: None or a mesh-less ``Sharder``
    (one card), or a ``Sharder`` on a mesh (any family: the params and
    moments the rank's blocks, the batch its rows; a leaf the loss does not
    read, such as the VLM's embedding table, gets a zero gradient block,
    which AdamW's decay still updates). ``grad_compress=True`` threads an
    int8 error-feedback residual through ``opt_state["ef_residual"]``.
    ``metrics``: the model's metrics plus ``loss``, ``grad_norm`` and
    ``lr`` (0-d tensors)."""
    sh = mesh_sharder(sharder)
    # the blocks' placements, from the global shapes (the guard decides by them)
    places = held_shardings(model.param_specs(), model.config, sh) \
        if sh is not None else None
    backend = backends.resolve(impl)
    opt = AdamW(opt_cfg)
    if grad_compress:
        base_init = opt.init

        def init_with_ef(params):
            st = dict(base_init(params))
            st["ef_residual"] = init_error_feedback(params)
            return st

        opt.init = init_with_ef

    def value_and_grad(params, batch):
        work = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()),
                        params)
        loss, metrics = model.loss(work, batch, sharder, backend)
        grads = torch.autograd.grad(loss, tree_leaves(work), allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, _unflatten_like(params, list(grads))

    def grads_of(params, batch):
        if microbatches <= 1:
            return value_and_grad(params, batch)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        losses, mets = [], []
        for b_i in _split(batch, microbatches):
            loss, metrics, g = value_and_grad(params, b_i)
            gsum = tree_map(lambda a, gg: a + gg.float(), gsum, g)
            losses.append(loss)
            mets.append(metrics)
            del g
        grads = tree_map(lambda g, p: (g / microbatches).to(p.dtype), gsum, params)
        metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        return torch.stack(losses).mean(), metrics, grads

    def step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        if grad_compress:
            opt_state = dict(opt_state)
            residual = opt_state.pop("ef_residual")
            grads, residual = ef_compress_decompress(grads, residual,
                                                     placements=places)
        gnorm = global_norm(grads) if sh is None else mesh_global_norm(grads, places)
        scale = clip_scale(gnorm, opt_cfg.clip_norm) if opt_cfg.clip_norm > 0 else None
        opt_state = opt.apply_(grads, opt_state, params, grad_scale=scale)
        if grad_compress:
            opt_state["ef_residual"] = residual
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr=opt.schedule(opt_state["step"]))
        return params, opt_state, metrics

    step.optimizer = opt
    return step


def mesh_global_norm(grads, placements) -> torch.Tensor:
    """The global norm of a tree of blocks: the squares of the leaves cut
    over the mesh summed over their ranks (one psum for each set of axes
    wider than 1 that cuts leaves, e.g. ``("data", "model")``), the whole
    leaves' once."""
    mesh = placements_mesh(placements)
    by_axes: dict = {}
    for g, p in zip(tree_leaves(grads), tree_leaves(placements)):
        axes = tuple(a for a in mesh.axes(cut_axes(p)) if mesh.shape[a] > 1)
        # AdamW.CHUNK elements at a time: no float32 copy of a whole leaf
        sq = sum(torch.sum(torch.square(c.float()))
                 for c in g.reshape(-1).split(AdamW.CHUNK))
        by_axes[axes] = by_axes.get(axes, 0.0) + sq
    total = 0.0
    for axes, sq in sorted(by_axes.items()):
        total = total + (col.psum(sq, mesh, axes) if axes else sq)
    return torch.sqrt(total)


def placements_mesh(placements):
    return tree_leaves(placements)[0].mesh
