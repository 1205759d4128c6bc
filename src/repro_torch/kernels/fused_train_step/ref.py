"""Plain composition of the fused train step: the port of
``repro.kernels.fused_train_step.ref``.

The math of the trainer's unfused step: (optionally) the counter-based batch
sampler and the trilinear target gather, the forward through the backend's
own hash-encode and fused-MLP ops, gradients by autograd (through their
backward passes), the update by :meth:`repro_torch.optim.adamw.AdamW.step`.
The partition axis is a tensor axis, not a Python loop: one backward of the
SUM of the per-partition mean losses gives each partition its own gradient,
because no parameter is shared between partitions.

This is what the ``ref`` backend runs as its fused train step, what the
unfused trainer step runs on every backend, and the plain version the CUDA
train-step and AdamW kernels (``csrc/train_step.cuh``, ``csrc/adamw.cu``)
are held against.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import backends
from repro_torch.core.sampling import training_coords_counter
from repro_torch.data.volume import sample_trilinear_batched
from repro_torch.kernels.fused_mlp.ops import fused_mlp_batched
from repro_torch.kernels.fused_mlp.ref import (fused_mlp_batched_bwd_ref,
                                               fused_mlp_batched_ref)
from repro_torch.kernels.hash_encoding.ops import hash_encode_batched
from repro_torch.kernels.hash_encoding.ref import (hash_encode_batched_bwd_ref,
                                                   hash_encode_batched_ref)
from repro_torch.optim.adamw import AdamW, OptConfig, adamw_leaf


def sample_batch(volumes, seeds, *, n_batch: int, boundary_lambda: float,
                 sigma: float, ghost: int):
    """Each partition's batch: (P, 2) seed words -> coords (P, N, 3) and
    trilinear targets (P, N, C) from the ghost-padded ``volumes``
    (P, nx+2g, ny+2g, nz+2g[, C])."""
    coords = training_coords_counter(seeds, n_batch, boundary_lambda, sigma)
    target = sample_trilinear_batched(volumes, coords, ghost)
    if target.ndim == 2:
        target = target[..., None]
    return coords, target


def loss_and_grads(params, coords, target, resolutions: Sequence[int],
                   backend, compute_dtype=None):
    """Per-partition L1 losses (P,) f32 and the gradient tree of their sum
    w.r.t. the stacked ``params`` (each partition's own gradient)."""
    P = coords.shape[0]
    leaves = [params["tables"], *params["mlp"]]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    part = list(range(P))
    with torch.enable_grad():
        feats = hash_encode_batched(coords, leaves[0], resolutions, part,
                                    backend, compute_dtype=compute_dtype)
        pred = fused_mlp_batched(feats, leaves[1:], part, backend,
                                 compute_dtype=compute_dtype)
        loss = torch.mean(torch.abs(pred.float() - target), dim=(1, 2))
        grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), {"tables": grads[0], "mlp": list(grads[1:])}


def train_step_ref(params, opt, coords, target, gate,
                   resolutions: Sequence[int], adam: AdamW, backend,
                   compute_dtype=None):
    """One L1 train step for every partition (stacked inputs).

    params/opt: (P, ...)-stacked trees (``opt["step"]`` (P,)); coords
    (P, N, 3) f32; target (P, N, out_dim) f32; gate (P,) f32 convergence
    mask. Returns ``(params, opt, loss)`` with loss (P,) f32; the inputs are
    not modified."""
    loss, grads = loss_and_grads(params, coords, target, resolutions, backend,
                                 compute_dtype)
    params, opt = adam.step(grads, opt, params, gate)
    return params, opt, loss


def train_step_sampling_ref(params, opt, volumes, seeds, gate,
                            resolutions: Sequence[int], adam: AdamW, backend,
                            *, n_batch: int, boundary_lambda: float,
                            sigma: float, ghost: int, compute_dtype=None):
    """The sampling-included step: draw the counter-based batch from the
    (P, 2) ``seeds``, gather its targets, then :func:`train_step_ref`."""
    coords, target = sample_batch(volumes, seeds, n_batch=n_batch,
                                  boundary_lambda=boundary_lambda,
                                  sigma=sigma, ghost=ghost)
    return train_step_ref(params, opt, coords, target, gate, resolutions,
                          adam, backend, compute_dtype)


# --------------------------------------------------------------------------- #
# the plain versions of the two CUDA kernels, on the packed state layout
# --------------------------------------------------------------------------- #
def _unpacked(flat, n_hidden):
    return {"tables": flat["tab"],
            "mlp": [flat["win"]] + [flat["whid"][:, k]
                                    for k in range(n_hidden - 1)]
            + [flat["wout"]]}


def train_step_grads_ref(flat_p, n_hidden: int, resolutions, coords, target,
                         cotangent_out=None):
    """The plain version of the train-step kernel: the packed state's f32
    gradients ({tab, win, whid, wout}, (P, ...)) and the per-partition SUM
    of |pred - target| (P,) for one batch (coords (P,N,3), target
    (P,N,D_out)). Given ``cotangent_out`` (P, N, L*F), the feature
    cotangent goes there and the table gradient is left zero, as the
    kernel's split mode does.

    The step of :func:`loss_and_grads` written out through the plain
    forward and backward versions, so that the gradients come out as their
    float32 sums: for a bf16 state (the bf16 policy, whose compute dtype is
    the state's) autograd would round each one to bf16 at its leaf, where
    the kernel (and JAX's Pallas kernel) hands float32 gradients to AdamW.
    The rounding points are the plain versions': the encode rounds each
    feature, the MLP each layer's output and, in its backward, each delta;
    the prediction is rounded, the L1 cotangent sign / (N D_out) is taken in
    float32 and rounded to the compute dtype, the feature cotangent comes
    back in it, and the table scatter is float32. For float32 this is
    autograd's arithmetic, operation for operation."""
    tab, ws = flat_p["tab"], _unpacked(flat_p, n_hidden)["mlp"]
    P, N, D_out = target.shape
    part = torch.arange(P, device=coords.device)
    feats = hash_encode_batched_ref(coords, tab, resolutions, part)
    pred = fused_mlp_batched_ref(feats, ws, part)
    diff = pred.float() - target
    loss_sum = torch.mean(torch.abs(diff), dim=(1, 2)) * float(N * D_out)
    g = (torch.sign(diff) / float(N * D_out)).to(pred.dtype)
    dx, dws = fused_mlp_batched_bwd_ref(feats, ws, g, part)
    if cotangent_out is not None:
        cotangent_out.copy_(dx)
        g_tab = torch.zeros(tab.shape, dtype=torch.float32, device=tab.device)
    else:
        g_tab = hash_encode_batched_bwd_ref(dx, coords, resolutions, part,
                                            tuple(tab.shape))
    hid = dws[1:-1]
    return {"tab": g_tab, "win": dws[0],
            "whid": (torch.stack(hid, 1) if hid
                     else torch.zeros_like(flat_p["whid"], dtype=torch.float32)),
            "wout": dws[-1]}, loss_sum


def adamw_apply_ref(flat_p, flat_m, flat_v, flat_mw, grads, scalars, *,
                    beta1: float, beta2: float, eps: float,
                    weight_decay: float, n_hidden: int):
    """The plain version of the AdamW kernel, in place: for every group,
    ``[lr, 1-b1^t, 1-b2^t, gate]`` rows of ``scalars`` (P, 4), the moments
    advance (gated or not), the update ``-lr * delta`` (weight decay added
    to delta against the master) goes to the master as
    ``master + gate * u``, and bf16 params are re-derived from the f32
    master by casting. The dummy hidden slab of an H = 1 MLP is skipped."""
    cfg = OptConfig(beta1=beta1, beta2=beta2, eps=eps,
                    weight_decay=weight_decay)
    keys = ("tab", "win", "wout") if n_hidden == 1 \
        else ("tab", "win", "whid", "wout")
    for k in keys:
        p = flat_p[k]
        master = flat_mw[k] if flat_mw is not None else p
        shape = (-1,) + (1,) * (p.ndim - 1)
        lr, bc1, bc2, gate = (scalars[:, j].reshape(shape) for j in range(4))
        u, m32, v32 = adamw_leaf(cfg, grads[k], flat_m[k], flat_v[k], master,
                                 lr, bc1, bc2)
        new_master = master + (gate * u).to(master.dtype)
        flat_m[k].copy_(m32)
        flat_v[k].copy_(v32)
        if flat_mw is not None:
            flat_mw[k].copy_(new_master)
        p.copy_(new_master.to(p.dtype))
