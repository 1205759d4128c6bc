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
train-step and AdamW kernels (``csrc/train_step.cu``, ``csrc/adamw.cu``)
are held against.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import backends
from repro_torch.core.sampling import training_coords_counter
from repro_torch.data.volume import sample_trilinear_batched
from repro_torch.kernels.fused_mlp.ops import fused_mlp_batched
from repro_torch.kernels.hash_encoding.ops import hash_encode_batched
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
                   backend, compute_dtype=None, with_features: bool = False):
    """Per-partition L1 losses (P,) f32 and the gradient tree of their sum
    w.r.t. the stacked ``params`` (each partition's own gradient); with
    ``with_features`` the tree also holds ``"features"``, the gradient
    w.r.t. the encoded features (P, N, L*F)."""
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
        grads = torch.autograd.grad(loss.sum(),
                                    leaves + ([feats] if with_features else []))
    tree = {"tables": grads[0], "mlp": list(grads[1:len(leaves)])}
    if with_features:
        tree["features"] = grads[-1]
    return loss.detach(), tree


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
                         compute_dtype=None, cotangent_out=None):
    """The plain version of the train-step kernel: the packed state's f32
    gradients ({tab, win, whid, wout}, (P, ...)) and the per-partition SUM
    of |pred - target| (P,) for one batch (coords (P,N,3), target
    (P,N,D_out)). Given ``cotangent_out`` (P, N, L*F), the feature
    cotangent goes there and the table gradient is left zero, as the
    kernel's split mode does."""
    loss, g = loss_and_grads(_unpacked(flat_p, n_hidden), coords, target,
                             resolutions, backends.resolve("ref"),
                             compute_dtype,
                             with_features=cotangent_out is not None)
    hid = g["mlp"][1:-1]
    grads = {"tab": g["tables"].float(), "win": g["mlp"][0].float(),
             "whid": (torch.stack(hid, 1).float() if hid
                      else torch.zeros_like(flat_p["whid"], dtype=torch.float32)),
             "wout": g["mlp"][-1].float()}
    if cotangent_out is not None:
        cotangent_out.copy_(g["features"])
        grads["tab"] = torch.zeros_like(grads["tab"])
    return grads, loss * float(target.shape[1] * target.shape[2])


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
