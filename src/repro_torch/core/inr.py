"""The base INR: multi-resolution hash encoding + small ReLU MLP (paper §III).

The port of ``repro.core.inr``. Parameters are a dict in the JAX package's
layout: ``{"tables": (L,T,F), "mlp": [(L*F,W), (W,W)..., (W,out_dim)]}``, or
with a leading partition axis on every leaf for a partition-stacked model.
"""
from __future__ import annotations

import warnings

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import backends
from repro_torch.backends import resolve_device
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.precision import torch_dtype
from repro_torch.kernels.fused_mlp.ops import fused_mlp, fused_mlp_batched
from repro_torch.kernels.hash_encoding.ops import hash_encode, hash_encode_batched
from repro_torch.kernels.inr_forward import inr_forward_cuda, refusal


def _uniform(shape, lo: float, hi: float, generator: torch.Generator):
    return torch.rand(shape, generator=generator, dtype=torch.float32) \
        * (hi - lo) + lo


def init_inr(cfg: DVNRConfig, generator: Optional[torch.Generator] = None,
             in_dim: int = 3, *, device="auto") -> dict:
    """Random INR parameters: tables ~ U(-1e-4, 1e-4) (instant-ngp), MLP
    He-uniform. Drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; default seed 0) and moved to ``device``. The draws
    are PyTorch's, not ``jax.random``'s: carry JAX weights across with
    :func:`repro_torch.interop.params_from_numpy`."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    W, H = cfg.n_neurons, cfg.n_hidden_layers
    tables = _uniform((L, T, F), -1e-4, 1e-4, g)
    dims = [L * F] + [W] * H + [cfg.out_dim]
    mlp = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = float(np.sqrt(6.0 / din))
        mlp.append(_uniform((din, dout), -bound, bound, g).to(dev))
    return {"tables": tables.to(dev), "mlp": mlp}


def _inference(b: backends.Backend, params: dict, coords: torch.Tensor,
               compute_dtype) -> bool:
    """Take the one-launch inference kernel (``inr_forward_cuda``)? On the
    ``cuda`` backend when no gradient is needed (grad mode off, or neither
    the coordinates nor any parameter requires grad) and the kernel takes
    the operands (``refusal``); else the two autograd ops (hash encode, then
    fused MLP)."""
    leaves = [coords, params["tables"], *params["mlp"]]
    if not b.is_cuda or (torch.is_grad_enabled()
                         and any(t.requires_grad for t in leaves)):
        return False
    return refusal(coords, params["tables"], params["mlp"], compute_dtype) is None


def _inr_apply(cfg: DVNRConfig, params: dict, coords: torch.Tensor,
               backend: backends.BackendLike = "ref",
               compute_dtype=None) -> torch.Tensor:
    """coords (N,3) in [0,1]^3 -> (N, out_dim) in the params' (or
    ``compute_dtype``'s) dtype; coords stay f32."""
    b = backends.resolve(backend)
    single = {"tables": params["tables"][None],
              "mlp": [w[None] for w in params["mlp"]]}
    if _inference(b, single, coords[None], compute_dtype):
        return inr_forward_cuda(coords[None], single["tables"], single["mlp"],
                                [0], cfg.level_resolutions(), compute_dtype)[0]
    feats = hash_encode(coords, params["tables"], cfg.level_resolutions(), b,
                        compute_dtype=compute_dtype)
    return fused_mlp(feats, params["mlp"], b, compute_dtype=compute_dtype)


def _inr_apply_batched(cfg: DVNRConfig, stacked_params: dict,
                       coords: torch.Tensor, part,
                       backend: backends.BackendLike = "ref",
                       compute_dtype=None) -> torch.Tensor:
    """coords (B,N,3) against partition-stacked params; row ``b`` runs the
    INR of partition ``part[b]`` -> (B, N, out_dim). One encode launch and
    one MLP launch for every row: the counterpart of ``jax.vmap`` over
    partitions (and over the clients of a render-service tick). Without
    a gradient the ``cuda`` backend runs both in one launch instead
    (:func:`_inference`)."""
    b = backends.resolve(backend)
    if _inference(b, stacked_params, coords, compute_dtype):
        return inr_forward_cuda(coords, stacked_params["tables"],
                                stacked_params["mlp"], part,
                                cfg.level_resolutions(), compute_dtype)
    feats = hash_encode_batched(coords, stacked_params["tables"],
                                cfg.level_resolutions(), part, b,
                                compute_dtype=compute_dtype)
    return fused_mlp_batched(feats, stacked_params["mlp"], part, b,
                             compute_dtype=compute_dtype)


def _decode_grid(cfg: DVNRConfig, params: dict, shape: Sequence[int],
                 backend: backends.BackendLike = "ref",
                 chunk: int = 1 << 22, *, compute_dtype=None,
                 out_dtype=None) -> torch.Tensor:
    """Decode the INR back to a cell-centred grid (the paper's compatibility
    path). Points are decoded ``chunk`` at a time (the values do not depend
    on it: every point is independent)."""
    b = backends.resolve(backend)
    nx, ny, nz = shape
    dev = params["tables"].device
    axes = [(torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
            for n in shape]
    coords = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    outs = [_inr_apply(cfg, params, coords[i:i + chunk], b,
                       compute_dtype=compute_dtype)
            for i in range(0, coords.shape[0], chunk)]
    out = torch.cat(outs, 0)
    if out_dtype is not None:
        out = out.to(torch_dtype(out_dtype))
    if cfg.out_dim == 1:
        return out.reshape(nx, ny, nz)
    return out.reshape(nx, ny, nz, cfg.out_dim)


# --------------------------------------------------------------------------- #
# Deprecated free-function API (pre-DVNRModel)
# --------------------------------------------------------------------------- #
def inr_apply(cfg: DVNRConfig, params: dict, coords: torch.Tensor,
              impl: backends.BackendLike = "ref") -> torch.Tensor:
    """Deprecated: use ``repro_torch.api.DVNRModel(cfg, params).apply(coords)``."""
    warnings.warn("inr_apply(cfg, params, coords, impl=...) is deprecated; "
                  "use repro_torch.api.DVNRModel(cfg, params).apply(coords, "
                  "backend=...)", DeprecationWarning, stacklevel=2)
    return _inr_apply(cfg, params, coords, impl)


def decode_grid(cfg: DVNRConfig, params: dict, shape: Sequence[int],
                impl: backends.BackendLike = "ref",
                chunk: int = 1 << 17) -> torch.Tensor:
    """Deprecated: use ``repro_torch.api.DVNRModel(cfg, params).decode_grid(shape)``."""
    warnings.warn("decode_grid(cfg, params, shape, impl=...) is deprecated; "
                  "use repro_torch.api.DVNRModel(cfg, params).decode_grid(shape)",
                  DeprecationWarning, stacklevel=2)
    return _decode_grid(cfg, params, shape, impl, chunk)


def param_count(cfg: DVNRConfig, in_dim: int = 3) -> int:
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    W, H = cfg.n_neurons, cfg.n_hidden_layers
    dims = [L * F] + [W] * H + [cfg.out_dim]
    return L * T * F + sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def param_bytes_f16(cfg: DVNRConfig) -> int:
    """Model size with fp16 weight storage (paper's on-disk format)."""
    return 2 * param_count(cfg)
