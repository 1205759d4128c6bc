"""The plain version of the INR inference kernel: the two-kernel route's
function, the hash encode then the fused MLP, with the compute-dtype casts
of ``hash_encode_batched`` and ``fused_mlp_batched``."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_mlp.ref import fused_mlp_batched_ref
from repro_torch.kernels.hash_encoding.ref import hash_encode_batched_ref
from repro_torch.precision import torch_dtype


def inr_forward_ref(coords: torch.Tensor, tables: torch.Tensor, weights, part,
                    resolutions, compute_dtype=None) -> torch.Tensor:
    """coords (B,N,3) f32 against partition-stacked tables (P,L,T,F) and MLP
    weights; row ``b`` runs partition ``part[b]`` -> (B,N,D_out). With a
    ``compute_dtype`` the tables are cast to it before the encode and the
    features and weights before the MLP, as the route's casts do."""
    part = torch.as_tensor(part).to(coords.device)
    if compute_dtype is not None:
        tables = tables.to(torch_dtype(compute_dtype))
    feats = hash_encode_batched_ref(coords, tables, resolutions, part)
    if compute_dtype is not None:
        dt = torch_dtype(compute_dtype)
        feats, weights = feats.to(dt), [w.to(dt) for w in weights]
    return fused_mlp_batched_ref(feats, list(weights), part)
