"""Parameters to and from the JAX package's numpy export.

The JAX package's INR parameters are ``{"tables": ..., "mlp": [...]}`` of
arrays; ``jax.tree.map(np.asarray, params)`` exports them as numpy arrays,
which these functions carry across in either direction, single
(``tables (L,T,F)``) or partition-stacked (``tables (P,L,T,F)``), keeping
each array's dtype. bfloat16 arrays (numpy's ``ml_dtypes`` extension type)
cross as their raw 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backends import resolve_device


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 type, as JAX hands it out
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(np_params: dict, device="auto") -> dict:
    """The JAX package's parameters as numpy arrays -> the port's tensors on
    ``device`` (``"auto"``: the GPU)."""
    dev = resolve_device(device)
    return {"tables": _to_torch(np_params["tables"], dev),
            "mlp": [_to_torch(w, dev) for w in np_params["mlp"]]}


def params_to_numpy(params: dict) -> dict:
    """The port's parameters -> numpy arrays in the JAX package's layout."""
    return {"tables": _to_numpy(params["tables"]),
            "mlp": [_to_numpy(w) for w in params["mlp"]]}
