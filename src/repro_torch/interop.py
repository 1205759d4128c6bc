"""Parameters and trainer states to and from the JAX package's numpy export.

The JAX package's INR parameters are ``{"tables": ..., "mlp": [...]}`` of
arrays; ``jax.tree.map(np.asarray, params)`` exports them as numpy arrays,
which these functions carry across in either direction, single
(``tables (L,T,F)``) or partition-stacked (``tables (P,L,T,F)``), keeping
each array's dtype. bfloat16 arrays (numpy's ``ml_dtypes`` extension type)
cross as their raw 16-bit patterns.

A whole trainer state crosses as the numpy dict ``{"params", "opt":
{"step", "m", "v"[, "mw"]}, "loss_ma", "active", "step"}`` — the JAX
``DVNRState``'s fields through ``jax.tree.map(np.asarray, ...)`` — so both
packages can start from one state.

An LM's parameters cross as the JAX ``init_lm`` tree of numpy arrays (the
same nested keys, layers stacked on a leading L axis), and its KV cache as
``{"k", "v", "pos"}``.
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


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return _to_torch(tree, device)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_numpy(v) for v in tree]
    return _to_numpy(tree)


def state_from_numpy(np_state: dict, device="auto"):
    """A trainer state as numpy (params, opt step/m/v[/mw], loss_ma,
    active, step) -> the port's :class:`~repro_torch.core.trainer.DVNRState`
    on ``device`` (``"auto"``: the GPU)."""
    from repro_torch.core.trainer import DVNRState

    dev = resolve_device(device)
    return DVNRState(_tree_to_torch(np_state["params"], dev),
                     _tree_to_torch(np_state["opt"], dev),
                     _to_torch(np_state["loss_ma"], dev),
                     _to_torch(np_state["active"], dev),
                     int(np_state["step"]))


def state_to_numpy(state) -> dict:
    """The port's trainer state -> the numpy dict of :func:`state_from_numpy`."""
    return {"params": _tree_to_numpy(state.params),
            "opt": _tree_to_numpy(state.opt),
            "loss_ma": _to_numpy(state.loss_ma),
            "active": _to_numpy(state.active),
            "step": int(state.step)}


def lm_params_from_numpy(np_params: dict, device="auto") -> dict:
    """The JAX LM parameter tree as numpy arrays -> the port's tensors on
    ``device`` (``"auto"``: the GPU), keeping keys and dtypes."""
    return _tree_to_torch(np_params, resolve_device(device))


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM parameters -> numpy arrays in the JAX tree layout."""
    return _tree_to_numpy(params)


def lm_cache_from_numpy(np_cache: dict, device="auto") -> dict:
    """A KV cache ``{"k", "v", "pos"}`` as numpy -> the port's cache on
    ``device``: k/v (L,B,S,Hkv,dh) and ``pos`` a 0-d int32 tensor."""
    dev = resolve_device(device)
    return {"k": _to_torch(np_cache["k"], dev), "v": _to_torch(np_cache["v"], dev),
            "pos": torch.as_tensor(int(np.asarray(np_cache["pos"])),
                                   dtype=torch.int32, device=dev)}
