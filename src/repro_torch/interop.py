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

A checkpoint of a trainer state is the tree :func:`state_tree` gives
(``{"params", "opt", "loss_ma", "active", "step"}``, the same fields): the
port's :class:`~repro_torch.checkpoint.CheckpointManager` writes the JAX
package's layout, and :func:`state_from_checkpoint` restores one that either
package's manager wrote, leaf by leaf in the JAX leaf order, checked against
the manifest's shapes and dtypes.

An LM's parameters cross as the JAX ``init`` tree of numpy arrays of any
family (the same nested keys, layers stacked on a leading L axis, bf16
leaves as bf16), and its cache as one of the families' layouts: the
transformer's ``{"k", "v", "pos"}``, the SSM's ``{"ssm", "conv", "pos"}``,
the hybrid's ``{"ssm", "conv", "k", "v", "pos"}`` and the encoder-decoder's
``{"k", "v", "cross_k", "cross_v", "pos"}``.
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


def lm_params_from_numpy(np_params: dict, device="auto", *, cfg=None,
                         sharder=None) -> dict:
    """The JAX LM parameter tree as numpy arrays -> the port's tensors on
    ``device`` (``"auto"``: the GPU), keeping keys and dtypes. With a
    ``sharder`` on a mesh (and the model's ``cfg``): this rank's blocks
    (``parallel.sharding.shard_params``), cut on the host so that only
    they reach the device."""
    if sharder is not None and sharder.mesh is not None:
        from repro_torch.parallel.sharding import shard_params
        np_params = shard_params(np_params, cfg, sharder)
    return _tree_to_torch(np_params, resolve_device(device))


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM parameters -> numpy arrays in the JAX tree layout."""
    return _tree_to_numpy(params)


#: the cache layouts of the model families (besides ``"pos"``)
CACHE_LAYOUTS = (frozenset({"k", "v"}), frozenset({"ssm", "conv"}),
                 frozenset({"ssm", "conv", "k", "v"}),
                 frozenset({"k", "v", "cross_k", "cross_v"}))


def _cache_keys(cache: dict) -> None:
    keys = frozenset(cache) - {"pos"}
    if "pos" not in cache or keys not in CACHE_LAYOUTS:
        raise ValueError(f"not an LM cache layout: {sorted(cache)} (want 'pos' "
                         f"and one of {[sorted(k) for k in CACHE_LAYOUTS]})")


def lm_cache_from_numpy(np_cache: dict, device="auto") -> dict:
    """An LM cache as numpy (any family's layout, ``CACHE_LAYOUTS``) -> the
    port's cache on ``device``: each array with its dtype, ``pos`` a 0-d
    int32 tensor."""
    _cache_keys(np_cache)
    dev = resolve_device(device)
    out = {k: _to_torch(a, dev) for k, a in np_cache.items() if k != "pos"}
    out["pos"] = torch.as_tensor(int(np.asarray(np_cache["pos"])),
                                 dtype=torch.int32, device=dev)
    return out


def lm_cache_to_numpy(cache: dict) -> dict:
    """The port's LM cache -> numpy in the JAX layout (``pos`` a 0-d int32
    array)."""
    _cache_keys(cache)
    out = {k: _to_numpy(t) for k, t in cache.items() if k != "pos"}
    out["pos"] = np.asarray(int(cache["pos"]), np.int32)
    return out


def state_tree(state) -> dict:
    """A trainer state as the checkpoint tree ``{"params", "opt",
    "loss_ma", "active", "step"}`` (``step`` a 0-d int64 tensor; the
    non-finite detector is not kept)."""
    return {"params": state.params, "opt": state.opt, "loss_ma": state.loss_ma,
            "active": state.active,
            "step": torch.tensor(int(state.step), dtype=torch.int64)}


def state_from_tree(tree: dict):
    """The :class:`~repro_torch.core.trainer.DVNRState` of a checkpoint tree
    (:func:`state_tree`), its tensors where the tree has them."""
    from repro_torch.core.trainer import DVNRState

    return DVNRState(tree["params"], tree["opt"], tree["loss_ma"],
                     tree["active"], int(tree["step"]))


def state_from_checkpoint(directory, like, step=None):
    """``(state, metadata)`` of the checkpoint at ``step`` (default: the
    latest) in ``directory``, written by either package's manager for a
    trainer state of ``like``'s structure (a port ``DVNRState`` whose
    tensors also give the devices). A JAX checkpoint of a state is the dict
    ``{"params", "opt", "loss_ma", "active", "step"}`` of its fields."""
    from repro_torch.checkpoint import CheckpointManager

    tree, meta = CheckpointManager(directory).restore(state_tree(like), step)
    return state_from_tree(tree), meta
