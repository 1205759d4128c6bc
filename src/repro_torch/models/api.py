"""Unified model API: build_model(config) -> Model with init/loss/prefill/decode.

The port's counterpart of ``repro.models.api``. The ``dense`` and ``vlm``
families build (the transformer stack); MoE, SSM, hybrid and enc-dec models
wait for later slices and raise ``NotImplementedError`` naming their
ROADMAP item.

The entry points run on the card unless the caller asks for the CPU:
``init`` and ``init_cache`` take ``device="auto"`` (the GPU; raises without
one), ``prefill`` and ``loss`` take ``impl="auto"`` (the ``cuda`` backend;
raises without a GPU). ``device="cpu"`` with ``impl="ref"`` runs the plain
PyTorch versions on the CPU. (JAX's ``input_specs``, the dry-run's shape
stand-ins, waits for the dry-run tools, ROADMAP item 16.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import backends
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

#: families not ported yet -> the ROADMAP item that ports them
_NOT_PORTED = {
    "moe": "ROADMAP item 16 (MoE layers)",
    "ssm": "ROADMAP item 16 (SSM / hybrid / enc-dec models)",
    "hybrid": "ROADMAP item 16 (SSM / hybrid / enc-dec models)",
    "encdec": "ROADMAP item 16 (SSM / hybrid / enc-dec models)",
}


@dataclass
class Model:
    config: ModelConfig
    init: Callable[..., Any]                         # (seed | Generator, device) -> params
    loss: Callable[..., tuple]                       # (params, batch, sharder, impl) -> (loss, metrics)
    prefill: Optional[Callable[..., tuple]]          # (params, batch, seq_len, sharder, impl) -> (logits, cache)
    decode_step: Optional[Callable[..., tuple]]      # (params, cache, tokens, sharder) -> (logits, cache)
    init_cache: Optional[Callable[..., Any]]         # (batch, seq_len, device) -> cache


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return _build_transformer(cfg)
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: the {fam!r} family is not "
                                  f"ported yet: {_NOT_PORTED[fam]}")
    raise ValueError(f"unknown family {fam!r}")


def _generator(rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=backends.resolve_device(device))
    gen.manual_seed(int(rng))
    return gen


def _build_transformer(cfg) -> Model:
    t = transformer

    def init(rng=0, device="auto"):
        """``rng``: an int seed or a ``torch.Generator`` (its device wins)."""
        return t.init_lm(cfg, _generator(rng, device))

    def loss(params, batch, sharder=None, impl="auto"):
        return t.lm_loss(cfg, params, batch, sharder, backends.resolve(impl))

    def prefill(params, batch, seq_len, sharder=None, impl="auto"):
        return t.prefill(cfg, params, batch, seq_len, sharder,
                         backends.resolve(impl))

    def decode_step(params, cache, tokens, sharder=None):
        return t.decode_step(cfg, params, cache, tokens, sharder)

    def init_cache(batch, seq_len, device="auto"):
        return t.init_cache(cfg, batch, seq_len, backends.resolve_device(device))

    return Model(cfg, init, loss, prefill, decode_step, init_cache)
