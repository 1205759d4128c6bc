"""Deterministic synthetic LM data pipeline (numpy only; the same batches,
bit for bit, as ``repro.data.lm``).

An "infinite corpus" derived from a counter-based PRNG: every (step, shard) pair
maps to the same tokens on any host, so multi-host input pipelines need no
coordination and restarts are bitwise reproducible (fault-tolerance requirement).
A Zipf-like marginal over the vocabulary gives the loss realistic structure.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int, alpha: float = 1.1):
    # inverse-CDF sampling of a truncated zipf via uniform powers (fast, vectorized)
    u = rng.random(shape)
    ranks = np.floor((vocab ** (1 - alpha) - 1) * u + 1) ** (1 / (1 - alpha))
    return np.clip(ranks.astype(np.int64) - 1, 0, vocab - 1).astype(np.int32)


def make_lm_batch(step: int, batch: int, seq_len: int, vocab: int,
                  shard: int = 0, input_mode: str = "tokens",
                  d_model: int = 0, family: str = "dense") -> dict:
    """Pure function (step, shard) -> batch dict (numpy, ready for device_put)."""
    rng = np.random.default_rng(np.random.SeedSequence([step, shard, 0xD17A]))
    toks = _zipf_tokens(rng, (batch, seq_len + 1), vocab)
    if family == "encdec":
        emb = rng.standard_normal((batch, seq_len, d_model), dtype=np.float32)
        return {"src_embeds": emb, "tgt_tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if input_mode == "embeds":
        emb = rng.standard_normal((batch, seq_len, d_model), dtype=np.float32)
        pos = np.broadcast_to(np.arange(seq_len, dtype=np.int32), (batch, seq_len))
        return {"embeds": emb, "labels": toks[:, 1:],
                "positions": np.broadcast_to(pos[None], (3, batch, seq_len)).copy()}
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class SyntheticTokens:
    """Stateful iterator facade with checkpointable cursor."""

    def __init__(self, cfg, batch: int, seq_len: int, shard: int = 0, start_step: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.shard = shard
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = make_lm_batch(self.step, self.batch, self.seq_len, self.cfg.vocab,
                          self.shard, self.cfg.input_mode, self.cfg.d_model,
                          self.cfg.family)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"step": self.step, "shard": self.shard}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])
        self.shard = int(s["shard"])
