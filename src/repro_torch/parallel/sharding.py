"""The part of ``repro.parallel.sharding`` the single-card LM path needs.

``padded_vocab`` fixes the embedding and head shapes, so the port keeps it to
hold the JAX parameter layout. The ``Sharder`` (logical axes -> mesh axes)
waits for multi-GPU (ROADMAP item 14): every ``sharder`` argument of the
port accepts ``None`` only, through :func:`require_no_sharder`.
"""
from __future__ import annotations


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad vocab so embedding/head shards divide evenly on any reasonable mesh."""
    return int(-(-vocab // multiple) * multiple)


def require_no_sharder(sharder) -> None:
    """Raise unless ``sharder`` is None: the port runs on one card."""
    if sharder is not None:
        raise NotImplementedError(
            "sharded execution is not ported yet (ROADMAP item 14): pass "
            "sharder=None")
