"""The deterministic routes' int64 fixed-point sums (``csrc/hash_grid.cuh``):
a contribution ``v`` is added as ``round(v * 2**FX_SHIFT)``, so the sum of
an entry does not depend on the order of its adds. A contribution must keep
``M * |v| <= FX_BOUND``, M the points of one partition (the batch of the
fused train step; N times the partition's rows in the hash backward), so
that an entry's at most 8 M adds stay inside int64; past it the partition's flag gets
``FX_OVER`` (a NaN or Inf contribution: ``FX_NONFINITE``), its gradient is
NaN and the caller raises :class:`FixedPointOverflowError`."""
from __future__ import annotations

FX_SHIFT = 47
FX_BOUND = 4096.0
FX_NONFINITE = 1
FX_OVER = 2


class FixedPointOverflowError(FloatingPointError):
    """A table-gradient contribution of a deterministic route left the
    fixed-point bound (``M * |w * g| > FX_BOUND``): the sum could have
    wrapped, so the step is refused rather than kept."""


def raise_on_overflow(flags, what: str, names=None) -> None:
    """Raise :class:`FixedPointOverflowError` if any partition's entry of
    ``flags`` ((P,) int64 flag bits) has ``FX_OVER`` (one host read);
    ``names`` maps a row to the partition it reports."""
    over = (flags & FX_OVER).cpu().numpy()
    if over.any():
        rows = [int(p) if names is None else names[int(p)]
                for p in over.nonzero()[0]]
        raise FixedPointOverflowError(
            f"{what}, partitions {rows}: a table-gradient contribution left "
            f"the deterministic route's fixed-point bound (M |w g| <= {FX_BOUND})")
