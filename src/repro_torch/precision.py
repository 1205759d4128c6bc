"""Mixed-precision policy, with torch dtypes.

The same policy strings and the same :class:`Precision` fields as
``repro.precision`` (param / compute / output / master dtype names), so a
``DVNRConfig.precision`` string means the same thing in both packages. The
``*_torch`` properties give the ``torch.dtype`` of each role.

- ``"f32"`` / ``"float32"``  everything float32 (the default);
- ``"bf16"`` / ``"mixed"``   bf16 params and compute, f32 output and master;
- ``"bf16_out"``             bf16 everywhere, output included;
- ``"<param>/<compute>/<output>"``  an explicit triple, e.g. ``"bf16/f32/f32"``.

Coordinates stay float32 on every path: hash-grid positions need the mantissa.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_DTYPE_ALIASES = {
    "f32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "float16": "float16",
}

#: dtypes a kernel backend may declare support for (see repro_torch.backends)
SUPPORTED_DTYPES = ("float32", "bfloat16", "float16")

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _canon_dtype(name) -> str:
    if isinstance(name, torch.dtype):
        name = str(name).replace("torch.", "")
    try:
        return _DTYPE_ALIASES[str(name).strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision dtype {name!r}; one of {sorted(_DTYPE_ALIASES)}"
        ) from None


def torch_dtype(name) -> torch.dtype:
    """A dtype name, alias or ``torch.dtype`` -> ``torch.dtype``."""
    return _TORCH[_canon_dtype(name)]


@dataclass(frozen=True)
class Precision:
    """param/compute/output dtype policy (default: bf16 train, f32 out)."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    output_dtype: str = "float32"
    master_dtype: str = "float32"

    def __post_init__(self):
        for f in ("param_dtype", "compute_dtype", "output_dtype", "master_dtype"):
            object.__setattr__(self, f, _canon_dtype(getattr(self, f)))

    @property
    def param_torch(self) -> torch.dtype:
        return _TORCH[self.param_dtype]

    @property
    def compute_torch(self) -> torch.dtype:
        return _TORCH[self.compute_dtype]

    @property
    def output_torch(self) -> torch.dtype:
        return _TORCH[self.output_dtype]

    @property
    def needs_master(self) -> bool:
        """Params are narrower than the optimizer's reference precision."""
        return self.param_dtype != self.master_dtype

    @property
    def name(self) -> str:
        """Canonical policy string; ``resolve_precision(p.name) == p``."""
        if self == F32:
            return "f32"
        if self == MIXED_BF16:
            return "bf16"
        if self == _NAMED["bf16_out"]:
            return "bf16_out"
        return "/".join(_SHORT[d] for d in
                        (self.param_dtype, self.compute_dtype, self.output_dtype))


_SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}

F32 = Precision("float32", "float32", "float32")
MIXED_BF16 = Precision()

_NAMED = {
    "f32": F32, "float32": F32, "fp32": F32, "": F32,
    "bf16": MIXED_BF16, "bfloat16": MIXED_BF16, "mixed": MIXED_BF16,
    "bf16_out": Precision(output_dtype="bfloat16"),
}


def resolve_precision(policy=None) -> Precision:
    """None / policy name / "p/c/o" triple / Precision -> Precision."""
    if policy is None:
        return F32
    if isinstance(policy, Precision):
        return policy
    key = str(policy).strip().lower()
    if key in _NAMED:
        return _NAMED[key]
    if "/" in key:
        parts = [p for p in key.split("/") if p]
        if len(parts) != 3:
            raise ValueError(
                f"precision triple must be param/compute/output, got {policy!r}")
        return Precision(*parts)
    raise ValueError(
        f"unknown precision policy {policy!r}; named policies: "
        f"{sorted(k for k in _NAMED if k)} or a 'param/compute/output' triple")
