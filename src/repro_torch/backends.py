"""Backend registry and device resolution.

The same op names (``OPS``) as ``repro.backends``; two backends:

- ``ref``   plain PyTorch on any device — the reference every kernel is held
            against, and what the tests run on the CPU;
- ``cuda``  the hand-written CUDA kernels (``repro_torch/csrc``) for the ops
            it lists; highest priority. Its wrappers take the plain version
            only for tensors that lie on the CPU: on a CUDA tensor they launch
            the kernel or raise.

``resolve("auto")`` picks the highest-priority backend for the card and
raises when there is no CUDA device: the entry points run on the GPU unless
the caller asks for the CPU (``device="cpu"`` with ``backend="ref"`` or
``"cuda"``). Nothing falls back from the GPU to the CPU by itself.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple, Union

import torch

from repro_torch.precision import SUPPORTED_DTYPES, torch_dtype

OPS = ("hash_encoding", "fused_mlp", "composite", "flash_attention",
       "fused_train_step", "fused_sampling", "tiled_sampling", "brick_cache")

#: ops the port implements (every op of ``OPS``)
PORTED_OPS = frozenset({"hash_encoding", "fused_mlp", "composite",
                        "flash_attention", "fused_train_step",
                        "fused_sampling", "tiled_sampling", "brick_cache"})


@dataclass(frozen=True)
class Backend:
    """One kernel implementation family plus its capability metadata.

    ``kind`` is what the op wrappers branch on: ``"torch"`` (plain PyTorch)
    or ``"cuda"`` (hand-written kernels)."""

    name: str
    kind: str
    description: str = ""
    platforms: Tuple[str, ...] = ("cpu", "cuda")
    priority: int = 0
    capabilities: frozenset = field(default_factory=frozenset)
    dtypes: Tuple[str, ...] = SUPPORTED_DTYPES
    # default device-memory budget of a BrickCache pool on this backend
    cache_budget_bytes: int = 64 * 2**20

    @property
    def is_cuda(self) -> bool:
        return self.kind == "cuda"

    def supports(self, op: str) -> bool:
        return op in self.capabilities

    def require_dtype(self, dtype, role: str = "compute") -> torch.dtype:
        """Resolve ``dtype`` and raise if this backend cannot run it."""
        dt = torch_dtype(dtype)
        if str(dt).replace("torch.", "") not in self.dtypes:
            raise ValueError(f"backend {self.name!r} does not support "
                             f"{role} dtype {dt}")
        return dt

    def available(self) -> bool:
        return "cuda" in self.platforms and torch.cuda.is_available()

    def __repr__(self) -> str:
        return f"Backend({self.name!r})"


BackendLike = Union[str, Backend]

_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    _REGISTRY[backend.name] = backend
    return backend


def available_backends() -> Tuple[str, ...]:
    """Names of registered backends runnable on this machine's card."""
    return tuple(n for n, b in _REGISTRY.items() if b.available())


def _no_cuda_error(what: str) -> RuntimeError:
    return RuntimeError(
        f"{what}: no CUDA device is available. The port runs on the GPU; "
        f"pass device='cpu' (and backend='ref' or 'cuda') to run the plain "
        f"PyTorch versions on the CPU explicitly.")


def resolve(impl: BackendLike = "auto") -> Backend:
    """Name / ``"auto"`` / Backend -> Backend. ``"auto"`` raises without CUDA."""
    if isinstance(impl, Backend):
        return impl
    if impl == "auto":
        if not torch.cuda.is_available():
            raise _no_cuda_error("backend 'auto'")
        return max((b for b in _REGISTRY.values() if b.available()),
                   key=lambda b: b.priority)
    try:
        return _REGISTRY[impl]
    except KeyError:
        raise ValueError(f"unknown backend {impl!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


def resolve_device(device="auto") -> torch.device:
    """``"auto"`` -> the current CUDA device (raises without one); anything
    else is taken as the caller's explicit choice."""
    if isinstance(device, torch.device):
        return device
    if device == "auto":
        if not torch.cuda.is_available():
            raise _no_cuda_error("device 'auto'")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


register_backend(Backend(
    name="ref", kind="torch",
    description="plain PyTorch versions of every op; any device",
    priority=10, capabilities=PORTED_OPS,
))

register_backend(Backend(
    name="cuda", kind="cuda",
    description="hand-written CUDA C++ kernels for sm_90a (H100); the plain "
                "versions only for CPU tensors",
    platforms=("cuda",), priority=100, capabilities=PORTED_OPS,
    dtypes=("float32", "bfloat16"),
))
