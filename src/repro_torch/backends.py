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

The JAX package's knobs are here too: :func:`get_backend`,
:func:`set_default_backend` (pin what ``"auto"`` resolves to),
:func:`resolve_auto` and :meth:`Backend.supports_dtype`. A pin chooses a
backend, never a device: pinning ``"cuda"`` without a card raises, and a
pinned ``"ref"`` still runs where the caller's tensors lie
(``resolve_device("auto")`` still needs the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

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

    def supports_dtype(self, dtype) -> bool:
        """Does this backend's kernel family take ``dtype`` natively (no
        silent float32 widening)? ``dtype``: a torch dtype or a name."""
        return str(torch_dtype(dtype)).replace("torch.", "") in self.dtypes

    def require_dtype(self, dtype, role: str = "compute") -> torch.dtype:
        """Resolve ``dtype`` and raise if this backend cannot run it."""
        dt = torch_dtype(dtype)
        if not self.supports_dtype(dt):
            raise ValueError(f"backend {self.name!r} does not support "
                             f"{role} dtype {dt}")
        return dt

    def available(self, platform: Optional[str] = None) -> bool:
        """Can this backend run on ``platform`` ("cpu" or "cuda"; default:
        the card, which must be present)?"""
        if platform is None or platform == "cuda":
            return "cuda" in self.platforms and torch.cuda.is_available()
        return platform in self.platforms

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


def get_backend(name: BackendLike) -> Backend:
    """Look up a backend by name (or pass a ``Backend`` through); ``"auto"``
    is :func:`resolve_auto`."""
    if isinstance(name, Backend):
        return name
    if name == "auto":
        return resolve_auto()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


_DEFAULT_OVERRIDE: Optional[str] = None


def set_default_backend(name: Optional[str]) -> None:
    """Pin what ``resolve("auto")`` returns (``None`` clears the pin), as
    the JAX package's knob does. A backend that runs only on the card
    cannot be pinned without one: no pin turns ``"auto"`` into a CPU run."""
    global _DEFAULT_OVERRIDE
    if name is not None:
        if name == "auto":
            raise ValueError("cannot pin the default backend to 'auto'")
        backend = get_backend(name)             # validate eagerly
        if not (backend.available() or backend.available("cpu")):
            raise ValueError(
                f"cannot pin default backend {name!r}: not available without "
                "a CUDA device")
    _DEFAULT_OVERRIDE = name


def resolve_auto(platform: Optional[str] = None) -> Backend:
    """The highest-priority backend available on ``platform`` (default:
    the card, and a ``RuntimeError`` without one); a
    :func:`set_default_backend` pin overrides the ranking."""
    if _DEFAULT_OVERRIDE is not None:
        return _REGISTRY[_DEFAULT_OVERRIDE]
    if platform in (None, "cuda") and not torch.cuda.is_available():
        raise _no_cuda_error("backend 'auto'")
    return max((b for b in _REGISTRY.values() if b.available(platform)),
               key=lambda b: b.priority)


def resolve(impl: BackendLike = "auto") -> Backend:
    """Name / ``"auto"`` / Backend -> Backend. ``"auto"`` raises without
    CUDA unless a backend is pinned (:func:`set_default_backend`)."""
    return get_backend(impl)


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
