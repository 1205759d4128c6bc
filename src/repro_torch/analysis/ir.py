"""Program capture for the port's static checks: the counterpart of the JAX
package's ``repro.analysis.ir`` (whose jaxpr, stableHLO and compiled HLO a
PyTorch program does not have).

:func:`capture` wraps ``fn(*args)``; its :class:`ProgramArtifacts` runs the
program ONCE, on the first read of any artifact, under a
``TorchDispatchMode`` that records every operation reaching PyTorch's
dispatcher (:class:`OpSite`: its namespace and name, the floating dtypes of
its tensor operands, the kernel region it ran in, and which watched tensors
it read), and the kernel regions that the kernel wrappers enter
(:func:`repro_torch.kernels.build.kernel_region`: one :class:`KernelSite`
each, with the dtypes of the operands its products take and the launches it
plans). A kernel region is the counterpart of a ``pallas_call``: a ctypes
launch never reaches the dispatcher, and on the CPU the region holds the
operations of the kernel's plain version, which the checks read as the
kernel's (``OpSite.region``).

The mode passes every operation through unchanged: a captured run gives the
bits a plain run gives. Artifact levels: ``"trace"`` (the ops and regions,
any device) and ``"device"`` (each launched kernel's attributes from the
compiled library, :attr:`ProgramArtifacts.launched`, when the program ran
on the card).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import build


@dataclass(frozen=True)
class OpSite:
    """One operation a program dispatched."""

    namespace: str           # "aten", "c10d", "_c10d_functional", ...
    op: str                  # the overload packet's name: "mm", "index", ...
    dtypes: Tuple            # floating dtypes of its tensor operands
    region: Optional[str]    # the kernel region it ran in, or None
    aliases: frozenset       # watched tensors whose storage it read

    @property
    def name(self) -> str:
        return f"{self.namespace}::{self.op}"


@dataclass(frozen=True)
class KernelSite:
    """One call of a kernel wrapper (a kernel region)."""

    name: str                # the region's name: "train_step", ...
    dtypes: Tuple            # floating dtypes of the operands of its products
    device: str              # "cuda" (the kernels launched) or "cpu"
    plan: Tuple              # ((kernel family, dynamic shared bytes), ...)


def _float_dtypes(objs) -> Tuple:
    out = []
    for x in tree_leaves(list(objs)):
        dt = x.dtype if isinstance(x, torch.Tensor) else x
        if isinstance(dt, torch.dtype) and dt.is_floating_point and dt not in out:
            out.append(dt)
    return tuple(out)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None


class _Recorder(TorchDispatchMode):
    def __init__(self, watch: Dict[str, torch.Tensor]):
        super().__init__()
        self.ops: List[OpSite] = []
        self.kernels: List[KernelSite] = []
        self._stack: List[str] = []
        self._watch = {name: _storage(t) for name, t in watch.items()}

    # kernel regions (build.kernel_region): a region inside a region is the
    # outer one's
    def enter_region(self, name, operands, plan):
        if not self._stack:
            tensors = [x for x in tree_leaves(list(operands))
                       if isinstance(x, torch.Tensor)]
            self.kernels.append(KernelSite(
                name, _float_dtypes(operands),
                tensors[0].device.type if tensors else "cpu",
                tuple(plan()) if plan is not None else ()))
        self._stack.append(name)

    def exit_region(self):
        self._stack.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [x for x in tree_leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)]
        ptrs = {_storage(t) for t in tensors}
        self.ops.append(OpSite(
            getattr(func, "namespace", ""), func._overloadpacket.__name__,
            _float_dtypes(tensors), self._stack[0] if self._stack else None,
            frozenset(n for n, p in self._watch.items()
                      if p is not None and p in ptrs)))
        return func(*args, **kwargs)


def _output_leaves(out) -> List[torch.Tensor]:
    """The tensors of a program's result: through tuples, lists, dicts and
    dataclasses (a ``DVNRState``)."""
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _output_leaves(x)]
    return []


#: the attributes ``repro_kernel_launches`` fills, in its order
LAUNCH_FIELDS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
                 "launches")


def launched_kernels() -> List[dict]:
    """The kernels launched since the last :func:`reset_launches`, each a
    dict of ``LAUNCH_FIELDS`` and its mangled ``name``, read through the
    library's ``repro_kernel_launches`` (``cudaFuncGetAttributes``)."""
    import ctypes

    lib = build.library()
    attrs = (ctypes.c_longlong * len(LAUNCH_FIELDS))()
    name = ctypes.create_string_buffer(1024)
    rows, i = [], 0
    while True:
        n = lib.repro_kernel_launches(i, ctypes.addressof(attrs), name, 1024)
        if n < 0:
            raise RuntimeError(f"repro_kernel_launches: CUDA error {-n}")
        if i >= n:
            return rows
        rows.append({"name": name.value.decode(),
                     **dict(zip(LAUNCH_FIELDS, (int(a) for a in attrs)))})
        i += 1


def reset_launches() -> None:
    """Forget the launches the library noted so far."""
    build.library().repro_kernel_launches(-1, None, None, 0)


class ProgramArtifacts:
    """One program under analysis, run once on the first read."""

    def __init__(self, name: str, fn: Callable, args: tuple, *,
                 watch: Optional[Dict[str, torch.Tensor]] = None):
        self.name = name
        self.fn = fn
        self.args = args
        self.watch = dict(watch or {})
        self._ran = False
        self._ops: List[OpSite] = []
        self._kernels: List[KernelSite] = []
        self._outputs = None
        self._launched: Optional[List[dict]] = None

    def run(self) -> "ProgramArtifacts":
        if self._ran:
            return self
        on_card = build._lib is not None
        if on_card:
            reset_launches()
        rec = _Recorder(self.watch)
        build._recorders.append(rec)
        try:
            with rec:
                self._outputs = self.fn(*self.args)
        finally:
            build._recorders.remove(rec)
        self._ops, self._kernels = rec.ops, rec.kernels
        if any(k.device == "cuda" for k in self._kernels):
            torch.cuda.synchronize()
            self._launched = launched_kernels()
        self._ran = True
        return self

    @property
    def ops(self) -> List[OpSite]:
        return self.run()._ops

    @property
    def kernels(self) -> List[KernelSite]:
        return self.run()._kernels

    @property
    def outputs(self):
        return self.run()._outputs

    def output_leaves(self) -> List[torch.Tensor]:
        return _output_leaves(self.outputs)

    @property
    def launched(self) -> Optional[List[dict]]:
        """Each kernel the run launched on the card with its attributes
        (:func:`launched_kernels`); None when no kernel region ran there."""
        return self.run()._launched


def capture(fn: Callable, *args, name: Optional[str] = None,
            watch: Optional[Dict[str, torch.Tensor]] = None) -> ProgramArtifacts:
    """Wrap ``fn(*args)`` for analysis (run on the first read). ``watch``
    names tensors whose reads the checks follow (``"volume"``: the training
    volume, for ``rng_gather_placement``)."""
    return ProgramArtifacts(name or getattr(fn, "__name__", "program"), fn,
                            args, watch=watch)
