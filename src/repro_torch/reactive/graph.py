"""DIVA-like reactive dataflow runtime (paper §IV).

The port's own copy of ``repro.reactive.graph`` (pure Python; the window's
byte count reads tensors as well as numpy arrays). Pull-based lazy
evaluation over a per-timestep clock:

- ``Source`` nodes are fed by the in situ session each visualization step.
- Derived nodes (``map``/``combine``) memoize per clock tick and evaluate ONLY
  when pulled — the paper's referential transparency: a DVNR constructor node
  whose value no trigger demands is never trained ("automatic bypassing of
  DVNR construction if not accessed by any triggers").
- ``Trigger`` wraps a Boolean node; registered actions run on rising edges.
- ``SlidingWindow`` turns a time-varying node into a bounded temporal array
  (paper §IV-B); with a DVNR node upstream it becomes the compressed temporal
  model cache.

Every node counts its evaluations so tests (and the paper's laziness claim)
are checkable: ``node.evaluations``.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, List, Optional

import torch

_UNSET = object()


class Node:
    """A lazily-evaluated time-varying value."""

    def __init__(self, runtime: "Runtime", name: str, deps: Iterable["Node"],
                 fn: Optional[Callable] = None):
        self.runtime = runtime
        self.name = name
        self.deps = list(deps)
        self.fn = fn
        self._cache: Any = _UNSET
        self._cache_tick = -1
        self.evaluations = 0
        runtime._register(self)

    # -- pull -------------------------------------------------------------- #
    def value(self):
        tick = self.runtime.tick
        if self._cache_tick == tick and self._cache is not _UNSET:
            return self._cache
        val = self._compute()
        self._cache, self._cache_tick = val, tick
        return val

    def _compute(self):
        self.evaluations += 1
        args = [d.value() for d in self.deps]
        return self.fn(*args)

    def _invalidate(self):
        self._cache = _UNSET

    # -- combinators --------------------------------------------------- #
    def map(self, fn: Callable, name: Optional[str] = None) -> "Node":
        return Node(self.runtime, name or f"{self.name}.map", [self], fn)

    def combine(self, *others: "Node", fn: Callable,
                name: Optional[str] = None) -> "Node":
        return Node(self.runtime, name or f"{self.name}.combine",
                    [self, *others], fn)

    def window(self, size: int, name: Optional[str] = None) -> "SlidingWindow":
        return SlidingWindow(self.runtime, name or f"{self.name}.window",
                             self, size)


class Source(Node):
    """Fed by the session each step (zero-copy handle to simulation data)."""

    def __init__(self, runtime, name):
        super().__init__(runtime, name, [])
        self._current = _UNSET

    def feed(self, value):
        self._current = value
        self._invalidate()

    def _compute(self):
        self.evaluations += 1
        if self._current is _UNSET:
            raise RuntimeError(f"source {self.name!r} not fed at tick "
                               f"{self.runtime.tick}")
        return self._current


class SlidingWindow(Node):
    """Bounded history of a node's per-tick values (paper §IV-B).

    EAGER per tick *if demanded at least once*: the runtime updates windows
    during ``advance`` only when some trigger/probe has marked the window live
    (laziness is preserved for never-used windows).
    """

    def __init__(self, runtime, name, src: Node, size: int):
        super().__init__(runtime, name, [src])
        self.size = size
        self.buf: deque = deque()
        self.live = False
        runtime._windows.append(self)

    def _advance(self):
        if not self.live:
            return
        self.buf.append(self.deps[0].value())
        while len(self.buf) > self.size:
            self.buf.popleft()          # evict oldest (paper IV-B)

    def _compute(self):
        self.evaluations += 1
        self.live = True
        return list(self.buf)

    def values(self) -> List[Any]:
        self.live = True
        return list(self.buf)

    @property
    def total_bytes(self) -> int:
        n = 0
        for v in self.buf:
            b = getattr(v, "bytes", None)
            if b is not None:
                n += b if isinstance(b, int) else 0
            elif isinstance(v, torch.Tensor):
                n += v.numel() * v.element_size()
            elif hasattr(v, "nbytes"):
                n += v.nbytes
        return n


class Trigger:
    """Boolean indicator node + actions on rising edges (Larsen-style)."""

    def __init__(self, runtime: "Runtime", name: str, cond: Node):
        self.runtime = runtime
        self.name = name
        self.cond = cond
        self.actions: List[Callable] = []
        self.fired_at: List[int] = []
        self._prev = False
        runtime._triggers.append(self)

    def on_fire(self, fn: Callable) -> "Trigger":
        self.actions.append(fn)
        return self

    def _evaluate(self):
        cur = bool(self.cond.value())
        rising = cur and not self._prev
        self._prev = cur
        if rising:
            self.fired_at.append(self.runtime.tick)
            for fn in self.actions:
                fn(self.runtime.tick)
        return rising


class Runtime:
    """Owns the clock; steps sources -> windows -> triggers once per tick."""

    def __init__(self):
        self.tick = -1
        self._nodes: List[Node] = []
        self._windows: List[SlidingWindow] = []
        self._triggers: List[Trigger] = []

    def _register(self, node: Node):
        self._nodes.append(node)

    def source(self, name: str) -> Source:
        return Source(self, name)

    def trigger(self, name: str, cond: Node) -> Trigger:
        return Trigger(self, name, cond)

    def advance(self, feeds: dict) -> dict:
        """One visualization step: feed sources, update live windows, run
        triggers. Only the demanded sub-graph evaluates."""
        self.tick += 1
        for node in self._nodes:
            node._invalidate()
        for name, value in feeds.items():
            src = next(n for n in self._nodes
                       if isinstance(n, Source) and n.name == name)
            src.feed(value)
        for w in self._windows:
            w._advance()
        fired = {t.name: t._evaluate() for t in self._triggers}
        return fired

    def stats(self) -> dict:
        return {n.name: n.evaluations for n in self._nodes}
