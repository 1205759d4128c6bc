"""Fault-tolerant checkpointing: atomic, async, shard-aware, reshardable (the
port of ``repro.checkpoint.manager``).

Layout per step (the JAX package's, so either package reads the other's):
    <dir>/step_<n>.tmp-<pid>/   (written)  ->  <dir>/step_<n>/   (os.replace)
        manifest.json           tree structure, shapes, dtypes, user metadata
        arrays.npz              one entry per leaf (host-gathered)

- ATOMICITY: a checkpoint is visible iff its final directory exists; crashes
  mid-write leave only ``.tmp-*`` junk that the next sweep removes.
- ASYNC: ``save`` snapshots leaves to host memory synchronously (the device
  to host copy) then writes in a daemon thread, overlapping I/O with
  training; a failed write raises at the next ``wait()`` / ``save()``.
- SHARDED SAVE: with shardings (a tree of
  :class:`repro_torch.parallel.sharding.Placement`, e.g. a rank's slice of
  a partition-stacked DVNR state, or an LM's blocks cut over ``"model"``
  and ``"data"``) every rank of the placements' mesh hands its blocks to
  the mesh's rank 0, which assembles the global arrays (each block at its
  placement's ``slices``) and writes them; the others write nothing. This
  is a collective, outside any training step.
- RESHARDING RESTORE: ``restore(..., shardings=)`` reads the global arrays
  on the target mesh's rank 0 and scatters each rank its own blocks, so a
  run resumes on another mesh shape (elastic restart after losing ranks).
- GC: the writer keeps the newest ``keep_last`` steps.

Leaves are tensors (any device), numpy arrays or Python scalars, in the JAX
package's leaf order (dict keys sorted). bfloat16 leaves are stored as
their 16-bit patterns (``uint16`` in the npz, ``"bfloat16"`` in the
manifest); a JAX-written bfloat16 leaf (``"<V2"``) restores into a bfloat16
template leaf. Restored leaves are tensors on the template leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import _unflatten_like

_BF16 = "bfloat16"


def _to_host(x):
    """(numpy array, manifest dtype token) of one leaf: a copy, so that an
    asynchronous write never sees a later in-place update of ``x``."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, a.dtype.str


def _to_torch(a: np.ndarray, token: str, like) -> torch.Tensor:
    """A restored host array as a tensor on ``like``'s device (the CPU for
    a non-tensor template leaf)."""
    dev = like.device if torch.is_tensor(like) else torch.device("cpu")
    bf16 = token == _BF16 or (token == "<V2" and torch.is_tensor(like)
                              and like.dtype == torch.bfloat16)
    a = np.array(a, order="C")          # a writable copy; a 0-d array stays 0-d
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _placement_mesh(shardings):
    leaves = [s for s in tree_leaves(shardings) if s is not None]
    return leaves[0].mesh if leaves else None


def _coords(mesh, i: int) -> dict:
    """The axis coordinates of the rank at mesh index ``i``."""
    return dict(zip(mesh.axis_names,
                    np.unravel_index(i, tuple(mesh.shape.values()))))


def _assemble(blocks, placement, mesh) -> np.ndarray:
    """The global array from every rank's block (``blocks[i]``: the block
    of the rank at mesh index i)."""
    shape = tuple(s * n for s, n in zip(blocks[0].shape,
                                        placement.blocks(blocks[0].ndim)))
    out = np.empty(shape, blocks[0].dtype)
    for i, b in enumerate(blocks):
        out[placement.slices(out.shape, _coords(mesh, i))] = b
    return out


class CheckpointManager:
    """``mesh``: the mesh of ranks that share this directory (None: a
    single process). Only its rank 0 sweeps, writes and collects garbage;
    every rank must call :meth:`save` and :meth:`restore` together."""

    def __init__(self, directory, *, keep_last: int = 3, async_save: bool = True,
                 mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh
        self.writer = mesh is None or mesh.index == 0
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if self.writer:
            self._sweep_tmp()
        if mesh is not None and mesh.size > 1:
            collectives.barrier(group=mesh.group)   # the directory exists

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None,
             blocking: bool = False, shardings: Any = None) -> Path:
        self.wait()
        host = [_to_host(x) for x in tree_leaves(tree)]      # snapshot NOW
        final = self.dir / f"step_{step:012d}"
        mesh = _placement_mesh(shardings) if shardings is not None else None
        if mesh is not None and mesh.size > 1:
            places = tree_leaves(shardings)
            got = collectives.gather_object([a for a, _ in host], group=mesh.group)
            if mesh.index != 0:
                return final
            host = [(_assemble([g[i] for g in got], places[i], mesh), tok)
                    for i, (_, tok) in enumerate(host)]
        elif not self.writer:
            return final
        manifest = {
            "step": int(step),
            "treedef": "repro_torch",
            "n_leaves": len(host),
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [tok for _, tok in host],
            "metadata": metadata or {},
            "time": time.time(),
        }

        def write():
            tmp = self.dir / f"step_{step:012d}.tmp-{os.getpid()}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            np.savez(tmp / "arrays.npz", **{f"leaf_{i}": a
                                            for i, (a, _) in enumerate(host)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)                       # atomic publish
            self._gc()

        def guarded_write():
            # a daemon thread swallows exceptions — capture the failure so
            # the next wait()/save() surfaces it instead of training on while
            # silently never checkpointing (full disk, dead mount, ...)
            try:
                write()
            except BaseException as e:       # noqa: BLE001 — re-raised later
                self._error = e

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=guarded_write, daemon=True)
            self._thread.start()
        else:
            write()
        return final

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write failed: {err!r}") from err

    # ------------------------------------------------------------------ #
    def all_steps(self) -> list:
        self.wait()
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and ".tmp" not in p.name:
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, example_tree, step, shardings, mesh):
        """(host arrays with their tokens, metadata) of a checkpoint,
        validated against its manifest and the template (whose leaves are
        this rank's blocks when ``shardings`` are given)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:012d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as z:
            host = [z[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
        leaves = tree_leaves(example_tree)
        if len(leaves) != len(host):
            raise ValueError(
                f"checkpoint has {len(host)} leaves, template has {len(leaves)}")
        places = tree_leaves(shardings) if shardings is not None else [None] * len(host)
        # validate the loaded arrays against the manifest (torn/corrupted
        # npz) AND against the template (restoring into the wrong model
        # config must fail loudly, not reshape-garble)
        for i, a in enumerate(host):
            want_shape = tuple(manifest["shapes"][i])
            tok = manifest["dtypes"][i]
            want_dtype = np.dtype(np.uint16) if tok == _BF16 else np.dtype(tok)
            if a.shape != want_shape or a.dtype != want_dtype:
                raise ValueError(
                    f"checkpoint leaf {i} is {a.dtype}{a.shape}, but its "
                    f"manifest recorded {want_dtype}{want_shape} — corrupt "
                    f"or torn checkpoint at step {step}")
            t_shape = tuple(getattr(leaves[i], "shape", ()))
            got = a.shape if places[i] is None else places[i].local_shape(a.shape)
            if t_shape and got != t_shape:
                raise ValueError(
                    f"checkpoint leaf {i} has shape {got}, template "
                    f"expects {t_shape} — wrong model config for this "
                    f"checkpoint")
        return [(a, manifest["dtypes"][i]) for i, a in enumerate(host)], \
            manifest["metadata"]

    def restore(self, example_tree: Any, step: Optional[int] = None, *,
                shardings: Any = None) -> tuple:
        """Restore into the structure of ``example_tree``; with
        ``shardings`` (placements on a mesh, possibly another shape than
        the one that saved) every rank of that mesh gets its own blocks."""
        self.wait()
        mesh = _placement_mesh(shardings) if shardings is not None else None
        leaves = tree_leaves(example_tree)
        if mesh is None or mesh.size == 1:
            host, meta = self._read(example_tree, step, shardings, mesh)
            places = tree_leaves(shardings) if shardings is not None else [None] * len(host)
            out = [_to_torch(a if p is None else p.local(a), tok, like)
                   for (a, tok), p, like in zip(host, places, leaves)]
            return _unflatten_like(example_tree, out), meta
        places = tree_leaves(shardings)
        parts = None
        if mesh.index == 0:
            try:
                host, meta = self._read(example_tree, step, shardings, mesh)
                parts = [("ok", [(a[p.slices(a.shape, _coords(mesh, i))], tok)
                                 for (a, tok), p in zip(host, places)], meta)
                         for i in range(mesh.size)]
            except (OSError, ValueError, KeyError) as e:
                parts = [("error", f"{type(e).__name__}: {e}", None)] * mesh.size
        status, mine, meta = collectives.scatter_object(parts, group=mesh.group)
        if status != "ok":
            raise ValueError(f"checkpoint restore failed on the mesh's rank 0: {mine}")
        out = [_to_torch(a, tok, like) for (a, tok), like in zip(mine, leaves)]
        return _unflatten_like(example_tree, out), meta

    # ------------------------------------------------------------------ #
    def _gc(self) -> None:
        steps = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and ".tmp" not in p.name:
                steps.append(int(p.name[5:]))
        for s in sorted(steps)[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    def _sweep_tmp(self) -> None:
        for p in self.dir.glob("step_*.tmp-*"):
            shutil.rmtree(p, ignore_errors=True)
