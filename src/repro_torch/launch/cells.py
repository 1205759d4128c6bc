"""Dry-run cells: (arch x shape x mesh) -> one rank's program, its inputs
as fake tensors, and analytic meta (the port of ``repro.launch.cells``).

JAX's cell is one SPMD program over the whole mesh, lowered from
``jax.eval_shape`` shapes. The port's is what one rank of that mesh runs:
rank 0's program on its blocks of the parameters, optimizer state, batch
and cache. Nothing is allocated: the inputs are made under a
``FakeTensorMode`` (``Cell.fake_mode``; run ``cell.fn(*cell.args)`` inside
it), the weights at the blocks :func:`~repro_torch.parallel.sharding.
held_shardings` gives each leaf of ``Model.param_specs`` (cut over
``"model"`` and, the fsdp split, over ``"data"``), the inputs at this
rank's rows of ``Model.input_specs``. The mesh is the caller's, built on a
process group of the production world size: the ``"fake"`` backend
(``torch.testing._internal.distributed.fake_pg``), whose collectives
complete at once and move nothing, so that one process can run rank 0.

The routes are the plain ones (``impl="ref"``), as JAX's cells lower
``impl="xla"``: the train step of ``train.step.make_train_step`` with JAX's
optimizer settings, ``Model.prefill`` and ``Model.decode_step``. The
kernel wrappers are not traced: a fake tensor has no data for a kernel to
read, and a dry run counts the plain route's operations.

The decode cache is the rank's part of the cache that the port's mesh
prefill returns, which its ``decode_step`` reads: batch cut on dimension 1
over the batch axes, and attention K/V cut on their slots over
``"model"`` (``attention.mesh_cache``): the largest interior dimension
divisible by ``"model"``, as JAX's ``_cache_shardings`` cuts them. An SSM
layer's state and convolution history take the port's head-parallel
serving layout (``mamba2.init_mamba_cache``: the rank's heads), where
JAX's rule picks the largest interior dimension; a rank holds as many
state bytes either way. An encoder-decoder's cross K/V stay whole over
``"model"``, as the port's decode reads them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, cell_is_applicable, get_config
from repro_torch.launch.train import batch_dims
from repro_torch.models import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.sharding import (Sharder, _flatten_with_path,
                                           _unflatten_like, held_shardings)
from repro_torch.train.step import make_train_step
from repro_torch.utils import hw
from repro_torch.utils.opcount import OpAnalysis, OpCounter


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable                      # rank 0's program
    args: Tuple[Any, ...]             # its inputs: fake tensors of its blocks
    meta: dict
    fake_mode: FakeTensorMode


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS (global): 6*N*D train, 2*N*D inference."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _flatten_with_path(tree)
               if isinstance(t, torch.Tensor))


def _blocks(specs, places):
    """Empty tensors of each leaf's block (under the caller's fake mode)."""
    return _unflatten_like(specs, [
        torch.empty(p.local_shape(tuple(s.shape)) if p is not None else s.shape,
                    dtype=s.dtype)
        for (_, s), (_, p) in zip(_flatten_with_path(specs),
                                  _flatten_with_path(places))])


def batch_inputs(model, shape, sharder: Sharder) -> dict:
    """This rank's rows of ``model.input_specs(shape)``, as empty tensors:
    each input's batch dimension (``launch.train.batch_dims``) over the
    sharder's batch axes."""
    dims = batch_dims(model, shape.kind)
    n = sharder.axis_size("batch")
    out = {}
    for k, v in model.input_specs(shape).items():
        s = list(v.shape)
        s[dims[k]] //= n
        out[k] = torch.empty(s, dtype=v.dtype)
    return out


def rank_cache(model, batch: int, seq_len: int, sharder: Sharder) -> dict:
    """This rank's decode cache (the module docstring's layout), of its
    ``batch`` rows."""
    from repro_torch.models import attention, mamba2, transformer
    cfg = model.config
    cache = model.init_cache(batch, seq_len, device="cpu")
    if "ssm" in cache:
        cache.update(mamba2.init_mamba_cache(cfg, batch, transformer.compute_dtype(cfg),
                                             "cpu", (cfg.n_layers,), sharder))
    if "k" in cache:
        attention.mesh_cache(cache, ("k", "v"), sharder, cache["k"].shape[2])
    return cache


def opt_config(cfg, overrides: Optional[dict] = None) -> OptConfig:
    """A train cell's optimizer: JAX's cells' settings (cosine, clip 1,
    bf16 moments for bf16 params), then ``overrides``."""
    opt_kw = dict(lr=3e-4, schedule="cosine", clip_norm=1.0)
    if cfg.param_dtype == "bfloat16":
        opt_kw["moments_dtype"] = "bfloat16"
    opt_kw.update(overrides or {})
    return OptConfig(**opt_kw)


def cell_meta(model, shape, devices: int, *, arch: str = "", shape_name: str = "") -> dict:
    """A cell's analytic meta, JAX's keys and values (``cache_bytes_global``
    for a decode cell: its cache's bytes at the global batch; call under a
    fake mode, which allocates none of it)."""
    cfg = model.config
    meta = {
        "arch": arch,
        "shape": shape_name or shape.name,
        "kind": shape.kind,
        "devices": devices,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops_global": model_flops(cfg, shape),
        "tokens_global": shape.global_batch * shape.seq_len,
    }
    if shape.kind == "decode":
        meta["cache_bytes_global"] = tree_bytes(
            model.init_cache(shape.global_batch, shape.seq_len, device="cpu"))
    return meta


def build_cell(arch: str, shape_name: str, mesh, *,
               opt_overrides: Optional[dict] = None,
               moe_dispatch: str = "scatter",
               extra_constraints: bool = True,
               config=None, shape=None) -> Cell:
    """Rank ``mesh.index``'s cell; ``mesh=None``: one card's (the
    single-card route, which a one-rank mesh's route is not: that one
    takes the mesh's code paths). ``extra_constraints`` is JAX's
    signature's, which its body does not read either: the port's sites
    state their layouts themselves. ``config`` / ``shape`` replace the
    arch's published config and the named shape (a cut-down cell: the
    tests' SMOKE widths, ``chip_smoke.py``'s one-rank cells at its own
    batch)."""
    if shape is None:
        shape = SHAPES[shape_name]
        ok, reason = cell_is_applicable(arch, shape_name)
        if not ok:
            raise ValueError(f"cell ({arch},{shape_name}) skipped: {reason}")
    cfg = get_config(arch) if config is None else config
    model = build_model(cfg, moe_dispatch)
    sharder = Sharder(mesh, shape.global_batch)
    specs = model.param_specs()
    places = held_shardings(specs, cfg, sharder)
    mode = FakeTensorMode()
    with mode:
        meta = cell_meta(model, shape, 1 if mesh is None else mesh.size, arch=arch,
                         shape_name=shape_name)
        params = _blocks(specs, places)
        batch = batch_inputs(model, shape, sharder)
        if shape.kind == "train":
            step = make_train_step(model, opt_config(cfg, opt_overrides), sharder,
                                   impl="ref")
            opt = step.optimizer.init(params)
            return Cell(arch, shape_name, "train", step, (params, opt, batch),
                        meta, mode)
        if shape.kind == "prefill":
            def prefill_fn(params, batch):
                return model.prefill(params, batch, shape.seq_len, sharder, "ref")

            return Cell(arch, shape_name, "prefill", prefill_fn, (params, batch),
                        meta, mode)
        rows = shape.global_batch // sharder.axis_size("batch")
        cache = rank_cache(model, rows, shape.seq_len, sharder)
        meta["cache_bytes_per_device"] = tree_bytes(cache)

    def decode_fn(params, cache, tokens):
        return model.decode_step(params, cache, tokens, sharder)

    return Cell(arch, shape_name, "decode", decode_fn,
                (params, cache, batch["tokens"]), meta, mode)


# --------------------------------------------------------------------------- #
# Running a cell: counts, memory, roofline
# --------------------------------------------------------------------------- #
def _storages(tree) -> dict:
    """Distinct storages of a tree's tensors: C pointer -> bytes."""
    from torch.utils._pytree import tree_leaves
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def measure(fn, args, fake_mode) -> Tuple[Any, OpAnalysis, dict]:
    """Run ``fn(*args)`` once under ``fake_mode``: its output, its counts
    (:class:`~repro_torch.utils.opcount.OpCounter`) and its memory, the
    counterpart of XLA's ``memory_analysis``: ``argument_bytes`` (the
    inputs' storages), ``output_bytes`` (the outputs'), ``alias_bytes``
    (outputs that are inputs, updated in place), ``peak_bytes`` (the most
    held at once, ``torch.distributed._tools.mem_tracker.MemTracker``:
    the inputs and every tensor the run made, each until it is freed,
    rounded as the caching allocator rounds) and ``temp_bytes`` (the peak
    beyond the inputs)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_leaves
    with fake_mode:
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves(args)
                                 if isinstance(t, torch.Tensor)])
        with tracker, OpCounter() as counter:
            out = fn(*args)
        # meta tensors (the shapes ``Model.param_specs`` gives) hold no memory
        peak = sum(s["Total"] for d, s in tracker.get_tracker_snapshot("peak").items()
                   if d.type != "meta")
    a, o = _storages(args), _storages(out)
    arg_bytes = sum(a.values())
    mem = {"argument_bytes": arg_bytes,
           "output_bytes": sum(o.values()),
           "temp_bytes": max(peak - arg_bytes, 0),
           "peak_bytes": peak,
           "alias_bytes": sum(b for k, b in o.items() if k in a)}
    return out, counter.analysis(), mem


def roofline_record(an: OpAnalysis, mem: dict, model_flops_global: float,
                    devices: int, peak_flops: float) -> dict:
    """The record's counted and roofline fields, a rank's, on the H100's
    constants (:mod:`repro_torch.utils.hw`): each product at its dtype's
    peak, the eager route's bytes at the HBM rate, the wire bytes at one
    link's (across nodes; ``collective_s_nvlink`` inside one).
    ``roofline_fraction``: the model FLOPs a rank at ``peak_flops`` (the
    cell's compute dtype) over the step time the terms bound."""
    terms = {
        "compute_s": sum(f / hw.peak_flops(d) for d, f in an.flops_by_dtype.items()),
        "memory_s": an.op_bytes / hw.HBM_BW,
        "collective_s": an.collective_wire_bytes / hw.LINK_BW,
    }
    step = max(terms.values())
    mf_dev = model_flops_global / devices
    return dict(
        devices=devices,
        memory_analysis=mem,
        cost_analysis={"flops": an.flops, "bytes_accessed": an.op_bytes},
        counted_flops_per_device=an.flops,
        flops_by_dtype=an.flops_by_dtype,
        op_bytes_per_device=an.op_bytes,
        collective_wire_bytes_per_device=an.collective_wire_bytes,
        collective_breakdown=an.collective_summary(),
        collective_calls=an.collective_calls(),
        roofline=dict(terms, dominant=max(terms, key=terms.get), step_time_s=step,
                      collective_s_nvlink=an.collective_wire_bytes / hw.NVLINK_BW,
                      roofline_fraction=mf_dev / peak_flops / max(step, 1e-30)),
        model_flops_global=model_flops_global,
        model_flops_per_device=mf_dev,
        useful_flops_ratio=mf_dev / max(an.flops, 1.0),
    )
