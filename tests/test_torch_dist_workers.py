"""Ranks for the port's distributed CPU tests (``test_torch_distributed.py``,
``test_torch_checkpoint.py``, ``test_torch_mesh_*.py``): a launcher that
spawns ``world`` processes into one ``gloo`` process group and the
functions they run. It holds no test of its own.

This module imports no JAX, so the spawned ranks stay light. Every process
group is initialised through a ``file://`` store in the test's own
directory (no TCP port, so tests running side by side cannot collide) with
a timeout, and the launcher joins the ranks against a deadline and kills
them past it, so no test can hang the suite. Each rank writes its result
(``torch.save``) or its traceback to the directory; :func:`launch` returns
the results in rank order or raises with the first traceback.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PG_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 240


def _entry(rank: int, world: int, fn_name: str, workdir: str, kwargs: dict):
    torch.set_num_threads(1)
    out = Path(workdir)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{out / 'pg_store'}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            # every rank connected before any works, and none leaves while
            # another may still be connecting (init has no barrier of its own)
            dist.barrier()
            result = globals()[fn_name](rank, world, out, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"result_{rank}.pt")
    except BaseException:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def launch(fn_name: str, world: int, workdir, **kwargs) -> list:
    """Run ``fn_name(rank, world, workdir, **kwargs)`` on ``world`` spawned
    ranks; their results in rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for f in workdir.glob("pg_store*"):
        f.unlink()
    ctx = mp.start_processes(_entry, args=(world, fn_name, str(workdir), kwargs),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn_name} on {world} ranks did not end "
                                   f"within {JOIN_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        errs = sorted(workdir.glob("error_*.txt"))
        raise RuntimeError(errs[0].read_text() if errs else str(e)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(workdir / f"result_{r}.pt", weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------------------- #
# the ranks' work
# --------------------------------------------------------------------------- #
def _mesh(world):
    from repro_torch.launch.mesh import build_mesh
    return build_mesh((world,), ("data",), device="cpu")


def meshes(rank, world, out):
    """Meshes over this group: their shapes, this rank's coordinates and
    index, and the refusals of shapes the group cannot hold."""
    from repro_torch.launch.mesh import (build_mesh, make_mesh_for,
                                         make_production_mesh, rank_device)
    got = {}
    m = make_mesh_for(world, model_parallel=2, device="cpu")
    got["elastic"] = (dict(m.shape), m.coords, m.index, str(m.device), m.backend)
    m = build_mesh((world,), ("data",), device="cpu")
    got["flat"] = (dict(m.shape), m.index)
    for name, fn in (("larger", lambda: make_mesh_for(2 * world, device="cpu")),
                     ("production", lambda: make_production_mesh(device="cpu")),
                     ("smaller", lambda: build_mesh((world // 2,), ("data",),
                                                    device="cpu"))):
        try:
            fn()
            got[name] = None
        except RuntimeError as e:
            got[name] = str(e)
    got["device"] = str(rank_device("cpu"))
    return got


def halo(rank, world, out, grid, local):
    """This rank's partition with its ghost shell zeroed, then refilled by
    ``halo_exchange``."""
    from repro_torch.data.halo import halo_exchange
    from repro_torch.data.volume import make_partition

    mesh = _mesh(world)
    v = make_partition("cloverleaf", mesh.index, grid, local, 0.3, device="cpu").data
    bare = torch.zeros_like(v)
    bare[1:-1, 1:-1, 1:-1] = v[1:-1, 1:-1, 1:-1]
    return halo_exchange(bare[None], grid, mesh, 1)[0]


def swap(rank, world, out, images, depths):
    """``binary_swap`` of this rank's row of the (P, R, 4) images."""
    from repro_torch.core.render import binary_swap

    mesh = _mesh(world)
    return binary_swap(mesh, torch.as_tensor(images[rank])[None],
                       torch.as_tensor(depths[rank])[None])[0]


def render(rank, world, out, cfg, np_params, metas, rays, tf_table, grange,
           n_samples):
    """``make_distributed_render_step`` on this rank's partition of the
    stacked numpy params."""
    from repro_torch import interop
    from repro_torch.core.render import make_distributed_render_step

    mesh = _mesh(world)
    p = rank
    params = interop.params_from_numpy(
        {"tables": np_params["tables"][p:p + 1],
         "mlp": [w[p:p + 1] for w in np_params["mlp"]]}, "cpu")
    step = make_distributed_render_step(cfg, mesh, n_samples=n_samples,
                                        impl="ref")
    los, exts, vrs = metas
    frame = step(params, los[p], exts[p], vrs[p], torch.as_tensor(rays[0]),
                 torch.as_tensor(rays[1]), torch.as_tensor(tf_table), grange)
    return frame[0]


def train(rank, world, out, cfg, grid, local, steps, key, per_rank=1,
          mask=None, count_control=True):
    """``api.train(mesh=)`` of this rank's ``per_rank`` partitions under
    ``count_collectives``; also counts a control ring shift and, with
    ``mask``, trains a chunk with the masked partitions kept out."""
    from repro_torch import api
    from repro_torch.data.volume import make_partition
    from repro_torch.parallel.collectives import count_collectives, ppermute

    mesh = _mesh(world)
    ids = range(mesh.index * per_rank, (mesh.index + 1) * per_rank)
    parts = [make_partition("cloverleaf", p, grid, local, 0.3, device="cpu")
             for p in ids]
    with count_collectives() as c:
        model, info = api.train(parts, cfg, backend="ref", mesh=mesh,
                                steps=steps, key=key)
    res = {"collectives": c.count, "partitions": info["partitions"],
           "params": model.params, "loss_ma": info["state"].loss_ma}
    if mask is not None:
        with count_collectives() as c:
            api.train(parts, cfg, backend="ref", mesh=mesh, steps=steps,
                      key=key, train_mask=[bool(mask[p]) for p in ids])
        res["masked_collectives"] = c.count
    if count_control:
        with count_collectives() as c:
            got = ppermute(torch.full((2,), float(rank)),
                           [(i, (i + 1) % world) for i in range(world)],
                           group=mesh.group)
        res["control_collectives"] = c.count
        res["control"] = got
    return res


def elastic_save(rank, world, out, cfg, grid, local, steps, key, ckpt):
    """Train ``steps`` on a mesh of ``world`` ranks and save the state to
    ``ckpt`` (rank 0 gathers and writes)."""
    from repro_torch import api, interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.volume import make_partition
    from repro_torch.parallel.sharding import Sharder, partition_shardings

    mesh = _mesh(world)
    P = int(np.prod(grid))
    k = P // world
    parts = [make_partition("cloverleaf", p, grid, local, 0.3, device="cpu")
             for p in range(mesh.index * k, (mesh.index + 1) * k)]
    model, info = api.train(parts, cfg, backend="ref", mesh=mesh, steps=steps,
                            key=key)
    tree = interop.state_tree(info["state"])
    mgr = CheckpointManager(ckpt, mesh=mesh, async_save=False)
    mgr.save(steps, tree, metadata={"world": world},
             shardings=partition_shardings(tree, Sharder(mesh)))
    return {"params": model.params, "tree": tree}


def elastic_resume(rank, world, out, cfg, grid, local, steps, key, ckpt,
                   survivors):
    """``plan_restart(survivors)`` on the restarted group, the checkpoint
    restored onto it with ``elastic_restore``, then trained to ``steps``."""
    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.sampling import as_key, split
    from repro_torch.core.trainer import DVNRTrainer
    from repro_torch.data.volume import make_partition
    from repro_torch.launch.elastic import elastic_restore, plan_restart

    plan = plan_restart(survivors, global_batch=cfg.batch_size, device="cpu")
    mesh = plan.mesh
    P = int(np.prod(grid))
    trainer = DVNRTrainer(cfg, P, mesh=mesh, impl="ref", device="cpu")
    parts = [make_partition("cloverleaf", p, grid, local, 0.3, device="cpu")
             for p in trainer.partitions]
    vols = torch.stack([p.normalized() for p in parts])
    k_init, k_train = split(as_key(key))
    like = interop.state_tree(trainer.init(k_init))
    mgr = CheckpointManager(ckpt, mesh=mesh)
    tree, meta = elastic_restore(mgr, like, cfg, plan)
    restored = {k: v for k, v in tree.items()}
    state = interop.state_from_tree(tree)
    state, _ = trainer.train(state, vols, steps=steps - state.step, key=k_train)
    return {"params": state.params, "partitions": trainer.partitions,
            "devices": plan.devices, "meta": meta, "restored": restored,
            "resumed_from": int(tree["step"])}


# --------------------------------------------------------------------------- #
# the LM on a mesh (test_torch_mesh_*.py; cases in torch_mesh_cases.py)
# --------------------------------------------------------------------------- #
_MESHES: dict = {}


def _lm_mesh(shape):
    """This rank's ("data", "model") mesh of ``shape`` (built once: every
    rank builds the same meshes in one order)."""
    from repro_torch.launch.mesh import build_mesh
    if shape not in _MESHES:
        _MESHES[shape] = build_mesh(shape, ("data", "model"), device="cpu")
    return _MESHES[shape]


def _batch_block(batch: dict, sharder) -> dict:
    """This rank's block of a global batch (its rows over the batch axes)."""
    mesh = sharder.mesh
    axes = sharder.axes("batch")
    n, k = mesh.axis_size(axes), mesh.axis_index(axes)
    return {key: v[k * (v.shape[0] // n):(k + 1) * (v.shape[0] // n)]
            for key, v in batch.items()}


def _np_tree(tree):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def mesh_models(rank, world, out, inputs):
    """Every LM case's loss and this rank's gradient blocks, and every
    decode case's logits (prefill, then teacher-forced decode steps)."""
    import pickle

    import torch
    sys_path_tests()
    import torch_mesh_cases as C
    from repro_torch import interop
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.sharding import Sharder, _unflatten_like
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    got = {}
    for name, (arch, shape, B, S, ch, dispatch) in C.LM_CASES.items():
        cfg = C.config(arch, ch)
        sharder = Sharder(_lm_mesh(shape), B)
        params = interop.lm_params_from_numpy(inp[name]["params"], "cpu", cfg=cfg,
                                              sharder=sharder)
        work = [p.requires_grad_(True) for p in tree_leaves(params)]
        batch = _batch_block({k: torch.from_numpy(v) for k, v in
                              inp[name]["batch"].items()}, sharder)
        loss, _ = build_model(cfg, dispatch).loss(params, batch, sharder, impl="ref")
        grads = torch.autograd.grad(loss, work)
        got[name] = {"loss": float(loss),
                     "grads": _np_tree(_unflatten_like(params, list(grads)))}
    for name, (arch, shape, B, S, n, ch) in C.DECODE_CASES.items():
        cfg = C.config(arch, ch)
        sharder = Sharder(_lm_mesh(shape), B)
        model = build_model(cfg)
        params = interop.lm_params_from_numpy(inp[name]["params"], "cpu", cfg=cfg,
                                              sharder=sharder)
        toks = _batch_block({"t": torch.from_numpy(inp[name]["batch"]["tokens"])},
                            sharder)["t"]
        logits, cache = model.prefill(params, {"tokens": toks[:, :S]}, S + n, sharder,
                                      impl="ref")
        seq = [logits.numpy().copy()]
        for i in range(n):
            logits, cache = model.decode_step(params, cache, toks[:, S + i:S + i + 1],
                                              sharder)
            seq.append(logits.numpy().copy())
        k = sharder.mesh.axis_index(sharder.axes("batch"))
        got[name] = {"logits": seq, "cache_slots": tuple(cache["k"].shape),
                     "rows": (k * len(toks), (k + 1) * len(toks))}
    return got


def sys_path_tests():
    """The tests folder on the path (the ranks import the case module)."""
    import sys
    here = str(Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)


def f32_driver(model_parallel=16):
    """``launch.train`` with its SMOKE configs in float32 compute (the
    comparisons' precision: bf16 psums reorder the sums) and its mesh's
    model axis at ``model_parallel``; returns the module."""
    import functools

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    train.get_smoke_config = lambda arch: get_smoke_config(arch).replace(
        compute_dtype="float32")
    train.make_mesh_for = functools.partial(mesh_mod.make_mesh_for,
                                            model_parallel=model_parallel)
    return train


class PortLax:
    """The ``lax`` collectives ``torch_mesh_cases.primitive_local`` calls, as
    the port's on this rank's mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def psum(self, x, axis):
        from repro_torch.parallel import collectives as col
        return col.psum(x, self.mesh, axis)

    def pmean(self, x, axis):
        from repro_torch.parallel import collectives as col
        return col.pmean(x, self.mesh, axis)

    def all_gather(self, x, axis_name, axis=0, tiled=True):
        from repro_torch.parallel import collectives as col
        return col.all_gather_dim(x, self.mesh, axis_name, axis)

    def all_to_all(self, x, axis_name, split_axis, concat_axis, tiled=True):
        from repro_torch.parallel import collectives as col
        return col.all_to_all(x, self.mesh, axis_name, split_axis, concat_axis)


def mesh_collectives(rank, world, out, inputs):
    """The collectives' cases (forward, and the gradient of sum(w * y)),
    the weight gather over "data" (its backward's reduce-scatter, counted),
    the MoE blocks (forward, aux, gradients of y.sum(), drop sets), the
    sequence-parallel attention block and the int8 all-reduce, on the (2, 2) mesh:
    this rank's blocks of everything (the weights gathered over "data" at
    their use, as a layer gathers them)."""
    import pickle

    import torch
    sys_path_tests()
    import torch_mesh_cases as C
    from repro_torch import interop
    from repro_torch.models import moe
    from repro_torch.models.attention import attention_block, attention_mode
    from repro_torch.models.transformer import enter_batch, gather_fsdp
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.compressed import ef_compress_decompress, quantize_int8
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.collectives import count_collectives
    from repro_torch.parallel.sharding import Sharder, _unflatten_like, held_shardings
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    mesh = _lm_mesh((2, 2))
    d, r = mesh.coords["data"], mesh.coords["model"]
    got = {"coords": (d, r), "rank_index": mesh.index, "prims": {}}
    x = torch.from_numpy(inp["x"])
    for name, (i, o) in C.PRIMITIVES.items():
        rows = x[2 * d:2 * d + 2].clone().requires_grad_(True)
        if i == "m" and name != "block":
            leaf = x[2 * d:2 * d + 2, 4 * r:4 * r + 4].clone().requires_grad_(True)
            xl = leaf
        else:
            leaf = rows
            xl = col.block(rows, mesh, "model", 1) if name == "block" else \
                col.enter(rows, mesh, "model")
        if name == "reduce":
            y = col.reduce(xl, mesh, "model")
        elif name == "gather":
            y = col.gather(xl, mesh, "model", 1)
        else:
            y = C.primitive_local(name, xl, float(r), PortLax(mesh))
            if o == "r":
                y = col.leave(y, mesh, "model")
        a, b = y.shape
        w = torch.from_numpy(inp["w"][name])
        w = w[a * d:a * (d + 1), b * r:b * (r + 1)] if o == "m" else w[a * d:a * (d + 1), :b]
        (g,) = torch.autograd.grad(torch.sum(w * y), leaf)
        got["prims"][name] = {"y": y.detach().numpy().copy(), "grad": g.numpy().copy()}
    # the weight gather of a (4, 8) weight cut over "data" along dim 0 and
    # over "model" along dim 1: its backward summed over "data" (one
    # reduce-scatter, its input's bytes counted) and not (the block); a
    # list reduce-scatter's bytes
    got["gather_weight"] = {}
    for summed in (True, False):
        wb = x[2 * d:2 * d + 2, 4 * r:4 * r + 4].clone().requires_grad_(True)
        y = col.gather_weight(wb, mesh, "data", 0, summed)
        with count_collectives() as c:
            (g,) = torch.autograd.grad(torch.sum(y * (1.0 + d) * y), wb)
        got["gather_weight"][summed] = {"y": y.detach().numpy().copy(),
                                        "grad": g.numpy().copy(),
                                        "coll": (c.count, dict(c.kinds), c.nbytes)}
    out_rs = torch.empty(3)
    with count_collectives() as c:
        torch.distributed.reduce_scatter(out_rs, [torch.ones(3) * (i + 1) for i in range(4)],
                                         group=mesh.group)
    got["reduce_scatter_list"] = (out_rs.numpy().copy(), dict(c.kinds), c.nbytes)
    sharder = Sharder(mesh, 4)
    for name, (arch, cap, _, _) in C.MOE_CASES.items():
        cfg = C.moe_config(arch, cap)
        p = interop.lm_params_from_numpy({"moe": inp[name]["params"]}, "cpu", cfg=cfg,
                                         sharder=sharder)["moe"]
        for t in tree_leaves(p):
            t.requires_grad_(True)
        xb = torch.from_numpy(inp[name]["x"][2 * d:2 * d + 2]).requires_grad_(True)
        places = held_shardings({"moe": inp[name]["params"]}, cfg, sharder)["moe"]
        pe = gather_fsdp(enter_batch(p, sharder, places), places, sharder)
        keep = None
        if name.startswith("tp"):
            y, aux = moe.moe_block_tp(cfg, pe, xb, sharder)
        else:
            y, aux = moe.moe_block_a2a(cfg, pe, xb, sharder)
            h = xb.shape[1] // 2          # this rank's block of the sequence
            keep = moe._a2a_dispatch(cfg, xb[:, h * r:h * (r + 1)].detach(),
                                     p["router"].detach(), 2)[3].numpy().copy()
        grads = torch.autograd.grad(y.sum(), tree_leaves(p) + [xb])
        got[name] = {"y": y.detach().numpy().copy(), "aux": float(aux.detach()),
                     "grads": _np_tree(_unflatten_like(p, list(grads[:-1]))),
                     "gx": grads[-1].numpy().copy(), "keep": keep}
    cfg = C.config(*C.ATTN_CASE[:2])
    sh2 = Sharder(mesh, C.ATTN_CASE[2])
    p = interop.lm_params_from_numpy({"attn": inp["attn"]["params"]}, "cpu", cfg=cfg,
                                     sharder=sh2)["attn"]
    for t in tree_leaves(p):
        t.requires_grad_(True)
    xb = torch.from_numpy(inp["attn"]["x"][d:d + 1]).requires_grad_(True)
    pos = torch.from_numpy(inp["attn"]["positions"][d:d + 1])
    places = held_shardings({"attn": inp["attn"]["params"]}, cfg, sh2)["attn"]
    o = attention_block(cfg, gather_fsdp(enter_batch(p, sh2, places), places, sh2), xb,
                        pos, sharder=sh2, impl="ref")
    grads = torch.autograd.grad(torch.sum(o * torch.cos(o)), tree_leaves(p) + [xb])
    got["attn"] = {"o": o.detach().numpy().copy(), "mode": attention_mode(sh2, cfg, xb.shape[1]),
                   "grads": _np_tree(_unflatten_like(p, list(grads[:-1]))),
                   "gx": grads[-1].numpy().copy()}
    gb = torch.from_numpy(inp["ef"]["g"][2 * d:2 * d + 2, 4 * r:4 * r + 4].copy())
    rb = torch.from_numpy(inp["ef"]["r"][2 * d:2 * d + 2, 4 * r:4 * r + 4].copy())
    ng, nr = ef_compress_decompress({"w": gb}, {"w": rb}, axis="model", mesh=mesh)
    got["ef"] = {"g": ng["w"].numpy().copy(), "r": nr["w"].numpy().copy(),
                 "q": quantize_int8(gb + rb)[0].numpy().copy()}
    return got


def mesh_training(rank, world, out, argv, ef_argv, ef_ckpt):
    """The training driver on this group (its mesh from ``make_mesh_for``),
    then with ``ef_argv`` on a (2, 2) mesh (the weights and AdamW state cut
    over "data" too), its checkpoint in ``ef_ckpt`` restored onto (1, 4)
    through ``elastic_restore``; then on a (1, 4) mesh: one qwen2
    SMOKE train step's collectives by kind (remat "none", float32), an
    arctic step's clip norm, ``shard_params`` / ``gather_params`` round
    trip and ``Sharder.constrain``'s reshardings."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.launch.elastic import elastic_restore, plan_restart
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.collectives import count_collectives
    from repro_torch.parallel.sharding import Sharder, gather_params, shard_params
    from repro_torch.train import make_train_step
    got = {"driver": f32_driver().main(list(argv)),
           "ef": f32_driver(2).main(list(ef_argv))}
    ecfg = get_smoke_config("qwen2_0_5b").replace(compute_dtype="float32")
    emodel = build_model(ecfg)
    plan = plan_restart(world, 4, device="cpu")
    eopt = make_train_step(emodel, OptConfig(), plan.sharder, impl="ref",
                           grad_compress=True).optimizer
    eparams = emodel.init(0, device="cpu", sharder=plan.sharder)
    especs = emodel.param_specs()
    restored, meta = elastic_restore(
        CheckpointManager(ef_ckpt, mesh=plan.mesh), (eparams, eopt.init(eparams)), ecfg,
        plan, shapes=(especs, eopt.init(especs)))
    got["ef_restored"] = {"coords": dict(plan.mesh.coords), "meta": meta,
                          "blocks": _np_tree(restored)}
    mesh = _lm_mesh((1, 4))
    r = mesh.coords["model"]
    cfg = get_smoke_config("qwen2_0_5b").replace(compute_dtype="float32", remat="none")
    model = build_model(cfg)
    sharder = Sharder(mesh, 4)
    full = model.init(0, device="cpu")
    params = shard_params(full, cfg, sharder)
    back = gather_params(params, full, cfg, sharder)
    got["round_trip"] = all(torch.equal(a, b) for a, b in
                            zip(tree_leaves(back), tree_leaves(full)))
    step = make_train_step(model, OptConfig(), sharder, impl="ref")
    opt = step.optimizer.init(params)
    batch = _batch_block(train.synth_batch(model, train.ShapeConfig("t", "train", 16, 4),
                                           0, "cpu"), sharder)
    counts = []
    for _ in range(2):
        with count_collectives() as c:
            step(params, opt, batch)
        counts.append((c.count, dict(c.kinds), c.nbytes))
    got["step_counts"] = counts
    # arctic's 8 experts on the 4-wide axis: 2 a rank, a block the
    # divisibility guard alone would call whole; the grouped scatter (no
    # rank-local aux): the step's clipped norm is the one-rank step's
    acfg = get_smoke_config("arctic_480b").replace(compute_dtype="float32")
    amodel = build_model(acfg, "scatter_gspmd")
    aparams = shard_params(amodel.init(0, device="cpu"), acfg, sharder)
    astep = make_train_step(amodel, OptConfig(), sharder, impl="ref")
    abatch = _batch_block(train.synth_batch(amodel, train.ShapeConfig(
        "t", "train", 16, 4), 0, "cpu"), sharder)
    _, _, metrics = astep(aparams, astep.optimizer.init(aparams), abatch)
    got["arctic_norm"] = float(metrics["grad_norm"])
    x = torch.arange(2 * 8 * 12, dtype=torch.float32).reshape(2, 8, 12)
    cols = x[:, :, 3 * r:3 * r + 3]
    got["constrain"] = {
        "a2a": torch.equal(sharder.constrain(cols, "batch", "seq", None,
                                             held=("batch", None, "model")),
                           x[:, 2 * r:2 * r + 2]),
        "cut": torch.equal(sharder.constrain(x, "batch", None, "model"), cols),
        "gather": torch.equal(sharder.constrain(cols, "batch", None, None,
                                                held=("batch", None, "model")), x),
        "same": sharder.constrain(cols, "batch", None, "model",
                                  held=("batch", None, "model")) is cols,
    }
    return got


def mesh_resume(rank, world, out, argv, ckpt):
    """An LM checkpoint of another mesh restored onto this group's through
    ``elastic_restore`` (the parameters' blocks, numpy), then the driver's
    own ``--resume`` (``f32_driver``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.elastic import elastic_restore, plan_restart
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.train import make_train_step
    train = f32_driver()
    cfg = train.get_smoke_config("qwen2_0_5b")
    model = build_model(cfg)
    plan = plan_restart(world, 4, device="cpu")
    opt = make_train_step(model, OptConfig(), plan.sharder, impl="ref").optimizer
    params = shard_params(model.init(0, device="cpu"), cfg, plan.sharder)
    specs = model.param_specs()
    mgr = CheckpointManager(ckpt, mesh=plan.mesh)
    (blocks, state), meta = elastic_restore(
        mgr, (params, opt.init(params)), cfg, plan,
        shapes=(specs, opt.init(specs)))
    got = {"coords": dict(plan.mesh.coords), "step": int(state["step"]),
           "meta": meta, "blocks": _np_tree(blocks)}
    got["driver"] = train.main(list(argv))
    return got


def mesh_families(rank, world, out, inputs, driver_argv):
    """The SSM, hybrid, encoder-decoder and VLM families on this group's
    meshes: every family case's loss and this rank's gradient blocks
    (the rank's rows of each input, ``launch.train.batch_block`` on its
    batch dimension), every decode case's prefill and decode logits on (1,
    4), the VLM's mesh train step's gradient of its embedding table (which
    the loss never reads), and the training driver on (2, 2)
    (``driver_argv``)."""
    import pickle

    import torch
    sys_path_tests()
    import torch_mesh_cases as C
    from repro_torch import interop
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import (Sharder, _flatten_with_path,
                                               _unflatten_like)
    from repro_torch.train import make_train_step
    with open(inputs, "rb") as f:
        inp = pickle.load(f)

    def tensors(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    got = {}
    for name, (arch, shape, B, S, ch) in C.FAMILY_CASES.items():
        cfg = C.config(arch, ch)
        model = build_model(cfg)
        sharder = Sharder(_lm_mesh(shape), B)
        params = interop.lm_params_from_numpy(inp[name]["params"], "cpu", cfg=cfg,
                                              sharder=sharder)
        work = [p.requires_grad_(True) for p in tree_leaves(params)]
        batch = train.batch_block(tensors(inp[name]["batch"]), sharder,
                                  train.batch_dims(model))
        loss, _ = model.loss(params, batch, sharder, impl="ref")
        grads = torch.autograd.grad(loss, work, allow_unused=True, materialize_grads=True)
        got[name] = {"loss": float(loss),
                     "grads": _np_tree(_unflatten_like(params, list(grads))),
                     "batch_shapes": {k: tuple(v.shape) for k, v in batch.items()}}
        if cfg.family == "vlm":       # the train step's block of the unread table
            seen = {}
            step = make_train_step(model, OptConfig(), sharder, impl="ref",
                                   grad_transform=lambda g: seen.update(g=g) or g)
            blocks = [t.detach().clone() for t in tree_leaves(params)]
            step(_unflatten_like(params, blocks), step.optimizer.init(
                _unflatten_like(params, blocks)), batch)
            g = seen["g"]["embed"]["tok"]
            got[name]["step_embed_grad"] = (type(g).__name__, tuple(g.shape),
                                            float(g.abs().max()))
    mesh = _lm_mesh((1, 4))
    for name, (arch, B, S, n) in C.FAMILY_DECODE.items():
        cfg = C.config(arch, {})
        model = build_model(cfg)
        sharder = Sharder(mesh, B)
        params = interop.lm_params_from_numpy(inp[name]["params"], "cpu", cfg=cfg,
                                              sharder=sharder)
        batch = tensors({k: v for k, v in inp[name]["batch"].items()
                         if k not in ("labels", "steps")})
        steps = torch.from_numpy(inp[name]["batch"]["steps"])
        if cfg.family == "encdec":
            batch["tgt_tokens"] = batch["tgt_tokens"][:, :1]
            seq_len = C.ENCDEC_SLOTS
        else:
            seq_len = S + n
        logits, cache = model.prefill(params, batch, seq_len, sharder, impl="ref")
        seq = [logits.numpy().copy()]
        with col.count_collectives() as wire:
            for i in range(n):
                logits, cache = model.decode_step(params, cache, steps[:, i:i + 1],
                                                  sharder)
                seq.append(logits.numpy().copy())
        got[name] = {"logits": seq,
                     "cache": {k: tuple(v.shape) for k, v in cache.items()
                               if isinstance(v, torch.Tensor) and v.dim()},
                     "step_bytes": wire.nbytes / n,
                     "in_proj_bytes": sum(t.nbytes for path, t in _flatten_with_path(params)
                                          if path[-1] == "in_proj")}
    got["driver"] = f32_driver(2).main(list(driver_argv))
    return got
