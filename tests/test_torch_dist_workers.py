"""Ranks for the port's distributed CPU tests (``test_torch_distributed.py``,
``test_torch_checkpoint.py``): a launcher that spawns ``world`` processes
into one ``gloo`` process group and the functions they run. It holds no
test of its own.

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
