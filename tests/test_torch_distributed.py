"""The port's multi-rank path against the JAX package on the CPU: ranks are
spawned processes of one ``gloo`` process group (``test_torch_dist_workers``:
a ``file://`` store in the test's directory, a timeout on the group and a
deadline on the join), world 4 (the halo also at world 8), SMOKE config,
partitions of 8^3.

- the halo exchange, bit for bit against both packages' reference and
  make_partition's own ghost cells on interior faces;
- the binary swap and the distributed render step against JAX's
  ``binary_swap`` / ``make_distributed_render_step`` (run on 4 host
  devices in a subprocess) and ``composite_depth_sort``: 1e-6 for the
  compositing, 1e-5 for frames (XLA's FMA fusion under jit, ROADMAP C5);
- the Sharder, ``lm_param_rules`` / ``spec_for_path`` / ``tree_paths``
  against JAX's for every LM config, entry by entry;
- the zero-collective counter on a rank's chunk, on a chunk with a
  partition masked out, and on a control ring shift that must be counted;
- rank-sharded training against the single-process run: bit for bit
  against the same partition trained alone with its global index, within
  1e-6 of the stacked run (the CPU's batched products change their last
  bits with the stack's size, which the test shows) and within 1e-5 of
  JAX's stacked trainer.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_workers as W
from repro.configs import dvnr as jdvnr
from repro.configs.base import get_config as jget_config, list_archs
from repro.core import render as jrender
from repro.core import trainer as jtr
from repro.data.halo import halo_exchange_ref as jhalo_ref
from repro.data.volume import make_partition as jmake_partition
from repro.models.api import build_model as jbuild_model
from repro.parallel import sharding as jsh
from repro_torch import api
from repro_torch.configs import dvnr
from repro_torch.core import render as trender
from repro_torch.data.halo import halo_exchange_ref
from repro_torch.data.volume import make_partition, partition_grid
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import sharding as tsh

ROOT = Path(__file__).resolve().parents[1]
LOCAL = (8, 8, 8)
CFG = dvnr.SMOKE
JCFG = jdvnr.SMOKE


def _bare(vols):
    """The stacked volumes with their ghost shells zeroed (loaded post hoc)."""
    bare = torch.zeros_like(vols)
    bare[:, 1:-1, 1:-1, 1:-1] = vols[:, 1:-1, 1:-1, 1:-1]
    return bare


def test_meshes_of_ranks(tmp_path):
    res = W.launch("meshes", 4, tmp_path)
    for r, got in enumerate(res):
        shape, coords, index, device, backend = got["elastic"]
        assert shape == {"data": 2, "model": 2} and index == r
        assert coords == {"data": r // 2, "model": r % 2}     # row-major
        assert device == "cpu" and backend == "gloo"
        assert got["flat"] == ({"data": 4}, r) and got["device"] == "cpu"
        # a shape the group cannot hold, smaller or larger, raises
        assert "needs 8 ranks" in got["larger"]
        assert "needs 256 ranks" in got["production"]
        assert "needs 2 ranks" in got["smaller"]


@pytest.mark.parametrize("world", [4, 8])
def test_halo_exchange_bit_for_bit(tmp_path, world):
    grid = partition_grid(world)
    got = torch.stack(W.launch("halo", world, tmp_path, grid=grid, local=LOCAL))
    vols = torch.stack([make_partition("cloverleaf", p, grid, LOCAL, 0.3,
                                       device="cpu").data for p in range(world)])
    bare = _bare(vols)
    ref = halo_exchange_ref(bare, grid, 1)
    assert torch.equal(got, ref)
    jref = np.asarray(jhalo_ref(jnp.asarray(bare.numpy()), grid, 1))
    np.testing.assert_array_equal(got.numpy(), jref)
    # interior faces (their owned extent) carry make_partition's ghost cells
    from repro_torch.data.halo import _neighbor_table
    nbr = _neighbor_table(grid)
    n_faces = 0
    for p in range(world):
        for ax in range(3):
            for side in (0, 1):
                sl = [slice(1, -1)] * 3
                sl[ax] = slice(0, 1) if side == 0 else slice(-1, None)
                if nbr[p, ax, side] >= 0:
                    assert torch.equal(got[p][tuple(sl)], vols[p][tuple(sl)])
                    n_faces += 1
                else:   # domain edges stay as loaded
                    assert not got[p][tuple(sl)].any()
    assert n_faces > 0


# --------------------------------------------------------------------------- #
# the binary swap and the distributed render step
# --------------------------------------------------------------------------- #
IMAGE, SAMPLES = 16, 16

_JAX_SWAP = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import dvnr
from repro.core.render import binary_swap, make_distributed_render_step
from repro.launch.mesh import build_mesh
d = np.load(sys.argv[1], allow_pickle=True)
n = d["images"].shape[0]
mesh = build_mesh(np.asarray(jax.devices()[:n]), ("data",))
# both shard_map programs under jit, as they run in production (run op by
# op, outside jit, they take most of two minutes on the CPU)
swap = jax.jit(lambda i, z: binary_swap(mesh, ("data",), i, z))(
    jnp.asarray(d["images"]), jnp.asarray(d["depths"]))
cfg = dvnr.SMOKE
params = {"tables": jnp.asarray(d["tables"]),
          "mlp": [jnp.asarray(d[f"mlp{i}"]) for i in range(int(d["n_mlp"]))]}
step = jax.jit(make_distributed_render_step(cfg, mesh, n_samples=int(d["samples"])))
frame = step(params, jnp.asarray(d["los"]), jnp.asarray(d["exts"]),
             jnp.asarray(d["vrs"]), jnp.asarray(d["origins"]),
             jnp.asarray(d["dirs"]), jnp.asarray(d["tf"]), jnp.asarray(d["grange"]))
np.savez(sys.argv[2], swap=np.asarray(swap), frame=np.asarray(frame))
"""


@pytest.fixture(scope="module")
def render_case(tmp_path_factory):
    """4 partitions of random weights (tables U(-0.1, 0.1)), their
    per-partition images and depths from the port's renderer, and JAX's
    binary swap and render step of the same on 4 host devices."""
    world = 4
    grid = partition_grid(world)
    parts = [make_partition("cloverleaf", p, grid, LOCAL, 0.3, device="cpu")
             for p in range(world)]
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.array,
                          jtr.DVNRTrainer(JCFG, world).init(jax.random.PRNGKey(4)).params)
    params["tables"] = rng.uniform(-0.1, 0.1, params["tables"].shape).astype(np.float32)
    model = api.DVNRModel(CFG, {"tables": torch.from_numpy(params["tables"]),
                                "mlp": [torch.from_numpy(w) for w in params["mlp"]]},
                          [{"origin": p.origin, "extent": p.extent, "vmin": p.vmin,
                            "vmax": p.vmax} for p in parts])
    cam = trender.Camera()
    origins, dirs = trender.make_rays(cam, IMAGE, IMAGE, "cpu")
    tf = trender.default_tf(device="cpu")
    metas = model.meta_arrays()
    images, depths = trender._render_batch(
        CFG, model.stacked_params(), metas, origins[None], dirs[None], tf[None],
        model.grange, n_samples=SAMPLES, impl="ref")
    images, depths = images[0].numpy(), depths[0].numpy()
    d = tmp_path_factory.mktemp("jax_swap")
    np.savez(d / "in.npz", images=images, depths=depths, tables=params["tables"],
             n_mlp=len(params["mlp"]), samples=SAMPLES,
             **{f"mlp{i}": w for i, w in enumerate(params["mlp"])},
             los=metas[0].numpy(), exts=metas[1].numpy(), vrs=metas[2].numpy(),
             origins=origins.numpy(), dirs=dirs.numpy(), tf=tf.numpy(),
             grange=np.asarray(model.grange, np.float32))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _JAX_SWAP, str(d / "in.npz"),
                    str(d / "out.npz")], env=env, check=True, timeout=300)
    jout = np.load(d / "out.npz")
    return types.SimpleNamespace(model=model, images=images, depths=depths,
                                 metas=[m.numpy() for m in metas],
                                 rays=(origins.numpy(), dirs.numpy()),
                                 tf=tf.numpy(), params=params,
                                 jswap=jout["swap"], jframe=jout["frame"])


def test_binary_swap_matches_jax(tmp_path, render_case):
    c = render_case
    got = W.launch("swap", 4, tmp_path, images=c.images, depths=c.depths)
    for g in got[1:]:
        assert torch.equal(g, got[0])           # the same frame on every rank
    ref = np.asarray(jrender.composite_depth_sort(jnp.asarray(c.images),
                                                  jnp.asarray(c.depths)))
    np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), c.jswap[0], atol=1e-6, rtol=0)
    assert np.abs(ref).max() > 0.05           # the frame is not empty


def test_distributed_render_step_matches_api_render(tmp_path, render_case):
    c = render_case
    los, exts, vrs = c.metas
    got = W.launch("render", 4, tmp_path, cfg=CFG, np_params=c.params,
                   metas=(los, exts, vrs), rays=c.rays, tf_table=c.tf,
                   grange=c.model.grange, n_samples=SAMPLES)
    for g in got[1:]:
        assert torch.equal(g, got[0])
    req = api.RenderRequest(width=IMAGE, height=IMAGE, n_samples=SAMPLES)
    frame = api.render(c.model, req, backend="ref").reshape(-1, 4)
    np.testing.assert_allclose(got[0].numpy(), frame.numpy(), atol=1e-5, rtol=0)
    # api.render accepts a mesh and, as JAX's, renders in this process
    same = api.render(c.model, req, backend="ref", mesh=object()).reshape(-1, 4)
    assert torch.equal(same, frame)
    np.testing.assert_allclose(got[0].numpy(), c.jframe[0], atol=1e-5, rtol=0)


# --------------------------------------------------------------------------- #
# sharding rules
# --------------------------------------------------------------------------- #
class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("arch", list_archs())
def test_sharding_rules_match_jax(arch):
    cfg = jget_config(arch)
    model = jbuild_model(cfg)
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda x: _Shape(x.shape), abstract)
    assert tsh.tree_paths(tree) == jsh.tree_paths(abstract)
    rules, jrules = tsh.lm_param_rules(cfg), jsh.lm_param_rules(cfg)
    assert rules == jrules
    for shape in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
                  {"data": 4, "model": 2}, {"data": 3, "model": 5}):
        mesh = types.SimpleNamespace(shape=shape)
        ts, js = tsh.Sharder(mesh, global_batch=32), jsh.Sharder(mesh, global_batch=32)
        assert ts.axis_map == js.axis_map
        for logical in (None, "batch", "fsdp", "model", "expert", "seq", "part"):
            assert ts.resolve(logical) == js.resolve(logical)
            assert ts.axis_size(logical or "batch") == js.axis_size(logical or "batch")
        assert tsh.batch_axes_for(mesh, 48) == jsh.batch_axes_for(mesh, 48)
        for path, (_, leaf) in zip(jsh.tree_paths(abstract),
                                   tsh._flatten_with_path(tree)):
            want = jsh._guard_divisibility(
                jsh.spec_for_path(path, jrules, len(leaf.shape), js),
                leaf.shape, js)
            got = tsh._guard_divisibility(
                tsh.spec_for_path(path, rules, len(leaf.shape), ts), leaf.shape, ts)
            assert len(got) == len(tuple(want)) and \
                all(a == b for a, b in zip(got, tuple(want))), (path, got, want)
    # no mesh: every spec replicated; on a mesh whose axes are all 1 wide
    # constrain holds every block whole (the reshardings on 4 ranks:
    # test_torch_mesh_training.py); a non-Sharder is refused
    assert tsh.Sharder().spec("batch", "model") == tuple(jsh.Sharder().spec("batch", "model"))
    one = Mesh({"data": 1, "model": 1}, ("data", "model"), {"data": 0, "model": 0}, 0,
               torch.device("cpu"))
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(tsh.Sharder(one).constrain(x, "batch", "model"), x)
    with pytest.raises(TypeError, match="Sharder"):
        tsh.mesh_sharder(types.SimpleNamespace(mesh=one))


def test_placements_cut_and_param_shardings():
    mesh = Mesh({"data": 2, "model": 2}, ("data", "model"),
                {"data": 1, "model": 0}, 2, torch.device("cpu"))
    sh = tsh.Sharder(mesh)
    a = np.arange(8 * 3).reshape(8, 3)
    tree = {"w": a, "s": np.zeros(())}
    places = tsh.partition_shardings(tree, sh)
    assert places["w"].spec == (("data", "model"),) and places["s"].spec == ()
    np.testing.assert_array_equal(places["w"].local(a), a[4:6])
    assert places["w"].local_shape((8, 3)) == (2, 3)
    ps = tsh.param_shardings({"embed": {"tok": _Shape((512, 64))}},
                             jget_config("llama3_8b"), sh)
    assert ps["embed"]["tok"].spec == ("model", "data")
    assert tsh.param_shardings({"x": _Shape((4,))}, jget_config("llama3_8b"),
                               tsh.Sharder()) == {"x": None}


# --------------------------------------------------------------------------- #
# training across ranks
# --------------------------------------------------------------------------- #
STEPS = 12


@pytest.fixture(scope="module")
def rank_training(tmp_path_factory):
    world = 4
    grid = partition_grid(world)
    res = W.launch("train", world, tmp_path_factory.mktemp("train"), cfg=CFG,
                   grid=grid, local=LOCAL, steps=STEPS, key=3,
                   mask=[True, False, True, True])
    return world, grid, res


def test_rank_chunk_issues_zero_collectives(rank_training):
    world, _, res = rank_training
    for r, out in enumerate(res):
        assert out["partitions"] == (r,)
        assert out["collectives"] == 0            # init + every chunk
        assert out["masked_collectives"] == 0     # a partition masked out
        assert out["control_collectives"] >= 1    # a ring shift is counted
        assert torch.equal(out["control"], torch.full((2,), float((r - 1) % world)))


def _alone(p, world, grid):
    """Partition p trained alone in this process with its global index (a
    stand-in mesh: the trainer reads only the mesh's size, index and
    device)."""
    mesh = Mesh({"data": world}, ("data",), {"data": p}, p, torch.device("cpu"))
    part = make_partition("cloverleaf", p, grid, LOCAL, 0.3, device="cpu")
    return api.train([part], CFG, backend="ref", mesh=mesh, steps=STEPS, key=3)[0]


def test_rank_sharded_training_matches_stacked(rank_training):
    world, grid, res = rank_training
    parts = [make_partition("cloverleaf", p, grid, LOCAL, 0.3, device="cpu")
             for p in range(world)]
    stacked, _ = api.train(parts, CFG, backend="ref", steps=STEPS, key=3)
    worst = 0.0
    for p, out in enumerate(res):
        alone = _alone(p, world, grid)
        for a, b, s in zip(tree_leaves(out["params"]), tree_leaves(alone.params),
                           tree_leaves(stacked.params)):
            assert torch.equal(a, b)                      # the same bits alone
            worst = max(worst, float((a[0] - s[p]).abs().max()))
    assert worst <= 1e-6
    if worst > 0:
        # the cause: the plain MLP's batched matmul gives other last bits for
        # a stack of 4 partitions than for one, while the encode does not
        from repro_torch.core.trainer import init_params
        from repro_torch.kernels.fused_mlp.ref import fused_mlp_batched_ref
        rng = np.random.default_rng(0)
        D_in = CFG.n_levels * CFG.n_features_per_level
        x = torch.from_numpy(rng.random((world, 512, D_in), np.float32))
        ws = init_params(CFG, 0, world)["mlp"]
        full = fused_mlp_batched_ref(x, ws, torch.arange(world))
        one = [fused_mlp_batched_ref(x[p:p + 1], [w[p:p + 1] for w in ws],
                                     torch.zeros(1, dtype=torch.int64))[0]
               for p in range(world)]
        assert any(not torch.equal(o, full[p]) for p, o in enumerate(one))
        assert max(float((o - full[p]).abs().max()) for p, o in enumerate(one)) < 1e-6


def test_rank_sharded_training_matches_jax(rank_training):
    world, grid, res = rank_training
    jparts = [jmake_partition("cloverleaf", p, grid, LOCAL, 0.3) for p in range(world)]
    from repro import api as japi
    jm, _ = japi.train(jparts, JCFG, backend="ref", steps=STEPS,
                       key=jax.random.PRNGKey(3))
    jp = jax.tree.map(np.asarray, jm.params)
    for p, out in enumerate(res):
        for a, b in zip(tree_leaves(out["params"]), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a[0].numpy(), b[p], atol=1e-5, rtol=0)
