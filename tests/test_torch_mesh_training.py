"""The port's LM training on a mesh of ``gloo`` ranks on the CPU.

- the training driver (``launch.train.main``) on 4 ranks builds JAX's mesh
  ((1, 4)) and trains qwen2 SMOKE (float32 compute, patched into the
  driver's config: bf16 psums reorder the sums) 3 steps at the one-rank
  driver's losses (1e-5), with its int8 error-feedback compression on a
  (2, 2) mesh too (the weights and AdamW state cut over ``"data"`` as
  well); then the 4-rank checkpoint restores onto 2 ranks
  ((1, 2)) through ``elastic_restore`` (each rank the checkpoint's blocks)
  and the driver's resume there continues at the one-rank run's losses;
  the (2, 2) run's checkpoint restores onto (1, 4), each rank the global
  arrays' blocks bit for bit, and holds the one-rank run's weights;
- one mesh train step's collectives by kind, as the model's layout says
  they must be, and none without a mesh;
- the clip norm over blocks where the divisibility guard alone would
  misread a block as whole (``Model.param_specs`` gives the global shapes,
  equal to ``init``'s for every architecture);
- ``shard_params`` / ``gather_params`` round trip; ``Sharder.constrain``
  cuts, gathers and trades an axis by one all_to_all;
- ``Model.init(..., sharder=)`` (the driver's init on a mesh) gives every
  rank ``shard_params``' blocks of the whole init bit for bit while
  cutting each leaf as it is drawn: no draw larger than one chunk of a
  leaf drawn in chunks, each block in storage of its own size;
- on (2, 2) a rank's parameter and AdamW bytes are a quarter of the
  tree's for every leaf the divisibility guard cuts over both axes.
"""
import itertools
import types

import numpy as np
import pytest
import torch

import test_torch_dist_workers as W
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim import AdamW, OptConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel.collectives import count_collectives
from repro_torch.parallel.sharding import (Sharder, held_shardings, shard_params,
                                           tree_paths)
from repro_torch.train import make_train_step

BASE = ["--arch", "qwen2_0_5b", "--smoke", "--batch", "4", "--seq", "16",
        "--device", "cpu", "--impl", "ref", "--log-every", "1"]


def _losses(result):
    return [h["loss"] for h in result["history"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_training")
    ck, ck_ef = str(d / "ck"), str(d / "ck_ef")
    ef = BASE + ["--steps", "3", "--grad-compress"]
    four = W.launch("mesh_training", 4, d / "r4",
                    argv=BASE + ["--steps", "3", "--ckpt-dir", ck],
                    ef_argv=ef + ["--ckpt-dir", ck_ef], ef_ckpt=ck_ef)
    two = W.launch("mesh_resume", 2, d / "r2", ckpt=ck,
                   argv=BASE + ["--steps", "5", "--ckpt-dir", ck, "--resume"])
    with pytest.MonkeyPatch.context() as mp:    # the ranks' float32 configs
        mp.setattr(train, "get_smoke_config", lambda arch: get_smoke_config(arch)
                   .replace(compute_dtype="float32"))
        one = train.main(BASE + ["--steps", "5"])
        one_ef = train.main(ef + ["--ckpt-dir", str(d / "ck_one_ef")])
    return {"four": four, "two": two, "one": one, "one_ef": one_ef, "ck": d / "ck",
            "ck_ef": d / "ck_ef", "ck_one_ef": d / "ck_one_ef"}


def _arrays(ckdir, step):
    return np.load(next(p for p in ckdir.iterdir() if p.name.endswith(f"{step:06d}"))
                   / "arrays.npz")


def test_driver_on_four_ranks_matches_one_rank(runs):
    want = _losses(runs["one"])
    for g in runs["four"]:
        got = _losses(g["driver"])
        assert [h["step"] for h in g["driver"]["history"]] == [1, 2, 3]
        assert got == pytest.approx(want[:3], rel=1e-5)
        assert _losses(g["ef"]) == pytest.approx(_losses(runs["one_ef"]), rel=1e-5)


def test_resume_on_two_ranks_continues_the_run(runs, tmp_path_factory):
    """The 4-rank run's checkpoint (step 3, the global arrays) restores
    onto (1, 2) through ``elastic_restore``, each rank its blocks; the
    driver's ``--resume`` there continues at the one-rank losses."""
    want = _losses(runs["one"])
    ck = next(p for p in runs["ck"].iterdir() if p.name.endswith("000003"))
    arrays = np.load(ck / "arrays.npz")
    cfg = get_smoke_config("qwen2_0_5b")
    specs = build_model(cfg).param_specs()
    for g in runs["two"]:
        assert g["step"] == 3 and g["meta"]["train_step"] == 3
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, coords=g["coords"])
        places = held_shardings(specs, cfg, Sharder(mesh, 4))
        for i, (blk, pl) in enumerate(zip(tree_leaves(g["blocks"]), tree_leaves(places))):
            a = arrays[f"leaf_{i}"]
            np.testing.assert_array_equal(blk, a[pl.slices(a.shape, g["coords"])])
        assert [h["step"] for h in g["driver"]["history"]] == [4, 5]
        assert _losses(g["driver"]) == pytest.approx(want[3:], rel=1e-5)


def test_fsdp_checkpoint_restores_onto_another_mesh(runs):
    """The (2, 2) int8 run's checkpoint (step 3, written from blocks cut over
    "data" and "model") restores onto (1, 4) through ``elastic_restore``:
    every rank the global arrays' blocks bit for bit. The global weights
    are the one-rank run's within what 3 AdamW steps can move a weight
    apart (2 x 3 x lr): a misplaced block would be off by the init's scale."""
    cfg = get_smoke_config("qwen2_0_5b")
    model = build_model(cfg)
    opt = make_train_step(model, OptConfig(), None, impl="ref",
                          grad_compress=True).optimizer
    specs = model.param_specs()
    arrays, one = _arrays(runs["ck_ef"], 3), _arrays(runs["ck_one_ef"], 3)
    n_params = len(tree_leaves(specs))
    for i in range(n_params):
        a, b = arrays[f"leaf_{i}"], one[f"leaf_{i}"]
        assert a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b).max() <= 2 * 3 * 3e-4, i
    for g in runs["four"]:
        got = g["ef_restored"]
        assert got["meta"]["train_step"] == 3
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 4}, coords=got["coords"])
        places = held_shardings((specs, opt.init(specs)), cfg, Sharder(mesh, 4))
        leaves = tree_leaves(got["blocks"])
        assert len(leaves) == len(tree_leaves(places)) > n_params
        for i, (blk, pl) in enumerate(zip(leaves, tree_leaves(places))):
            a = arrays[f"leaf_{i}"]
            np.testing.assert_array_equal(blk, a[pl.slices(a.shape, got["coords"])])


def test_mesh_train_step_collectives_by_kind(runs):
    """qwen2 SMOKE, 2 layers, 4 q / 2 K/V heads of 16 on (1, 4), remat
    "none": forward, the embedding's psum, per layer the K and V column
    blocks gathered (the K/V heads do not split over 4) and the
    attention's and the MLP's psums, the cross-entropy's pmax and two
    psums; backward, the logits' and per layer the MLP's and attention's
    inputs summed and the K / V gathers' transposes (psum-scatters, an
    all-reduce each); the clip norm's psum: 8 + 9 + 1 all-reduces and 4
    all-gathers."""
    for g in runs["four"]:
        (n1, k1, b1), (n2, k2, b2) = g["step_counts"]
        assert (n1, k1, b1) == (n2, k2, b2)
        assert k1 == {"allreduce_": 18, "allgather_": 4}, k1
        assert n1 == 22 and b1 > 0


def test_no_collectives_without_a_mesh():
    cfg = get_smoke_config("qwen2_0_5b").replace(compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    step = make_train_step(model, OptConfig(), Sharder(None, 4), impl="ref")
    opt = step.optimizer.init(params)
    batch = train.synth_batch(model, train.ShapeConfig("t", "train", 16, 4), 0, "cpu")
    with count_collectives() as c:
        step(params, opt, batch)
    assert c.count == 0 and c.nbytes == 0 and not c.kinds


def test_clip_norm_over_blocks_the_guard_alone_misreads(runs):
    """arctic's 8 experts on (1, 4): each rank's block of 2 does not divide
    4, yet it is a block; the mesh step's global norm (from the global
    shapes, ``Model.param_specs``) is the one-rank step's."""
    cfg = get_smoke_config("arctic_480b").replace(compute_dtype="float32")
    model = build_model(cfg, "scatter_gspmd")
    params = model.init(0, device="cpu")
    step = make_train_step(model, OptConfig(), None, impl="ref")
    batch = train.synth_batch(model, train.ShapeConfig("t", "train", 16, 4), 0, "cpu")
    _, _, metrics = step(params, step.optimizer.init(params), batch)
    for g in runs["four"]:
        assert g["arctic_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_are_the_init_shapes(arch):
    model = build_model(get_smoke_config(arch))
    specs, params = model.param_specs(), model.init(0, device="cpu")
    assert [(tuple(a.shape), a.dtype) for a in tree_leaves(specs)] == \
        [(tuple(b.shape), b.dtype) for b in tree_leaves(params)]
    assert tree_paths(specs) == tree_paths(params)


def test_shard_gather_and_constrain_on_a_mesh(runs):
    for g in runs["four"]:
        assert g["round_trip"]
        assert g["constrain"] == {"a2a": True, "cut": True, "gather": True, "same": True}


INIT_ARCHS = [("grok_1_314b", {}), ("arctic_480b", {}),
              ("llama3_8b", {"param_dtype": "bfloat16"}), ("qwen2_0_5b", {})]


@pytest.mark.parametrize("arch,changes", INIT_ARCHS)
def test_fsdp_blocks_hold_a_quarter_of_the_state(arch, changes):
    """Every rank of (2, 2): for each leaf that the divisibility guard cuts
    over both "data" and "model", the rank's parameter block and its two
    AdamW moments hold a quarter of the whole leaf's bytes."""
    cfg = get_smoke_config(arch).replace(**changes)
    model = build_model(cfg)
    specs = model.param_specs()
    opt = AdamW(OptConfig())
    for d, r in itertools.product(range(2), range(2)):
        mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                     coords={"data": d, "model": r})
        sh = Sharder(mesh, 4)
        params = model.init(0, device="cpu", sharder=sh)
        state = opt.init(params)
        whole_m = opt.init(specs)
        both = 0
        for path, p, s, blk, m, v, wm in zip(
                tree_paths(specs), tree_leaves(held_shardings(specs, cfg, sh)),
                tree_leaves(specs), tree_leaves(params), tree_leaves(state["m"]),
                tree_leaves(state["v"]), tree_leaves(whole_m["m"])):
            cut = [e for e in p.spec if e is not None]
            if sorted(cut) != ["data", "model"]:
                continue
            both += 1
            assert 4 * blk.numel() * blk.element_size() == s.numel() * s.element_size(), path
            for t in (m, v):
                assert 4 * t.numel() * t.element_size() == wm.numel() * wm.element_size(), path
        assert both >= 7          # the embedding, head and every layer weight


@pytest.mark.parametrize("arch,changes", INIT_ARCHS)
def test_init_on_a_mesh_cuts_each_leaf_as_it_is_drawn(monkeypatch, arch, changes):
    """Every rank of (2, 2) and (1, 4), with the draws' chunk cut to 1,000
    elements so that the narrow-dtype leaves are drawn in chunks that end
    mid-row."""
    from repro_torch.models import layers
    chunk = 1000
    monkeypatch.setattr(layers, "_DRAW_CHUNK", chunk)
    cfg = get_smoke_config(arch).replace(**changes)
    model = build_model(cfg)
    whole = model.init(0, device="cpu")
    specs = tree_leaves(model.param_specs())
    # the draws of a whole leaf: float32 leaves and those within a chunk
    most = max(max(t.numel() for t in specs
                   if t.dtype == torch.float32 or t.numel() <= chunk), chunk)
    assert (cfg.param_dtype == "float32") != any(
        t.numel() > chunk and t.dtype != torch.float32 for t in specs)
    drawn, real = [], torch.nn.init.trunc_normal_

    def spy(t, *a, **k):
        drawn.append(t.numel())
        return real(t, *a, **k)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", spy)
    for shape in ((2, 2), (1, 4)):
        for d, r in itertools.product(range(shape[0]), range(shape[1])):
            mesh = types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                                         coords={"data": d, "model": r})
            sh = Sharder(mesh, 4)
            drawn.clear()
            got = model.init(0, device="cpu", sharder=sh)
            assert 0 < max(drawn) <= most
            for a, b in zip(tree_leaves(got), tree_leaves(shard_params(whole, cfg, sh))):
                assert a.dtype == b.dtype and torch.equal(a, b)
                assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
