"""The SSM, hybrid, encoder-decoder and VLM families on a mesh against the
JAX package on the same mesh: JAX's ``Model.loss`` jitted with
``Sharder(mesh)`` and ``param_shardings`` on 4 host devices and its
teacher-forced logits (one subprocess, which writes the inputs first), the
port's on 4 ``gloo`` ranks meanwhile, each with its blocks of JAX's
parameters and its rows of the batch (one launch; cases in
``torch_mesh_cases.py``), all SMOKE configs in float32.

- the loss within 1e-5 and every rank's gradient blocks within 2e-4 of
  JAX's global gradient: mamba2 on (2, 2) and (1, 4) (``in_proj``'s 296
  columns in blocks of 148 and 74, not head-aligned: gathered whole over
  "model" and summed back), zamba2 on (2, 2) (2 groups and a tail, the
  shared block applied twice), seamless on (2, 2) (the cross-attention
  leaves whole on every rank), qwen2-VL on (2, 2) (random M-RoPE
  positions, cut on their batch dimension 1; the embedding table's block
  zero, also in the mesh train step), mamba2 on (2, 2) at a batch of 3
  (no batch axes), and mamba2 with 2 heads on (1, 4) (they do not divide
  4: the whole block on every rank);
- prefill and 4 decode steps of each family on (1, 4) against JAX's
  teacher-forced logits within 1e-4 x max|logit|, the caches holding the
  rank's heads and slots, and a decode step of the SSM families sending
  fewer bytes a rank than its blocks of ``in_proj`` (serving moves the
  projections over "model", not the weights);
- the training driver trains mamba2 on 4 ranks on (2, 2) at the one-rank
  driver's losses (1e-5);
- ``launch.train.batch_block`` cuts the VLM's (3, B, S) positions on (2, 2)
  along B;
- ``Model.init(..., sharder=)`` gives every rank of (2, 2) and (1, 4)
  ``shard_params``' blocks of the whole init bit for bit, for each of the
  four families.
"""
import itertools
import types

import numpy as np
import pytest
import torch

import test_torch_dist_workers as W
import torch_mesh_cases as C
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel.sharding import (Sharder, _flatten_with_path, held_shardings,
                                           shard_params)

DRIVER = ["--arch", "mamba2_780m", "--smoke", "--batch", "4", "--seq", "32",
          "--steps", "3", "--device", "cpu", "--impl", "ref", "--log-every", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_families")
    job = C.JaxJob("families", d)       # the port's side runs meanwhile
    _, path = job.inputs()
    got = W.launch("mesh_families", 4, d / "ranks", inputs=str(path),
                   driver_argv=DRIVER)
    with pytest.MonkeyPatch.context() as mp:    # the ranks' float32 config
        mp.setattr(train, "get_smoke_config", lambda arch: get_smoke_config(arch)
                   .replace(compute_dtype="float32"))
        one = train.main(DRIVER)
    return job.results(), got, one


def _coords(rank, shape):
    return dict(zip(("data", "model"), (int(c) for c in np.unravel_index(rank, shape))))


@pytest.mark.parametrize("name", list(C.FAMILY_CASES))
def test_loss_and_gradient_blocks_match_jax(runs, name):
    jout, got, _ = runs
    arch, shape, B, S, ch = C.FAMILY_CASES[name]
    cfg = C.config(arch, ch)
    want = jout[name]
    rows = B // shape[0] if B % shape[0] == 0 else B
    for rank, g in enumerate(got):
        mine = g[name]
        np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5)
        assert all(s[1 if k == "positions" else 0] == rows
                   for k, s in mine["batch_shapes"].items())
        coords = _coords(rank, shape)
        mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                     coords=coords)
        places = held_shardings(want["grads"], cfg, Sharder(mesh, B))
        for (path, jg), (_, tg), (_, pl) in zip(_flatten_with_path(want["grads"]),
                                                _flatten_with_path(mine["grads"]),
                                                _flatten_with_path(places)):
            block = jg[pl.slices(jg.shape, coords)]
            assert tg.shape == block.shape, path
            np.testing.assert_allclose(tg, block, atol=2e-4, rtol=0,
                                       err_msg="/".join(path))
        if cfg.family == "vlm":       # embeds mode never reads the table
            assert not np.any(mine["grads"]["embed"]["tok"])
            kind, shp, top = mine["step_embed_grad"]
            assert kind == "Tensor" and shp == mine["grads"]["embed"]["tok"].shape
            assert top == 0.0


@pytest.mark.parametrize("name", list(C.FAMILY_DECODE))
def test_prefill_and_decode_match_jax(runs, name):
    jout, got, _ = runs
    arch, B, S, n = C.FAMILY_DECODE[name]
    cfg = get_smoke_config(arch)
    want = jout[name]["logits"]
    first = 0 if cfg.family == "encdec" else S - 1       # the prefill's position
    for g in got:
        mine = g[name]
        assert len(mine["logits"]) == n + 1
        for j, a in enumerate(mine["logits"]):
            b = want[:, first + j]
            a = np.asarray(a).reshape(b.shape)
            np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=0)
        cache = mine["cache"]
        if "ssm" in cache:            # the rank's heads, its block of the conv columns
            di = cfg.ssm.expand * cfg.d_model
            nh, N = di // cfg.ssm.head_dim, cfg.ssm.state_dim
            assert cache["ssm"][2] == nh // 4
            assert cache["conv"][-1] == (di + 2 * N) // 4
            # serving moves the projections, not the rank's in_proj blocks
            assert mine["step_bytes"] < mine["in_proj_bytes"]
        if "k" in cache:              # the rank's quarter of the slots
            slots = C.ENCDEC_SLOTS if cfg.family == "encdec" else S + n
            assert cache["k"][2] == slots // 4
        if "cross_k" in cache:        # every head of the source's K/V
            assert cache["cross_k"][2:] == (S, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_driver_trains_mamba2_on_four_ranks(runs):
    _, got, one = runs
    want = [h["loss"] for h in one["history"]]
    for g in got:
        assert [h["step"] for h in g["driver"]["history"]] == [1, 2, 3]
        assert [h["loss"] for h in g["driver"]["history"]] == pytest.approx(want, rel=1e-5)


def test_batch_block_cuts_vlm_positions_on_their_batch_dim():
    model = build_model(get_smoke_config("qwen2_vl_7b"))
    dims = train.batch_dims(model)
    assert dims == {"embeds": 0, "labels": 0, "positions": 1}
    B, S = 4, 6
    batch = {"embeds": torch.arange(B * S * 2.0).reshape(B, S, 2),
             "labels": torch.arange(B * S).reshape(B, S),
             "positions": torch.arange(3 * B * S).reshape(3, B, S)}
    for d, r in itertools.product(range(2), range(2)):
        mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                     coords={"data": d, "model": r})
        got = train.batch_block(batch, Sharder(mesh, B), dims)
        rows = slice(2 * d, 2 * d + 2)
        assert torch.equal(got["embeds"], batch["embeds"][rows])
        assert torch.equal(got["labels"], batch["labels"][rows])
        assert torch.equal(got["positions"], batch["positions"][:, rows])
        assert got["positions"].shape == (3, 2, S)
    # 3 rows do not split over "data": every rank the whole batch
    odd = {k: v[:, :3] if k == "positions" else v[:3] for k, v in batch.items()}
    got = train.batch_block(odd, Sharder(mesh, 3), dims)
    assert all(torch.equal(got[k], odd[k]) for k in odd)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b", "seamless_m4t_large_v2",
                                  "qwen2_vl_7b"])
def test_init_on_a_mesh_is_shard_params_of_the_whole_init(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    whole = model.init(0, device="cpu")
    for shape in ((2, 2), (1, 4)):
        for d, r in itertools.product(range(shape[0]), range(shape[1])):
            mesh = types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                                         coords={"data": d, "model": r})
            sh = Sharder(mesh, 4)
            got = model.init(0, device="cpu", sharder=sh)
            for a, b in zip(tree_leaves(got), tree_leaves(shard_params(whole, cfg, sh))):
                assert a.dtype == b.dtype and torch.equal(a, b)
