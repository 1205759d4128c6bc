"""The dense and MoE LM families on a mesh against the JAX package on the
same mesh: JAX's ``Model.loss`` jitted with ``Sharder(mesh)`` and
``param_shardings`` on 4 host devices (one subprocess), the port's on 4
``gloo`` ranks, each with its blocks of JAX's parameters
(``interop.lm_params_from_numpy(..., sharder=)``) and of the batch (one
launch; cases in ``torch_mesh_cases.py``).

- the loss within 1e-5 and every rank's gradient blocks (cut over
  ``"model"`` and ``"data"``, JAX's ``param_shardings``) within 2e-4 of
  JAX's global gradient: llama3 SMOKE on (2, 2) and (1, 4) (head mode,
  the K/V heads gathered on (1, 4)), and on (2, 2) at a batch of 3, which
  ``"data"`` does not divide (no batch axes: the weight gathers' backward
  keeps each rank's block, no sum), qwen2 SMOKE with 6 q / 3 K/V heads
  on (1, 4) (6 does not divide 4: sequence mode), grok SMOKE
  (``moe_block_tp``) and arctic SMOKE (``moe_block_a2a``; its aux loss is
  the rank's own, rank 0's JAX's) on (2, 2), and the two scatters as XLA
  partitions them (arctic ``"scatter_gspmd"``, grok ``"scatter_global"``:
  the global batch gathered);
- prefill and 4 decode steps on (1, 4) (the cache cut over ``"seq"``;
  arctic's prefill by a2a, its decode steps by the scatter), and llama3's
  on (2, 2) (each layer's weights gathered over ``"data"``), against JAX's
  teacher-forced prefills (llama3's on (1, 4): they do not depend on the
  mesh), within 1e-4 x max|logit|.
"""
import pickle
import types

import numpy as np
import pytest

import test_torch_dist_workers as W
import torch_mesh_cases as C
from repro_torch.parallel.sharding import Sharder, _flatten_with_path, held_shardings


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_models")
    inp, jout = C.run_jax("models", d)
    path = d / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return jout, W.launch("mesh_models", 4, d / "ranks", inputs=str(path))


@pytest.mark.parametrize("name", list(C.LM_CASES))
def test_loss_and_gradient_blocks_match_jax(runs, name):
    jout, got = runs
    arch, shape, B, S, ch, dispatch = C.LM_CASES[name]
    cfg = C.config(arch, ch)
    want = jout[name]
    arctic = cfg.moe is not None and dispatch == "scatter" and \
        cfg.moe.expert_sharding == "ep"
    for rank, g in enumerate(got):
        mine = g[name]
        if rank == 0 or not arctic:
            np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5)
        coords = dict(zip(("data", "model"), (int(c) for c in np.unravel_index(rank, shape))))
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
    if arctic:     # the a2a aux losses are the ranks' own
        assert len({round(g[name]["loss"], 7) for g in got}) > 1


@pytest.mark.parametrize("name", list(C.DECODE_CASES))
def test_prefill_and_decode_match_jax(runs, name):
    jout, got = runs
    arch, shape, B, S, n, ch = C.DECODE_CASES[name]
    want = jout[C.DECODE_SAME.get(name, name)]["logits"]
    for g in got:
        mine = g[name]
        assert len(mine["logits"]) == n + 1
        lo, hi = mine["rows"]           # the rank's block of the batch
        assert hi - lo == B // (shape[0] if B % shape[0] == 0 else 1)
        for a, b in zip(mine["logits"], want):
            b = b[lo:hi]
            a = np.asarray(a).reshape(b.shape)
            np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=0)
        # each rank holds its quarter of the S + n cache slots
        assert mine["cache_slots"][2] == (S + n) // shape[1]
