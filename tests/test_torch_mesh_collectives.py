"""The port's differentiable collectives, MoE dispatch on a mesh,
sequence-parallel attention and the int8 all-reduce against the JAX
package on the same (2, 2) ("data", "model") mesh: JAX on 4 host devices
in one subprocess, the port on 4 ``gloo`` ranks in one launch (both once
for the module; cases and rank work in ``torch_mesh_cases.py`` and
``test_torch_dist_workers.mesh_collectives``).

- every collective's forward and its backward (the transpose JAX's
  ``shard_map`` with ``check_rep=False`` gives it: psum's is psum,
  all_gather's is psum_scatter, an output no out_spec maps over an axis
  has its cotangent divided by the axis size, an input no in_spec maps
  has its cotangent summed, ...), exactly (small integers times normals);
- the weight gather over ``"data"`` (the fsdp split): its backward one
  reduce-scatter over ``"data"`` where ``"data"`` is a batch axis (its
  input's bytes counted, as a list reduce-scatter's), else this rank's
  block of the cotangent and no collective;
- ``moe_block_tp`` (grok SMOKE, capacity 8) and ``moe_block_a2a`` (arctic
  SMOKE at capacity 16 and at the config's own, bound): forward within
  1e-5 and gradients within 2e-4 (JAX's own limits, ``test_moe_dispatch``),
  the a2a drop sets (each rank's keep mask of its tokens' routed pairs)
  exact;
- sequence-parallel attention (qwen2's block with 3 heads on a 2-wide
  axis: the models' ``attention_block``, JAX's sequence-parallel ``sdpa``
  inside) within 1e-5, its gradients within 2e-4;
- ``ef_compress_decompress(axis="model")`` against JAX's inside
  ``shard_map``: int8 codes and residuals exact, values within 1e-6.
"""
import types

import numpy as np
import pytest

import test_torch_dist_workers as W
import torch_mesh_cases as C
from repro_torch.parallel.sharding import Sharder, held_shardings


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_collectives")
    inp, jout = C.run_jax("collectives", d)
    path = d / "inputs.pkl"
    import pickle
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return jout, W.launch("mesh_collectives", 4, d / "ranks", inputs=str(path))


@pytest.mark.parametrize("name", list(C.PRIMITIVES))
def test_collective_and_its_transpose_match_jax(runs, name):
    jout, got = runs
    i, o = C.PRIMITIVES[name]
    want = jout["prims"][name]
    for g in got:
        d, r = g["coords"]
        mine = g["prims"][name]
        a, b = mine["y"].shape
        if o == "m":
            np.testing.assert_array_equal(mine["y"], want["y"][a * d:a * (d + 1),
                                                              b * r:b * (r + 1)])
        elif r == 0:        # an unmapped output: JAX returns the first block's
            np.testing.assert_array_equal(mine["y"], want["y"][a * d:a * (d + 1)])
        rows = slice(2 * d, 2 * d + 2)
        jg = want["grad"][rows, 4 * r:4 * r + 4] if i == "m" and name != "block" \
            else want["grad"][rows]
        np.testing.assert_array_equal(mine["grad"], jg)
        assert np.abs(jg).max() > 0.1


def test_weight_gather_backward_is_a_reduce_scatter(runs):
    """y = the (4, 4) column block gathered over "data"; the loss (1 + d)
    * sum(y^2) on data rank d: summed, the gradient is the block of
    sum_d 2 (1 + d) y = 6 y, by one reduce-scatter of 64 bytes; not
    summed, 2 (1 + d) y, by none."""
    _, got = runs
    x = None
    for g in got:
        d, r = g["coords"]
        s, n = g["gather_weight"][True], g["gather_weight"][False]
        np.testing.assert_array_equal(s["y"], n["y"])
        assert s["y"].shape == (4, 4)
        x = s["y"][2 * d:2 * d + 2]
        np.testing.assert_allclose(s["grad"], 6.0 * x, rtol=1e-6, atol=0)
        np.testing.assert_allclose(n["grad"], 2.0 * (1 + d) * x, rtol=1e-6, atol=0)
        assert s["coll"] == (1, {"_reduce_scatter_base_": 1}, 64)
        assert n["coll"] == (0, {}, 0)
        out, kinds, nbytes = g["reduce_scatter_list"]
        np.testing.assert_array_equal(out, np.full(3, 4.0 * (g["rank_index"] + 1)))
        assert kinds == {"reduce_scatter_": 1} and nbytes == 4 * 3 * 4
    assert np.abs(x).max() > 0.1


def _grad_blocks(cfg, jgrads, coords, key="moe"):
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                 coords={"data": coords[0], "model": coords[1]})
    places = held_shardings({key: jgrads}, cfg, Sharder(mesh, 4))[key]
    return {k: jgrads[k][places[k].slices(jgrads[k].shape)] for k in jgrads}


@pytest.mark.parametrize("name", list(C.MOE_CASES))
def test_moe_dispatch_on_a_mesh_matches_jax(runs, name):
    jout, got = runs
    arch, cap, _, _ = C.MOE_CASES[name]
    cfg = C.moe_config(arch, cap)
    want = jout[name]
    for g in got:
        d, r = g["coords"]
        mine = g[name]
        np.testing.assert_allclose(mine["y"], want["y"][2 * d:2 * d + 2], atol=1e-5, rtol=0)
        np.testing.assert_allclose(mine["gx"], want["gx"][2 * d:2 * d + 2], atol=2e-4, rtol=0)
        for k, jg in _grad_blocks(cfg, want["grads"], (d, r)).items():
            assert mine["grads"][k].shape == jg.shape
            np.testing.assert_allclose(mine["grads"][k], jg, atol=2e-4, rtol=0, err_msg=k)
        if name.startswith("a2a"):
            np.testing.assert_array_equal(mine["keep"], want["keep"][(d, r)])
        if name.startswith("tp") or (d, r) == (0, 0):
            # tp: the pmean over the batch axes; a2a: each rank's own (JAX
            # returns the first device's)
            assert abs(mine["aux"] - want["aux"]) < 1e-6
    drops = sum(int((~g[name]["keep"]).sum()) for g in got) if name.startswith("a2a") else 0
    assert (drops > 0) == (name == "a2a_config"), drops


def test_sequence_parallel_attention_matches_jax(runs):
    """3 q heads do not divide the 2-wide model axis: each rank attends its
    query rows (q and the output each moved by one all_to_all); output,
    input gradient and weight-gradient blocks as JAX's on the mesh."""
    jout, got = runs
    want = jout["attn"]
    cfg = C.config(*C.ATTN_CASE[:2])
    for g in got:
        d, r = g["coords"]
        mine = g["attn"]
        assert mine["mode"] == "seq"
        np.testing.assert_allclose(mine["o"], want["o"][d:d + 1], atol=1e-5, rtol=0)
        np.testing.assert_allclose(mine["o"], want["ref"][d:d + 1], atol=1e-5, rtol=0)
        np.testing.assert_allclose(mine["gx"], want["gx"][d:d + 1], atol=2e-4, rtol=0)
        for k, jg in _grad_blocks(cfg, want["grads"], (d, r), "attn").items():
            assert mine["grads"][k].shape == jg.shape
            np.testing.assert_allclose(mine["grads"][k], jg, atol=2e-4, rtol=0, err_msg=k)


def test_int8_allreduce_matches_jax_shard_map(runs):
    jout, got = runs
    want = jout["ef"]
    for g in got:
        d, r = g["coords"]
        sl = (slice(2 * d, 2 * d + 2), slice(4 * r, 4 * r + 4))
        np.testing.assert_array_equal(g["ef"]["q"], want["q"][sl])
        np.testing.assert_array_equal(g["ef"]["r"], want["r"][sl])
        np.testing.assert_allclose(g["ef"]["g"], want["g"][sl], atol=1e-6, rtol=0)
