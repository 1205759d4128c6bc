"""repro_torch.core.inr against repro.core.inr, with the JAX package's
weights carried across by repro_torch.interop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dvnr as jdvnr
from repro.core import inr as jinr
from repro_torch import interop
from repro_torch.configs import dvnr
from repro_torch.core import inr

# tables of a trained model are O(0.1); the init's +-1e-4 would make every
# output the MLP's constant and hide a wrong gather
TABLE_AMP = 0.1


def _jax_params(cfg, seed=0, n_partitions=None):
    key = jax.random.PRNGKey(seed)
    if n_partitions is None:
        p = jinr.init_inr(cfg, key)
    else:
        p = jax.vmap(lambda k: jinr.init_inr(cfg, k))(
            jax.random.split(key, n_partitions))
    p = jax.tree.map(np.asarray, p)
    p["tables"] = np.random.default_rng(seed).uniform(
        -TABLE_AMP, TABLE_AMP, p["tables"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("name", ["SMOKE", "PRODUCTION256", "S3D_SCALING",
                                  "ABLATION", "CLOVERLEAF_CACHE"])
def test_param_counts_equal_jax(name):
    j, t = getattr(jdvnr, name), getattr(dvnr, name)
    assert inr.param_count(t) == jinr.param_count(j)
    assert inr.param_bytes_f16(t) == jinr.param_bytes_f16(j)


def test_init_inr_shapes_bounds_and_seeding():
    cfg = dvnr.PRODUCTION256
    p = inr.init_inr(cfg, torch.Generator().manual_seed(3), device="cpu")
    j = jax.tree.map(np.asarray, jinr.init_inr(jdvnr.PRODUCTION256,
                                               jax.random.PRNGKey(0)))
    assert p["tables"].shape == j["tables"].shape
    assert [tuple(w.shape) for w in p["mlp"]] == [w.shape for w in j["mlp"]]
    assert float(p["tables"].abs().max()) <= 1e-4
    for w in p["mlp"]:
        assert float(w.abs().max()) <= np.sqrt(6.0 / w.shape[0])
    again = inr.init_inr(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(p["tables"], again["tables"])


@pytest.mark.parametrize("impl,name", [("ref", "SMOKE"), ("pallas", "SMOKE"),
                                       ("ref", "PRODUCTION256")])
def test_inr_apply_matches_jax(impl, name):
    jcfg, cfg = getattr(jdvnr, name), getattr(dvnr, name)
    npp = _jax_params(jcfg, seed=1)
    coords = np.random.default_rng(2).uniform(0, 1, (300, 3)).astype(np.float32)
    want = np.asarray(jinr._inr_apply(jcfg, jax.tree.map(jnp.asarray, npp),
                                      jnp.asarray(coords), impl))
    params = interop.params_from_numpy(npp, "cpu")
    for backend in ("ref", "cuda"):
        got = inr._inr_apply(cfg, params, torch.from_numpy(coords), backend)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("out_dim", [1, 3])
def test_decode_grid_matches_jax(out_dim):
    jcfg = jdvnr.SMOKE.replace(out_dim=out_dim)
    cfg = dvnr.SMOKE.replace(out_dim=out_dim)
    npp = _jax_params(jcfg, seed=4)
    shape = (6, 5, 7)
    want = np.asarray(jinr._decode_grid(jcfg, jax.tree.map(jnp.asarray, npp),
                                        shape, "pallas", chunk=64))
    got = inr._decode_grid(cfg, interop.params_from_numpy(npp, "cpu"), shape,
                           "cuda", chunk=50)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    half = inr._decode_grid(cfg, interop.params_from_numpy(npp, "cpu"), shape,
                            "ref", out_dtype="bfloat16")
    assert half.dtype == torch.bfloat16


def test_batched_apply_rows_match_partitions():
    cfg = dvnr.SMOKE
    npp = _jax_params(jdvnr.SMOKE, seed=5, n_partitions=3)
    sp = interop.params_from_numpy(npp, "cpu")
    coords = torch.rand(4, 30, 3, generator=torch.Generator().manual_seed(0))
    part = [2, 0, 1, 2]
    out = inr._inr_apply_batched(cfg, sp, coords, part, "cuda")
    for b, p in enumerate(part):
        single = inr._inr_apply(cfg, {"tables": sp["tables"][p],
                                      "mlp": [w[p] for w in sp["mlp"]]},
                                coords[b], "ref")
        torch.testing.assert_close(out[b], single, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_interop_round_trip_keeps_dtype_and_bits(dtype):
    npp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                       _jax_params(jdvnr.SMOKE, seed=6, n_partitions=2))
    params = interop.params_from_numpy(npp, "cpu")
    assert params["tables"].dtype == (torch.float32 if dtype == np.float32
                                      else torch.bfloat16)
    back = interop.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(npp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
