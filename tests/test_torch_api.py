"""repro_torch.api against repro.api: DVNRModel structure and inference,
api.render frames, and the msgpack save format in both directions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import dvnr as jdvnr
from repro_torch import api, interop
from repro_torch.configs import dvnr

FRAME_ATOL = 1e-5
METAS = tuple({"origin": (0.5 * (p % 2), 0.0, 0.5 * (p // 2)),
               "extent": (0.5, 1.0, 0.5), "vmin": -0.2 * p, "vmax": 1.0 + 0.5 * p}
              for p in range(4))


def _jax_model(P=4, seed=0, amp=0.1, dtype=jnp.float32):
    """A JAX model with tables of a trained model's magnitude (see
    tests/test_torch_render.py for why not U(-1,1))."""
    m = japi.DVNRModel.init(jdvnr.SMOKE, jax.random.PRNGKey(seed),
                            n_partitions=P, parts_meta=METAS[:P])
    npp = jax.tree.map(np.asarray, m.params)
    npp["tables"] = np.random.default_rng(seed).uniform(
        -amp, amp, npp["tables"].shape).astype(np.float32)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), npp)
    return japi.DVNRModel(jdvnr.SMOKE, params, METAS[:P])


def _port(jm):
    return api.DVNRModel(dvnr.SMOKE, interop.params_from_numpy(
        jax.tree.map(np.asarray, jm.params), "cpu"), jm.parts_meta)


def test_model_structure_matches_jax():
    jm = _jax_model()
    tm = _port(jm)
    assert tm.stacked and tm.n_partitions == jm.n_partitions == 4
    assert tm.param_count == jm.param_count and tm.nbytes == jm.nbytes
    assert tm.grange == jm.grange
    p2 = tm.partition(2)
    assert not p2.stacked and p2.parts_meta == (tm.parts_meta[2],)
    assert p2.stacked_params()["tables"].shape == (1,) + tuple(p2.params["tables"].shape)
    for x, y in zip(jm.meta_arrays(), tm.meta_arrays()):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert tm.meta_arrays() is tm.meta_arrays()              # derived once
    with pytest.raises(ValueError):
        tm.apply(torch.rand(4, 3), backend="ref")
    fresh = api.DVNRModel.init(dvnr.SMOKE, 3, n_partitions=2, device="cpu")
    assert fresh.params["tables"].shape == (2,) + tuple(jm.params["tables"].shape[1:])


def test_apply_and_decode_match_jax():
    jm = _jax_model().partition(1)
    tm = _port(japi.DVNRModel(jdvnr.SMOKE, jm.params, jm.parts_meta))
    xyz = np.random.default_rng(0).uniform(0, 1, (256, 3)).astype(np.float32)
    want = np.asarray(jm.apply(jnp.asarray(xyz), backend="ref"))
    got = tm.apply(torch.from_numpy(xyz), backend="cuda")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    want = np.asarray(jm.decode_grid((5, 6, 4), backend="ref"))
    got = tm.decode_grid((5, 6, 4), backend="cuda")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("angle", [0.5, 3.0])
def test_render_frame_matches_jax(angle):
    w, h, s = 20, 16, 12        # one shape: JAX compiles each new one (~10 s)
    jm = _jax_model()
    tm = _port(jm)
    cam = japi.Camera().orbit(angle)
    want = np.asarray(japi.render(jm, japi.RenderRequest(
        camera=cam, width=w, height=h, n_samples=s), backend="ref"))
    got = api.render(tm, api.RenderRequest(camera=api.Camera(**vars(cam)),
                                           width=w, height=h, n_samples=s),
                     backend="cuda")
    assert got.shape == (h, w, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FRAME_ATOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_msgpack_from_jax_loads_and_resaves_byte_for_byte(tmp_path, dtype):
    jm = _jax_model(P=2, dtype=dtype)
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jm.save(jpath)
    tm = api.load(jpath, device="cpu")
    assert tm.cfg == dvnr.SMOKE and tm.parts_meta == tuple(
        api.PartitionMeta.of(m) for m in METAS[:2]) and tm.grange == jm.grange
    want = jax.tree.map(np.asarray, jm.params)
    got = interop.params_to_numpy(tm.params)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tm.save(tpath)
    assert tpath.read_bytes() == jpath.read_bytes()


def test_msgpack_from_port_loads_in_jax(tmp_path):
    tm = api.DVNRModel.init(dvnr.SMOKE, 7, n_partitions=2, parts_meta=METAS[:2],
                            device="cpu")
    tpath, jpath = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    api.save(tm, tpath)
    jm = japi.load(tpath)
    assert jm.cfg == jdvnr.SMOKE and jm.grange == tm.grange
    for a, b in zip(jax.tree.leaves(interop.params_to_numpy(tm.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jm.params))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    jm.save(jpath)
    assert jpath.read_bytes() == tpath.read_bytes()
    with pytest.raises(ValueError):
        (tmp_path / "junk").write_bytes(b"\x00\x01")
        api.load(tmp_path / "junk", device="cpu")
