"""repro_torch.serving against repro.serving's uncached RenderService, and
``python -m repro_torch.launch.serve`` on the CPU (the cached service:
tests/test_torch_brick_cache.py)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro.configs import dvnr as jdvnr
from repro.serving import RenderService as JaxRenderService
from repro_torch import api, interop
from repro_torch.configs import dvnr
from repro_torch.launch import serve
from repro_torch.serving import RenderService

FRAME_ATOL = 1e-5
METAS = tuple({"origin": (0.0, 0.5 * (p % 2), 0.5 * (p // 2)),
               "extent": (1.0, 0.5, 0.5), "vmin": 0.3 * p, "vmax": 2.0 + p}
              for p in range(4))


@pytest.fixture(scope="module")
def models():
    """The same weights in both packages (tables of a trained model's
    magnitude; see tests/test_torch_render.py)."""
    jm = japi.DVNRModel.init(jdvnr.SMOKE, jax.random.PRNGKey(1), n_partitions=4,
                             parts_meta=METAS)
    npp = jax.tree.map(np.asarray, jm.params)
    npp["tables"] = np.random.default_rng(1).uniform(
        -0.1, 0.1, npp["tables"].shape).astype(np.float32)
    jm = japi.DVNRModel(jdvnr.SMOKE, jax.tree.map(jnp.asarray, npp), METAS)
    tm = api.DVNRModel(dvnr.SMOKE, interop.params_from_numpy(npp, "cpu"), METAS)
    return jm, tm


def _requests(mod, tf_table):
    cam = mod.Camera()
    warm = mod.TransferFunction(table=tf_table, density=30.0)
    return [mod.RenderRequest(camera=cam.orbit(a), width=16, height=12,
                              n_samples=10) for a in (0.2, 1.9, 4.0)] + \
        [mod.RenderRequest(camera=cam.orbit(a), width=16, height=12,
                           n_samples=10, tf=warm) for a in (0.9, 2.6)] + \
        [mod.RenderRequest(camera=cam.orbit(5.0), width=9, height=7,
                           n_samples=6)]


def test_tick_frames_match_jax_uncached_service(models):
    jm, tm = models
    tf_table = np.linspace(0, 1, 4 * 9, dtype=np.float32).reshape(9, 4)
    jsvc = JaxRenderService(jm, backend="ref", use_cache=False)
    tsvc = RenderService(tm, backend="cuda", use_cache=False)
    for r in _requests(japi, tf_table):
        jsvc.submit(r)
    for r in _requests(api, tf_table):
        tsvc.submit(r)
    want, got = jsvc.tick(), tsvc.tick()
    assert [r.ticket for r in got] == [r.ticket for r in want] == list(range(6))
    assert [r.batch_size for r in got] == [r.batch_size for r in want] == \
        [3, 3, 3, 2, 2, 1]
    for a, b in zip(want, got):
        assert b.frame.shape == a.frame.shape and b.frame.dtype == np.float32
        np.testing.assert_allclose(b.frame, a.frame, atol=FRAME_ATOL)
    assert tsvc.stats() == jsvc.stats()
    assert tsvc.stats()["cache"]["lookups"] == 0 and tsvc.stats()["served"] == 6


def test_batched_tick_equals_single_renders(models):
    """Clients stacked on a leading axis render what each renders alone."""
    _, tm = models
    svc = RenderService(tm, backend="cuda", use_cache=False)
    reqs = _requests(api, None)[:3]
    for r in reqs:
        svc.submit(r)
    batch = svc.tick()
    for resp, req in zip(batch, reqs):
        alone = api.render(tm, req, backend="ref").numpy()
        np.testing.assert_allclose(resp.frame, alone, atol=1e-6)
    assert svc.render(reqs[0]).shape == (12, 16, 4)


def test_serve_entry_point_smoke_on_cpu(capsys, tmp_path):
    out = serve.main(["--smoke", "--device", "cpu", "--backend", "cuda",
                      "--frames", "2"])
    assert out["served"] == 4 and out["device"] == "cpu"
    assert out["mode"] == "cached" and out["cache_hit_rate"] == 0.5
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    # a model saved by the JAX package serves through --model
    path = tmp_path / "m.msgpack"
    japi.DVNRModel.init(jdvnr.SMOKE, jax.random.PRNGKey(0), n_partitions=2,
                        parts_meta=METAS[:2]).save(path)
    out = serve.main(["--model", str(path), "--device", "cpu", "--backend",
                      "ref", "--frames", "1", "--width", "8", "--height", "8",
                      "--n-samples", "4"])
    assert out["partitions"] == 2 and np.isfinite(out["checksum"])
