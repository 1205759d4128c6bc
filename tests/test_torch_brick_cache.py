"""repro_torch.serving.BrickCache and the cache-aware render path against
repro.serving's: brick sampling, brick coordinates, the residency trace,
the pool, cached frames and the cached RenderService (SMOKE, the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import dvnr as jdvnr
from repro.core import render as jrender
from repro.core.render import sample_bricks as jax_sample_bricks
from repro.serving import BrickCache as JaxBrickCache
from repro.serving import RenderService as JaxRenderService
from repro_torch import api, interop
from repro_torch.configs import dvnr
from repro_torch.core import render
from repro_torch.core.render import sample_bricks, sample_bricks_batched
from repro_torch.data.volume import sample_trilinear
from repro_torch.launch import serve
from repro_torch.serving import BrickCache, RenderService

FRAME_ATOL = 1e-5
APPLY_ATOL = 1e-5          # tests/test_torch_api.py's apply / decode tolerance


def _metas(P=2):
    return tuple({"origin": (0.0, 0.0, p / P), "extent": (1.0, 1.0, 1.0 / P),
                  "vmin": 0.1 * p, "vmax": 1.0 + p} for p in range(P))


@pytest.fixture(scope="module")
def models():
    """The same weights in both packages, tables of a trained model's
    magnitude (see tests/test_torch_render.py)."""
    jm = japi.DVNRModel.init(jdvnr.SMOKE, jax.random.PRNGKey(0), n_partitions=2,
                             parts_meta=_metas())
    npp = jax.tree.map(np.asarray, jm.params)
    npp["tables"] = np.random.default_rng(2).uniform(
        -0.1, 0.1, npp["tables"].shape).astype(np.float32)
    jm = japi.DVNRModel(jdvnr.SMOKE, jax.tree.map(jnp.asarray, npp), _metas())
    tm = api.DVNRModel(dvnr.SMOKE, interop.params_from_numpy(npp, "cpu"), _metas())
    return jm, tm


def _brick_pool(grid, edge):
    """JAX's test layout: every brick of ``grid`` in slot order."""
    nb = tuple(-(-s // edge) for s in grid.shape)
    E = edge + 1
    pool = np.empty((int(np.prod(nb)), E, E, E), np.float32)
    slots = np.arange(int(np.prod(nb)), dtype=np.int32).reshape(nb)
    for bx in range(nb[0]):
        for by in range(nb[1]):
            for bz in range(nb[2]):
                ix = np.minimum(bx * edge + np.arange(E), grid.shape[0] - 1)
                iy = np.minimum(by * edge + np.arange(E), grid.shape[1] - 1)
                iz = np.minimum(bz * edge + np.arange(E), grid.shape[2] - 1)
                pool[slots[bx, by, bz]] = grid[np.ix_(ix, iy, iz)]
    return pool, slots


def test_sample_bricks_bitexact_with_jax_and_sample_trilinear(monkeypatch):
    rng = np.random.default_rng(0)
    grid_shape, edge = (20, 12, 16), 8
    grid = rng.standard_normal(grid_shape).astype(np.float32)
    pool, slots = _brick_pool(grid, edge)
    coords = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    coords = np.concatenate([coords, [[0, 0, 0], [1, 1, 1], [0.5, 1, 0],
                                      [-0.2, 1.3, 0.5]]]).astype(np.float32)
    want = np.asarray(jax_sample_bricks(jnp.asarray(pool), jnp.asarray(slots),
                                        jnp.asarray(coords), grid_shape, edge))
    tp, ts, tc = map(torch.from_numpy, (pool, slots, coords))
    got = sample_bricks(tp, ts, tc, grid_shape, edge).numpy()
    tri = sample_trilinear(torch.from_numpy(grid), tc, ghost=0).numpy()
    assert got.dtype == np.float32
    assert (got == want).all() and (got == tri).all()
    # chunking the points changes nothing; nor does batching rows over the
    # partitions' slot maps (row b through slots[part[b]])
    monkeypatch.setattr(render, "SAMPLE_CHUNK", 37)
    assert (sample_bricks(tp, ts, tc, grid_shape, edge).numpy() == got).all()
    perm = torch.from_numpy(rng.permutation(slots.size).astype(np.int32))
    pool2 = torch.empty_like(tp)
    pool2[perm.long()] = tp
    slots2 = torch.stack([ts, perm[ts.long()].reshape(ts.shape)])
    rows = torch.stack([tc[:258], tc[258:], tc[:258]])
    out = sample_bricks_batched(pool2, slots2, rows, grid_shape, edge, [1, 1, 0])
    assert (out[0].numpy() == got[:258]).all() and (out[1].numpy() == got[258:]).all()
    assert (out[2] == sample_bricks(pool2, ts, tc[:258], grid_shape, edge)).all()


@pytest.mark.parametrize("grid_shape,edge", [((32, 32, 32), 16),
                                             ((20, 13, 9), 8),
                                             ((7, 30, 11), 4)])
def test_brick_coords_bitexact_with_jax(models, grid_shape, edge):
    """Built on the device in float64 and rounded once, as numpy does."""
    _, tm = models
    kw = dict(grid_shape=grid_shape, brick_edge=edge, backend="ref")
    jc = JaxBrickCache(jdvnr.SMOKE, **kw)
    tc = BrickCache(dvnr.SMOKE, device="cpu", **kw)
    for level in range(3):
        assert tc.level_grid(level) == jc.level_grid(level)
        assert tc.brick_grid(level) == jc.brick_grid(level)
        bricks = list(range(tc.bricks_per_partition(level)))[::-1]
        want = jc._brick_coords(level, bricks)
        got = tc._brick_coords(level, bricks).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert (got == want).all()


def _tiny_caches(n_slots, **kw):
    one = JaxBrickCache(jdvnr.SMOKE, grid_shape=(8, 8, 8), brick_edge=8,
                        backend="ref").slot_bytes
    geo = dict(grid_shape=(8, 8, 8), brick_edge=8, budget_bytes=n_slots * one,
               trace=True, backend="ref", **kw)
    return JaxBrickCache(jdvnr.SMOKE, **geo), BrickCache(dvnr.SMOKE, device="cpu",
                                                         **geo)


def _run_trace(cache, model):
    for ts in (0, 1, 0, 1, 1):
        cache.ensure(model, timestep=ts)
    return list(cache.events), dict(cache.stats())


def test_cache_trace_stats_and_pool_match_jax(models):
    jm, tm = models
    jc, tc = _tiny_caches(3)
    jev, jst = _run_trace(jc, jm)
    tev, tst = _run_trace(tc, tm)
    assert tev == jev and tst == jst
    assert tst["evictions"] > 0 and tst["lookups"] == tst["hits"] + tst["misses"]
    assert all(kind == "hit" for kind, _ in tev[-2:])
    # the same slots hold the same bricks, decoded to apply's tolerance
    np.testing.assert_allclose(tc.pool.numpy(), np.asarray(jc.pool),
                               atol=APPLY_ATOL, rtol=0)
    assert tc._slot_of == jc._slot_of and list(tc._lru) == list(jc._lru)
    view = tc.ensure(tm, timestep=1)
    jview = jc.ensure(jm, timestep=1)
    assert view.slots.dtype == torch.int32
    assert (view.slots.numpy() == np.asarray(jview.slots)).all()
    assert tc.ensure(tm, timestep=1).slots is view.slots     # memoized
    tc.clear()
    assert tc.stats()["resident"] == 0 and tc.pool.numel() > 0


def test_cache_budget_closed_form_and_exceeds(models):
    _, tm = models
    jc, tc = _tiny_caches(3)
    assert (tc.slot_bytes, tc.n_slots, tc.pool_bytes) == \
        (jc.slot_bytes, jc.n_slots, jc.pool_bytes)
    assert tc.pool_bytes == tc.n_slots * tc.slot_bytes <= tc.budget_bytes
    pool = tc.pool
    for ts in range(5):
        tc.ensure(tm, timestep=ts)
        # the live pool IS the closed form, written in place
        assert tc.pool is pool
        assert pool.numel() * pool.element_size() == tc.pool_bytes
        assert tc.stats()["resident"] <= tc.n_slots
    _, small = _tiny_caches(1)
    with pytest.raises(ValueError, match="exceeds"):
        small.ensure(tm)
    bf = BrickCache(dvnr.SMOKE, grid_shape=(8, 8, 8), brick_edge=8,
                    budget_bytes=10 ** 6, dtype="bfloat16", backend="ref",
                    device="cpu")
    assert bf.slot_bytes == 9 ** 3 * 2 and bf.pool.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="single"):
        BrickCache(dvnr.SMOKE, brick_edge=8, budget_bytes=100, backend="ref",
                   device="cpu")


def test_cache_level_of_detail_geometry_matches_jax(models):
    jm, tm = models
    kw = dict(grid_shape=(32, 32, 32), brick_edge=16, backend="ref")
    jc, tc = JaxBrickCache(jdvnr.SMOKE, **kw), BrickCache(dvnr.SMOKE,
                                                           device="cpu", **kw)
    for level in range(5):
        assert tc.level_grid(level) == jc.level_grid(level)
        assert tc.bricks_per_partition(level) == jc.bricks_per_partition(level)
    assert tc.level_grid(4) == (2, 2, 2) and tc.bricks_per_partition(0) == 8
    v, jv = tc.ensure(tm, level=1), jc.ensure(jm, level=1)
    assert tuple(v.slots.shape) == tuple(jv.slots.shape) == (2, 1, 1, 1)
    assert v.grid_shape == jv.grid_shape and tc.stats() == jc.stats()
    np.testing.assert_allclose(tc.pool[:2].numpy(), np.asarray(jc.pool[:2]),
                               atol=APPLY_ATOL, rtol=0)


def test_render_partition_sampled_matches_jax(models):
    """One partition's ray march from the brick pool, as JAX's twin."""
    jm, _ = models
    jc = JaxBrickCache(jdvnr.SMOKE, grid_shape=(16, 16, 16), brick_edge=8,
                       backend="ref")
    view = jc.ensure(jm)
    pool, slots = np.array(view.pool), np.array(view.slots)[1]
    cam = japi.Camera().orbit(1.3)
    jo, jd = jrender.make_rays(cam, 10, 8)
    tf = np.array(jrender.default_tf())
    box = ((0.0, 0.0, 0.5), (1.0, 1.0, 0.5), (0.1, 2.0), (0.0, 2.0))
    want = jrender._render_partition_sampled(
        jnp.asarray(pool), jnp.asarray(slots), view.grid_shape, 8, *box,
        jo, jd, jnp.asarray(tf), n_samples=9)
    got = render._render_partition_sampled(
        torch.from_numpy(pool), torch.from_numpy(slots), view.grid_shape, 8,
        *box, torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd)),
        torch.from_numpy(tf), n_samples=9, impl="cuda")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=FRAME_ATOL)
    assert (np.isinf(got[1].numpy()) == np.isinf(np.asarray(want[1]))).all()
    fin = np.isfinite(np.asarray(want[1]))
    np.testing.assert_allclose(got[1].numpy()[fin], np.asarray(want[1])[fin],
                               rtol=1e-6)


def _req(mod, w=24, h=20, s=12, **kw):
    return mod.RenderRequest(width=w, height=h, n_samples=s, **kw)


@pytest.mark.parametrize("angle", [0.4, 2.9])
def test_cached_frames_match_jax_and_cold_equals_warm(models, angle):
    jm, tm = models
    kw = dict(grid_shape=(16, 16, 16), brick_edge=8, backend="ref")
    jcam = japi.Camera().orbit(angle)
    want = np.asarray(japi.render(jm, _req(japi, camera=jcam), backend="ref",
                                  cache=JaxBrickCache(jdvnr.SMOKE, **kw)))
    req = _req(api, camera=api.Camera(**vars(jcam)))
    warm_cache = BrickCache(dvnr.SMOKE, device="cpu", **kw)
    first = api.render(tm, req, backend="cuda", cache=warm_cache)   # fill
    warm = api.render(tm, req, backend="cuda", cache=warm_cache)
    assert warm_cache.stats()["hits"] == warm_cache.stats()["fills"] > 0
    cold = api.render(tm, req, backend="ref",
                      cache=BrickCache(dvnr.SMOKE, device="cpu", **kw))
    assert warm.dtype == torch.float32 and warm.shape == (20, 24, 4)
    assert torch.equal(first, warm) and torch.equal(warm, cold)
    np.testing.assert_allclose(warm.numpy(), want, atol=FRAME_ATOL)
    # the brick pool resamples the INR: frames agree with direct inference
    # to the grid's error, and differ from it
    direct = api.render(tm, req, backend="ref").numpy()
    assert 0 < np.abs(direct - warm.numpy()).max() < 0.1


def test_cached_frames_bf16_pool(models):
    jm, tm = models
    kw = dict(grid_shape=(16, 16, 16), brick_edge=8, backend="ref",
              dtype="bfloat16", compute_dtype="bfloat16")
    want = np.asarray(japi.render(jm, _req(japi), backend="ref",
                                  cache=JaxBrickCache(jdvnr.SMOKE, **kw)))
    cache = BrickCache(dvnr.SMOKE, device="cpu", **kw)
    api.render(tm, _req(api), backend="ref", cache=cache)
    warm = api.render(tm, _req(api), backend="ref", cache=cache).numpy()
    cold = api.render(tm, _req(api), backend="ref",
                      cache=BrickCache(dvnr.SMOKE, device="cpu", **kw)).numpy()
    assert (warm == cold).all()
    np.testing.assert_allclose(warm, want, atol=1e-3)
    f32 = api.render(tm, _req(api), backend="ref", cache=BrickCache(
        dvnr.SMOKE, grid_shape=(16, 16, 16), brick_edge=8, backend="ref",
        device="cpu")).numpy()
    np.testing.assert_allclose(warm, f32, atol=0.05)


def test_service_batched_multi_camera_parity(models):
    jm, tm = models
    geo = dict(grid_shape=(16, 16, 16), brick_edge=8)
    svc = RenderService(tm, backend="cuda", cache_kw=geo)
    jsvc = JaxRenderService(jm, backend="ref", cache_kw=geo)
    assert svc.use_cache and svc.cache.device == tm.device
    angles = (0.0, 1.1, 2.2)
    reqs = [_req(api, camera=api.Camera().orbit(a)) for a in angles]
    for r in reqs:
        svc.submit(r)
    for a in angles:
        jsvc.submit(_req(japi, camera=japi.Camera().orbit(a)))
    batch, jbatch = svc.tick(), jsvc.tick()
    assert [r.ticket for r in batch] == [0, 1, 2]
    assert all(r.batch_size == 3 for r in batch)
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(batch[i].frame, jbatch[i].frame,
                                   atol=FRAME_ATOL)
        single = svc.render(r)                  # per-request path, same cache
        np.testing.assert_allclose(batch[i].frame, single, atol=1e-6)
    # mixed shapes split into separate groups but all serve in one tick
    svc.submit(_req(api))
    svc.submit(_req(api, w=16, h=16, s=8))
    out = svc.tick()
    assert {r.frame.shape for r in out} == {(20, 24, 4), (16, 16, 4)}
    assert [t["groups"] for t in svc.ticks] == [1, 1, 1, 1, 2]
    assert svc.ticks[-1]["cache"] == svc.cache.stats()
    assert svc.stats() == {"ticks": 5, "served": 8, "pending": 0,
                           "warm_models": 0, "cache": svc.cache.stats()}
    jsvc.render(_req(japi))
    assert svc.cache.stats()["fills"] == jsvc.cache.stats()["fills"]


def test_service_uncached_matches_default_cache_geometry(models):
    """``use_cache=False`` renders through INR inference, and the service
    still carries JAX's default cache (64 MiB of the backend's budget)."""
    jm, tm = models
    svc = RenderService(tm, backend="ref", use_cache=False)
    jsvc = JaxRenderService(jm, backend="ref", use_cache=False)
    frame = svc.render(_req(api))
    np.testing.assert_allclose(frame, api.render(tm, _req(api), backend="ref"),
                               atol=1e-6)
    np.testing.assert_allclose(frame, jsvc.render(_req(japi)), atol=FRAME_ATOL)
    assert svc.stats() == jsvc.stats()
    assert svc.stats()["cache"]["lookups"] == 0
    assert svc.cache.pool_bytes <= svc.backend.cache_budget_bytes == 64 * 2 ** 20
    with pytest.raises(ValueError, match="model and/or"):
        RenderService(backend="ref")
    with pytest.raises(ValueError, match="parts_meta"):
        RenderService(api.DVNRModel(dvnr.SMOKE, tm.params), backend="ref")


def test_serve_entry_point_cached_on_cpu(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--backend", "ref",
                      "--frames", "3"])
    assert out["mode"] == "cached" and out["served"] == 6
    # 2 partitions x 8 bricks of 8^3 at --grid 16: filled once, then hits
    assert out["cache_hit_rate"] == pytest.approx(2 / 3)
    assert out["cache_pool_bytes"] == (64 * 2 ** 20 // (9 ** 3 * 4)) * 9 ** 3 * 4
    assert np.isfinite(out["checksum"])
    capsys.readouterr()
    off = serve.main(["--smoke", "--device", "cpu", "--backend", "ref",
                      "--frames", "1", "--no-cache"])
    assert off["mode"] == "uncached" and off["cache_hit_rate"] == 0.0
