"""repro_torch.core.temporal against repro.core.temporal: blob bytes, byte
accounting, window eviction, decoding, the integrity fallback, the weight
cache, and the render service over a temporal window (SMOKE, the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.compress.codec_util import BlobIntegrityError as JaxBlobIntegrityError
from repro.configs import dvnr as jdvnr
from repro.core.temporal import TemporalModelCache as JaxTemporalModelCache
from repro.core.temporal import WeightCache as JaxWeightCache
from repro.serving import RenderService as JaxRenderService
from repro_torch import api, interop
from repro_torch.compress.codec_util import BlobIntegrityError
from repro_torch.configs import dvnr
from repro_torch.core.temporal import TemporalModelCache, WeightCache
from repro_torch.serving import BrickCache, RenderService

FRAME_ATOL = 1e-5
METAS = tuple({"origin": (0.0, 0.0, 0.5 * p), "extent": (1.0, 1.0, 0.5),
               "vmin": 0.2 * p, "vmax": 1.5 + p} for p in range(2))


def _params(seed, P=2, amp=0.1):
    """Stacked numpy params of a trained model's magnitude."""
    m = japi.DVNRModel.init(jdvnr.SMOKE, jax.random.PRNGKey(seed),
                            n_partitions=P)
    npp = jax.tree.map(np.asarray, m.params)
    npp["tables"] = np.random.default_rng(seed).uniform(
        -amp, amp, npp["tables"].shape).astype(np.float32)
    return npp


def _both(npp, dtype=None):
    j = jax.tree.map(jnp.asarray, npp)
    t = interop.params_from_numpy(npp, "cpu")
    if dtype is not None:
        j = jax.tree.map(lambda a: a.astype(jnp.bfloat16), j)
        t = {"tables": t["tables"].to(torch.bfloat16),
             "mlp": [w.to(torch.bfloat16) for w in t["mlp"]]}
    return j, t


def _leaves_equal(jax_tree, port_tree):
    a = jax.tree.leaves(jax.tree.map(np.asarray, jax_tree))
    b = jax.tree.leaves(interop.params_to_numpy(port_tree))
    return len(a) == len(b) and all(x.dtype == y.dtype and x.shape == y.shape
                                    and x.tobytes() == y.tobytes()
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_append_blobs_bytes_and_decode_match_jax(compress, dtype):
    jc = JaxTemporalModelCache(jdvnr.SMOKE, window=2)
    tc = TemporalModelCache(dvnr.SMOKE, window=2, device="cpu")
    for ts in range(3):
        j, t = _both(_params(ts), dtype)
        je = jc.append(ts, j, meta={"ts": ts}, compress=compress)
        te = tc.append(ts, t, meta={"ts": ts}, compress=compress)
        assert te.blobs == je.blobs and te.bytes == je.bytes and te.meta == je.meta
    assert tc.timesteps == jc.timesteps == [1, 2] and len(tc) == 2
    assert tc.total_bytes == jc.total_bytes > 0
    for ts in (1, 2):
        for p in range(2):
            assert _leaves_equal(jc.get(ts, p), tc.get(ts, p))
        sp = tc.stacked_params(ts)
        assert sp["tables"].shape == (2,) + tuple(tc.get(ts, 0)["tables"].shape)
        assert _leaves_equal(jc.stacked_params(ts), sp)
    assert all(_leaves_equal(a, b) for a, b in zip(jc.window_params(1),
                                                   tc.window_params(1)))
    with pytest.raises(KeyError):
        tc.get(0, 0)


def test_corrupt_blob_falls_back_like_jax():
    jc = JaxTemporalModelCache(jdvnr.SMOKE, window=3)
    tc = TemporalModelCache(dvnr.SMOKE, window=3, device="cpu")
    for ts in range(3):
        j, t = _both(_params(ts + 10))
        jc.append(ts, j, compress=ts != 1)
        tc.append(ts, t, compress=ts != 1)
    for c in (jc, tc):
        blob = c._entries[2].blobs[0]
        c._entries[2].blobs[0] = blob[:5] + bytes([blob[5] ^ 0xFF]) + blob[6:]
    # timestep 2, partition 0 falls back to timestep 1's (raw) model
    assert _leaves_equal(jc.get(2, 0), tc.get(2, 0))
    assert _leaves_equal(tc.get(1, 0), tc.get(2, 0))
    assert _leaves_equal(jc.get(2, 1), tc.get(2, 1))
    assert all(_leaves_equal(a, b) for a, b in zip(jc.window_params(0),
                                                   tc.window_params(0)))
    for c in (jc, tc):
        blob = c._entries[0].blobs[1]
        c._entries[0].blobs[1] = blob[:9] + bytes([blob[9] ^ 0x55]) + blob[10:]
    w = tc.window_params(1)            # a corrupt oldest entry falls forward
    assert _leaves_equal(w[1], w[0])
    assert all(_leaves_equal(a, b) for a, b in zip(jc.window_params(1), w))
    for c in (jc, tc):
        for e in c._entries:
            b = e.blobs[0]
            e.blobs[0] = b[:7] + bytes([b[7] ^ 0xAA]) + b[8:]
    with pytest.raises(JaxBlobIntegrityError):
        jc.window_params(0)
    with pytest.raises(BlobIntegrityError, match="no clean fallback"):
        tc.window_params(0)
    with pytest.raises(BlobIntegrityError):
        tc.get(0, 0)


def test_windows_decode_across_packages():
    """A window appended by either package decodes in the other."""
    jc = JaxTemporalModelCache(jdvnr.SMOKE, window=2)
    tc = TemporalModelCache(dvnr.SMOKE, window=2, device="cpu")
    j, t = _both(_params(20))
    for ts, compress in ((0, True), (1, False)):
        jc.append(ts, j, compress=compress)
        tc.append(ts, t, compress=compress)
    jc2 = JaxTemporalModelCache(jdvnr.SMOKE, window=2)
    tc2 = TemporalModelCache(dvnr.SMOKE, window=2, device="cpu")
    jc2._entries.extend(tc._entries)
    tc2._entries.extend(jc._entries)
    for ts in (0, 1):
        for p in range(2):
            assert _leaves_equal(jc2.get(ts, p), tc2.get(ts, p))
            assert _leaves_equal(jc.get(ts, p), tc2.get(ts, p))


def test_weight_cache_matches_jax():
    jw, tw = JaxWeightCache(max_entries=2), WeightCache(max_entries=2)
    for i, name in enumerate(("rho", "u", "p")):
        j, t = _both(_params(30 + i))
        jw.put(name, jdvnr.SMOKE, j)
        tw.put(name, dvnr.SMOKE, t)
        assert tw.get(name, dvnr.SMOKE)["tables"] is not t["tables"]   # a copy
    assert tw.get("rho", dvnr.SMOKE) is None and jw.get("rho", jdvnr.SMOKE) is None
    for name in ("u", "p"):
        assert _leaves_equal(jw.get(name, jdvnr.SMOKE), tw.get(name, dvnr.SMOKE))
    assert tw.get("u", dvnr.SMOKE.replace(n_neurons=8)) is None


def _req(mod, **kw):
    return mod.RenderRequest(width=20, height=16, n_samples=10, **kw)


def test_service_temporal_cache_integration_matches_jax():
    geo = dict(grid_shape=(16, 16, 16), brick_edge=8)
    j0, t0 = _both(_params(40))
    bumped = jax.tree.map(lambda a: a + 0.05, _params(40))
    j1, t1 = _both(bumped)
    jtc = JaxTemporalModelCache(jdvnr.SMOKE, window=2)
    ttc = TemporalModelCache(dvnr.SMOKE, window=2, device="cpu")
    for tc, (p0, p1) in ((jtc, (j0, j1)), (ttc, (t0, t1))):
        # raw-f16 blobs: the error-bounded codecs would round the bump away
        tc.append(0, p0, compress=False)
        tc.append(1, p1, compress=False)
    jsvc = JaxRenderService(temporal=jtc, cfg=jdvnr.SMOKE, parts_meta=METAS,
                            backend="ref", cache_kw=geo)
    svc = RenderService(temporal=ttc, cfg=dvnr.SMOKE, parts_meta=METAS,
                        backend="cuda", cache_kw=geo)
    assert svc.device == torch.device("cpu") and svc.cache.device == svc.device
    for ts in (0, 1, 0):
        want = jsvc.render(_req(japi, timestep=ts))
        got = svc.render(_req(api, timestep=ts))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=FRAME_ATOL)
        assert svc.warm_timesteps == jsvc.warm_timesteps
    assert svc.warm_timesteps == [1, 0]
    assert svc.cache.stats() == jsvc.cache.stats()
    assert svc.stats()["warm_models"] == 2 and len(svc.ticks) == 3
    assert not np.array_equal(svc.render(_req(api, timestep=0)),
                              svc.render(_req(api, timestep=1)))
    with pytest.raises(ValueError, match="no live model"):
        svc.render(_req(api))
    with pytest.raises(ValueError, match="cfg="):
        RenderService(temporal=ttc, parts_meta=METAS, backend="ref")
    with pytest.raises(ValueError, match="parts_meta="):
        RenderService(temporal=ttc, cfg=dvnr.SMOKE, backend="ref")


def test_temporal_trace_evicts_the_stale_timestep():
    """JAX's ``_run_trace`` through both services: the same events; each
    switch of timestep evicts bricks of the other timestep only, and the
    last request hits."""
    geo = dict(grid_shape=(16, 16, 16), brick_edge=8, trace=True)
    j0, t0 = _both(_params(50))
    j1, t1 = _both(jax.tree.map(lambda a: a * 0.5, _params(50)))
    one = BrickCache(dvnr.SMOKE, backend="ref", device="cpu", **geo).slot_bytes
    svcs = []
    for tmc, bc, svc, mod, cfg, (p0, p1), kw in (
            (JaxTemporalModelCache, None, JaxRenderService, japi, jdvnr.SMOKE,
             (j0, j1), {}),
            (TemporalModelCache, BrickCache, RenderService, api, dvnr.SMOKE,
             (t0, t1), {"device": "cpu"})):
        tc = tmc(cfg, window=2, **kw)
        tc.append(0, p0)
        tc.append(1, p1)
        s = svc(temporal=tc, cfg=cfg, parts_meta=METAS, backend="ref",
                cache_kw=dict(geo, budget_bytes=20 * one))
        svcs.append(s)
        per_call = []
        for ts in (0, 1, 0, 1, 1):
            n = len(s.cache.events)
            s.render(_req(mod, timestep=ts))
            evicted = [k for kind, k in s.cache.events[n:] if kind == "evict"]
            assert all(k[2] == 1 - ts for k in evicted)
            per_call.append(len(evicted))
        # 16 bricks a timestep in 20 slots: 12 victims at each switch
        assert per_call == [0, 12, 12, 12, 0]
    jsvc, svc = svcs
    assert svc.cache.events == jsvc.cache.events
    assert svc.cache.stats() == jsvc.cache.stats()
    assert svc.cache.stats()["evictions"] == 3 * 12
    assert all(kind == "hit" for kind, _ in svc.cache.events[-16:])
    assert svc.warm_timesteps == jsvc.warm_timesteps == [0, 1]
