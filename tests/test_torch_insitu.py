"""repro_torch's isosurfaces, pathlines, actions and in situ session against
the JAX package's: marching tets bit for bit on the same grid; isosurfaces
of carried-over params (cases differ only at vertices within rounding of
the iso value, Chamfer distance under 1e-4); the Chamfer distance; backward
and ground-truth pathlines within 1e-5; the compress and pathlines actions;
the session's trigger and cache against JAX's session (``fired``,
``cache_len`` and ``dvnr_trained`` exact, ``cache_bytes`` within 1%: the
params differ within the trainer's tolerance, so the compressed blobs can
differ by a few bytes); and the cache modes (SMOKE, the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import dvnr as jdvnr
from repro.core import isosurface as jiso
from repro.core import pathlines as jpath
from repro.core.inr import _inr_apply as jax_inr_apply
from repro.data.volume import make_partition as jmake_partition
from repro.insitu import InSituSession as JaxInSituSession
from repro.insitu import SimulationConfig as JaxSimulationConfig
from repro_torch import api, interop
from repro_torch.configs import dvnr
from repro_torch.core import isosurface as iso
from repro_torch.core import pathlines as path
from repro_torch.data.volume import VolumePartition
from repro_torch.insitu import InSituSession, SimulationConfig
from repro_torch.insitu.actions import (compress_action, isosurface_action,
                                        pathlines_action)
from repro_torch.reactive.dvnr import DVNRValue

PATH_ATOL = 1e-5      # trajectories: float32 INR queries of ~1e-7 error, 8 RK2 substeps
CHAMFER_MAX = 1e-4    # isosurfaces of the same params: a few ulps of the
                      # vertex values move points by far less than a cell (1/31)
VCFG = dvnr.SMOKE.replace(n_levels=2, log2_hashmap_size=8, n_neurons=8,
                          n_hidden_layers=1, batch_size=128, out_dim=3)
JVCFG = jdvnr.DVNRConfig(**VCFG.__dict__)


def _sphere_grid(n=20, r=0.3):
    g = np.linspace(0, 1, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return np.sqrt((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2).astype(np.float32)


@pytest.mark.parametrize("level,origin,extent", [
    (0.3, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    (0.25, (0.5, 0.0, 0.25), (0.5, 1.0, 0.25))])
def test_marching_tets_matches_jax_bit_for_bit(level, origin, extent,
                                               monkeypatch):
    monkeypatch.setattr(iso, "CELLS_PER_CHUNK", 1000)    # several passes
    grid = _sphere_grid()
    tris, valid = iso.marching_tets(torch.from_numpy(grid), level, origin, extent)
    jtris, jvalid = jiso.marching_tets(jnp.asarray(grid), level, origin, extent)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tris.numpy(), np.asarray(jtris))
    pts = iso.surface_points(tris, valid)
    assert len(pts) > 500
    np.testing.assert_array_equal(pts, jiso.surface_points(jtris, jvalid))


def test_marching_tets_empty_when_iso_outside():
    tris, valid = iso.marching_tets(torch.from_numpy(_sphere_grid()), 5.0)
    assert int(valid.sum()) == 0 and not tris.any()
    assert len(iso.surface_points(tris, valid)) == 0


def test_chamfer_distance_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    assert iso.chamfer_distance(a, a) < 1e-6
    assert iso.chamfer_distance(a, a + 0.1) > 0.01
    for p, q in ((a, b), (a, a + 0.1)):
        got = iso.chamfer_distance(torch.from_numpy(p), q, chunk=64)
        assert got == pytest.approx(jiso.chamfer_distance(p, q), rel=1e-6)
    assert iso.chamfer_distance(a[:0], b) == float("inf")


def _jax_model(cfg, P, seed, amp=0.2):
    """Stacked numpy params of a JAX model: tables of a trained model's
    magnitude, a non-negative output layer (values in [0, 1], as a
    normalized field's)."""
    jm = japi.DVNRModel.init(cfg, jax.random.PRNGKey(seed), n_partitions=P)
    npp = jax.tree.map(np.asarray, jm.params)
    npp["tables"] = np.random.default_rng(seed).uniform(
        -amp, amp, npp["tables"].shape).astype(np.float32)
    npp["mlp"][-1] = np.abs(npp["mlp"][-1])
    return npp


def _tie_cells(grid, level, tol):
    """Cells that touch a vertex within ``tol`` of ``level``, as a
    (cells, 6 tets x 2 triangles) mask in marching_tets' row order."""
    tie = np.abs(grid - level) <= tol
    nx, ny, nz = grid.shape
    cells = np.zeros((nx - 1, ny - 1, nz - 1), bool)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cells |= tie[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
    return np.repeat(cells.reshape(-1), 12)


def test_isosurface_from_inr_matches_jax():
    """Carried-over params: the vertex grids agree to float32 rounding; the
    triangles differ only in cells touching a vertex within that rounding of
    the iso value, and the surfaces within CHAMFER_MAX."""
    cfg = dvnr.SMOKE
    npp = _jax_model(jdvnr.SMOKE, 1, 0)
    single = {"tables": npp["tables"][0], "mlp": [w[0] for w in npp["mlp"]]}
    tp = interop.params_from_numpy(single, "cpu")
    jp = jax.tree.map(jnp.asarray, single)
    shape = (16, 16, 16)
    grid = iso.inr_vertex_grid(cfg, tp, shape, "ref").numpy()
    level = float(np.quantile(grid, 0.7))
    tris, valid = iso.isosurface_from_inr(cfg, tp, level, shape,
                                          (0.0, 0.0, 0.5), (1.0, 1.0, 0.5), "ref")
    jtris, jvalid = jiso.isosurface_from_inr(jdvnr.SMOKE, jp, level, shape,
                                             (0.0, 0.0, 0.5), (1.0, 1.0, 0.5),
                                             "ref")
    coords = np.stack(np.meshgrid(*[np.asarray(jnp.linspace(0.0, 1.0, n))
                                    for n in shape], indexing="ij"), -1)
    jgrid = np.asarray(jax_inr_apply(jdvnr.SMOKE, jp,
                                     jnp.asarray(coords.reshape(-1, 3)),
                                     "ref")[..., 0]).reshape(shape)
    tol = 2e-6 * max(1.0, float(np.abs(jgrid).max()))
    np.testing.assert_allclose(grid, jgrid, atol=tol, rtol=0)
    differ = valid.numpy() != np.asarray(jvalid)
    assert not (differ & ~_tie_cells(jgrid, level, tol)).any()
    pts, jpts = iso.surface_points(tris, valid), jiso.surface_points(jtris, jvalid)
    assert abs(len(pts) - len(jpts)) <= 36 * _tie_cells(jgrid, level, tol).sum() / 12
    assert len(pts) > 100
    assert iso.chamfer_distance(pts, jpts) < CHAMFER_MAX


def test_api_isosurface_matches_jax():
    npp = _jax_model(jdvnr.SMOKE, 2, 1)
    metas = [{"origin": (0.0, 0.0, 0.5 * p), "extent": (1.0, 1.0, 0.5),
              "vmin": 0.1 * p, "vmax": 1.0 + 0.5 * p} for p in range(2)]
    jm = japi.DVNRModel(jdvnr.SMOKE, jax.tree.map(jnp.asarray, npp), metas)
    tm = api.DVNRModel(dvnr.SMOKE, interop.params_from_numpy(npp, "cpu"), metas)
    # global levels that cross partition 0's INR (gmin 0, gmax 1.5)
    q = np.quantile(iso.inr_vertex_grid(dvnr.SMOKE, tm.partition(0).params,
                                        (16, 16, 16), "ref").numpy(), [0.3, 0.7])
    lo, hi = (float(x) / 1.5 for x in q)
    for level, jlevel in ((lo, lo),
                          (api.RenderRequest(iso=hi), japi.RenderRequest(iso=hi))):
        pts = api.isosurface(tm, level, resolution=12, backend="ref")
        jpts = japi.isosurface(jm, jlevel, resolution=12, backend="ref")
        assert pts.dtype == np.float32 and len(pts) > 100
        assert abs(len(pts) - len(jpts)) <= 0.01 * len(jpts)
        assert iso.chamfer_distance(pts, jpts) < CHAMFER_MAX
    with pytest.raises(ValueError, match="request.iso"):
        api.isosurface(tm, api.RenderRequest(), backend="ref")
    assert api.isosurface(tm, 7.0, resolution=8, backend="ref").shape == (0, 3)


def _velocity_models():
    """Two velocity window entries (t = 0.40, 0.45), 2 partitions each, the
    JAX init's params carried across, the partitions' metadata: (port
    models, JAX models)."""
    tms, jms = [], []
    for i, t in enumerate((0.40, 0.45)):
        metas = [{"origin": p.origin, "extent": p.extent, "vmin": p.vmin,
                  "vmax": p.vmax}
                 for p in (jmake_partition("velocity", r, (1, 1, 2), (8, 8, 8), t)
                           for r in range(2))]
        npp = _jax_model(JVCFG, 2, 10 + i)
        jms.append(japi.DVNRModel(JVCFG, jax.tree.map(jnp.asarray, npp), metas))
        tms.append(api.DVNRModel(VCFG, interop.params_from_numpy(npp, "cpu"),
                                 metas))
    return tms, jms


def test_trace_backward_and_ground_truth_match_jax():
    tms, jms = _velocity_models()
    seeds = np.random.default_rng(0).uniform(0.3, 0.7, (64, 3)).astype(np.float32)
    traj = api.trace_pathlines(tms[::-1], seeds, 0.05, substeps=2, backend="ref")
    jtraj = japi.trace_pathlines(jms[::-1], seeds, 0.05, substeps=2, backend="ref")
    assert traj.shape == (2 * 2 + 1, 64, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=PATH_ATOL,
                               rtol=0)
    gt = path.trace_ground_truth("velocity", [0.45, 0.40], seeds, 0.05,
                                 substeps=2)
    jgt = jpath.trace_ground_truth("velocity", [0.45, 0.40], seeds, 0.05,
                                   substeps=2)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=PATH_ATOL, rtol=0)
    assert float(gt.min()) >= 0.0 and float(gt.max()) <= 1.0
    assert float((gt[-1] - gt[0]).abs().max()) > 1e-3
    dev = path.pathline_deviation(traj, gt)
    jdev = jpath.pathline_deviation(jtraj, jgt)
    for k in ("mean", "max", "final_mean"):
        assert dev[k] == pytest.approx(jdev[k], abs=PATH_ATOL)
    with pytest.raises(ValueError, match="empty model window"):
        api.trace_pathlines([], seeds, 0.05, backend="ref")


def test_pathline_deviation_metric():
    a = np.zeros((5, 4, 3), np.float32)
    d = path.pathline_deviation(a, a + 0.1)
    assert abs(d["mean"] - 0.1 * np.sqrt(3)) < 1e-5


def test_compress_and_pathlines_actions():
    tms, _ = _velocity_models()
    values = [DVNRValue(m, 0.0, 4) for m in tms]     # oldest -> newest
    blobs = compress_action(values[-1])
    assert len(blobs) == 2 and all(isinstance(b, bytes) for b in blobs)
    values[-1].compressed = blobs
    assert compress_action(values[-1]) is blobs       # cached blobs reused as-is
    assert compress_action(values[-1], r_enc=1e-3) is not blobs
    seeds = np.random.default_rng(0).uniform(0.3, 0.7, (4, 3)).astype(np.float32)
    traj = pathlines_action(values, seeds, dt=0.05, substeps=2, impl="ref")
    want = api.trace_pathlines([v.model for v in reversed(values)], seeds, 0.05,
                               substeps=2, backend="ref")
    assert torch.equal(traj, want)                    # newest-first order
    pts = isosurface_action(DVNRValue(api.DVNRModel(
        dvnr.SMOKE, interop.params_from_numpy(_jax_model(jdvnr.SMOKE, 2, 1), "cpu"),
        tms[0].parts_meta), 0.0, 0), iso01=0.5, resolution=12, impl="ref")
    assert pts.ndim == 2 and pts.shape[1] == 3


CFG_S = dvnr.SMOKE.replace(epochs=1, n_train_min=2, batch_size=128)


def test_session_trigger_and_cache_match_jax():
    sim, jsim = (SimulationConfig("cloverleaf", n_ranks=2, local_shape=(8, 8, 8)),
                 JaxSimulationConfig("cloverleaf", n_ranks=2, local_shape=(8, 8, 8)))
    sess = InSituSession(sim, CFG_S, window=2, compress=True, impl="ref",
                         device="cpu")
    jsess = JaxInSituSession(jsim, jdvnr.DVNRConfig(**CFG_S.__dict__), window=2,
                             compress=True)
    seen = {"port": [], "jax": []}
    for s, k in ((sess, "port"), (jsess, "jax")):
        s.add_trigger("hot", lambda parts: float(parts[0].vmax) > 2.25,
                      [lambda t, k=k: seen[k].append(t)])
        s.add_trigger("always", lambda parts: True)
    recs, jrecs = sess.run(4), jsess.run(4)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    for r, j in zip(recs, jrecs):
        assert (r.cycle, r.fired, r.cache_len, r.dvnr_trained,
                r.raw_equiv_bytes) == \
            (j.cycle, j.fired, j.cache_len, j.dvnr_trained, j.raw_equiv_bytes)
        assert r.cache_bytes == pytest.approx(j.cache_bytes, rel=0.01)
    assert recs[-1].cache_len == 2
    assert 0 < recs[-1].cache_bytes < recs[-1].raw_equiv_bytes
    frame = sess.render_now(width=8, height=8, n_samples=4, impl="ref")
    assert frame.shape == (8, 8, 4) and torch.isfinite(frame).all()


def test_cache_modes_memory_ordering():
    sizes = {}
    for mode in ("dvnr", "raw"):
        sess = InSituSession(
            SimulationConfig("nekrs", n_ranks=2, local_shape=(8, 8, 8)),
            CFG_S, window=2, compress=True, cache_mode=mode, impl="ref",
            device="cpu")
        recs = sess.run(3)
        sizes[mode] = recs[-1].cache_bytes
        assert recs[-1].dvnr_trained == (mode == "dvnr")   # lazy in raw mode
    assert sizes["raw"] == 2 * 2 * 10 ** 3 * 4             # two ghosted copies
    assert sizes["dvnr"] < sizes["raw"], sizes


def test_session_without_a_card_needs_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: 'auto' resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InSituSession(SimulationConfig("cloverleaf", n_ranks=2,
                                       local_shape=(8, 8, 8)), CFG_S)
