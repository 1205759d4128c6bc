"""repro_torch.core.render against repro.core.render: cameras and rays,
the slab test, the transfer function, ray marching, sort-last compositing
and whole frames.

Whole frames are held to JAX through ``api.render`` and the render
service (tests/test_torch_api.py, tests/test_torch_serving.py), within 1e-5.
The remaining differences are float32 roundings: XLA fuses multiply-adds into
FMAs inside ``jit`` (``jnp.linalg.norm``, the ``lax.scan`` bodies),
PyTorch's CPU ops round each product. The field's gradient scales a
coordinate ulp, so those models use tables of a trained model's magnitude
(U(-0.1, 0.1)), not U(-1, 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dvnr as jdvnr
from repro.core import inr as jinr
from repro.core import render as jr
from repro_torch import interop
from repro_torch.configs import dvnr
from repro_torch.core import render as tr

METAS = tuple({"origin": (0.0, 0.0, p / 2), "extent": (1.0, 1.0, 0.5),
               "vmin": 0.1 * p, "vmax": 1.0 + p} for p in range(2))


def _stacked_params(P=2, seed=0, amp=0.1):
    p = jax.vmap(lambda k: jinr.init_inr(jdvnr.SMOKE, k))(
        jax.random.split(jax.random.PRNGKey(seed), P))
    p = jax.tree.map(np.asarray, p)
    p["tables"] = np.random.default_rng(seed).uniform(
        -amp, amp, p["tables"].shape).astype(np.float32)
    return p


def test_camera_orbit_equals_jax():
    for a in (0.0, 0.7, 2.5, -1.0):
        assert tr.Camera().orbit(a) == tr.Camera(**vars(jr.Camera().orbit(a)))
        assert tr.Camera().orbit(a, radius=2.0, height=0.3).eye == \
            jr.Camera().orbit(a, radius=2.0, height=0.3).eye


@pytest.mark.parametrize("w,h,fov", [(24, 20, 45.0), (7, 13, 60.0)])
def test_rays_match_jax(w, h, fov):
    cam = jr.Camera(eye=(1.3, -0.4, 1.1), fov_deg=fov)
    oj, dj = jr.make_rays(cam, w, h)
    ot, dt = tr.make_rays(tr.Camera(**vars(cam)), w, h)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6, rtol=0)
    # a batch of cameras on a leading axis gives each camera's rays
    eyes = torch.tensor([cam.eye, (0.2, 1.9, 0.5)])
    ob, db = tr.rays_from_arrays(eyes, torch.tensor([cam.center] * 2),
                                 torch.tensor([cam.up] * 2), fov, w, h)
    assert ob.shape == (2, w * h, 3)
    torch.testing.assert_close(db[0], dt, rtol=0, atol=0)


def test_ray_aabb_and_march_setup_match_jax():
    rng = np.random.default_rng(0)
    o = rng.uniform(-1, 2, (300, 3)).astype(np.float32)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]          # axis-aligned rays
    lo, hi = np.float32([0.0, 0.5, 0.0]), np.float32([1.0, 1.0, 0.5])
    a = jr.ray_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi))
    b = tr.ray_aabb(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo),
                    torch.from_numpy(hi))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    mj = jr._march_setup((0.0, 0.5, 0.0), (1.0, 0.5, 0.5), jnp.asarray(o),
                         jnp.asarray(d), 16)
    mt = tr._march_setup((0.0, 0.5, 0.0), (1.0, 0.5, 0.5), torch.from_numpy(o),
                         torch.from_numpy(d), 16)
    for x, y in zip(mj, mt):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6, rtol=1e-6)


def test_transfer_function_matches_jax():
    np.testing.assert_array_equal(tr.default_tf().numpy(), np.asarray(jr.default_tf()))
    v = np.random.default_rng(1).uniform(-0.2, 1.2, (50, 9)).astype(np.float32)
    v[0, :3] = [0.0, 1.0, 0.5]
    for table in (jr.default_tf(), jr.default_tf(7)):
        want = np.asarray(jr.apply_tf(jnp.asarray(v), table))
        got = tr.apply_tf(torch.from_numpy(v), torch.tensor(np.asarray(table)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    # one table per client: (C, K, 4) against values (C, ...)
    tabs = torch.stack([tr.default_tf(), tr.default_tf() * 0.5])
    vv = torch.from_numpy(v[:2])
    per = tr.apply_tf(vv, tabs)
    torch.testing.assert_close(per[1], tr.apply_tf(vv[1], tabs[1]), rtol=0, atol=0)


def test_depth_sort_and_over_match_jax():
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 1, (4, 100, 4)).astype(np.float32)
    deps = rng.uniform(0, 3, (4, 100)).astype(np.float32)
    deps[:, :10] = np.inf                                # missed rays: ties
    deps[1, 10:20] = deps[2, 10:20]                      # equal depths: ties
    want = np.asarray(jr.composite_depth_sort(jnp.asarray(imgs), jnp.asarray(deps)))
    got = tr.composite_depth_sort(torch.from_numpy(imgs), torch.from_numpy(deps))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tr.over(torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1])).numpy(),
        np.asarray(jr.over(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]))), atol=1e-7)
    los, exts, vrs = tr.meta_arrays(METAS)
    for x, y in zip(jr.meta_arrays(METAS), (los, exts, vrs)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_render_partition_is_a_one_partition_batch():
    """The single-partition render equals the batched one for P = 1, C = 1
    (the batched path's frames are held to JAX in tests/test_torch_api.py
    and tests/test_torch_serving.py)."""
    npp = _stacked_params(P=1, seed=3)
    params = interop.params_from_numpy(npp, "cpu")
    single = {"tables": params["tables"][0], "mlp": [w[0] for w in params["mlp"]]}
    origins, dirs = tr.make_rays(tr.Camera().orbit(0.4), 16, 12)
    box = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    img, dep = tr._render_partition(dvnr.SMOKE, single, *box, (0.2, 1.4),
                                    (0.0, 2.0), origins, dirs, tr.default_tf(),
                                    n_samples=12, impl="cuda")
    metas = tr.meta_arrays([{"origin": box[0], "extent": box[1], "vmin": 0.2,
                             "vmax": 1.4}])
    imgs, deps = tr._render_batch(dvnr.SMOKE, params, metas, origins[None],
                                  dirs[None], tr.default_tf()[None], (0.0, 2.0),
                                  n_samples=12, impl="ref")
    torch.testing.assert_close(imgs[0, 0], img, rtol=0, atol=1e-6)
    torch.testing.assert_close(deps[0, 0], dep, rtol=0, atol=0)
    assert 0.05 < float(img[:, 3].mean()) < 0.95          # not an empty image
