"""repro_torch.data.volume against repro.data.volume: the analytic fields,
the partition grid, ghost-banded partitions and trilinear sampling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import volume as jv
from repro_torch.data import volume as tv

EPS32 = float(np.finfo(np.float32).eps)
# XLA's and PyTorch's sin/cos/exp/tanh differ by an ulp or two; the shock
# front exp(-((r - front) / 0.03)^2) scales an argument ulp by up to ~10
FIELD_ULPS = 16


def _field_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_less(np.abs(a - b),
                                 FIELD_ULPS * EPS32 * np.maximum(np.abs(a), 1.0)
                                 + 1e-30)


@pytest.mark.parametrize("kind", ["cloverleaf", "nekrs", "s3d", "magnetic",
                                  "velocity"])
@pytest.mark.parametrize("t", [0.0, 0.37])
def test_synthetic_field_matches_jax(kind, t):
    c = np.random.default_rng(0).uniform(-0.1, 1.1, (1500, 3)).astype(np.float32)
    _field_close(jv.synthetic_field(kind, jnp.asarray(c), t),
                 tv.synthetic_field(kind, torch.from_numpy(c), t))


def test_partition_grid_matches_jax():
    for n in range(1, 65):
        assert tv.partition_grid(n) == jv.partition_grid(n), n


@pytest.mark.parametrize("kind,idx,grid,shape,ghost", [
    ("cloverleaf", 0, (1, 1, 2), (8, 8, 8), 1),
    ("nekrs", 5, (2, 2, 2), (10, 12, 9), 1),
    ("s3d", 2, (1, 2, 3), (6, 7, 5), 2),
    ("magnetic", 1, (2, 1, 1), (9, 4, 6), 0),
])
def test_make_partition_matches_jax(kind, idx, grid, shape, ghost):
    pj = jv.make_partition(kind, idx, grid, shape, t=0.2, ghost=ghost)
    pt = tv.make_partition(kind, idx, grid, shape, t=0.2, ghost=ghost,
                           device="cpu")
    assert pt.origin == pj.origin and pt.extent == pj.extent
    assert pt.ghost == pj.ghost and pt.owned_shape == pj.owned_shape
    assert pt.data.dtype == torch.float32 and pt.data.shape == pj.data.shape
    _field_close(pj.data, pt.data)
    scale = max(abs(pj.vmin), abs(pj.vmax), 1.0)
    assert abs(pt.vmin - pj.vmin) <= FIELD_ULPS * EPS32 * scale
    assert abs(pt.vmax - pj.vmax) <= FIELD_ULPS * EPS32 * scale
    np.testing.assert_allclose(pt.normalized().numpy(),
                               np.asarray(pj.normalized()), atol=1e-5)


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("ghost", [0, 1])
def test_sample_trilinear_matches_jax(channels, ghost):
    rng = np.random.default_rng(1)
    shape = (7 + 2 * ghost, 5 + 2 * ghost, 6 + 2 * ghost) + \
        ((channels,) if channels else ())
    data = rng.standard_normal(shape).astype(np.float32)
    c = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    # partition faces and corners: the ghost band carries the interpolation
    c = np.concatenate([c, [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [0.999, 0, 1]]]) \
        .astype(np.float32)
    a = jv.sample_trilinear(jnp.asarray(data), jnp.asarray(c), ghost=ghost)
    b = tv.sample_trilinear(torch.from_numpy(data), torch.from_numpy(c),
                            ghost=ghost)
    assert b.shape == a.shape
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
