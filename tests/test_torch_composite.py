"""repro_torch compositing against repro's (jnp scan reference and the
Pallas kernel in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.composite.ops import composite as jcomposite
from repro_torch.kernels.composite.ops import composite, composite_cuda

BF16_ULP = 2.0 ** -7


def _samples(rng, R, S):
    rgba = rng.uniform(0, 1, (R, S, 4)).astype(np.float32)
    rgba[..., 3] *= 0.15                   # keep transmittance meaningful
    return rgba


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("R,S", [(300, 70), (257, 65), (5, 1)])
def test_composite_f32_matches_jax(impl, R, S):
    rgba = _samples(np.random.default_rng(R + S), R, S)
    want = np.asarray(jcomposite(jnp.asarray(rgba), impl))
    for backend in ("ref", "cuda"):
        got = composite(torch.from_numpy(rgba), backend).numpy()
        assert got.shape == (R, 4)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_composite_bf16_matches_jax_pallas():
    """bf16 samples: (color, transmittance) carried in f32 and cast back once,
    as the Pallas kernel does (the jnp scan carries bf16)."""
    rgba = _samples(np.random.default_rng(1), 300, 64)
    want = np.asarray(jcomposite(jnp.asarray(rgba, jnp.bfloat16), "pallas")) \
        .astype(np.float32)
    got = composite(torch.from_numpy(rgba).to(torch.bfloat16), "cuda")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_less(np.abs(got.float().numpy() - want),
                                 BF16_ULP * np.abs(want) + 1e-30)


def test_leading_axes_are_one_batch():
    """(C, P, R, S, 4) composites like its rows, in one call."""
    rgba = torch.from_numpy(_samples(np.random.default_rng(2), 2 * 3 * 10, 9)) \
        .reshape(2, 3, 10, 9, 4)
    before = composite_cuda.launches
    out = composite(rgba, "cuda")
    assert out.shape == (2, 3, 10, 4)
    flat = composite(rgba.reshape(-1, 9, 4), "ref").reshape(2, 3, 10, 4)
    torch.testing.assert_close(out, flat, rtol=0, atol=0)
    assert composite_cuda.launches == before
