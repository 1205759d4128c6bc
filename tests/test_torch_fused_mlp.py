"""repro_torch fused MLP against repro's (jnp reference and the Pallas
kernel in interpret mode), single and partition-stacked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mlp import ops as jops
from repro.kernels.fused_mlp.ops import fused_mlp as jfused_mlp
from repro_torch.kernels.fused_mlp import ops as tops
from repro_torch.kernels.fused_mlp.ops import (fused_mlp, fused_mlp_batched,
                                               fused_mlp_cuda)

BF16_ULP = 2.0 ** -7


def _weights(rng, D_in, W, H, D_out, lead=()):
    dims = [D_in] + [W] * H + [D_out]
    return [(rng.standard_normal(lead + (a, b)) * 0.3).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("N,D_in,W,H,D_out", [
    (100, 8, 16, 2, 1), (513, 32, 64, 3, 3), (64, 16, 16, 1, 1), (77, 20, 16, 2, 1),
])
def test_fused_mlp_f32_matches_jax(impl, N, D_in, W, H, D_out):
    rng = np.random.default_rng(N)
    ws = _weights(rng, D_in, W, H, D_out)
    x = rng.standard_normal((N, D_in)).astype(np.float32)
    want = np.asarray(jfused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                 impl))
    for backend in ("ref", "cuda"):
        got = fused_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                        backend).numpy()
        assert got.shape == (N, D_out)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("H", [1, 3])
def test_fused_mlp_bf16_matches_jax(H):
    """bf16 in, bf16 out: f32 accumulation, each layer rounded to bf16."""
    rng = np.random.default_rng(5 + H)
    ws = _weights(rng, 16, 16, H, 1)
    x = rng.uniform(-1, 1, (200, 16)).astype(np.float32)
    want = np.asarray(jfused_mlp(jnp.asarray(x, jnp.bfloat16),
                                 [jnp.asarray(w, jnp.bfloat16) for w in ws],
                                 "ref")).astype(np.float32)
    got = fused_mlp(torch.from_numpy(x).to(torch.bfloat16),
                    [torch.from_numpy(w).to(torch.bfloat16) for w in ws], "cuda")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_less(np.abs(got - want),
                                 BF16_ULP * np.abs(want) + 1e-30)


@pytest.mark.parametrize("H", [1, 2, 3])
def test_stack_keeps_dummy_hidden_slab(H):
    """[w_in, hidden..., w_out] -> (w_in, (max(H-1,1),W,W), w_out, H), the JAX
    layout, single and partition-stacked."""
    rng = np.random.default_rng(H)
    for lead in ((), (4,)):
        ws = _weights(rng, 12, 16, H, 1, lead)
        jw = jops._stack([jnp.asarray(w) for w in ws])
        tw = tops._stack([torch.from_numpy(w) for w in ws])
        assert tw[3] == jw[3] == H
        assert tuple(tw[1].shape) == lead + (max(H - 1, 1), 16, 16)
        if not lead:
            for a, b in zip(tw[:3], jw[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_batched_rows_use_their_partition_weights():
    rng = np.random.default_rng(9)
    P, B, N = 3, 4, 50
    ws = [torch.from_numpy(w) for w in _weights(rng, 20, 16, 2, 1, (P,))]
    x = torch.from_numpy(rng.uniform(-1, 1, (B, N, 20)).astype(np.float32))
    part = [1, 2, 0, 1]
    before = fused_mlp_cuda.launches
    for backend in ("ref", "cuda"):
        out = fused_mlp_batched(x, ws, part, backend)
        assert out.shape == (B, N, 1)
        for b, p in enumerate(part):
            # batched and single products may sum in another order
            single = fused_mlp(x[b], [w[p] for w in ws], "ref")
            torch.testing.assert_close(out[b], single, rtol=0, atol=1e-6)
    assert fused_mlp_cuda.launches == before     # CPU tensors launch nothing
