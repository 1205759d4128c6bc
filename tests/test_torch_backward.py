"""Gradients of the port's hash encode and fused MLP against jax.grad of the
JAX package's ops (jnp reference; the MLP also against its Pallas backward
kernel in interpret mode), single and partition-stacked, on both port
backends: ``ref`` (the plain backward) and ``cuda``, whose wrappers take the
plain versions for CPU tensors (the kernels themselves run on the card, in
chip_smoke.py).

Tolerance: 1e-5 absolute on gradients of order 1e-2..1 (float32 sums of
up to a few hundred terms, taken in another order than XLA's scatter and
matmuls)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mlp.ops import fused_mlp as jfused_mlp
from repro.kernels.hash_encoding.ops import hash_encode as jhash_encode
from repro_torch.kernels.fused_mlp import ops as mops
from repro_torch.kernels.fused_mlp.ops import fused_mlp, fused_mlp_batched
from repro_torch.kernels.hash_encoding import ops as hops
from repro_torch.kernels.hash_encoding.ops import hash_encode, hash_encode_batched

GRAD_ATOL = 1e-5


@functools.partial(jax.jit, static_argnums=(3,))
def _jhash_grad(coords, tables, cot, res):
    f = lambda t: jnp.sum(jhash_encode(coords, t, res, "ref").astype(jnp.float32)
                          * cot)
    return jax.grad(f)(tables)


def _hash_grad_jax(coords, tables, res, cot):
    return np.asarray(_jhash_grad(jnp.asarray(coords), jnp.asarray(tables),
                                  jnp.asarray(cot), tuple(res)))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("L,T,F,res", [
    (2, 128, 2, (4, 8)),            # dense (125 <= 128) + hashed
    (3, 64, 4, (2, 3, 16)),         # dense, dense, hashed
    (2, 4096, 1, (8, 15))])         # both dense
def test_hash_encode_grad_matches_jax(backend, L, T, F, res):
    rng = np.random.default_rng(T + F)
    coords = rng.uniform(-0.2, 1.2, (300, 3)).astype(np.float32)
    tables = rng.uniform(-0.1, 0.1, (L, T, F)).astype(np.float32)
    cot = rng.standard_normal((300, L * F)).astype(np.float32)
    want = _hash_grad_jax(coords, tables, res, cot)
    t = torch.from_numpy(tables).requires_grad_(True)
    out = hash_encode(torch.from_numpy(coords), t, res, backend)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_hash_encode_batched_grad_sums_rows_into_their_partition(backend):
    rng = np.random.default_rng(7)
    P, B, N, L, T, F, res = 3, 5, 120, 2, 128, 2, (4, 8)
    part = [2, 0, 2, 1, 0]
    coords = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
    tables = rng.uniform(-0.1, 0.1, (P, L, T, F)).astype(np.float32)
    cot = rng.standard_normal((B, N, L * F)).astype(np.float32)
    want = np.zeros_like(tables)
    for b, p in enumerate(part):
        want[p] += _hash_grad_jax(coords[b], tables[p], res, cot[b])
    t = torch.from_numpy(tables).requires_grad_(True)
    out = hash_encode_batched(torch.from_numpy(coords), t, res, part, backend)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=GRAD_ATOL, rtol=0)


def test_hash_bwd_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(8)
    coords = torch.from_numpy(rng.uniform(0, 1, (2, 50, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 50, 8)).astype(np.float32))
    before = hops.hash_encode_bwd_cuda.launches
    got = hops.hash_encode_bwd_cuda(g, coords, (4, 8), [1, 0], (2, 2, 128, 4))
    want = hops._ref.hash_encode_batched_bwd_ref(g, coords, (4, 8),
                                                 torch.tensor([1, 0]),
                                                 (2, 2, 128, 4))
    assert torch.equal(got, want) and got.shape == (2, 2, 128, 4)
    assert hops.hash_encode_bwd_cuda.launches == before   # no kernel on the CPU
    with pytest.raises(ValueError):
        hops.hash_encode_bwd_cuda(g[..., :4], coords, (4, 8), [1, 0],
                                  (2, 2, 128, 4))


def _mlp_weights(rng, D_in, W, H, D_out, lead=()):
    dims = [D_in] + [W] * H + [D_out]
    # scaled by 1/sqrt(fan-in), so activations and gradients stay of order 1
    return [(rng.standard_normal(lead + (a, b)) / np.sqrt(a)).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("jimpl", ["ref", "pallas"])
@pytest.mark.parametrize("N,D_in,W,H,D_out", [
    (200, 8, 16, 2, 1), (77, 20, 16, 1, 1), (130, 12, 32, 3, 3)])
def test_fused_mlp_grads_match_jax(backend, jimpl, N, D_in, W, H, D_out):
    rng = np.random.default_rng(N + H)
    x = rng.standard_normal((N, D_in)).astype(np.float32)
    ws = _mlp_weights(rng, D_in, W, H, D_out)
    cot = rng.standard_normal((N, D_out)).astype(np.float32)
    f = lambda xx, ww, g: jnp.sum(jfused_mlp(xx, ww, jimpl) * g)
    jdx, jdw = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_(True)
    tws = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    (fused_mlp(tx, tws, backend) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               atol=GRAD_ATOL, rtol=0)
    for tw, jw in zip(tws, jdw, strict=True):
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_fused_mlp_batched_grads_sum_rows_into_their_partition(backend):
    rng = np.random.default_rng(9)
    P, B, N = 3, 4, 60
    part = [1, 2, 1, 0]
    x = rng.standard_normal((B, N, 12)).astype(np.float32)
    ws = _mlp_weights(rng, 12, 16, 2, 1, (P,))
    cot = rng.standard_normal((B, N, 1)).astype(np.float32)
    want_dx = np.zeros_like(x)
    want_dw = [np.zeros_like(w) for w in ws]
    for b, p in enumerate(part):
        f = lambda xx, ww: jnp.sum(jfused_mlp(xx, ww, "ref") * jnp.asarray(cot[b]))
        dx, dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x[b]),
                                             [jnp.asarray(w[p]) for w in ws])
        want_dx[b] = np.asarray(dx)
        for acc, d in zip(want_dw, dw):
            acc[p] += np.asarray(d)
    tx = torch.from_numpy(x).requires_grad_(True)
    tws = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    out = fused_mlp_batched(tx, tws, part, backend)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, atol=GRAD_ATOL, rtol=0)
    for tw, w in zip(tws, want_dw):
        np.testing.assert_allclose(tw.grad.numpy(), w, atol=GRAD_ATOL, rtol=0)


def test_mlp_bwd_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 30, 8)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _mlp_weights(rng, 8, 16, 1, 1, (2,))]
    g = torch.from_numpy(rng.standard_normal((2, 30, 1)).astype(np.float32))
    before = mops.fused_mlp_bwd_cuda.launches
    dx, dws = mops.fused_mlp_bwd_cuda(x, ws, g, [1, 0])
    want_dx, want_dws = mops._ref.fused_mlp_batched_bwd_ref(x, ws, g,
                                                            torch.tensor([1, 0]))
    assert torch.equal(dx, want_dx)
    assert all(torch.equal(a, b) for a, b in zip(dws, want_dws))
    assert mops.fused_mlp_bwd_cuda.launches == before


def test_bf16_plain_gradients_track_jax():
    """bf16 tables and weights through the plain backward: the JAX reference
    accumulates the corner scatter and the products in bf16, the port in
    f32 rounded once, so they agree to bf16 precision (2^-7 relative to the
    gradient's scale)."""
    rng = np.random.default_rng(11)
    coords = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    tables = rng.uniform(-0.1, 0.1, (2, 128, 2)).astype(np.float32)
    cot = rng.standard_normal((200, 4)).astype(np.float32)
    want = np.asarray(_jhash_grad(jnp.asarray(coords),
                                  jnp.asarray(tables, jnp.bfloat16),
                                  jnp.asarray(cot), (4, 8)), np.float32)
    t = torch.from_numpy(tables).to(torch.bfloat16).requires_grad_(True)
    out = hash_encode(torch.from_numpy(coords), t, (4, 8), "ref")
    (out.float() * torch.from_numpy(cot)).sum().backward()
    got = t.grad.float().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2.0 ** -7 * scale, rtol=0)
