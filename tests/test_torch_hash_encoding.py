"""repro_torch hash encoding against repro's: corner indices, the per-level
blend, the batched partition-stacked form, and the kernel wrapper's CPU
route. JAX runs both its jnp reference ("ref") and the Pallas kernel in
interpret mode ("pallas")."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hash_encoding import ref as jref
from repro.kernels.hash_encoding.ops import hash_encode as jhash_encode
from repro_torch.kernels.hash_encoding import ref as tref
from repro_torch.kernels.hash_encoding.ops import (hash_encode,
                                                   hash_encode_batched,
                                                   hash_encode_cuda)

BF16_ULP = 2.0 ** -7          # one bf16 ulp, relative (8-bit significand)


def _tables(rng, L, T, F):
    return rng.uniform(-1, 1, (L, T, F)).astype(np.float32)


@pytest.mark.parametrize("res,T", [(4, 512), (8, 729), (64, 512), (2048, 2**19)])
def test_corner_indices_exact(res, T):
    """Dense (injective) and hashed (uint32 wraparound xor-prime) indices."""
    ijk = np.random.default_rng(res).integers(0, res + 1, (1000, 3)).astype(np.int32)
    ijk[:3] = [[0, 0, 0], [res, res, res], [res, 0, res]]
    a = np.asarray(jref.corner_indices(jnp.asarray(ijk), res, T))
    b = tref.corner_indices(torch.from_numpy(ijk), res, T).numpy()
    np.testing.assert_array_equal(b, a)
    assert b.min() >= 0 and b.max() < T


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("L,T,F", [(2, 128, 2), (4, 2048, 4), (3, 64, 8)])
def test_hash_encode_f32_matches_jax(impl, L, T, F):
    N = 300                     # ragged against the Pallas kernel's 1024 block
    rng = np.random.default_rng(N + L)
    coords = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    coords[:2] = [[0, 0, 0], [1, 1, 1]]
    tables = _tables(rng, L, T, F)
    res = tuple(int(4 * 2**l) for l in range(L))
    want = np.asarray(jhash_encode(jnp.asarray(coords), jnp.asarray(tables),
                                   res, impl))
    for backend in ("ref", "cuda"):       # "cuda" on CPU tensors: plain route
        got = hash_encode(torch.from_numpy(coords), torch.from_numpy(tables),
                          res, backend).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_hash_encode_extrapolates_outside_unit_box_like_jax(impl):
    """Rays that miss a partition feed coordinates far outside [0,1]: the
    lower corner is clamped, the offset is not."""
    rng = np.random.default_rng(7)
    coords = rng.uniform(-3, 4, (200, 3)).astype(np.float32)
    tables = _tables(rng, 3, 512, 4)
    res = (4, 16, 64)
    want = np.asarray(jhash_encode(jnp.asarray(coords), jnp.asarray(tables),
                                   res, impl))
    got = hash_encode(torch.from_numpy(coords), torch.from_numpy(tables), res,
                      "cuda").numpy()
    # values reach ~1e6 here: one f32 rounding of the 8-corner sum, relative
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_hash_encode_bf16_matches_jax_f32_accumulation():
    """bf16 tables: each corner weight rounds to bf16, the blend accumulates
    in f32 and rounds once — the JAX "fused" backend's arithmetic (its ref and
    Pallas paths accumulate in bf16 instead; see ROADMAP §C)."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    tables = _tables(rng, 4, 2048, 4)
    res = (4, 8, 16, 32)
    want = np.asarray(jhash_encode(jnp.asarray(coords),
                                   jnp.asarray(tables, jnp.bfloat16), res,
                                   "fused")).astype(np.float32)
    got = hash_encode(torch.from_numpy(coords),
                      torch.from_numpy(tables).to(torch.bfloat16), res, "cuda")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_less(np.abs(got - want),
                                 BF16_ULP * np.abs(want) + 1e-30)


def test_batched_rows_read_their_partition():
    """(B,N,3) against (P,L,T,F): row b equals the single-model encode of
    partition part[b], through both backends' CPU routes."""
    rng = np.random.default_rng(11)
    P, B, N, L, T, F = 3, 5, 40, 2, 256, 4
    res = (4, 16)
    tables = torch.from_numpy(rng.uniform(-1, 1, (P, L, T, F)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, N, 3)).astype(np.float32))
    part = [2, 0, 1, 1, 2]
    for backend in ("ref", "cuda"):
        out = hash_encode_batched(coords, tables, res, part, backend)
        assert out.shape == (B, N, L * F)
        for b, p in enumerate(part):
            single = hash_encode(coords[b], tables[p], res, "ref")
            torch.testing.assert_close(out[b], single, rtol=0, atol=0)


def test_wrapper_counts_only_kernel_launches():
    """On CPU tensors the wrapper takes the plain version and launches
    nothing, so its counter does not move."""
    before = hash_encode_cuda.launches
    coords = torch.rand(1, 10, 3)
    hash_encode_cuda(coords, torch.rand(1, 2, 64, 2), (4, 8), [0])
    assert hash_encode_cuda.launches == before


def test_level_rows_and_levels_arg():
    """Dense levels use (res+1)^3 rows, hashed ones T; the C entries take
    at most 32 levels."""
    from repro_torch.kernels.hash_encoding import ops as hops

    assert hops.level_rows(4, 8192) == 125 and hops.level_rows(32, 8192) == 8192
    assert hops.level_rows(1289, 2**31) == 1290 ** 3   # 64-bit product
    assert list(hops.levels_arg((4, 8, 16))) == [4, 8, 16]
    with pytest.raises(ValueError, match="at most 32"):
        hops.levels_arg(range(33))
