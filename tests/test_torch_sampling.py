"""repro_torch.core.sampling against repro.core.sampling and jax.random:
Threefry words, keys, split, uniform draws (the random init), per-step seeds
and the training coordinates, and the trilinear gathers.

Tolerances: every integer word and every uniform row is compared for
equality; boundary rows go through log / cos / sqrt, whose last bits differ
between XLA's and PyTorch's CPU implementations by up to an ulp each, and
the roundings after them can add one: within 3 float32 ulp (the most seen
over 98,304 boundary values at sigma 0.005 and 0.05). The
gathers share the reference's arithmetic but not its summation order:
within 1e-6 on values of order 1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as js
from repro.data.volume import sample_trilinear as jsample_trilinear
from repro_torch.core import sampling as ts
from repro_torch.data.volume import sample_trilinear, sample_trilinear_batched

KEYS = (0, 7, 123456789, (0xDEADBEEF, 0x12345678))


def _jkey(k):
    if isinstance(k, int):
        return jax.random.PRNGKey(k)
    return jnp.asarray(np.array(k, np.uint32))


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_threefry_words_and_keys_match_jax(key):
    jk = _jkey(key)
    assert np.array_equal(ts.as_key(key).numpy(), np.asarray(jk))
    rng = np.random.default_rng(1)
    c0 = rng.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    k0, k1 = js.key_words(jk)
    want = js.threefry2x32(k0, k1, jnp.asarray(c0), jnp.asarray(c1))
    tk0, tk1 = ts.key_words(key)
    got = ts.threefry2x32(tk0, tk1, torch.from_numpy(c0.astype(np.int64)),
                          torch.from_numpy(c1.astype(np.int64)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("key", KEYS, ids=str)
@pytest.mark.parametrize("n", [2, 5])
def test_split_matches_jax_random_split(key, n):
    want = np.asarray(jax.random.split(_jkey(key), n)).astype(np.int64)
    assert np.array_equal(ts.split(key, n).numpy(), want)


@pytest.mark.parametrize("shape,lo,hi", [
    ((2, 64, 4), -1e-4, 1e-4), ((20, 16), -0.5477, 0.5477),
    ((4099,), -3.0, 2.0)])
def test_random_uniform_matches_jax_bit_for_bit(shape, lo, hi):
    for key in KEYS[:3]:
        want = np.asarray(jax.random.uniform(_jkey(key), shape, jnp.float32,
                                             lo, hi))
        got = ts.random_uniform(key, shape, lo, hi).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("step", [0, 1, 37, 2**31 + 5])
@pytest.mark.parametrize("P", [1, 8])
def test_step_seeds_match_jax(step, P):
    key = jax.random.PRNGKey(3)
    want = np.asarray(js.step_seeds(key, step, P)).astype(np.int64)
    assert np.array_equal(ts.step_seeds(np.asarray(key), step, P).numpy(), want)


def test_step_seed_table_of_a_chunk_equals_per_step_seeds():
    key = jax.random.PRNGKey(11)
    table = ts.step_seeds(np.asarray(key), torch.arange(20, 26), 3)
    assert table.shape == (6, 3, 2)
    for i, step in enumerate(range(20, 26)):
        want = np.asarray(js.step_seeds(key, step, 3)).astype(np.int64)
        assert np.array_equal(table[i].numpy(), want)


_jcoords = jax.jit(js.training_coords_counter, static_argnums=(1, 2, 3))


def _ulps(got, want):
    return np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))


@pytest.mark.parametrize("n_batch,lam,sigma", [
    (4096, 0.15, 0.005), (1000, 0.5, 0.005), (1000, 0.5, 0.05), (513, 0.0, 0.005)])
def test_training_coords_uniform_exact_boundary_within_3ulp(n_batch, lam, sigma):
    seed = np.asarray(js.step_seeds(jax.random.PRNGKey(5), 9, 2))
    n_u = n_batch - js.n_boundary(n_batch, lam)
    assert n_u == n_batch - ts.n_boundary(n_batch, lam)
    batched = ts.training_coords_counter(seed, n_batch, lam, sigma).numpy()
    for p in range(2):
        want = np.asarray(_jcoords(jnp.asarray(seed[p]), n_batch, lam, sigma))
        got = ts.training_coords_counter(seed[p], n_batch, lam, sigma).numpy()
        assert np.array_equal(batched[p], got)
        assert np.array_equal(got[:n_u], want[:n_u])
        if n_u < n_batch:
            assert _ulps(got[n_u:], want[n_u:]).max() <= 3
            # each boundary row lies within 10 sigma of a face
            dist = np.minimum(got[n_u:], 1 - got[n_u:]).min(axis=1)
            assert (dist <= 10 * sigma).all()


def test_counter_coords_rows_are_global_ids():
    """The kernel draws block by block: any slice of rows draws the same."""
    seed = np.asarray(js.step_seeds(jax.random.PRNGKey(2), 0, 1))[0]
    k0, k1 = ts.key_words(seed)
    rows = torch.arange(300)[:, None]
    full = ts.counter_coords(k0, k1, rows, 200, 0.005)
    part = ts.counter_coords(k0, k1, rows[128:256], 200, 0.005)
    assert torch.equal(full[128:256], part)


def _volume(rng, shape=(10, 9, 12), C=None):
    v = rng.standard_normal(shape + ((C,) if C else ())).astype(np.float32)
    return v


@pytest.mark.parametrize("brick", [(4, 4, 4), (3, 5, 7), (64, 64, 64)],
                         ids=str)
@pytest.mark.parametrize("C", [None, 3])
def test_gather_trilinear_bricked_matches_jax(brick, C):
    rng = np.random.default_rng(4)
    vol = _volume(rng, C=C)
    coords = rng.uniform(0, 1, (333, 3)).astype(np.float32)
    want = np.asarray(js.gather_trilinear_bricked(jnp.asarray(vol),
                                                  jnp.asarray(coords), 1, brick))
    got = ts.gather_trilinear_bricked(torch.from_numpy(vol),
                                      torch.from_numpy(coords), 1, brick).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    plain = sample_trilinear(torch.from_numpy(vol), torch.from_numpy(coords), 1)
    plain = plain.numpy().reshape(got.shape)
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)


@pytest.mark.parametrize("C", [None, 2])
def test_sample_trilinear_matches_jax_and_batches(C):
    rng = np.random.default_rng(6)
    vols = np.stack([_volume(rng, (8, 8, 8), C) for _ in range(3)])
    coords = rng.uniform(0, 1, (3, 200, 3)).astype(np.float32)
    batched = sample_trilinear_batched(torch.from_numpy(vols),
                                       torch.from_numpy(coords), 1).numpy()
    for p in range(3):
        want = np.asarray(jsample_trilinear(jnp.asarray(vols[p]),
                                            jnp.asarray(coords[p]), 1))
        np.testing.assert_allclose(batched[p], want, atol=1e-6, rtol=0)


def test_bad_key_raises():
    with pytest.raises(ValueError, match="two uint32 words"):
        ts.as_key([1, 2, 3])
