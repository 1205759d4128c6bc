"""repro_torch's Mamba2 block (``models/mamba2.py``) and the Mamba2 LM
(``models/ssm_lm.py``) against the JAX package: the chunked SSD scan, the
causal conv, the block with its states, the recurrent decode step, and
the model's prefill, decode, loss and gradient at ``tests/test_torch_lm.py``'s
tolerances (see ``torch_family_parity``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_parity as F
from repro.models import mamba2 as jm
from repro_torch import interop
from repro_torch.models import build_model, mamba2

ARCH = "mamba2_780m"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(dtype="float32", seed=0):
    cfg, jcfg = F.cfgs(ARCH, dtype)
    jp = jax.tree.map(np.asarray, jm.init_mamba2(jax.random.PRNGKey(seed), jcfg,
                                                 jnp.float32))
    return cfg, jcfg, jp, interop.lm_params_from_numpy(jp, "cpu")


def _scan_inputs(cfg, S, seed=1):
    """x, dt, a_log = dt*A (<= 0), b, c as the block makes them."""
    di, nh, n, pd, _ = mamba2.dims(cfg)
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((F.B, S, nh, pd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((F.B, S, nh)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, nh, dtype=np.float32)
    b = rng.standard_normal((F.B, S, n)).astype(np.float32)
    c = rng.standard_normal((F.B, S, n)).astype(np.float32)
    return xh, dt, (dt * a).astype(np.float32), b, c


# --------------------------------------------------------------------------- #
# the block
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5, 16, 31, 256, 257, 1000])
def test_cumsum_blocked_equals_jnp_cumsum_bit_for_bit(n, dtype):
    """The log-decays' prefix sums in XLA's order (blocks of 16)."""
    x = (np.random.default_rng(n).standard_normal((2, n, 3)) * 20).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x).astype(dtype), axis=1).astype(jnp.float32))
    got = mamba2.cumsum_blocked(_t(x).to(getattr(torch, dtype)), 1)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("chunks", [1, 4])
def test_ssd_chunked_equals_jax(chunks):
    """S = Q and S = 4Q, y and the final state to 1e-5 in f32."""
    cfg, jcfg = F.cfgs(ARCH)
    S = cfg.ssm.chunk * chunks
    args = _scan_inputs(cfg, S)
    jy, jh = jm.ssd_chunked(jcfg, *args)
    y, h = mamba2.ssd_chunked(cfg, *map(_t, args))
    assert h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)


def test_ssd_chunked_refuses_a_ragged_length():
    cfg, jcfg = F.cfgs(ARCH)
    S = cfg.ssm.chunk + 4                     # Q = chunk does not divide S
    args = _scan_inputs(cfg, S)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(jcfg, *args)
    with pytest.raises(ValueError, match="not a multiple"):
        mamba2.ssd_chunked(cfg, *map(_t, args))
    # S below the chunk is one chunk of S
    args = _scan_inputs(cfg, cfg.ssm.chunk - 1)
    jy, _ = jm.ssd_chunked(jcfg, *args)
    y, _ = mamba2.ssd_chunked(cfg, *map(_t, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_causal_conv_equals_jax():
    cfg, _, jp, p = _block()
    rng = np.random.default_rng(2)
    xbc = rng.standard_normal((F.B, 11, jp["conv_w"].shape[1])).astype(np.float32)
    np.testing.assert_allclose(mamba2._causal_conv(_t(xbc), p["conv_w"]).numpy(),
                               np.asarray(jm._causal_conv(xbc, jp["conv_w"])),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_state_equals_jax(dtype):
    """The block's output, final SSM state and conv tail (the prefill's
    cache of a layer)."""
    cfg, jcfg, jp, p = _block(dtype)
    x = np.random.default_rng(3).standard_normal((F.B, 2 * cfg.ssm.chunk,
                                                  cfg.d_model)).astype(np.float32)
    cdt = getattr(torch, dtype)
    jy, jh, jtail = jm.mamba2_block_state(jcfg, jp, jnp.asarray(x).astype(dtype))
    y, h, tail = mamba2.mamba2_block_state(cfg, p, _t(x).to(cdt))
    assert y.dtype == tail.dtype == cdt and h.dtype == torch.float32
    assert tail.shape == (F.B, cfg.ssm.conv_width - 1, jtail.shape[-1])
    for got, want, what in ((y, jy, "y"), (h, jh, "state"), (tail, jtail, "tail")):
        F.assert_close(got, np.asarray(want.astype(jnp.float32)), dtype, what)
    assert torch.equal(mamba2.mamba2_block(cfg, p, _t(x).to(cdt)), y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_decode_step_from_a_shared_cache_equals_jax(dtype):
    cfg, jcfg, jp, p = _block(dtype)
    rng = np.random.default_rng(4)
    jcache = jax.tree.map(np.asarray, jm.init_mamba_cache(jcfg, F.B, jnp.dtype(dtype)))
    jcache = {k: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype)
              for k, a in jcache.items()}
    x = rng.standard_normal((F.B, 1, cfg.d_model)).astype(np.float32)
    jy, jnew = jm.mamba2_decode_step(jcfg, jp, jnp.asarray(x).astype(dtype), jcache)
    cache = {k: interop._to_torch(a, "cpu") for k, a in jcache.items()}
    y, new = mamba2.mamba2_decode_step(cfg, p, _t(x).to(getattr(torch, dtype)), cache)
    F.assert_close(y, np.asarray(jy.astype(jnp.float32)), dtype, "y")
    for k in ("ssm", "conv"):
        assert str(new[k].dtype) == f"torch.{jnew[k].dtype}"
        F.assert_close(new[k], np.asarray(jnew[k].astype(jnp.float32)), dtype, k)
    # the recurrence continues the scan: S steps from zeros = the block
    mine = {k: torch.zeros_like(v) for k, v in cache.items()}
    xs = rng.standard_normal((F.B, 8, cfg.d_model)).astype(np.float32)
    ys = []
    for t in range(8):
        yt, mine = mamba2.mamba2_decode_step(cfg, p, _t(xs[:, t:t + 1]).float(), mine)
        ys.append(yt)
    cfg32 = cfg.replace(compute_dtype="float32")
    yb, hb, tail = mamba2.mamba2_block_state(cfg32, p, _t(xs))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), yb.numpy(), atol=1e-5)
    np.testing.assert_allclose(mine["ssm"].numpy(), hb.numpy(), atol=1e-5)
    assert torch.equal(mine["conv"], tail)


def test_init_mamba2_equals_jax_tree():
    cfg, jcfg, jp, _ = _block()
    p = mamba2.init_mamba2(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        np.testing.assert_allclose(p[k].numpy(), jp[k], rtol=1e-6)
    assert abs(float(p["conv_w"].std()) / float(np.std(jp["conv_w"])) - 1) < 0.1


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def test_init_tree_equals_jax():
    F.check_init_tree(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_equals_jax(dtype):
    F.check_prefill(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_from_a_shared_cache_equals_jax(dtype):
    F.check_decode_shared(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_equals_jax(dtype):
    F.check_loss(ARCH, dtype)


def test_loss_gradient_equals_jax_grad():
    F.check_loss_grad(ARCH)


@pytest.mark.parametrize("steps", [1, 4])
def test_prefill_then_decode_equals_teacher_forced_jax_prefill(steps):
    """prefill(S) + decode steps against JAX's prefill of the whole: S = Q-1
    and one step (S+1 = Q), or S = Q and Q steps (2Q), each length a
    multiple of the chunk as ``ssd_chunked`` needs."""
    from repro.models import build_model as jbuild
    cfg, jcfg = F.cfgs(ARCH)
    Q = cfg.ssm.chunk
    S_, n = (Q - 1, 1) if steps == 1 else (Q, Q)
    jp = F.jax_params(jcfg)
    full = F.make_batch(cfg, S_ + n)
    want, _ = jbuild(jcfg).prefill(jp, F.prompt(full, S_ + n), S_ + n)
    model = build_model(cfg)
    params = F.port_params(jp)
    _, cache = model.prefill(params, F.prompt(full, S_), S_ + n, impl="cuda")
    for t in range(n):
        got, cache = model.decode_step(params, cache, full["tokens"][:, S_ + t:S_ + t + 1])
    assert int(cache["pos"]) == S_ + n
    F.assert_close(got, want, "float32")


def test_prefill_launches_no_kernel(monkeypatch):
    F.check_flash_launches(monkeypatch, ARCH, 0, 0)


def test_entry_points_raise_on_auto_without_a_gpu(monkeypatch):
    F.check_auto_raises(monkeypatch, ARCH)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_interop_round_trip_keeps_dtypes(param_dtype):
    F.check_round_trip(ARCH, param_dtype)
