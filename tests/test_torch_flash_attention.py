"""repro_torch flash attention against the JAX package: the plain version
(``attention_ref``) against JAX's ``attention_ref`` and its Pallas kernel in
interpret mode, the recomputing backward against ``jax.grad``, the CUDA
wrapper's CPU path, and ``sdpa``'s routing to the kernel.

Inputs are drawn with numpy and handed to both packages. Tolerances are the
JAX package's own (``tests/test_kernel_flash_attention.py``): f32 2e-5
absolute + relative, bf16 3e-2 absolute, gradients 1e-4."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch import backends
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_tiled_ref,
                                                     p_rounding_slack,
                                                     tiled_probabilities)
from repro_torch.models import attention as tattn

CASES = [
    # B, Sq, Sk, Hq, Hkv, dh, causal, window  (JAX's seven, plus dh=80)
    (1, 256, 256, 2, 2, 64, True, None),          # MHA causal, exact blocks
    (2, 256, 256, 4, 2, 64, True, None),          # GQA
    (1, 300, 300, 2, 1, 32, True, None),          # padding (Sq % BLOCK != 0)
    (1, 256, 512, 2, 2, 64, True, None),          # Sk > Sq (right-aligned)
    (2, 256, 256, 4, 4, 64, False, None),         # non-causal (cross-attn)
    (1, 512, 512, 2, 2, 64, True, 128),           # sliding window
    (1, 256, 256, 8, 1, 128, True, None),         # MQA, dh=128
    (1, 300, 300, 4, 2, 80, True, 100),           # danube's dh=80, ragged, window
]


def _qkv(seed, B, Sq, Sk, Hq, Hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, dh), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, dh), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, dh), dtype=np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window", CASES)
def test_plain_matches_jax_ref_and_pallas(B, Sq, Sk, Hq, Hkv, dh, causal, window):
    q, k, v = _qkv(0, B, Sq, Sk, Hq, Hkv, dh)
    want_ref = np.asarray(jref(q, k, v, causal=causal, window=window))
    want_pal = np.asarray(jflash(q, k, v, causal, window, "pallas"))
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want_pal, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window", CASES)
def test_tiled_plain_matches_jax_in_f32(B, Sq, Sk, Hq, Hkv, dh, causal, window):
    """The kernels' tile schedule (online softmax over KERNEL_BLOCK_K-key
    tiles, p in f32) is the same function as JAX's kernel and reference."""
    q, k, v = _qkv(0, B, Sq, Sk, Hq, Hkv, dh)
    want_ref = np.asarray(jref(q, k, v, causal=causal, window=window))
    want_pal = np.asarray(jflash(q, k, v, causal, window, "pallas"))
    got = attention_tiled_ref(_t(q), _t(k), _t(v), causal=causal, window=window,
                              block_k=ops.KERNEL_BLOCK_K,
                              p_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want_pal, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window", CASES)
def test_tiled_plain_bf16_p_matches_jax_and_f32(B, Sq, Sk, Hq, Hkv, dh, causal,
                                                window):
    """bf16 inputs with p rounded to bf16 per tile (the tensor-core kernel's
    rounding point): within JAX's bf16 3e-2 of its interpret-mode kernel,
    and within a per-row relative L2 error of 1e-2 of the f32 plain version
    on the same bf16 values."""
    q, k, v = (a.astype(ml_dtypes.bfloat16) for a in _qkv(1, B, Sq, Sk, Hq, Hkv, dh))
    want_pal = np.asarray(jflash(q, k, v, causal, window, "pallas"), np.float32)
    tq, tk, tv = (_t(a.astype(np.float32), torch.bfloat16) for a in (q, k, v))
    got = attention_tiled_ref(tq, tk, tv, causal=causal, window=window,
                              block_k=ops.KERNEL_BLOCK_K, p_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want_pal, atol=3e-2)
    want32 = attention_ref(tq.float(), tk.float(), tv.float(), causal=causal,
                           window=window)
    rel = (got.float() - want32).norm(dim=-1) / want32.norm(dim=-1)
    assert float(rel.max()) <= 1e-2, float(rel.max())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window", CASES)
def test_p_rounding_slack_covers_reordered_scores(B, Sq, Sk, Hq, Hkv, dh, causal,
                                                  window):
    """Scores a few float32 ulps off (as a tensor-core product's are against
    a float32 GEMM's) round some p to the other bf16 neighbour, which the
    tight on-card limit 1e-5 + 8e-3 |out| alone does not allow; with
    p_rounding_slack it holds, and the slack stays small beside |out|."""
    q, k, v = (_t(a.astype(ml_dtypes.bfloat16).astype(np.float32))
               for a in _qkv(7, B, Sq, Sk, Hq, Hkv, dh))
    kw = dict(causal=causal, window=window, block_k=ops.KERNEL_BLOCK_K)
    want = attention_tiled_ref(q, k, v, p_dtype=torch.bfloat16, **kw)
    got = attention_tiled_ref(q * (1 + 2.0 ** -21), k, v, p_dtype=torch.bfloat16,
                              **kw)
    slack = p_rounding_slack(q, k, v, **kw)
    err = (got - want).abs() - (1e-5 + 8e-3 * want.abs())
    assert float(err.max()) > 0            # the limit alone does not hold
    assert float((err - slack).max()) <= 0, float((err - slack).max())
    assert float(slack.mean()) <= 1e-2 * float(want.abs().mean())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window", CASES)
def test_tiled_probabilities_are_the_online_softmax_weights(B, Sq, Sk, Hq, Hkv,
                                                            dh, causal, window):
    """The yardstick's p, which the on-card check holds the bf16 kernel's
    own p against: over one tile of every key, p / sum(p) is the plain
    version's softmax; over the kernel's tiles, masked keys weigh 0, every
    row's p peaks at 1 (within float32 ulps) in some tile, and keys before
    the first tile are NaN."""
    q, k, v = (_t(a) for a in _qkv(8, B, Sq, Sk, Hq, Hkv, dh))
    kw = dict(causal=causal, window=window)
    q_pos = (Sk - Sq) + torch.arange(Sq)[:, None]
    k_pos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.einsum("bqhd,bkhd->bqhk", q,
                          k.repeat_interleave(Hq // Hkv, dim=2)) / dh ** 0.5
    want = torch.softmax(torch.where(mask[:, None], scores, -1e30), dim=-1)
    one = tiled_probabilities(q, k, v, block_k=Sk, **kw)
    np.testing.assert_allclose((one / one.sum(-1, keepdim=True)).numpy(),
                               want.numpy(), atol=1e-6, rtol=1e-5)
    p = tiled_probabilities(q, k, v, block_k=ops.KERNEL_BLOCK_K, **kw)
    k_lo = max(0, Sk - Sq - window + 1) if window is not None else 0
    k0 = (k_lo // ops.KERNEL_BLOCK_K) * ops.KERNEL_BLOCK_K
    assert torch.isnan(p[..., :k0]).all() and torch.isfinite(p[..., k0:]).all()
    p = p[..., k0:]
    # at the running max, s c - f32(m c) is the rounding of m c: 1 +- ulps
    np.testing.assert_allclose(p.amax(-1).numpy(), 1.0, atol=2.0 ** -21, rtol=0)
    assert not p.masked_select(~mask[:, None, k0:]).any()


@pytest.mark.parametrize("case", [CASES[1], CASES[7]], ids=["gqa", "dh80_window"])
def test_plain_bf16_matches_jax(case):
    B, Sq, Sk, Hq, Hkv, dh, causal, window = case
    q, k, v = (a.astype(ml_dtypes.bfloat16) for a in _qkv(1, B, Sq, Sk, Hq, Hkv, dh))
    want_ref = np.asarray(jref(q, k, v, causal=causal, window=window), np.float32)
    want_pal = np.asarray(jflash(q, k, v, causal, window, "pallas"), np.float32)
    tq, tk, tv = (_t(a.astype(np.float32), torch.bfloat16) for a in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want_ref, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), want_pal, atol=3e-2)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_backward_matches_jax_grad(impl):
    q, k, v = _qkv(2, 1, 256, 256, 2, 1, 32)

    def f_jax(q, k, v):
        return (jflash(q, k, v, True, None, "pallas") ** 2).sum()

    want = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, True, None, impl)
    (out ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", [CASES[3], CASES[5], CASES[7]],
                         ids=["right_aligned", "window", "dh80"])
def test_cuda_wrapper_on_cpu_is_the_plain_version(case):
    B, Sq, Sk, Hq, Hkv, dh, causal, window = case
    q, k, v = (_t(a) for a in _qkv(3, B, Sq, Sk, Hq, Hkv, dh))
    before = ops.flash_attention_cuda.launches
    got = ops.flash_attention_cuda(q, k, v, causal, window)
    assert torch.equal(got, attention_ref(q, k, v, causal=causal, window=window))
    assert ops.flash_attention_cuda.launches == before   # no kernel ran


def test_cuda_wrapper_refuses_other_devices():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cuda_wrapper_refuses_causal_rows_without_keys(device):
    # causal, Sq > Sk: the kernel and the plain version disagree on the first
    # rows, so both branches refuse the shape
    q = torch.zeros((1, 8, 2, 16), device=device)
    k = torch.zeros((1, 4, 2, 16), device=device)
    with pytest.raises(ValueError, match="Sq=8 > Sk=4"):
        ops.flash_attention_cuda(q, k, k, True)


def test_compute_dtype_casts_inputs():
    q, k, v = (_t(a) for a in _qkv(4, 1, 64, 64, 2, 1, 16))
    out = ops.flash_attention(q, k, v, True, None, "ref", compute_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    want = attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert torch.equal(out, want)


def test_sdpa_routing_condition():
    cuda, ref = backends.resolve("cuda"), backends.resolve("ref")
    assert tattn.routes_to_kernel(cuda)
    assert not tattn.routes_to_kernel(ref)
    assert not tattn.routes_to_kernel(cuda, kv_valid_len=5)
    assert not tattn.routes_to_kernel(cuda, q_offset=3)
    assert not tattn.routes_to_kernel(cuda, q_offset=torch.tensor(0))


def test_sdpa_sends_prefill_to_the_kernel_and_decode_to_the_plain_path(monkeypatch):
    calls = []
    real = ops.flash_attention_cuda

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention_cuda", counting)
    q, k, v = (_t(a) for a in _qkv(5, 2, 32, 32, 4, 2, 16))
    o_k = tattn.sdpa(q, k, v, causal=True, impl="cuda")
    o_p = tattn.sdpa(q, k, v, causal=True, impl="ref")
    assert len(calls) == 1
    np.testing.assert_allclose(o_k.numpy(), o_p.numpy(), atol=2e-5, rtol=2e-5)
    # decode-shaped calls (an offset, a valid length) stay on the plain path
    tattn.sdpa(q[:, :1], k, v, causal=False, q_offset=torch.tensor(31),
               kv_valid_len=torch.tensor(32), impl="cuda")
    tattn.sdpa(q[:, :1], k, v, causal=False, kv_valid_len=16, impl="cuda")
    assert len(calls) == 1


@pytest.mark.parametrize("window", [None, 8])
def test_sdpa_matches_jax_sdpa(window):
    from repro.models.attention import sdpa as jsdpa

    q, k, v = _qkv(6, 2, 32, 32, 4, 2, 16)
    want = np.asarray(jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window, impl="xla"))
    for impl in ("ref", "cuda"):
        got = tattn.sdpa(_t(q), _t(k), _t(v), causal=True, window=window, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
