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
from repro_torch.kernels.flash_attention.ref import attention_ref
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
