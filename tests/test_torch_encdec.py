"""repro_torch's encoder-decoder (``models/encdec.py``, seamless-m4t style)
against the JAX package: the encoder (non-causal self-attention through the
flash kernel's wrapper), the teacher-forced decoder with cross-attention,
the serving prefill (encoder, cross K/V, one BOS decode step) and decode,
the loss and its gradient at ``tests/test_torch_lm.py``'s tolerances (see
``torch_family_parity``).
"""
import jax
import numpy as np
import pytest
import torch

import torch_family_parity as F
from repro.models import encdec as je
from repro.models import transformer as JT
from repro.models import build_model as jbuild
from repro_torch.configs import base
from repro_torch.models import build_model, encdec
from repro_torch.models import transformer as T

ARCH = "seamless_m4t_large_v2"


def test_init_tree_equals_jax():
    F.check_init_tree(ARCH)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_encode_and_decode_train_equal_jax(impl):
    """The two stacks alone (f32): the encoder's hidden states and the
    teacher-forced decoder's, cross-attending to them."""
    cfg, jcfg = F.cfgs(ARCH)
    jp = F.jax_params(jcfg)
    p = F.port_params(jp)
    batch = F.make_batch(cfg)
    jenc = je.encode(jcfg, jp, batch["src_embeds"])
    enc = encdec.encode(cfg, p, torch.from_numpy(batch["src_embeds"]), impl=impl)
    F.assert_close(enc, jenc, "float32", "encoder")
    jdec = je.decode_train(jcfg, jp, batch["tgt_tokens"], jenc)
    dec = encdec.decode_train(cfg, p, batch["tgt_tokens"], enc, impl=impl)
    F.assert_close(dec, jdec, "float32", "decoder")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_equals_jax(dtype):
    """Logits of the BOS step, the decoder's self-attention KV and every
    layer's cross K/V (the source's length)."""
    F.check_prefill(ARCH, dtype)


def test_prefill_through_the_pallas_kernel_equals_jax():
    F.check_prefill_pallas(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_from_a_shared_cache_equals_jax(dtype):
    F.check_decode_shared(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_equals_jax(dtype):
    F.check_loss(ARCH, dtype)


def test_loss_gradient_equals_jax_grad():
    F.check_loss_grad(ARCH)


@pytest.mark.parametrize("steps", [1, 5])
def test_prefill_then_decode_equals_teacher_forced_jax_decoder(steps):
    """prefill (encoder + BOS) and decode steps of the target tokens against
    JAX's teacher-forced decoder over the same target prefix, position by
    position."""
    cfg, jcfg = F.cfgs(ARCH)
    jp = F.jax_params(jcfg)
    batch = F.make_batch(cfg)
    tgt = batch["tgt_tokens"][:, :steps + 1]
    jenc = je.encode(jcfg, jp, batch["src_embeds"])
    want = np.asarray(JT.logits_fn(jcfg, jp, je.decode_train(jcfg, jp, tgt, jenc)))
    model = build_model(cfg)
    params = F.port_params(jp)
    got, cache = model.prefill(params, F.prompt(batch), F.S, impl="cuda")
    F.assert_close(got, want[:, :1], "float32", "BOS")
    for t in range(1, steps + 1):
        got, cache = model.decode_step(params, cache, tgt[:, t:t + 1])
        F.assert_close(got, want[:, t:t + 1], "float32", f"step {t}")
    assert int(cache["pos"]) == steps + 1


def test_prefill_launches_the_kernel_once_per_encoder_layer(monkeypatch):
    """The prefill reaches the kernel in the encoder only (its BOS step
    decodes on the plain path); the loss also in the decoder's causal self-
    and non-causal cross-attention (Sq != Sk)."""
    cfg = base.get_smoke_config(ARCH)
    F.check_flash_launches(monkeypatch, ARCH, cfg.encoder_layers, 2 * cfg.n_layers
                           + cfg.encoder_layers)


def test_cross_attention_reaches_the_kernel_with_other_lengths(monkeypatch):
    calls = F.count_flash(monkeypatch)
    cfg = base.get_smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = F.make_batch(cfg)
    batch = dict(batch, tgt_tokens=batch["tgt_tokens"][:, :8],
                 labels=batch["labels"][:, :8])
    model.loss(params, batch, impl="cuda")
    lengths = sorted({(q[1]) for q in calls})
    assert lengths == [8, F.S]


def test_entry_points_raise_on_auto_without_a_gpu(monkeypatch):
    F.check_auto_raises(monkeypatch, ARCH)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_interop_round_trip_keeps_dtypes(param_dtype):
    F.check_round_trip(ARCH, param_dtype)


def test_padded_vocab_masks_the_pad():
    cfg = base.get_config(ARCH)
    assert cfg.vocab == 256_206 and T.padded_vocab(cfg.vocab) == 256_256
    small = base.get_smoke_config(ARCH).replace(vocab=500, compute_dtype="float32")
    model = build_model(small)
    params = model.init(0, device="cpu")
    assert params["embed"]["tok"].shape[0] == 512
    logits, _ = model.prefill(params, F.prompt(F.make_batch(small)), 8, impl="ref")
    assert float(logits[..., 500:].max()) < -1e8
    assert jax is not None and jbuild is not None
