"""repro_torch's LM training inputs and gradients against the JAX package:
``Model.input_specs`` and ``launch.train.synth_batch`` for every
architecture, the loss gradient of the dense and VLM families against
``jax.grad``, and the remat policies (``models.transformer.remat_wrap``).

``input_specs`` and ``synth_batch`` are compared bit for bit; gradients at
float32 compute to 1e-4 of each leaf's largest entry (the tolerance of
``tests/torch_family_parity.py``'s gradient checks for the other families).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_train_parity as T
from repro.models import build_model as jbuild
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.train import synth_batch
from repro_torch.models import build_model
from repro_torch.models import transformer

KINDS = ("train", "prefill", "decode")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", T.ARCHS)
def test_input_specs_equal_jax(arch, kind):
    cfg, jcfg = base.get_smoke_config(arch), T.jbase.get_smoke_config(arch)
    shape, jshape = T.shape(3, 24, kind)
    got = build_model(cfg).input_specs(shape)
    want = jbuild(jcfg).input_specs(jshape)
    assert list(got) == list(want)
    for k, s in want.items():
        t = got[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == s.shape, (k, tuple(t.shape), s.shape)
        assert str(t.dtype) == f"torch.{np.dtype(s.dtype).name}", (k, t.dtype, s.dtype)


@pytest.mark.parametrize("arch", T.ARCHS)
def test_synth_batch_bit_for_bit(arch):
    cfg, jcfg = base.get_smoke_config(arch), T.jbase.get_smoke_config(arch)
    model = build_model(cfg)
    for step in (0, 7):
        want = T.jax_batch(jcfg, step, 3, 24)
        got = synth_batch(model, T.shape(3, 24)[0], step, "cpu")
        assert list(got) == list(want)
        for k, a in want.items():
            t = got[k]
            assert t.device.type == "cpu" and str(t.dtype) == f"torch.{a.dtype.name}", k
            b = interop.lm_params_to_numpy({k: t})[k]
            np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("arch", T.DENSE_VLM)
def test_loss_grad_equals_jax(arch):
    cfg, jcfg = T.cfgs(arch)
    jp = T.jax_params(jcfg)
    batch = T.jax_batch(jcfg)
    jm = jbuild(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch)[0])(
        jax.tree.map(jnp.asarray, jp))
    for impl in ("ref", "cuda"):
        loss, grads = T.port_grads(build_model(cfg), interop.lm_params_from_numpy(jp, "cpu"),
                                   batch, impl)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        jg = dict(T.leaves(jax.tree.map(np.asarray, jgrads)))
        assert sorted(jg) == sorted(grads)
        for name, g in jg.items():
            scale = max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(grads[name], g, atol=1e-4 * scale, rtol=0,
                                       err_msg=f"{impl} {name}")


class _CountDots(TorchDispatchMode):
    """Counts the products ``remat="dots"`` saves."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in transformer._DOTS
        return func(*args, **(kwargs or {}))


REMAT_ARCHS = ("llama3_8b", "qwen2_vl_7b", "grok_1_314b", "mamba2_780m",
               "zamba2_1_2b", "seamless_m4t_large_v2")


def _attention_layers(cfg):
    """Attention calls of a training forward pass: every self-attention
    layer, the hybrid's shared block once a group, and the decoder's
    cross-attention (also through ``sdpa``, non-causal)."""
    from repro_torch.models.hybrid import group_structure
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return group_structure(cfg)[0]
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_agree_bit_for_bit(arch, monkeypatch):
    """``"none"``, ``"dots"`` and ``"full"`` give the same loss and grads bit
    for bit; the flash wrapper runs once an attention layer without remat
    and twice with it (the recompute); ``"dots"`` recomputes no saved
    product (as many ``mm`` calls as ``"none"``), ``"full"`` every one; and
    inference is untouched by the policy."""
    calls = []
    real = flash_ops.flash_attention_cuda
    monkeypatch.setattr(flash_ops, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jcfg = T.jbase.get_smoke_config(arch)
    jp = T.jax_params(jcfg)
    batch = T.jax_batch(jcfg)
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = T.base.get_smoke_config(arch).replace(remat=remat)
        calls.clear()
        with _CountDots() as dots:
            loss, grads = T.port_grads(build_model(cfg),
                                       interop.lm_params_from_numpy(jp, "cpu"), batch,
                                       "cuda")
        out[remat] = (loss, grads, len(calls), dots.n)
    L = _attention_layers(T.base.get_smoke_config(arch))
    assert [out[r][2] for r in ("none", "dots", "full")] == [L, 2 * L, 2 * L]
    assert out["dots"][3] == out["none"][3] < out["full"][3]
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0], remat
        for name, g in out["none"][1].items():
            np.testing.assert_array_equal(out[remat][1][name], g, err_msg=f"{remat} {name}")
    # no grad mode: no checkpoint, one launch a layer
    calls.clear()
    with torch.no_grad():
        build_model(T.base.get_smoke_config(arch)).loss(
            interop.lm_params_from_numpy(jp, "cpu"), batch, impl="cuda")
    assert len(calls) == L


def _flat_grads(tree):
    return np.concatenate([np.asarray(g, np.float32).ravel() for _, g in T.leaves(tree)])


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
def test_scan_bf16_grads_held_to_jax_f32(arch):
    """ROADMAP §C8 for training: under bf16 compute the scan families' loss
    within 2e-2 of JAX's bf16 loss, and their gradient no further from
    JAX's float32 computation (same params and batch), in relative L2, than
    1.5x JAX's own bf16 gradient (``torch_family_parity.SCAN_BF16_FACTOR``);
    a gradient with twice that departure planted must fail."""
    from torch_family_parity import SCAN_BF16_FACTOR
    cfg, jcfg = T.cfgs(arch, compute_dtype="bfloat16")
    _, jcfg32 = T.cfgs(arch)
    jp = T.jax_params(jcfg)
    batch = T.jax_batch(jcfg)
    grads = {}
    for name, c in (("bf16", jcfg), ("f32", jcfg32)):
        jm = jbuild(c)
        loss, g = jax.value_and_grad(lambda p: jm.loss(p, batch)[0])(
            jax.tree.map(jnp.asarray, jp))
        grads[name] = (float(loss), _flat_grads(jax.tree.map(np.asarray, g)))
    ref = grads["f32"][1]
    rel = lambda g: float(np.linalg.norm(g - ref) / np.linalg.norm(ref))
    theirs = rel(grads["bf16"][1])
    for impl in ("ref", "cuda"):
        loss, g = T.port_grads(build_model(cfg), interop.lm_params_from_numpy(jp, "cpu"),
                               batch, impl)
        np.testing.assert_allclose(loss, grads["bf16"][0], rtol=2e-2)
        mine = rel(np.concatenate([g[k].ravel() for k in sorted(g)]))
        assert mine <= SCAN_BF16_FACTOR * theirs, (impl, mine, theirs)
    noise = np.random.default_rng(0).standard_normal(ref.shape).astype(np.float32)
    planted = grads["bf16"][1] + noise * (2 * theirs * np.linalg.norm(ref)
                                          / np.linalg.norm(noise))
    assert rel(planted) > SCAN_BF16_FACTOR * theirs
