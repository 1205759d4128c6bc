"""repro_torch's Zamba2-style hybrid (``models/hybrid.py``: Mamba2 groups
and one shared attention + MLP block) against the JAX package: the group
structure, and the model's prefill (the shared block through the flash
kernel's wrapper), decode, loss and gradient at ``tests/test_torch_lm.py``'s
tolerances (see ``torch_family_parity``).
"""
import numpy as np
import pytest

import torch_family_parity as F
from repro.configs import base as jbase
from repro.models import build_model as jbuild
from repro.models import hybrid as jh
from repro_torch.configs import base
from repro_torch.models import build_model, hybrid

ARCH = "zamba2_1_2b"


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_group_structure_equals_jax(getter):
    cfg = getattr(base, getter)(ARCH)
    assert hybrid.group_structure(cfg) == jh.group_structure(getattr(jbase, getter)(ARCH))
    if getter == "get_config":
        assert hybrid.group_structure(cfg) == (6, 6, 2)


def test_init_tree_equals_jax():
    F.check_init_tree(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_equals_jax(dtype):
    """Logits, every layer's mamba states and each group's shared-block KV
    at the head of the seq_len cache."""
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


@pytest.mark.parametrize("steps", [1, 4])
def test_prefill_then_decode_equals_teacher_forced_jax_prefill(steps):
    """prefill(S) + decode steps against JAX's prefill of the whole (S = Q-1
    and one step, or S = Q and Q steps: lengths ``ssd_chunked`` takes). The
    hybrid's cache continues the prompt, in JAX as in the port: JAX's own
    prefill(S) + decode gives the same logits."""
    cfg, jcfg = F.cfgs(ARCH)
    Q = cfg.ssm.chunk
    S_, n = (Q - 1, 1) if steps == 1 else (Q, Q)
    jp = F.jax_params(jcfg)
    full = F.make_batch(cfg, S_ + n)
    jmodel = jbuild(jcfg)
    want, _ = jmodel.prefill(jp, F.prompt(full, S_ + n), S_ + n)
    model = build_model(cfg)
    params = F.port_params(jp)
    _, cache = model.prefill(params, F.prompt(full, S_), S_ + n, impl="cuda")
    _, jcache = jmodel.prefill(jp, F.prompt(full, S_), S_ + n)
    for t in range(n):
        tok = full["tokens"][:, S_ + t:S_ + t + 1]
        got, cache = model.decode_step(params, cache, tok)
        jgot, jcache = jmodel.decode_step(jp, jcache, tok)
    assert int(cache["pos"]) == S_ + n
    F.assert_close(got, want, "float32")
    F.assert_close(jgot, want, "float32")


def test_prefill_launches_the_kernel_once_per_group(monkeypatch):
    cfg = base.get_smoke_config(ARCH)
    n_groups = hybrid.group_structure(cfg)[0]
    F.check_flash_launches(monkeypatch, ARCH, n_groups, n_groups)


def test_entry_points_raise_on_auto_without_a_gpu(monkeypatch):
    F.check_auto_raises(monkeypatch, ARCH)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_interop_round_trip_keeps_dtypes(param_dtype):
    F.check_round_trip(ARCH, param_dtype)


def test_prompt_longer_than_the_cache_raises():
    model = build_model(base.get_smoke_config(ARCH))
    params = model.init(0, device="cpu")
    batch = F.make_batch(model.config, 16)
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(params, F.prompt(batch, 16), 8, impl="ref")
    logits, _ = model.prefill(params, F.prompt(batch, 16), 16, impl="ref")
    assert bool(logits.isfinite().all())
