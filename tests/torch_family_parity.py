"""Shared checks of the port's model families against the JAX package
(``tests/test_torch_{moe,ssm,hybrid,encdec}.py``).

Parameters come from the JAX ``init`` of each family's SMOKE config and
cross through ``repro_torch.interop``; inputs are drawn with numpy from a
seed. Tolerances are ``tests/test_torch_lm.py``'s: float32 compute 1e-5
absolute, bf16 compute 2e-2 of the largest value (bf16 rounds at other
places in the two frameworks); gradients 1e-4 of each leaf's largest
entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import build_model as jbuild
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model

B, S = 2, 32


def cfgs(arch, dtype="float32", **cfg_kw):
    """(port config, JAX config): the SMOKE config in ``dtype`` compute."""
    return (base.get_smoke_config(arch).replace(compute_dtype=dtype, **cfg_kw),
            jbase.get_smoke_config(arch).replace(compute_dtype=dtype, **cfg_kw))


def with_capacity(cfg, factor):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def to_np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(seed)))


def port_params(jp, grad=False):
    p = interop.lm_params_from_numpy(jp, "cpu")
    if grad:
        for _, t in leaves(p):
            t.requires_grad_(t.is_floating_point())
    return p


def make_batch(cfg, S_=S, seed=0):
    """Uniform random tokens and labels (the encoder-decoder: N(0,1) source
    embeddings, target tokens and labels)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S_ + 1)).astype(np.int32)
    if cfg.family == "encdec":
        return {"src_embeds": rng.standard_normal((B, S_, cfg.d_model),
                                                  dtype=np.float32),
                "tgt_tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def prompt(batch, n=None):
    if "src_embeds" in batch:
        return {"src_embeds": batch["src_embeds"], "tgt_tokens": batch["tgt_tokens"]}
    return {"tokens": batch["tokens"][:, :n]}


def assert_close(got, want, dtype, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    atol = 1e-5 if dtype == "float32" else 2e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


#: how much further than JAX's bf16 computation the port's may lie from
#: JAX's float32 computation, in relative L2 (``assert_no_further``)
SCAN_BF16_FACTOR = 1.5


def rel_l2(a, b) -> float:
    a, b = to_np(a), to_np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_no_further(got, want, ref, what=""):
    """got (the port's bf16) no further from ``ref`` (JAX's float32
    computation) than ``SCAN_BF16_FACTOR`` x ``want`` (JAX's bf16), in
    relative L2; every value finite."""
    assert to_np(got).shape == to_np(want).shape and np.isfinite(to_np(got)).all(), what
    mine, theirs = rel_l2(got, ref), rel_l2(want, ref)
    assert mine <= SCAN_BF16_FACTOR * theirs, (what, mine, theirs)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def random_cache(jcfg, seq_len, pos, seed=4):
    """JAX's ``init_cache`` filled with N(0, 0.5^2) values, ``pos`` set."""
    cache = jax.tree.map(np.asarray, jbuild(jcfg).init_cache(B, seq_len))
    rng = np.random.default_rng(seed)
    for key, a in cache.items():
        if key != "pos":
            cache[key] = (rng.standard_normal(a.shape) * 0.5).astype(a.dtype)
    cache["pos"] = np.asarray(pos, np.int32)
    return cache


# --------------------------------------------------------------------------- #
# the checks, one per test of each family's file
# --------------------------------------------------------------------------- #
def check_init_tree(arch):
    jp = dict(leaves(jax_params(jbase.get_smoke_config(arch))))
    tp = dict(leaves(build_model(base.get_smoke_config(arch)).init(0, device="cpu")))
    assert sorted(tp) == sorted(jp)
    for name, j in jp.items():
        t = tp[name]
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", name
        js, ts = float(np.std(j)), float(t.float().std())
        if js == 0 or name.endswith("A_log"):   # constants: equal values
            np.testing.assert_allclose(to_np(t), j, rtol=1e-6, err_msg=name)
        else:
            assert abs(ts / js - 1) < 0.05, (name, ts, js)


def check_prefill(arch, dtype, impls=("ref", "cuda"), **cfg_kw):
    cfg, jcfg = cfgs(arch, dtype, **cfg_kw)
    jp = jax_params(jcfg)
    batch = prompt(make_batch(cfg), S)
    seq_len = S + 8
    jlogits, jcache = jbuild(jcfg).prefill(jp, batch, seq_len)
    model = build_model(cfg)
    params = port_params(jp)
    # bf16 through the SSD scan: the two frameworks' bf16 roundings (the
    # log-decays reach |la| ~ 10^2, where bf16's ulp is ~1) leave the port
    # as far from JAX's bf16 states as each lies from the f32 computation
    # (ROADMAP §C8). There each state, and the next decode step's logits
    # read from it, is held to JAX's float32 computation: no further from
    # it, in relative L2, than SCAN_BF16_FACTOR x JAX's bf16 departure
    scan_bf16 = dtype != "float32" and cfg.ssm is not None
    if scan_bf16:
        tok = np.random.default_rng(6).integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jcfg32 = cfgs(arch, "float32", **cfg_kw)[1]
        _, rcache = jbuild(jcfg32).prefill(jp, batch, seq_len)
        rnext, _ = jbuild(jcfg32).decode_step(jp, rcache, tok)
        jnext, _ = jbuild(jcfg).decode_step(jp, jcache, tok)
    for impl in impls:
        logits, cache = model.prefill(params, batch, seq_len, impl=impl)
        assert_close(logits, jlogits, dtype, f"logits {impl}")
        assert int(cache["pos"]) == int(jcache["pos"])
        assert sorted(cache) == sorted(jcache)
        for key in cache:
            if key == "pos":
                continue
            want = np.asarray(jcache[key])
            got = cache[key]
            assert str(got.dtype) == f"torch.{want.dtype}", key
            if key in ("k", "v") and cfg.family == "moe":
                # JAX's transformer keeps the prompt's length (ROADMAP §C6)
                got = got[:, :, :want.shape[2]]
            if scan_bf16:
                assert_no_further(got, want, rcache[key], f"cache {key} {impl}")
            else:
                assert_close(got, want, dtype, f"cache {key} {impl}")
        if scan_bf16:
            nxt, _ = model.decode_step(params, cache, tok)
            assert_no_further(nxt, jnext, rnext, f"decode from the cache {impl}")
    return cfg, jcfg, jp, batch


def check_prefill_pallas(arch):
    cfg, jcfg = cfgs(arch)
    jp = jax_params(jcfg)
    batch = prompt(make_batch(cfg), S)
    jlogits, _ = jbuild(jcfg).prefill(jp, batch, S + 8, impl="pallas")
    logits, _ = build_model(cfg).prefill(port_params(jp), batch, S + 8, impl="cuda")
    assert_close(logits, jlogits, "float32")


def check_decode_shared(arch, dtype, pos=21, seq_len=24):
    cfg, jcfg = cfgs(arch, dtype)
    jp = jax_params(jcfg)
    jmodel, model = jbuild(jcfg), build_model(cfg)
    jcache = random_cache(jcfg, seq_len, pos)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jlogits, jnew = jmodel.decode_step(jp, jcache, tokens)
    cache = interop.lm_cache_from_numpy(jcache, "cpu")
    logits, new = model.decode_step(port_params(jp), cache, tokens)
    assert_close(logits, jlogits, dtype, "logits")
    assert int(new["pos"]) == int(jnew["pos"]) == pos + 1
    assert sorted(new) == sorted(jnew)
    for key in new:
        if key != "pos":
            assert str(new[key].dtype) == f"torch.{np.asarray(jnew[key]).dtype}", key
            assert_close(new[key], jnew[key], dtype, key)


def check_loss(arch, dtype, **cfg_kw):
    cfg, jcfg = cfgs(arch, dtype, **cfg_kw)
    jp = jax_params(jcfg)
    batch = make_batch(cfg)
    jloss, jm = jbuild(jcfg).loss(jp, batch)
    for impl in ("ref", "cuda"):
        loss, m = build_model(cfg).loss(port_params(jp), batch, impl=impl)
        assert sorted(m) == sorted(jm)
        assert_close(loss, np.asarray(jloss), dtype, "loss")
        for key in jm:
            assert_close(m[key], np.asarray(jm[key]), dtype, key)


def check_loss_grad(arch, **cfg_kw):
    cfg, jcfg = cfgs(arch, **cfg_kw)
    jp = jax_params(jcfg)
    batch = make_batch(cfg)
    jmodel = jbuild(jcfg)
    jgrads = jax.grad(lambda p: jmodel.loss(p, batch)[0])(
        jax.tree.map(jnp.asarray, jp))
    params = port_params(jp, grad=True)
    loss, _ = build_model(cfg).loss(params, batch, impl="cuda")
    loss.backward()
    got = dict(leaves(params))
    for name, g in leaves(jax.tree.map(np.asarray, jgrads)):
        t = got[name].grad
        assert t is not None, name
        scale = max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(to_np(t), g, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


def count_flash(monkeypatch):
    calls = []
    real = flash_ops.flash_attention_cuda
    monkeypatch.setattr(flash_ops, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    return calls


def check_flash_launches(monkeypatch, arch, prefill_want, loss_want):
    """The flash wrapper is reached once per attention layer of a prefill
    (and of a loss) on the ``cuda`` backend, never in a decode step or on
    ``ref``."""
    calls = count_flash(monkeypatch)
    cfg = base.get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch(cfg)
    _, cache = model.prefill(params, prompt(batch, S), S + 4, impl="cuda")
    assert len(calls) == prefill_want
    model.prefill(params, prompt(batch, S), S + 4, impl="ref")
    model.decode_step(params, cache, batch["labels"][:, :1])
    assert len(calls) == prefill_want
    model.loss(params, batch, impl="cuda")
    assert len(calls) == prefill_want + loss_want


def check_auto_raises(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = base.get_smoke_config(arch)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(B, S)
    params = model.init(0, device="cpu")
    batch = make_batch(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.prefill(params, prompt(batch, S), S)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.loss(params, batch)
    logits, cache = model.prefill(params, prompt(batch, S), S, impl="ref")
    assert logits.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in cache.values())


def check_round_trip(arch, param_dtype="float32", seq_len=12, pos=5):
    """Params and the family's cache through interop and back, bit for bit
    with their dtypes."""
    jcfg = jbase.get_smoke_config(arch).replace(param_dtype=param_dtype)
    jp = jax_params(jcfg)
    back = interop.lm_params_to_numpy(interop.lm_params_from_numpy(jp, "cpu"))
    assert sorted(n for n, _ in leaves(jp)) == sorted(n for n, _ in leaves(back))
    for (n1, a), (n2, b) in zip(sorted(leaves(jp)), sorted(leaves(back))):
        assert n1 == n2 and a.dtype == b.dtype, n1
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    if param_dtype == "bfloat16":
        assert any(a.dtype.name == "bfloat16" for _, a in leaves(jp))
    jcache = random_cache(jcfg, seq_len, pos)
    cache = interop.lm_cache_from_numpy(jcache, "cpu")
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == pos
    back = interop.lm_cache_to_numpy(cache)
    assert sorted(back) == sorted(jcache)
    for key, a in jcache.items():
        b = back[key]
        assert b.dtype == np.asarray(a).dtype and b.shape == np.asarray(a).shape, key
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))
    # the port's own init_cache has the JAX layout
    mine = build_model(base.get_smoke_config(arch)).init_cache(B, seq_len, device="cpu")
    assert {k: (tuple(t.shape), str(t.dtype)) for k, t in mine.items()} == \
        {k: (np.asarray(a).shape, f"torch.{np.asarray(a).dtype}")
         for k, a in jax.tree.map(np.asarray, jbuild(jcfg).init_cache(B, seq_len)).items()}

