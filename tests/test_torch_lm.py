"""repro_torch's LM serving path against the JAX package: configs, layers,
the init tree, the synthetic batches, prefill, decode and the model API.

Parameters come from JAX's ``init_lm`` and cross through
``repro_torch.interop``; inputs are drawn with numpy. Tolerances: float32
compute 1e-5 absolute (summation order of matmuls), bf16 compute 2e-2 of the
largest logit (bf16 rounds at other places in the two frameworks).

Which JAX computation each comparison holds the port to: ``prefill`` logits
and cache slots against JAX's ``prefill``; ``decode_step`` against JAX's
``decode_step`` from one shared cache; prefill(S) + decode(1) against JAX's
teacher-forced prefill(S + 1), because JAX's own prefill cache cannot be
decoded from (it has the prompt's length, and its sliding-window ring is
laid out from the last W tokens; ROADMAP §C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import lm as jlm
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.data import lm
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model, layers
from repro_torch.models import transformer as T

DENSE = ["llama3_8b", "h2o_danube_1_8b", "qwen2_0_5b", "olmo_1b"]
SERVED = DENSE + ["qwen2_vl_7b"]
NOT_PORTED = ["arctic_480b", "grok_1_314b", "mamba2_780m", "zamba2_1_2b",
              "seamless_m4t_large_v2"]
B, S = 2, 32


def _cfg(arch, dtype="float32"):
    return base.get_smoke_config(arch).replace(compute_dtype=dtype)


def _jcfg(arch, dtype="float32"):
    return jbase.get_smoke_config(arch).replace(compute_dtype=dtype)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().cpu().numpy()


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(seed)))


def _batch(cfg, S_, seed=0):
    """Uniform random tokens (or embeddings and M-RoPE positions) and labels.
    Not ``make_lm_batch``: its Zipf sampler gives every token vocab - 1
    (ROADMAP §C), which would hide a misplaced cache slot."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S_ + 1)).astype(np.int32)
    if cfg.input_mode == "embeds":
        pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (3, B, S_)).copy()
        return {"embeds": rng.standard_normal((B, S_, cfg.d_model), dtype=np.float32),
                "labels": toks[:, 1:], "positions": pos}
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _prompt(batch, n):
    """The first n positions of a batch's prompt (tokens, or embeds and
    M-RoPE positions)."""
    if "embeds" in batch:
        return {"embeds": batch["embeds"][:, :n],
                "positions": batch["positions"][:, :, :n]}
    return {"tokens": batch["tokens"][:, :n]}


def _assert_logits(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    atol = 1e-5 if dtype == "float32" else 2e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_equal_jax(arch):
    for getter in ("get_config", "get_smoke_config"):
        j, t = getattr(jbase, getter)(arch), getattr(base, getter)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.resolved_head_dim == j.resolved_head_dim
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    for shape in jbase.SHAPES:
        assert base.cell_is_applicable(arch, shape) == \
            jbase.cell_is_applicable(arch, shape)


def test_shapes_and_registry_equal_jax():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert base.get_config("llama3_8b").param_count() == 8_030_257_152
    with pytest.raises(KeyError):
        base.get_config("gpt2")


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def test_norms_and_activations_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    sc = rng.standard_normal(64).astype(np.float32)
    bi = rng.standard_normal(64).astype(np.float32)
    tx, tsc, tbi = torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(bi)
    pairs = [
        (layers.rms_norm(tx, tsc), jlayers.rms_norm(x, sc)),
        (layers.rms_norm(tx), jlayers.rms_norm(x)),
        (layers.layer_norm(tx, tsc, tbi), jlayers.layer_norm(x, sc, bi)),
        (layers.layer_norm(tx), jlayers.layer_norm(x)),
        (layers.silu(tx), jlayers.silu(x)),
        (layers.softplus(tx), jlayers.softplus(x)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    for arch in ("llama3_8b", "olmo_1b"):       # rmsnorm, nonparam_ln
        c, jc = _cfg(arch), _jcfg(arch)
        p = layers.init_norm(c, 64)
        jp = jlayers.init_norm(None, jc, 64)
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: v.shape for k, v in jp.items()}
        np.testing.assert_allclose(_np(layers.apply_norm(c, p, tx)),
                                   _np(jlayers.apply_norm(jc, jp, x)), atol=1e-5)


@pytest.mark.parametrize("sections", [None, (4, 2, 2)])
def test_rope_equals_jax(sections):
    rng = np.random.default_rng(1)
    dh, theta = 16, 500_000.0
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 3, (2, 7))
    if sections is not None:
        pos = np.stack([pos, pos + 1, pos * 2])
    pos = np.ascontiguousarray(pos)
    ang = layers.rope_angles(torch.from_numpy(pos), dh, theta, sections)
    jang = jlayers.rope_angles(jnp.asarray(pos), dh, theta, sections)
    np.testing.assert_allclose(_np(ang), _np(jang), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(layers.rope_frequencies(dh, theta)),
                               _np(jlayers.rope_frequencies(dh, theta)), rtol=1e-6)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    np.testing.assert_allclose(_np(layers.apply_rope(torch.from_numpy(x), ang)),
                               _np(jlayers.apply_rope(x, jang)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_equals_jax(act):
    rng = np.random.default_rng(2)
    c, jc = _cfg("llama3_8b").replace(act=act), _jcfg("llama3_8b").replace(act=act)
    jp = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(0), jc, 64, 128,
                                                   jnp.float32))
    p = interop.lm_params_from_numpy(jp, "cpu")
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(layers.apply_mlp(c, p, torch.from_numpy(x))),
                               _np(jlayers.apply_mlp(jc, jp, x)), atol=1e-5, rtol=1e-5)
    tp = layers.init_mlp(torch.Generator().manual_seed(0), c, 64, 128, torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    with pytest.raises(NotImplementedError, match="item 16"):
        layers.apply_mlp(c, p, torch.from_numpy(x), sharder=object())


def test_softmax_xent_equals_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for kw in ({}, {"mask": mask}, {"z_loss": 0.0}):
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        got = layers.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), **tkw)
        want = jlayers.softmax_xent(logits, labels, **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------------------- #
# init, data, interop
# --------------------------------------------------------------------------- #
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", SERVED)
def test_init_tree_equals_jax(arch):
    cfg = base.get_smoke_config(arch)
    jp = dict(_leaves(_jax_params(jbase.get_smoke_config(arch))))
    tp = dict(_leaves(build_model(cfg).init(0, device="cpu")))
    assert sorted(tp) == sorted(jp)
    for name, j in jp.items():
        t = tp[name]
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", name
        js, ts = float(np.std(j)), float(t.float().std())
        if js == 0:
            assert ts == 0 and float(t.float().mean()) == float(np.mean(j)), name
        else:
            assert abs(ts / js - 1) < 0.05, (name, ts, js)
            # truncated at +-3 std (the truncated normal's std is 0.9866 std)
            assert float(t.abs().max()) <= 1.05 * 3 * js / 0.9866, name


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen2_vl_7b", "seamless_m4t_large_v2"])
def test_make_lm_batch_bit_identical(arch):
    cfg = base.get_smoke_config(arch)
    # the reference's Zipf sampler maps every draw to the last token id
    # (ROADMAP §C); the port keeps it bit for bit
    assert (lm.make_lm_batch(0, 2, 8, cfg.vocab)["tokens"] == cfg.vocab - 1).all()
    for step, shard in ((0, 0), (7, 3)):
        got = lm.make_lm_batch(step, 3, 16, cfg.vocab, shard, cfg.input_mode,
                               cfg.d_model, cfg.family)
        want = jlm.make_lm_batch(step, 3, 16, cfg.vocab, shard, cfg.input_mode,
                                 cfg.d_model, cfg.family)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it, jit_ = lm.SyntheticTokens(cfg, 2, 8, shard=1), jlm.SyntheticTokens(cfg, 2, 8, shard=1)
    for _ in range(2):
        a, b = next(it), next(jit_)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert it.state_dict() == jit_.state_dict()


def test_interop_round_trip_keeps_dtypes():
    jcfg = jbase.get_smoke_config("qwen2_0_5b").replace(param_dtype="bfloat16")
    jp = _jax_params(jcfg)
    back = interop.lm_params_to_numpy(interop.lm_params_from_numpy(jp, "cpu"))
    for (n1, a), (n2, b) in zip(sorted(_leaves(jp)), sorted(_leaves(back))):
        assert n1 == n2 and a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# --------------------------------------------------------------------------- #
# prefill / decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_equals_jax(arch, dtype):
    cfg, jcfg = _cfg(arch, dtype), _jcfg(arch, dtype)
    jp = _jax_params(jcfg)
    batch = _prompt(_batch(cfg, S), S)
    jlogits, jcache = jbuild(jcfg).prefill(jp, batch, S)
    model = build_model(cfg)
    params = interop.lm_params_from_numpy(jp, "cpu")
    seq_len = S + 8
    for impl in ("ref", "cuda"):
        logits, cache = model.prefill(params, batch, seq_len, impl=impl)
        _assert_logits(logits, jlogits, dtype)
        assert int(cache["pos"]) == S
        n = jcache["k"].shape[2]          # JAX keeps the last min(S, W) tokens
        assert cache["k"].shape[2] == T.cache_len(cfg, seq_len)
        assert cache["k"].dtype == T.compute_dtype(cfg)
        for key in ("k", "v"):
            # W divides S here, so JAX's slot order is the ring's
            _assert_logits(cache[key][:, :, :n], jcache[key], dtype)


def test_prefill_through_the_pallas_kernel_equals_jax():
    cfg, jcfg = _cfg("llama3_8b"), _jcfg("llama3_8b")
    jp = _jax_params(jcfg)
    batch = _prompt(_batch(cfg, S), S)
    jlogits, _ = jbuild(jcfg).prefill(jp, batch, S, impl="pallas")
    logits, _ = build_model(cfg).prefill(interop.lm_params_from_numpy(jp, "cpu"),
                                         batch, S, impl="cuda")
    _assert_logits(logits, jlogits, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_decode_step_from_a_shared_cache_equals_jax(arch, dtype):
    cfg, jcfg = _cfg(arch, dtype), _jcfg(arch, dtype)
    jp = _jax_params(jcfg)
    jmodel, model = jbuild(jcfg), build_model(cfg)
    jcache = jax.tree.map(np.asarray, jmodel.init_cache(B, 24))
    rng = np.random.default_rng(4)
    pos = 21                       # danube's W=16 ring has wrapped
    for key in ("k", "v"):
        jcache[key] = (rng.standard_normal(jcache[key].shape) * 0.5).astype(jcache[key].dtype)
    jcache["pos"] = np.asarray(pos, np.int32)
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jlogits, jnew = jmodel.decode_step(jp, jcache, tokens)
    cache = interop.lm_cache_from_numpy(jcache, "cpu")
    logits, new = model.decode_step(interop.lm_params_from_numpy(jp, "cpu"), cache,
                                    tokens)
    _assert_logits(logits, jlogits, dtype)
    assert int(new["pos"]) == int(jnew["pos"]) == pos + 1
    for key in ("k", "v"):
        _assert_logits(new[key], jnew[key], dtype)


@pytest.mark.parametrize("arch,S_", [("llama3_8b", 32), ("h2o_danube_1_8b", 20),
                                     ("qwen2_vl_7b", 32)])
def test_prefill_then_decode_equals_teacher_forced_jax_prefill(arch, S_):
    """The port's cache continues the prompt: prefill(S) + decode(1) gives
    JAX's teacher-forced prefill(S+1) logits (danube: W=16 does not divide
    S=20, so the ring has wrapped mid-buffer)."""
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    jp = _jax_params(jcfg)
    full = _batch(cfg, S_ + 1)
    if cfg.input_mode == "embeds":   # decode feeds a token's embedding
        tok = full["labels"][:, S_ - 1:S_]
        full["embeds"][:, S_] = jp["embed"]["tok"][tok[:, 0]]
    else:
        tok = full["tokens"][:, S_:S_ + 1]
    want, _ = jbuild(jcfg).prefill(jp, _prompt(full, S_ + 1), S_ + 1)
    model = build_model(cfg)
    params = interop.lm_params_from_numpy(jp, "cpu")
    _, cache = model.prefill(params, _prompt(full, S_), S_ + 8, impl="cuda")
    got, cache = model.decode_step(params, cache, tok)
    assert int(cache["pos"]) == S_ + 1
    _assert_logits(got, want, "float32")
    # the reference's own prefill cache does not continue the prompt
    jmodel = jbuild(jcfg)
    _, jcache = jmodel.prefill(jp, _prompt(full, S_), S_ + 8)
    jgot, _ = jmodel.decode_step(jp, jcache, tok)
    assert float(np.abs(_np(jgot) - _np(want)).max()) > 1e-2


def test_prefill_launches_the_kernel_once_per_layer(monkeypatch):
    calls = []
    real = flash_ops.flash_attention_cuda
    monkeypatch.setattr(flash_ops, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = _cfg("llama3_8b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = _prompt(_batch(cfg, S), S)
    _, cache = model.prefill(params, batch, S + 4, impl="cuda")
    assert len(calls) == cfg.n_layers
    model.prefill(params, batch, S + 4, impl="ref")
    model.decode_step(params, cache, batch["tokens"][:, :1])
    assert len(calls) == cfg.n_layers


def test_loss_forward_equals_jax():
    cfg, jcfg = _cfg("qwen2_0_5b"), _jcfg("qwen2_0_5b")
    jp = _jax_params(jcfg)
    batch = _batch(cfg, 16)
    jloss, jm = jbuild(jcfg).loss(jp, batch)
    loss, m = build_model(cfg).loss(interop.lm_params_from_numpy(jp, "cpu"), batch,
                                    impl="cuda")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]), rtol=1e-5)


# --------------------------------------------------------------------------- #
# what is not ported, and the GPU-by-default rule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", NOT_PORTED)
def test_build_model_raises_for_families_not_ported(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        build_model(base.get_smoke_config(arch))


def test_moe_layers_raise():
    cfg = base.get_smoke_config("grok_1_314b")
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        T.init_lm(cfg, torch.Generator())


def test_sharder_raises():
    cfg = _cfg("llama3_8b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        model.prefill(params, _prompt(_batch(cfg, 8), 8), 8, sharder=object(),
                      impl="ref")


def test_entry_points_raise_on_auto_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg("llama3_8b")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(B, S)
    params = model.init(0, device="cpu")
    batch = _prompt(_batch(cfg, 8), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.prefill(params, batch, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.loss(params, _batch(cfg, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params_from_numpy(_jax_params(_jcfg("llama3_8b")))
    # the CPU runs only when the caller asks for it
    logits, cache = model.prefill(params, batch, 8, impl="ref")
    assert logits.device.type == cache["k"].device.type == "cpu"


def test_prompt_longer_than_the_cache_raises():
    cfg = _cfg("llama3_8b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(params, _prompt(_batch(cfg, 16), 16), 8, impl="ref")
