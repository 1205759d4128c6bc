"""repro_torch's LM train step (``train.make_train_step``) against JAX's
``jax.jit(make_train_step(...))``: three steps of every architecture's
SMOKE config at float32 compute (cosine schedule with warm-up, clip 1.0),
then microbatches, int8 error-feedback compression and bf16 params with an
f32 master. Losses and ``grad_norm`` within 1e-5 relative, ``lr`` exactly,
params and moments within 1e-5 of each leaf's largest value, tie-aware
(``tests/torch_train_parity.py``), with a planted departure that must fail.
"""
import numpy as np
import pytest
import torch

import torch_train_parity as T

CASES = [(arch, {}) for arch in T.ARCHS] + [
    ("llama3_8b", {"microbatches": 2}),
    ("llama3_8b", {"grad_compress": True}),
    ("llama3_8b", {"cfg_kw": {"param_dtype": "bfloat16"},
                   "opt_kw": {"master_dtype": "float32"}}),
]
IDS = list(T.ARCHS) + ["microbatches2", "grad_compress", "bf16_master"]


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_three_steps_match_jax(arch, kw):
    params, opt, ties = T.run_steps(arch, **kw)
    print(f"{arch} {kw}: {ties} tie entries")
    if kw.get("grad_compress"):
        # the residual is threaded through the state and has moved
        assert sorted(opt) == ["ef_residual", "m", "step", "v"]
        assert float(opt["ef_residual"]["embed"]["tok"].abs().max()) > 0
    if "opt_kw" in kw:
        # bf16 working params; JAX's LM step carries the master untouched
        assert sorted(opt) == ["m", "mw", "step", "v"]
        assert params["embed"]["tok"].dtype == torch.bfloat16
        assert opt["mw"]["embed"]["tok"].dtype == torch.float32


def test_step_updates_in_place_and_returns_the_same_tensors():
    cfg, jcfg = T.cfgs("qwen2_0_5b")
    model = T.build_model(cfg)
    step = T.make_train_step(model, T.OptConfig(**T.OPT), impl="ref")
    params = model.init(0, device="cpu")
    opt = step.optimizer.init(params)
    before = params["embed"]["tok"].clone()
    p2, o2, metrics = step(params, opt, T.jax_batch(jcfg))
    assert p2["embed"]["tok"] is params["embed"]["tok"]
    assert o2["m"]["embed"]["tok"] is opt["m"]["embed"]["tok"]
    assert not torch.equal(before, params["embed"]["tok"])
    assert int(o2["step"]) == 1 and int(opt["step"]) == 0
    assert sorted(metrics) == ["aux", "grad_norm", "loss", "lr", "xent"]
    assert all(t.requires_grad is False for _, t in T.leaves(p2))


def test_apply_updates_and_in_place_apply_equal_the_functional_update():
    """``AdamW.apply_`` is ``clip`` + ``update`` + ``apply_updates`` bit for
    bit, also with rows sliced (a CHUNK below a leaf's size)."""
    from repro_torch.optim import AdamW, clip_by_global_norm
    from repro_torch.optim.adamw import clip_scale, global_norm

    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.standard_normal((7, 5), dtype=np.float32)),
              "b": {"c": torch.from_numpy(rng.standard_normal(9, dtype=np.float32))}}
    grads = {"a": torch.from_numpy(rng.standard_normal((7, 5), dtype=np.float32)),
             "b": {"c": torch.from_numpy(rng.standard_normal(9, dtype=np.float32))}}
    opt = AdamW(T.OptConfig(**T.OPT))
    state = opt.init(params)
    clipped, norm = clip_by_global_norm(grads, 1.0)
    upd, want_state = opt.update(clipped, state, params)
    want = AdamW.apply_updates(params, upd)
    for chunk in (1 << 26, 10):
        opt.CHUNK = chunk
        p = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
        st = opt.init(p)
        st = opt.apply_(grads, st, p, grad_scale=clip_scale(global_norm(grads), 1.0))
        for (n, g), (_, w) in zip(T.leaves(p), T.leaves(want)):
            assert torch.equal(g, w), (chunk, n)
        for key in ("m", "v"):
            for (n, g), (_, w) in zip(T.leaves(st[key]), T.leaves(want_state[key])):
                assert torch.equal(g, w), (chunk, key, n)
        assert int(st["step"]) == int(want_state["step"]) == 1
