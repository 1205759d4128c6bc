"""repro_torch.optim.adamw and repro_torch.core.metrics against the JAX
package's: schedules, global-norm clipping, and AdamW over 10 steps with and
without the f32 master copy, single and partition-stacked with a gate.

Tolerances: AdamW is the same float32 arithmetic operation for operation,
but the bias corrections go through pow, whose last bit may differ between
XLA and PyTorch: params, moments and masters within 1e-7 absolute (on
values of order 1e-2..1), which is in practice bit-exact. bf16 params are
re-derived from the same f32 master by one rounding: equal. Metrics within
1e-6 relative."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import metrics as jm
from repro.optim import adamw as ja
from repro_torch.core import metrics as tm
from repro_torch.optim import adamw as ta


def _tree(rng, lead=()):
    return {"tables": rng.uniform(-0.1, 0.1, lead + (3, 16, 2)).astype(np.float32),
            "mlp": [rng.uniform(-0.5, 0.5, lead + (6, 8)).astype(np.float32),
                    rng.uniform(-0.5, 0.5, lead + (8, 1)).astype(np.float32)]}


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).astype(np.float32)
    return t.numpy()


def _to_t(tree, dtype=torch.float32):
    return ta.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype),
                       tree)


def _close(a, b, atol=1e-7):
    for x, y in zip(ta.tree_leaves(a), jax.tree.leaves(b), strict=True):
        np.testing.assert_allclose(_np(x), np.asarray(y, np.float32), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("cfg", [
    ja.OptConfig(lr=5e-3), ja.OptConfig(lr=1e-2, schedule="exp", decay_steps=3),
    ja.OptConfig(schedule="cosine", total_steps=7, warmup_steps=4)],
    ids=["constant", "exp", "cosine-warmup"])
def test_schedule_matches_jax(cfg):
    steps = np.arange(0, 12, dtype=np.int32)
    want = np.asarray(jax.vmap(ja.make_schedule(cfg))(jnp.asarray(steps)))
    got = ta.make_schedule(ta.OptConfig(**cfg.__dict__))(torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("max_norm", [0.0, 0.1, 100.0])
def test_global_norm_and_clip_match_jax(max_norm):
    tree = _tree(np.random.default_rng(0))
    jt, jn = ja.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    tt, tn = ta.clip_by_global_norm(_to_t(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(tt, jt, atol=1e-7)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("schedule", ["constant", "exp"])
def test_adamw_10_steps_matches_jax(precision, schedule):
    rng = np.random.default_rng(1)
    master = "float32" if precision == "bf16" else ""
    kw = dict(lr=1e-2, schedule=schedule, decay_steps=4, clip_norm=0.0,
              master_dtype=master)
    jopt, topt = ja.AdamW(ja.OptConfig(**kw)), ta.AdamW(ta.OptConfig(**kw))
    p0 = _tree(rng)
    jdt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    tdt = torch.bfloat16 if precision == "bf16" else torch.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = _to_t(p0, tdt)
    js, ts_ = jopt.init(jp), topt.init(tp)
    assert ("mw" in js) == ("mw" in ts_) == (precision == "bf16")
    for step in range(10):
        g = _tree(np.random.default_rng(100 + step))
        gate = jnp.float32(0.0 if step == 4 else 1.0)
        jp, js = jopt.step(jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js, jp,
                           gate)
        tp, ts_ = topt.step(_to_t(g, tdt), ts_, tp, torch.tensor(float(gate)))
    assert int(ts_["step"]) == int(js["step"]) == 10
    _close(ts_["m"], js["m"])
    _close(ts_["v"], js["v"])
    if precision == "bf16":
        _close(ts_["mw"], js["mw"])
        _close(tp, jp, atol=0.0)
    else:
        _close(tp, jp)


def test_stacked_adamw_with_per_partition_gate_matches_vmapped_jax():
    """The port's stacked form ((P,) step, (P,) gate) is jax.vmap(AdamW)."""
    P = 3
    rng = np.random.default_rng(2)
    cfg = dict(lr=1e-2, clip_norm=0.0)
    jopt, topt = ja.AdamW(ja.OptConfig(**cfg)), ta.AdamW(ta.OptConfig(**cfg))
    p0 = _tree(rng, (P,))
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _to_t(p0)
    js = jax.vmap(jopt.init)(jp)
    ts_ = topt.init(tp, P)
    assert tuple(ts_["step"].shape) == (P,)
    gate = np.array([1.0, 0.0, 1.0], np.float32)
    for step in range(10):
        g = _tree(np.random.default_rng(50 + step), (P,))
        jp, js = jax.vmap(jopt.step)(jax.tree.map(jnp.asarray, g), js, jp,
                                     jnp.asarray(gate))
        tp, ts_ = topt.step(_to_t(g), ts_, tp, torch.from_numpy(gate))
    _close(tp, jp)
    _close(ts_["m"], js["m"])
    _close(ts_["v"], js["v"])
    # the gated partition kept its params; its moments still advanced
    np.testing.assert_array_equal(_np(tp["tables"][1]), p0["tables"][1])
    assert np.abs(_np(ts_["m"]["tables"][1])).max() > 0


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (6, 7, 8)).astype(np.float32)
    b = (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    ta_, tb = torch.from_numpy(a), torch.from_numpy(b)
    for f_t, f_j in ((tm.mse, jm.mse), (tm.psnr, jm.psnr), (tm.nrmse, jm.nrmse)):
        np.testing.assert_allclose(float(f_t(ta_, tb)),
                                   float(f_j(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-6)
    mses = np.array([1e-3, 4e-3, 2.5e-4])
    np.testing.assert_allclose(float(tm.psnr_from_mses(mses)),
                               float(jm.psnr_from_mses(mses)), rtol=1e-6)
