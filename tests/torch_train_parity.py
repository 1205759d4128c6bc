"""Shared checks of the port's LM training path against the JAX package
(``tests/test_torch_{train_lm,lm_train_step,train_driver}.py``).

Parameters come from the JAX ``init`` of each family's SMOKE config (float32
compute unless a test says otherwise) and cross through
``repro_torch.interop``; batches are JAX's ``launch.train.synth_batch``,
which the port's reproduces bit for bit.

The train-step comparison (:func:`run_steps`) runs three steps of each.
Each step is also taken by the port from JAX's state of that step (params,
moments, residual as numpy), so that no earlier departure propagates: its
loss, ``grad_norm`` and the model's metrics within 1e-5 relative of JAX's,
``lr`` exactly, and its new params and opt state held to JAX's new state
(:func:`check_step`). The port's own three-step trajectory meets the same
metric limits, except that with bf16 params it is held to 1e-3 after the
first step (one-ulp bf16 departures at rounding ties make the two
trajectories part). In :func:`check_step`:

- the gradient as it enters AdamW (after the int8 round trip and the
  clipping), ``gh``, is known on both sides from each framework's own
  gradient of the loss at that state; ``dg`` = |gh_port - gh_jax|;
- moments within 1e-5 of their leaf's largest value plus ``DEP_K`` x what
  ``dg`` moves them by ((1 - beta1) dg for m, (1 - beta2) |gh_port^2 -
  gh_jax^2| for v), the residual within 1e-5 plus ``DEP_K`` x (|delta
  target| + |delta dequantized|) (``DEP_K`` > 1: JAX's jitted step fuses
  its gradient otherwise than the ``jax.grad`` that gives ``gh``);
- params within 1e-5 of their leaf's largest value plus what ``dg`` moves
  Adam's update by: ``lr`` x the update's first-order sensitivity to the
  gradient at JAX's new moments x ``dg`` x ``TIE_K``, capped at 2 ``lr``
  (a flipped update: where the gradient lies within its rounding error of
  0, or at an int8 level's edge, Adam's ``m / (sqrt(v) + eps)`` can come
  out either way). bf16 params add one bf16 ulp of the value (the update
  and the sum are each rounded to bf16). The entries that this allowance
  admits beyond the flat limit are the *ties*: counted and held under
  ``TIE_SHARE_MAX`` of the entries; a departure planted at a non-tie entry
  must fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.configs.base import ShapeConfig as JShape
from repro.launch.train import synth_batch as jsynth
from repro.models import build_model as jbuild
from repro.optim import OptConfig as JOpt
from repro.train import make_train_step as jmake
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.train import make_train_step

ARCHS = base.list_archs()
DENSE_VLM = ("llama3_8b", "h2o_danube_1_8b", "qwen2_0_5b", "olmo_1b", "qwen2_vl_7b")
B, S = 2, 32
#: the optimizer of the step comparisons: cosine with warm-up, clip 1.0
OPT = dict(lr=1e-3, schedule="cosine", warmup_steps=2, total_steps=10,
           clip_norm=1.0)
TIE_K = 2.0
DEP_K = 4.0
TIE_SHARE_MAX = 1e-2
TRAJ_RTOL_BF16 = 1e-3
STEP_RTOL = 1e-5


def cfgs(arch, **kw):
    """(port config, JAX config): the SMOKE config, float32 compute unless
    ``kw`` says otherwise."""
    kw = {"compute_dtype": "float32", **kw}
    return (base.get_smoke_config(arch).replace(**kw),
            jbase.get_smoke_config(arch).replace(**kw))


def leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(seed)))


def jax_batch(jcfg, step=0, B_=B, S_=S):
    """JAX's ``synth_batch`` as numpy arrays."""
    out = jsynth(jbuild(jcfg), JShape("t", "train", S_, B_), step)
    return {k: np.asarray(v) for k, v in out.items()}


def port_grads(model, params, batch, impl="ref"):
    """(loss, grads as a flat name -> numpy dict) through autograd."""
    work = interop.lm_params_from_numpy(interop.lm_params_to_numpy(params), "cpu")
    names, ts = zip(*leaves(work))
    for t in ts:
        t.requires_grad_(True)
    loss, _ = model.loss(work, batch, impl=impl)
    gs = torch.autograd.grad(loss, ts, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), {n: g.float().numpy() for n, g in zip(names, gs)}


def _entering_adam(g, resid, gnorm, clip_norm, dtype):
    """(gh, target, dequantized) of one leaf in numpy float32: the gradient
    as it enters AdamW after the int8 error-feedback round trip (when
    ``resid`` is given) and the clipping."""
    g = np.asarray(g, np.float32)
    target = deq = None
    if resid is not None:
        target = g + resid
        scale = np.maximum(np.abs(target).max() / np.float32(127.0), np.float32(1e-12))
        deq = np.clip(np.round(target / scale), -127, 127) * scale
        g = deq
    if clip_norm > 0:
        g = g * np.float32(min(1.0, clip_norm / max(gnorm, 1e-9)))
    return to_np(torch.from_numpy(np.ascontiguousarray(g)).to(dtype)), target, deq


def _flat_np(tree):
    return {k: to_np(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in leaves(tree)}


def check_step(jin, jout, tout, jg, tg, jgnorm, tgnorm, ocfg, lr, plant=False):
    """One step's new state, the port's (``tout``: params and opt state)
    against JAX's (``jout``), both from JAX's state ``jin``; ``jg`` / ``tg``
    each framework's gradient of the loss at ``jin`` (flat numpy). Returns
    (ties, entries, the largest departure / its limit). ``plant`` moves one
    non-tie entry of the largest param leaf by 5x its limit first."""
    b1, b2 = ocfg["beta1"], ocfg["beta2"]
    jp, tp = _flat_np(jout["params"]), _flat_np(tout["params"])
    jr_in = jin["opt"].get("ef_residual")
    jr_in = _flat_np(jr_in) if jr_in is not None else None
    worst, n_tie, n = 0.0, 0, 0
    big = max(jp, key=lambda k: jp[k].size)
    for name in sorted(jp):
        pt = dict(leaves(tout["params"]))[name]
        r = None if jr_in is None else jr_in[name]
        ghj, tj, dj = _entering_adam(jg[name], r, jgnorm, ocfg["clip_norm"], pt.dtype)
        ght, tt, dt = _entering_adam(tg[name], r, tgnorm, ocfg["clip_norm"], pt.dtype)
        dg = np.abs(ght - ghj)
        want, got = jp[name].astype(np.float32), tp[name].astype(np.float32)
        flat = STEP_RTOL * float(np.abs(want).max())
        # Adam's update's first-order sensitivity to the gradient, at
        # JAX's new moments (step t = its new counter)
        k = int(jout["opt"]["step"])
        bc1, bc2 = 1 - b1 ** k, 1 - b2 ** k
        mh = _flat_np(jout["opt"]["m"])[name] / bc1
        rv = np.sqrt(_flat_np(jout["opt"]["v"])[name] / bc2)
        eps = ocfg["eps"]
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            sens = ((1 - b1) / bc1 / (rv + eps)
                    + np.abs(mh) * (1 - b2) * np.abs(ghj)
                    / (bc2 * np.maximum(rv, 1e-30) * (rv + eps) ** 2))
        allow = np.where(dg > 0, np.minimum(2.0 * lr, TIE_K * lr * sens * dg), 0.0)
        tie = allow > flat
        n_tie += int(tie.sum())
        n += tie.size
        lim = flat + allow
        if pt.dtype == torch.bfloat16:
            lim = lim + np.abs(want) * 2.0 ** -7
        if plant and name == big:
            got = got.copy()
            e = np.flatnonzero(~tie.ravel())[0]
            got.ravel()[e] = want.ravel()[e] + 5 * lim.ravel()[e]
        checks = [("param", got, want, lim)]
        for key, allow in (("m", (1 - b1) * dg),
                           ("v", (1 - b2) * np.abs(ght ** 2 - ghj ** 2))):
            w = _flat_np(jout["opt"][key])[name].astype(np.float32)
            t = _flat_np(tout["opt"][key])[name].astype(np.float32)
            checks.append((key, t, w, STEP_RTOL * float(np.abs(w).max()) + DEP_K * allow))
        if r is not None:
            w = _flat_np(jout["opt"]["ef_residual"])[name]
            t = _flat_np(tout["opt"]["ef_residual"])[name]
            allow = (np.abs(tt - tj) + np.abs(dt - dj)
                     + np.spacing(np.abs(tj).astype(np.float32)))
            checks.append(("ef_residual", t, w,
                           STEP_RTOL * float(np.abs(w).max()) + DEP_K * allow))
        for key, t, w, l in checks:
            assert t.shape == w.shape, (key, name, t.shape, w.shape)
            ratio = float((np.abs(t - w) / np.maximum(l, 1e-30)).max())
            assert ratio <= 1.0, (key, name, ratio)
            worst = max(worst, ratio)
    if not plant:
        print(f"    step {int(jout['opt']['step'])}: {n_tie} ties of {n}, largest "
              f"departure {worst:.3f} of its limit")
    assert n_tie <= TIE_SHARE_MAX * n, (n_tie, n)
    return n_tie, n, worst


def step_grads(jgrad, model, np_params, batch, microbatches):
    """JAX's and the port's gradient of the loss at the same params (flat
    numpy): with microbatches the mean of the slices' gradients, summed in
    float32 and cast to the param dtype, as the steps take them."""
    n = max(1, microbatches)
    jsum, tsum = {}, {}
    for i in range(n):
        b = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()}
        jg = jax.tree.map(np.asarray, jgrad(jax.tree.map(jnp.asarray, np_params), b))
        _, tg = port_grads(model, interop.lm_params_from_numpy(np_params, "cpu"), b)
        for name, g in leaves(jg):
            jsum[name] = jsum.get(name, 0) + np.asarray(g, np.float32)
            tsum[name] = tsum.get(name, 0) + tg[name]
    return ({k: v / np.float32(n) for k, v in jsum.items()},
            {k: v / np.float32(n) for k, v in tsum.items()})


def assert_metrics(got, want, rtol, gnorm_dep=0.0):
    """Metrics within ``rtol`` (``aux`` also 1e-6 absolute: it is ~0 for a
    balanced router), ``grad_norm`` also within ``gnorm_dep`` (the L2 norm
    of the two gradients' departure bounds their norms' by the triangle
    inequality), ``lr`` exactly."""
    got = {k: float(v) for k, v in got.items()}
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        atol = {"aux": 1e-6, "grad_norm": gnorm_dep}.get(k, 0.0)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)
    assert np.float32(got["lr"]) == np.float32(want["lr"]), (got["lr"], want["lr"])


def run_steps(arch, n=3, cfg_kw=None, opt_kw=None, microbatches=1,
              grad_compress=False):
    """``n`` steps of JAX's ``jax.jit(make_train_step(...))`` and of the
    port's, from the same params and batches: the port's own trajectory's
    metrics against JAX's, and each step from JAX's state
    (:func:`check_step`; the planted control must fail there). Returns the
    port's final (params, opt state) and the count of ties."""
    cfg, jcfg = cfgs(arch, **(cfg_kw or {}))
    ocfg = {**OPT, **(opt_kw or {})}
    jm, m = jbuild(jcfg), build_model(cfg)
    jstep_fn = jmake(jm, JOpt(**ocfg), microbatches=microbatches,
                     grad_compress=grad_compress)
    jstep = jax.jit(jstep_fn)
    jgrad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    step = make_train_step(m, OptConfig(**ocfg), impl="ref",
                           microbatches=microbatches, grad_compress=grad_compress)
    full = {**OptConfig(**ocfg).__dict__}
    bf16 = cfg.param_dtype == "bfloat16"
    jp0 = jax_params(jcfg)
    jp = jax.tree.map(jnp.asarray, jp0)
    jo = jstep_fn.optimizer.init(jp)
    p = interop.lm_params_from_numpy(jp0, "cpu")
    o = step.optimizer.init(p)
    ties = 0
    for i in range(n):
        batch = jax_batch(jcfg, i)
        jin = {"params": jax.tree.map(np.asarray, jp), "opt": jax.tree.map(np.asarray, jo)}
        jg, tg = step_grads(jgrad, m, jin["params"], batch, microbatches)
        jp, jo, jmet = jstep(jp, jo, batch)
        jout = {"params": jax.tree.map(np.asarray, jp), "opt": jax.tree.map(np.asarray, jo)}
        jmet = {k: float(v) for k, v in jmet.items()}
        # the port's step from JAX's state: the same metrics and new state
        tin_p = interop.lm_params_from_numpy(jin["params"], "cpu")
        tin_o = interop.lm_params_from_numpy(jin["opt"], "cpu")
        tp_, to_, tmet1 = step(tin_p, tin_o, batch)
        dep = DEP_K * float(np.sqrt(sum(
            np.sum((to_np(torch.from_numpy(tg[k]).to(dt)) - to_np(torch.from_numpy(jg[k]).to(dt))) ** 2)
            for k, dt in ((k, t.dtype) for k, t in leaves(tin_p)))))
        assert_metrics(tmet1, jmet, STEP_RTOL, dep)
        tout = {"params": tp_, "opt": to_}
        args = (jin, jout, tout, jg, tg, jmet["grad_norm"],
                float(tmet1["grad_norm"]), full, jmet["lr"])
        ties += check_step(*args)[0]
        try:
            check_step(*args, plant=True)
        except AssertionError:
            pass
        else:
            raise AssertionError("the planted departure passed the step check")
        assert int(to_["step"]) == int(jo["step"]) == i + 1
        # the port's own trajectory: float32 params within 1e-5; bf16
        # params part at their rounding ties after the first step
        p, o, tmet = step(p, o, batch)
        assert_metrics(tmet, jmet, STEP_RTOL if i == 0 or not bf16 else TRAJ_RTOL_BF16)
    return p, o, ties


def shape(B_=B, S_=S, kind="train"):
    return ShapeConfig("t", kind, S_, B_), JShape("t", kind, S_, B_)
