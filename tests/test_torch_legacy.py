"""The deprecated entry points, backend knobs and sampler helpers of the
JAX package, in the port (ROADMAP item 17): each legacy surface warns as
JAX's does (``DeprecationWarning``, JAX's message with the port's module
names) and gives what the call it stands for gives, bit for bit in the
port and within the render / decode tolerance (1e-5) of JAX; the sampler
helpers and the backend knobs, which JAX does not deprecate, warn in
neither package and agree with JAX bit for bit."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import backends as jbackends
from repro.configs import dvnr as jdvnr
from repro.core import inr as jinr
from repro.core import render as jr
from repro.core import sampling as js
from repro_torch import api, backends, interop
from repro_torch.configs import dvnr
from repro_torch.core import inr as tinr
from repro_torch.core import render as tr
from repro_torch.core import sampling as ts

ATOL = 1e-5
METAS = tuple({"origin": (0.0, 0.0, p / 2), "extent": (1.0, 1.0, 0.5),
               "vmin": 0.1 * p, "vmax": 1.0 + p} for p in range(2))


def _params(P=2, seed=0, amp=0.1):
    """Stacked SMOKE params of a trained model's magnitude: numpy, and the
    port's tensors of the same values."""
    p = jax.vmap(lambda k: jinr.init_inr(jdvnr.SMOKE, k))(
        jax.random.split(jax.random.PRNGKey(seed), P))
    p = jax.tree.map(np.asarray, p)
    p["tables"] = np.random.default_rng(seed).uniform(
        -amp, amp, p["tables"].shape).astype(np.float32)
    return p, interop.params_from_numpy(p, "cpu")


def _warned(fn):
    """(result, [DeprecationWarning messages]) of ``fn()``."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec
                 if issubclass(w.category, DeprecationWarning)]


def _same_text(port_msgs, jax_msgs):
    """The port's message is JAX's with its own package name."""
    assert len(port_msgs) == len(jax_msgs) == 1, (port_msgs, jax_msgs)
    assert port_msgs[0].replace("repro_torch.", "repro.") == jax_msgs[0]


def test_render_legacy_keywords_warn_and_match():
    npp, tp = _params()
    jm = japi.DVNRModel(jdvnr.SMOKE, jax.tree.map(jnp.asarray, npp), METAS)
    tm = api.DVNRModel(dvnr.SMOKE, tp, METAS)
    kw = dict(eye=(1.6, -0.5, 1.2), width=20, height=16, n_samples=12,
              density=30.0)
    want, jmsgs = _warned(lambda: japi.render(jm, backend="ref", **kw))
    got, tmsgs = _warned(lambda: api.render(tm, backend="cuda", **kw))
    _same_text(tmsgs, jmsgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    req = api.RenderRequest(camera=api.Camera(eye=kw["eye"]), width=20,
                            height=16, n_samples=12,
                            tf=api.TransferFunction(density=30.0))
    assert torch.equal(got, api.render(tm, req, backend="cuda"))
    with pytest.raises(TypeError, match="OR legacy"):
        api.render(tm, req, width=8)
    with pytest.raises(TypeError, match="unexpected keyword"):
        api.render(tm, backend="cuda", colour="red")


def test_render_distributed_and_partition_warn_and_match():
    npp, tp = _params()
    cam = jr.Camera(eye=(1.8, 1.4, 1.6))
    tcam = tr.Camera(**vars(cam))
    jfn = lambda: jr.render_distributed(jdvnr.SMOKE, jax.tree.map(jnp.asarray, npp),
                                        METAS, cam, 12, 10, (0.0, 2.0),
                                        n_samples=8, impl="ref")
    tfn = lambda: tr.render_distributed(dvnr.SMOKE, tp, METAS, tcam, 12, 10,
                                        (0.0, 2.0), n_samples=8, impl="cuda")
    want, jmsgs = _warned(jfn)
    got, tmsgs = _warned(tfn)
    _same_text(tmsgs, jmsgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert torch.equal(got, tr._render_distributed(
        dvnr.SMOKE, tp, METAS, tcam, 12, 10, (0.0, 2.0), n_samples=8,
        impl="cuda"))
    # one partition's ray march
    one_j = {"tables": npp["tables"][1], "mlp": [w[1] for w in npp["mlp"]]}
    one_t = {"tables": tp["tables"][1], "mlp": [w[1] for w in tp["mlp"]]}
    oj, dj = jr.make_rays(cam, 12, 10)
    ot, dt = tr.make_rays(tcam, 12, 10)
    args = ((0.0, 0.0, 0.5), (1.0, 1.0, 0.5), (0.1, 2.0), (0.0, 2.0))
    (wr, wd), jmsgs = _warned(lambda: jr.render_partition(
        jdvnr.SMOKE, jax.tree.map(jnp.asarray, one_j), *args, oj, dj,
        jr.default_tf(), n_samples=8, impl="ref"))
    (gr, gd), tmsgs = _warned(lambda: tr.render_partition(
        dvnr.SMOKE, one_t, *args, ot, dt, tr.default_tf(), n_samples=8,
        impl="cuda"))
    _same_text(tmsgs, jmsgs)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=ATOL, rtol=0)
    hit = np.isfinite(np.asarray(wd))
    assert np.array_equal(hit, np.isfinite(gd.numpy()))
    np.testing.assert_allclose(gd.numpy()[hit], np.asarray(wd)[hit], atol=ATOL)
    got_r, got_d = tr._render_partition(dvnr.SMOKE, one_t, *args, ot, dt,
                                        tr.default_tf(), n_samples=8, impl="cuda")
    assert torch.equal(gr, got_r) and torch.equal(gd, got_d)


@pytest.mark.parametrize("surface", ["inr_apply", "decode_grid"])
def test_inr_apply_and_decode_grid_warn_and_match(surface):
    npp, tp = _params(P=1, seed=3)
    one_j = jax.tree.map(lambda a: jnp.asarray(a[0]), npp)
    one_t = {"tables": tp["tables"][0], "mlp": [w[0] for w in tp["mlp"]]}
    if surface == "inr_apply":
        xyz = np.random.default_rng(1).uniform(0, 1, (300, 3)).astype(np.float32)
        want, jmsgs = _warned(lambda: jinr.inr_apply(jdvnr.SMOKE, one_j,
                                                     jnp.asarray(xyz), impl="ref"))
        got, tmsgs = _warned(lambda: tinr.inr_apply(dvnr.SMOKE, one_t,
                                                    torch.from_numpy(xyz),
                                                    impl="cuda"))
        same = tinr._inr_apply(dvnr.SMOKE, one_t, torch.from_numpy(xyz), "cuda")
    else:
        want, jmsgs = _warned(lambda: jinr.decode_grid(jdvnr.SMOKE, one_j,
                                                       (5, 6, 4), impl="ref",
                                                       chunk=37))
        got, tmsgs = _warned(lambda: tinr.decode_grid(dvnr.SMOKE, one_t,
                                                      (5, 6, 4), impl="cuda",
                                                      chunk=37))
        same = tinr._decode_grid(dvnr.SMOKE, one_t, (5, 6, 4), "cuda", 37)
    _same_text(tmsgs, jmsgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert torch.equal(got, same)


@pytest.mark.parametrize("key", [0, 7, (123, 456789)])
def test_step_keys_and_training_coords_bit_for_bit(key):
    jkey = jax.random.PRNGKey(key) if isinstance(key, int) else \
        jnp.asarray(key, jnp.uint32)
    (want, got), msgs = _warned(lambda: (js.step_keys(jkey, 5, 4),
                                         ts.step_keys(key, 5, 4)))
    assert not msgs                      # neither package deprecates them
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(jax.random.key_data(want)
                                             if jnp.issubdtype(want.dtype,
                                                               jax.dtypes.prng_key)
                                             else want))
    (want, got), msgs = _warned(lambda: (
        js.training_coords(jkey, 1000, 0.2, 0.01),
        ts.training_coords(key, 1000, 0.2, 0.01)))
    assert not msgs
    n_u = 1000 - ts.n_boundary(1000, 0.2)
    # uniform rows bit for bit; the Box-Muller boundary rows go through
    # log / cos, within a few ulp (ROADMAP: how a part counts as ported)
    np.testing.assert_array_equal(got.numpy()[:n_u], np.asarray(want)[:n_u])
    np.testing.assert_allclose(got.numpy()[n_u:], np.asarray(want)[n_u:],
                               atol=1e-6, rtol=0)


@pytest.fixture
def no_pin():
    yield
    backends.set_default_backend(None)
    jbackends.set_default_backend(None)


def test_backend_knobs_match_jax(no_pin):
    for name in ("ref", "cuda"):
        b = backends.get_backend(name)
        assert backends.get_backend(b) is b
        assert backends.resolve(name) is b
    for dt in ("float32", "bfloat16", "float16"):
        assert backends.get_backend("ref").supports_dtype(dt) == \
            jbackends.get_backend("ref").supports_dtype(dt), dt
        assert backends.get_backend("ref").supports_dtype(getattr(torch, dt)) == \
            jbackends.get_backend("ref").supports_dtype(dt)
    assert backends.get_backend("cuda").supports_dtype("bfloat16")
    assert not backends.get_backend("cuda").supports_dtype("float16")
    # a pin overrides "auto" in both packages, and None clears it
    jbackends.set_default_backend("ref")
    backends.set_default_backend("ref")
    assert jbackends.resolve("auto").name == backends.resolve("auto").name == "ref"
    assert backends.resolve_auto() is backends.get_backend("ref")
    with pytest.raises(ValueError, match="auto"):
        backends.set_default_backend("auto")
    with pytest.raises(ValueError, match="auto"):
        jbackends.set_default_backend("auto")
    with pytest.raises(ValueError, match="unknown backend"):
        backends.set_default_backend("nope")
    backends.set_default_backend(None)
    assert backends.resolve_auto("cpu") is backends.get_backend("ref")
    assert jbackends.resolve_auto("cpu").name == "ref"


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_pin_never_turns_auto_into_a_cpu_run(no_pin):
    """Without a card, "auto" raises, pinning the card's backend raises, and
    a pinned "ref" chooses the backend only: the device still needs the
    card."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.resolve("auto")
    with pytest.raises(ValueError, match="not available"):
        backends.set_default_backend("cuda")
    backends.set_default_backend("ref")
    assert backends.resolve("auto").name == "ref"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.resolve_device("auto")
