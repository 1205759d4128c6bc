"""repro_torch.core.trainer and repro_torch.api.train against the JAX
package's trainer: the §III-B rules, the random init (bit for bit), a
chunk's loss trace on every step path, the per-step loop, convergence
masking, the non-finite guard, the quickstart's PSNR, state interop, and
the entry points' boundaries (no JAX loaded, no silent CPU, unported
options refused).

Tolerances: the init and the integer state are compared for equality; loss
traces within 1e-5 absolute (float32 L1 losses of ~0.1; the sums run in
another order than XLA's); the quickstart's PSNR within 0.1 dB."""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import dvnr as jdvnr
from repro.core import trainer as jtr
from repro.data.volume import make_partition as jmake_partition
from repro_torch import api, interop
from repro_torch.configs import dvnr
from repro_torch.core import trainer as ttr
from repro_torch.data.volume import make_partition
from repro_torch.optim.adamw import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-5
CFG = dvnr.SMOKE.replace(n_hidden_layers=2, batch_size=512)
JCFG = jdvnr.SMOKE.replace(n_hidden_layers=2, batch_size=512)
P = 2


def _parts(local=(10, 10, 10), kind="cloverleaf"):
    grid = (1, 1, P)
    return ([jmake_partition(kind, p, grid, local, 0.3) for p in range(P)],
            [make_partition(kind, p, grid, local, 0.3, device="cpu")
             for p in range(P)])


def _vols(parts):
    return torch.stack([p.normalized() for p in parts])


@pytest.fixture(scope="module")
def jax_unfused_trace():
    """The JAX trainer's unfused 12-step chunk (the parity baseline)."""
    jparts, _ = _parts()
    tr = jtr.DVNRTrainer(JCFG.replace(fuse_train_step="off"), P)
    st = tr.init(jax.random.PRNGKey(1))
    vols = jnp.stack([p.normalized() for p in jparts])
    st, trace = tr.train_chunk(st, vols, 12, key=jax.random.PRNGKey(2))
    return np.asarray(trace), jax.tree.map(np.asarray, st.params)


@pytest.mark.parametrize("cfg", [dvnr.SMOKE, dvnr.PRODUCTION256,
                                 dvnr.CLOVERLEAF_SCALING], ids=["smoke", "p256", "cl"])
def test_adaptive_rules_match_jax(cfg):
    jcfg = jdvnr.DVNRConfig(**cfg.__dict__)
    for nvox in (1000, 256 ** 3, 10 ** 7):
        assert ttr.train_iterations(cfg, nvox) == jtr.train_iterations(jcfg, nvox)
    for local, glob in ((256 ** 3, 512 ** 3), (64 ** 3, 512 ** 3), (1, 1)):
        a = ttr.adaptive_config(cfg, local, glob)
        b = jtr.adaptive_config(jcfg, local, glob)
        assert (a.log2_hashmap_size, a.base_resolution) == \
            (b.log2_hashmap_size, b.base_resolution)


@pytest.mark.parametrize("cfg", [CFG, dvnr.PRODUCTION256.replace(n_levels=2)],
                         ids=["smoke", "p256"])
def test_init_matches_jax_bit_for_bit(cfg):
    jcfg = jdvnr.DVNRConfig(**cfg.__dict__)
    jst = jtr.DVNRTrainer(jcfg, 3).init(jax.random.PRNGKey(9))
    tst = ttr.DVNRTrainer(cfg, 3, impl="ref", device="cpu").init(9)
    for a, b in zip(tree_leaves(tst.params), jax.tree.leaves(jst.params),
                    strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tst.opt["step"].numpy(), np.asarray(jst.opt["step"]))
    assert all(not t.any() for t in tree_leaves(tst.opt["m"]))
    assert torch.isinf(tst.loss_ma).all() and tst.active.all()


def test_warm_start_copies_the_cache_and_seeds_the_master():
    cache = ttr.init_params(CFG, 4, P)
    tr = ttr.DVNRTrainer(CFG.replace(precision="bf16"), P, impl="ref",
                         device="cpu")
    st = tr.init(0, cached_params=cache)
    assert st.params["tables"].dtype == torch.bfloat16
    assert torch.equal(st.opt["mw"]["tables"], cache["tables"])   # not rounded
    cache["tables"].add_(1.0)                                     # caller's copy
    assert not torch.equal(st.opt["mw"]["tables"], cache["tables"])


@pytest.mark.parametrize("backend,fuse,fuse_sampling", [
    ("ref", "off", "off"), ("cuda", "off", "off"), ("cuda", "auto", "off"),
    ("ref", "auto", "auto"), ("cuda", "auto", "auto")])
def test_chunk_loss_trace_matches_jax_unfused(jax_unfused_trace, backend, fuse,
                                              fuse_sampling):
    want, want_params = jax_unfused_trace
    _, tparts = _parts()
    tr = ttr.DVNRTrainer(CFG.replace(fuse_train_step=fuse,
                                     fuse_sampling=fuse_sampling), P,
                         impl=backend, device="cpu")
    assert tr.fuse_train_step == (fuse != "off")
    assert tr.fuse_sampling == (fuse_sampling != "off")
    st, trace = tr.train_chunk(tr.init(1), _vols(tparts), 12, key=2)
    assert st.step == 12 and trace.shape == (12, P) and st.finite.all()
    np.testing.assert_allclose(trace.numpy(), want, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(st.params["tables"].numpy(), want_params["tables"],
                               atol=LOSS_ATOL, rtol=0)


def test_train_looped_matches_train_chunk():
    _, tparts = _parts()
    vols = _vols(tparts)
    tr = ttr.DVNRTrainer(CFG, P, impl="ref", device="cpu")
    a, ha = tr.train(tr.init(3), vols, steps=9, key=5, log_every=1)
    b, hb = tr.train_looped(tr.init(3), vols, steps=9, key=5, log_every=1)
    assert a.step == b.step == 9
    assert [s for s, _ in ha["loss"]] == [s for s, _ in hb["loss"]]
    np.testing.assert_array_equal([l for _, l in ha["loss"]],
                                  [l for _, l in hb["loss"]])
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_convergence_masking_matches_jax():
    """A target loss that one partition reaches first: the same steps run,
    the same partitions freeze, the same loss history is logged."""
    jparts, tparts = _parts()
    cfg = CFG.replace(target_loss=0.07)
    jcfg = JCFG.replace(target_loss=0.07)
    jm, ji = japi.train(jparts, jcfg, key=jax.random.PRNGKey(0), backend="ref",
                        steps=40, check_every=8, log_every=4)
    tm, ti = api.train(tparts, cfg, key=0, backend="cuda", steps=40,
                       check_every=8, log_every=4)
    assert ti["steps"] == ji["steps"]
    assert np.array_equal(ti["state"].active.numpy(),
                          np.asarray(ji["state"].active))
    np.testing.assert_allclose([l for _, l in ti["loss_history"]],
                               [l for _, l in ji["loss_history"]],
                               atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(ti["state"].loss_ma.numpy(),
                               np.asarray(ji["state"].loss_ma), atol=LOSS_ATOL)


@pytest.mark.parametrize("guard", [True, False])
def test_guard_nonfinite_flags_only_the_bad_partition(guard):
    jparts, tparts = _parts()
    jvols = np.stack([np.asarray(p.normalized()) for p in jparts])
    jvols[1, 3:6, 3:6, 3:6] = np.nan
    ttrn = ttr.DVNRTrainer(CFG.replace(guard_nonfinite=guard), P, impl="cuda",
                           device="cpu")
    tst, _ = ttrn.train_chunk(ttrn.init(0), torch.from_numpy(jvols), 6, key=1)
    assert tst.finite.tolist() == ([True, False] if guard else [True, True])
    if guard:    # with the guard off JAX reports all-True without checking
        jtrn = jtr.DVNRTrainer(JCFG, P)
        jst, _ = jtrn.train_chunk(jtrn.init(jax.random.PRNGKey(0)),
                                  jnp.asarray(jvols), 6, key=jax.random.PRNGKey(1))
        assert np.array_equal(tst.finite.numpy(), np.asarray(jst.finite))


def test_api_train_quickstart_psnr_matches_jax():
    """examples/quickstart.py's configuration, 60 steps, through both
    packages' api.train and the trainers' evaluate."""
    local = (24, 24, 24)
    jparts, tparts = _parts(local)
    kw = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=9,
              base_resolution=8, n_neurons=16, n_hidden_layers=2, epochs=10,
              batch_size=4096, n_train_min=200, boundary_lambda=0.15,
              boundary_sigma=0.005)
    jm, ji = japi.train(jparts, jdvnr.DVNRConfig(**kw), backend="ref",
                        key=jax.random.PRNGKey(0), steps=60)
    tm, ti = api.train(tparts, dvnr.DVNRConfig(**kw), backend="cuda", key=0,
                       steps=60)
    jpsnr = ji["trainer"].evaluate(ji["state"], jnp.stack(
        [p.normalized() for p in jparts]), local)["psnr"]
    tpsnr = ti["trainer"].evaluate(ti["state"], _vols(tparts), local)["psnr"]
    assert abs(tpsnr - jpsnr) < 0.1, (tpsnr, jpsnr)
    assert tpsnr > 15.0
    assert tm.n_partitions == P and tm.parts_meta is not None


def test_state_interop_roundtrip_and_from_state():
    _, tparts = _parts()
    tr = ttr.DVNRTrainer(CFG, P, impl="ref", device="cpu")
    st, _ = tr.train_chunk(tr.init(0), _vols(tparts), 3, key=0)
    back = interop.state_from_numpy(interop.state_to_numpy(st), "cpu")
    assert back.step == st.step == 3
    for x, y in zip(tree_leaves(back.params) + tree_leaves(back.opt),
                    tree_leaves(st.params) + tree_leaves(st.opt)):
        assert torch.equal(x, y)
    model = api.DVNRModel.from_state(CFG, back, tparts)
    assert model.stacked and model.n_partitions == P
    assert model.grange == (min(p.vmin for p in tparts), max(p.vmax for p in tparts))


def test_unported_options_raise():
    # a mesh is ported (test_torch_distributed.py); it must be the port's
    with pytest.raises(TypeError, match="Mesh"):
        ttr.DVNRTrainer(CFG, P, mesh=object(), impl="ref", device="cpu")
    # the static checks are ported (test_torch_analysis.py): a clean config
    # builds under "warn" with no warning, and only the three modes exist
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr = ttr.DVNRTrainer(CFG.replace(static_checks="warn"), P, impl="ref",
                             device="cpu")
    assert tr.run_static_checks(strict=True).passed
    with pytest.raises(ValueError, match="static_checks"):
        ttr.DVNRTrainer(CFG.replace(static_checks="strict"), P, impl="ref",
                        device="cpu")
    _, tparts = _parts((6, 6, 6))
    # the recovery ladder is ported; it acts on the non-finite detector
    from repro_torch.resilience import RecoveryPolicy
    with pytest.raises(ValueError, match="guard_nonfinite"):
        api.train(tparts, CFG.replace(guard_nonfinite=False), backend="ref",
                  steps=1, recovery=RecoveryPolicy())
    with pytest.raises(ValueError, match="fuse_train_step"):
        ttr.DVNRTrainer(CFG.replace(fuse_train_step="always"), P, impl="ref",
                        device="cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_api_train_on_cpu_loads_no_jax_and_auto_needs_a_card():
    code = (
        "import sys\n"
        "from repro_torch import api\n"
        "from repro_torch.configs.dvnr import SMOKE\n"
        "from repro_torch.data.volume import make_partition\n"
        "parts = [make_partition('cloverleaf', p, (1, 1, 2), (6, 6, 6),"
        " device='cpu') for p in range(2)]\n"
        "m, info = api.train(parts, SMOKE, backend='cuda', steps=3)\n"
        "assert info['steps'] == 3 and m.params['tables'].device.type == 'cpu'\n"
        "try:\n"
        "    api.train(parts, SMOKE, steps=1)\n"
        "    raise SystemExit('backend auto trained without a card')\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_serve_trains_the_smoke_model_first():
    from repro_torch.launch import serve

    out = serve.main(["--smoke", "--device", "cpu", "--backend", "ref",
                      "--frames", "2", "--clients", "1"])
    assert out["train_s"] > 0 and out["served"] == 2
    assert np.isfinite(out["checksum"])
