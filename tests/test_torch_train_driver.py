"""repro_torch's LM training driver (``launch.train``) on the CPU: it trains
and resumes (``tests/test_drivers.py``'s run), resumes a checkpoint the JAX
driver wrote (step 5's loss within 1e-5 of JAX's own resumed step 5, both
at float32 compute), takes microbatches and int8 compression, and raises
without a GPU under ``"auto"``; a mesh-less ``Sharder`` runs every family's
loss, ``object()`` raises, and every family's loss on a one-rank mesh is
JAX's on a one-device mesh.
"""
import shutil

import numpy as np
import pytest
import torch

import torch_train_parity as T
from repro.launch import train as jtrain
from repro_torch import interop
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.parallel.sharding import Sharder

CPU = ["--device", "cpu", "--impl", "ref"]


def test_train_driver_runs_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    args = ["--arch", "olmo_1b", "--smoke", "--batch", "2", "--seq", "32",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "2"] + CPU
    r1 = ttrain.main(args + ["--steps", "4"])
    assert r1["final_loss"] is not None and np.isfinite(r1["final_loss"])
    assert [h["step"] for h in r1["history"]] == [1, 2, 4]
    r2 = ttrain.main(args + ["--steps", "6", "--resume"])
    assert r2["history"][0]["step"] > 4        # resumed, not restarted
    assert r2["arch"] == "olmo_1b" and r2["steps"] == 6


def test_async_save_snapshots_before_the_next_in_place_step(tmp_path, monkeypatch):
    """The step updates params and moments in place while the driver's save
    writes in a thread: the checkpoint of step 1 holds step 1's values, bit
    for bit, even when the write only starts after step 2 has run (held
    back here until then)."""
    import threading
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as cm
    cfg, jcfg = T.cfgs("qwen2_0_5b")
    model = build_model(cfg)
    step = T.make_train_step(model, T.OptConfig(**T.OPT), impl="ref")
    params = model.init(0, device="cpu")
    opt = step.optimizer.init(params)
    params, opt, _ = step(params, opt, T.jax_batch(jcfg, 0))
    want = [(n, t.clone()) for n, t in T.leaves({"p": params, "o": opt})]
    go = threading.Event()
    savez = np.savez
    monkeypatch.setattr(cm.np, "savez", lambda *a, **k: (go.wait(), savez(*a, **k)))
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, (params, opt))
    params, opt, _ = step(params, opt, T.jax_batch(jcfg, 1))
    assert not torch.equal(params["embed"]["tok"], dict(want)["p/embed/tok"])
    go.set()
    mgr.wait()
    (p1, o1), _ = mgr.restore((params, opt), step=1)
    got = dict(T.leaves({"p": p1, "o": o1}))
    for n, t in want:
        assert torch.equal(got[n], t), n


def _f32_smoke(monkeypatch):
    """Both drivers' ``--smoke`` configs at float32 compute."""
    for mod, base in ((jtrain, T.jbase), (ttrain, T.base)):
        monkeypatch.setattr(mod, "get_smoke_config", lambda a, b=base: b.get_smoke_config(
            a).replace(compute_dtype="float32"))


def test_resumes_a_checkpoint_the_jax_driver_wrote(tmp_path, monkeypatch):
    _f32_smoke(monkeypatch)
    ck = tmp_path / "jax"
    args = ["--arch", "llama3_8b", "--smoke", "--batch", "2", "--seq", "32",
            "--ckpt-every", "4", "--log-every", "1"]
    jtrain.main(args + ["--steps", "4", "--ckpt-dir", str(ck)])
    shutil.copytree(ck, tmp_path / "port")
    want = jtrain.main(args + ["--steps", "5", "--ckpt-dir", str(ck), "--resume"])
    got = ttrain.main(args + ["--steps", "5", "--ckpt-dir", str(tmp_path / "port"),
                              "--resume"] + CPU)
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]] == [5]
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-5)


def test_driver_microbatches_and_grad_compress(tmp_path):
    r = ttrain.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "2", "--batch", "4",
                     "--seq", "16", "--microbatches", "2", "--grad-compress",
                     "--log-every", "1"] + CPU)
    assert [h["step"] for h in r["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in r["history"])


def test_driver_raises_without_a_gpu_under_auto(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "olmo_1b", "--smoke", "--steps", "1", "--batch", "2", "--seq", "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(args + ["--device", "cpu"])          # impl "auto"


@pytest.mark.parametrize("arch", T.ARCHS)
def test_meshless_sharder_runs_the_loss(arch):
    cfg, jcfg = T.cfgs(arch)
    model = build_model(cfg)
    params = interop.lm_params_from_numpy(T.jax_params(jcfg), "cpu")
    batch = T.jax_batch(jcfg)
    want, _ = model.loss(params, batch, impl="ref")
    got, _ = model.loss(params, batch, Sharder(None, T.B), impl="ref")
    assert torch.equal(got, want)
    mesh = Mesh({"data": 1, "model": 1}, ("data", "model"), {"data": 0, "model": 0},
                0, torch.device("cpu"))
    with pytest.raises(TypeError, match="Sharder"):
        model.loss(params, batch, object(), impl="ref")
    # on a one-rank mesh: JAX's loss on a one-device mesh (the MoE families
    # route as JAX's do on a mesh: arctic to a2a, grok to the tp block; 4
    # ranks against 4 devices: test_torch_mesh_models.py and, for the SSM,
    # hybrid, encoder-decoder and VLM families, test_torch_mesh_families.py)
    import jax
    from repro.launch.mesh import build_mesh
    from repro.models import build_model as jbuild
    from repro.parallel.sharding import Sharder as JSharder
    jmesh = build_mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jmesh:
        jloss, _ = jax.jit(lambda p, b: jbuild(jcfg).loss(p, b, JSharder(jmesh, T.B)))(
            T.jax_params(jcfg), batch)
    got, _ = model.loss(params, batch, Sharder(mesh, T.B), impl="ref")
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
    T.make_train_step(model, T.OptConfig(), Sharder(mesh, T.B), impl="ref")
