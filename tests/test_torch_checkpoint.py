"""The port's checkpoints against the JAX package's
(``tests/test_checkpoint.py``, test for test): atomic save and restore, GC,
async saves and their error on ``wait``, swept temporary directories, a
mismatched template, a crash mid-write, torn arrays, a wrong config, and
compressed trees (error bound, bf16, ratio, lossless int leaves, the blob's
leaves equal to JAX's). Then across packages and ranks: a checkpoint that
the JAX manager wrote for a DVNR trainer state restored by the port (and
the reverse), and an elastic restart of a 4-rank run on 2 ranks
(``plan_restart`` / ``elastic_restore``) that trains to the same bits as
the run that was not interrupted.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

import test_torch_dist_workers as W
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import compress_tree as jcompress_tree
from repro.checkpoint import decompress_tree as jdecompress_tree
from repro.configs import dvnr as jdvnr
from repro.core import trainer as jtr
from repro.data.volume import make_partition as jmake_partition
from repro_torch import api, interop
from repro_torch.checkpoint import (CheckpointManager, compress_tree,
                                    compression_report, decompress_tree)
from repro_torch.configs import dvnr
from repro_torch.core import trainer as ttr
from repro_torch.data.volume import make_partition, partition_grid
from repro_torch.optim.adamw import tree_leaves


def _tree(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep_last=5)
    mgr.save(10, t, metadata={"note": "x"}, blocking=True)
    rec, meta = mgr.restore(t)
    assert meta["note"] == "x"
    for k in t:
        assert torch.equal(rec[k], t[k]) and rec[k].dtype == t[k].dtype


def test_gc_keeps_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=3)
    for s in [1, 2]:
        mgr.save(s, _tree(s))          # async
    mgr.wait()
    rec, _ = mgr.restore(_tree(), step=2)
    assert torch.equal(rec["w"], _tree(2)["w"])


def test_crash_tmp_dirs_swept(tmp_path):
    junk = tmp_path / "step_000000000099.tmp-1234"
    junk.mkdir(parents=True)
    (junk / "partial").write_bytes(b"x")
    mgr = CheckpointManager(tmp_path)
    assert not junk.exists()           # swept on startup
    assert mgr.all_steps() == []


def test_restore_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=True)
    with pytest.raises(ValueError):
        mgr.restore({"only_one": torch.zeros(3)})


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    """A failing async write must re-raise at the next sync point; the
    manager stays usable afterwards."""
    mgr = CheckpointManager(tmp_path)

    def boom(*a, **k):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "savez", boom)
    mgr.save(1, _tree())                             # async; thread captures
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()
    monkeypatch.undo()
    mgr.save(2, _tree(2), blocking=True)             # error cleared: usable
    assert mgr.latest_step() == 2


def test_crash_mid_write_recovers_to_previous_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=3)
    mgr.save(1, _tree(1), blocking=True)
    torn = tmp_path / "step_000000000002.tmp-9999"   # simulated dead writer
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"partial garbage")
    mgr2 = CheckpointManager(tmp_path)
    assert not torn.exists()                         # swept on startup
    assert mgr2.latest_step() == 1
    rec, _ = mgr2.restore(_tree(1))
    assert torch.equal(rec["w"], _tree(1)["w"])


def test_restore_detects_torn_arrays_vs_manifest(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    final = mgr.save(1, t, blocking=True)
    with np.load(final / "arrays.npz") as z:
        arrs = {k: z[k] for k in z.files}
    arrs["leaf_0"] = arrs["leaf_0"][:3]              # truncated leaf
    np.savez(final / "arrays.npz", **arrs)
    with pytest.raises(ValueError, match="corrupt or torn"):
        mgr.restore(t, 1)


def test_restore_into_wrong_config_template_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=True)
    wrong = {"w": torch.zeros((8, 8)), "b": torch.zeros(64),
             "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="wrong model config"):
        mgr.restore(wrong, 1)


def test_bf16_leaves_roundtrip_as_bit_patterns(tmp_path):
    t = {"w": torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
         .to(torch.bfloat16), "s": torch.tensor(3)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, t, blocking=True)
    rec, _ = mgr.restore(t)
    assert rec["w"].dtype == torch.bfloat16 and torch.equal(rec["w"], t["w"])


if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(st.integers(0, 2**31 - 1), st.sampled_from([1e-2, 1e-3, 1e-4]))
    def test_compressed_tree_error_bound(seed, rel_tol):
        rng = np.random.default_rng(seed)
        t = {"w": torch.from_numpy(rng.standard_normal((80, 96)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(17).astype(np.float32))}
        rec = decompress_tree(compress_tree(t, rel_tol), t)
        for k in t:
            a, b = t[k].numpy(), rec[k].numpy()
            rngk = max(float(a.max() - a.min()), 1e-12)
            assert np.abs(a - b).max() <= rel_tol * rngk * (1 + 1e-3), k
            assert b.dtype == a.dtype


def test_compressed_tree_leaves_equal_jax():
    """The same codecs, byte for byte: the port decodes to JAX's values."""
    rng = np.random.default_rng(11)
    a = {"w": rng.standard_normal((80, 96)).astype(np.float32),
         "b": rng.standard_normal(17).astype(np.float32)}
    rec = decompress_tree(compress_tree({k: torch.from_numpy(v) for k, v in a.items()},
                                        1e-3), a)
    jrec = jdecompress_tree(jcompress_tree({k: jnp.asarray(v) for k, v in a.items()},
                                           1e-3), a)
    for k in a:
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(jrec[k]))


def test_compressed_tree_bf16_roundtrip():
    rng = np.random.default_rng(3)
    rel_tol = 1e-3
    t = {"w": torch.from_numpy(rng.standard_normal((80, 96)).astype(np.float32))
         .to(torch.bfloat16),
         "b": torch.from_numpy(rng.standard_normal(17).astype(np.float32))
         .to(torch.bfloat16),
         "step": torch.tensor(7, dtype=torch.int32)}
    rec = decompress_tree(compress_tree(t, rel_tol), t)
    assert int(rec["step"]) == 7
    for k in ("w", "b"):
        assert rec[k].dtype == t[k].dtype == torch.bfloat16, k
        a32, b32 = t[k].float().numpy(), rec[k].float().numpy()
        rngk = float(a32.max() - a32.min())
        bound = rel_tol * rngk * (1 + 1e-3) + np.abs(a32).max() / 128.0
        assert np.abs(a32 - b32).max() <= bound, k


def test_compressed_tree_ratio_beats_raw():
    rng = np.random.default_rng(0)
    x = np.linspace(0, 4 * np.pi, 128)
    t = {"w": torch.from_numpy((np.sin(x)[:, None] * np.cos(x)[None, :]
                                + 0.01 * rng.standard_normal((128, 128)))
                               .astype(np.float32))}
    rep = compression_report(t, rel_tol=1e-3)
    assert rep["ratio"] > 3.0, rep


def test_compressed_tree_int_leaves_lossless():
    t = {"ids": torch.arange(100, dtype=torch.int32), "w": torch.ones((8, 8)),
         "mask": torch.tensor([True, False, True])}
    rec = decompress_tree(compress_tree(t, 1e-2), t)
    assert torch.equal(rec["ids"], t["ids"]) and torch.equal(rec["mask"], t["mask"])


# --------------------------------------------------------------------------- #
# across packages and ranks
# --------------------------------------------------------------------------- #
CFG = dvnr.SMOKE.replace(n_hidden_layers=2)
JCFG = jdvnr.SMOKE.replace(n_hidden_layers=2)


def test_jax_written_dvnr_checkpoint_restores_in_the_port(tmp_path):
    grid, local, P = (1, 1, 2), (8, 8, 8), 2
    jparts = [jmake_partition("cloverleaf", p, grid, local, 0.3) for p in range(P)]
    tr = jtr.DVNRTrainer(JCFG, P)
    st = tr.init(jax.random.PRNGKey(1))
    st, _ = tr.train_chunk(st, jnp.stack([p.normalized() for p in jparts]), 5,
                           key=jax.random.PRNGKey(2))
    jtree = {"params": st.params, "opt": st.opt, "loss_ma": st.loss_ma,
             "active": st.active, "step": st.step}
    JCheckpointManager(tmp_path / "jax").save(5, jtree, metadata={"by": "jax"},
                                              blocking=True)
    like = ttr.DVNRTrainer(CFG, P, impl="ref", device="cpu").init(0)
    got, meta = interop.state_from_checkpoint(tmp_path / "jax", like)
    assert meta == {"by": "jax"} and got.step == 5
    want = interop.state_from_numpy(
        {"params": jax.tree.map(np.asarray, st.params),
         "opt": jax.tree.map(np.asarray, st.opt),
         "loss_ma": np.asarray(st.loss_ma), "active": np.asarray(st.active),
         "step": st.step}, "cpu")
    for a, b in zip(tree_leaves(interop.state_tree(got)),
                    tree_leaves(interop.state_tree(want))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and the other way: the port's checkpoint read by the JAX manager
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(5, interop.state_tree(got), blocking=True)
    jrec, _ = JCheckpointManager(tmp_path / "port").restore(jtree)
    for a, b in zip(jax.tree.leaves(jrec), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _restack(trees, pairs):
    """The 4 ranks' saved trees as the 2 ranks' shares: partitions
    concatenated pair by pair (what the restore must give)."""
    def cat(*xs):
        return xs[0] if xs[0].ndim == 0 else torch.cat(xs)
    from repro_torch.optim.adamw import tree_map
    return [tree_map(cat, *[trees[r] for r in pair]) for pair in pairs]


def test_elastic_restart_4_to_2_ranks(tmp_path):
    """4 ranks train 6 steps and checkpoint; the restarted group of 2
    plans (3 survivors -> 2 ranks), restores 2 partitions a rank and
    trains to 12 steps. The restore is the 4 ranks' state bit for bit, and
    the resumed run is bit for bit a run that continues from that state on
    2 ranks without the checkpoint; against 12 uninterrupted steps on 2
    ranks it is within 1e-6 (the first 6 steps ran one partition a rank:
    the CPU's batched products change their last bits with the stack's
    size, test_torch_distributed.py)."""
    grid, local, steps, half = partition_grid(4), (8, 8, 8), 12, 6
    ckpt = tmp_path / "ckpt"
    saved = W.launch("elastic_save", 4, tmp_path / "save", cfg=CFG, grid=grid,
                     local=local, steps=half, key=9, ckpt=str(ckpt))
    res = W.launch("elastic_resume", 2, tmp_path / "resume", cfg=CFG, grid=grid,
                   local=local, steps=steps, key=9, ckpt=str(ckpt), survivors=3)
    assert [r["partitions"] for r in res] == [(0, 1), (2, 3)]
    assert all(r["devices"] == 2 and r["resumed_from"] == half and
               r["meta"] == {"world": 4} for r in res)
    want = _restack([s_["tree"] for s_ in saved], [(0, 1), (2, 3)])
    for r, w in zip(res, want):
        for a, b in zip(tree_leaves(r["restored"]), tree_leaves(w)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    from repro_torch.core.sampling import as_key, split
    from repro_torch.launch.mesh import Mesh
    k_train = split(as_key(9))[1]
    parts = [make_partition("cloverleaf", p, grid, local, 0.3, device="cpu")
             for p in range(4)]
    for i, (r, w) in enumerate(zip(res, want)):
        mesh = Mesh({"data": 2}, ("data",), {"data": i}, i, torch.device("cpu"))
        tr = ttr.DVNRTrainer(CFG, 4, mesh=mesh, impl="ref", device="cpu")
        vols = torch.stack([parts[p].normalized() for p in tr.partitions])
        st, _ = tr.train(interop.state_from_tree(w), vols, steps=steps - half,
                         key=k_train)
        for a, b in zip(tree_leaves(r["params"]), tree_leaves(st.params)):
            assert torch.equal(a, b)
    whole = W.launch("elastic_save", 2, tmp_path / "whole", cfg=CFG, grid=grid,
                     local=local, steps=steps, key=9, ckpt=str(tmp_path / "c2"))
    for r, w in zip(res, whole):
        for a, b in zip(tree_leaves(r["params"]), tree_leaves(w["params"])):
            assert float((a - b).abs().max()) <= 1e-6
