"""repro_torch.resilience against repro.resilience: the fault plan's draws
(the flipped bytes and the poisoned voxels, bit for bit with JAX's),
injection that leaves the originals clean, structural sanitization (the
same degraded ranks and placeholder boxes as JAX), the non-finite detector,
the retry ladder on JAX's flaky-chunk stub (the same events in both
packages), ``train_chunk(lr_scale=)``, ``api.train(recovery=)`` (the
healthy partition bit for bit with the port's clean run, within the trainer
tests' 1e-5 of JAX's recovered run), and the 20-cycle acceptance session,
whose ``health()`` equals the values JAX's test pins, on two runs (SMOKE,
2 ranks x 10^3, the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import dvnr as jdvnr
from repro.core.trainer import DVNRState as JaxDVNRState
from repro.core.trainer import DVNRTrainer as JaxDVNRTrainer
from repro.insitu.simulation import SimulationConfig as JaxSimulationConfig
from repro.insitu.simulation import SyntheticSimulation as JaxSyntheticSimulation
from repro.resilience import FaultPlan as JaxFaultPlan
from repro.resilience import FaultSpec as JaxFaultSpec
from repro.resilience import FaultySimulation as JaxFaultySimulation
from repro.resilience import RecoveryPolicy as JaxRecoveryPolicy
from repro.resilience import sanitize_partitions as jax_sanitize
from repro.resilience import train_with_recovery as jax_train_with_recovery
from repro.resilience.faults import _truncate as jax_truncate
from repro_torch import api
from repro_torch.configs import dvnr
from repro_torch.core.trainer import DVNRState, DVNRTrainer
from repro_torch.data.volume import VolumePartition
from repro_torch.insitu import InSituSession, SimulationConfig, SyntheticSimulation
from repro_torch.optim.adamw import tree_leaves
from repro_torch.resilience import (FaultPlan, FaultSpec, FaultySimulation,
                                    InjectedKernelFault, RecoveryPolicy,
                                    sanitize_partitions, train_with_recovery)
from repro_torch.resilience.faults import _truncate
from repro_torch.resilience.recovery import (NonFiniteTrainingError,
                                             merge_partitions, snapshot_state)

TOL = 1e-5                      # the trainer tests' tolerance
CFG = dvnr.SMOKE
JCFG = jdvnr.SMOKE
SIM = SimulationConfig("cloverleaf", n_ranks=2, local_shape=(10, 10, 10))
JSIM = JaxSimulationConfig("cloverleaf", n_ranks=2, local_shape=(10, 10, 10))


def _jparts(cycles=1):
    sim = JaxSyntheticSimulation(JSIM)
    for _ in range(cycles):
        sim.step()
    return list(sim.publish(sim.field_names[0]))


def _tpart(p):
    return VolumePartition(torch.from_numpy(np.array(p.data)), p.origin,
                           p.extent, p.ghost, p.vmin, p.vmax)


def _all_nan(part):
    return VolumePartition(torch.full_like(part.data, float("nan")),
                           part.origin, part.extent, part.ghost, part.vmin,
                           part.vmax)


def _jax_all_nan(part):
    from repro.data.volume import VolumePartition as JaxVolumePartition
    return JaxVolumePartition(np.full_like(np.asarray(part.data), np.nan),
                              part.origin, part.extent, part.ghost, part.vmin,
                              part.vmax)


def _leaves_np(tree):
    return [x.float().numpy() for x in tree_leaves(tree)]


# --------------------------------------------------------------------------- #
# the fault plan's draws
# --------------------------------------------------------------------------- #
def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("cosmic_ray", cycle=1)


@pytest.mark.parametrize("seed,magnitude,partition", [
    (7, 0.05, 1), (8, 0.05, 1), (7, 0.3, None), (11, 0.02, 0)])
def test_corrupt_bytes_match_jax_byte_for_byte(seed, magnitude, partition):
    blob = bytes(range(256)) * 4
    spec = FaultSpec("corrupt_blob", cycle=3, partition=partition,
                     magnitude=magnitude)
    jspec = JaxFaultSpec("corrupt_blob", cycle=3, partition=partition,
                         magnitude=magnitude)
    got = FaultPlan(seed, [spec]).corrupt_bytes(blob, spec)
    assert got == JaxFaultPlan(seed, [jspec]).corrupt_bytes(blob, jspec)
    assert got != blob and len(got) == len(blob)


@pytest.mark.parametrize("kind,magnitude,field", [
    ("nan_field", 0.02, "cloverleaf"), ("inf_field", 0.3, "cloverleaf"),
    ("nan_field", 0.05, "velocity")])
def test_poisoned_voxels_match_jax(kind, magnitude, field):
    """The same voxels poisoned (3-component fields: the same vectors)."""
    def faults(cls_spec):
        return [cls_spec(kind, cycle=1, partition=0, magnitude=magnitude),
                cls_spec(kind, cycle=1, partition=1, magnitude=magnitude / 2)]

    sim = FaultySimulation(SyntheticSimulation(SIM, device="cpu"),
                           FaultPlan(5, faults(FaultSpec)))
    jsim = JaxFaultySimulation(JaxSyntheticSimulation(JSIM),
                               JaxFaultPlan(5, faults(JaxFaultSpec)))
    for s in (sim, jsim):
        s.step()
    got, want = sim.publish(field), jsim.publish(field)
    bad = np.isnan if kind == "nan_field" else np.isinf
    for g, w in zip(got, want):
        g, w = g.data.numpy(), np.asarray(w.data)
        assert bad(g).any()
        np.testing.assert_array_equal(bad(g), bad(w))


def test_faulty_simulation_injects_and_keeps_originals_clean():
    plan = FaultPlan(0, [
        FaultSpec("nan_field", cycle=1, partition=1, magnitude=0.01),
        FaultSpec("drop_partition", cycle=2, partition=0),
        FaultSpec("truncate_partition", cycle=3, partition=1),
        FaultSpec("slow_tick", cycle=4, latency_s=2.5),
    ])
    inner = SyntheticSimulation(SIM, device="cpu")
    sim = FaultySimulation(inner, plan)
    f = sim.field_names[0]
    sim.step()
    parts = sim.publish(f)
    assert torch.isnan(parts[1].data).any()
    assert not torch.isnan(parts[0].data).any()
    assert np.isfinite(parts[1].vmin) and np.isfinite(parts[1].vmax)
    assert sim.publish(f) is parts                   # memoized faulted handle
    for p in inner.publish(f):                       # originals never written
        assert torch.isfinite(p.data).all()
    sim.step()
    parts = sim.publish(f)
    assert parts[0] is None and parts[1] is not None
    assert sim.injected_latency_s == 0.0
    sim.step()
    parts = sim.publish(f)
    good = tuple(parts[0].data.shape)
    assert parts[1].data.shape[0] == good[0] // 2
    assert parts[1].data.data_ptr() != inner.publish(f)[1].data.data_ptr()
    sim.step()
    assert sim.injected_latency_s == 2.5             # accounted, not slept
    assert plan.should_raise(4) is False and plan.latency(4) == 2.5


# --------------------------------------------------------------------------- #
# structural sanitization
# --------------------------------------------------------------------------- #
def test_sanitize_matches_jax():
    jparts = _jparts()
    tparts = [_tpart(p) for p in jparts]
    cases = [
        ([None, 1], None), ([None, 1], "template"), ([0, "torn"], None),
        ([0], None), ([None, None], "template"), ([0, 1], None)]

    def build(parts, spec, trunc):
        return [None if i is None else trunc(parts[1]) if i == "torn"
                else parts[i] for i in spec]

    for spec, tmpl in cases:
        got, gdeg = sanitize_partitions(build(tparts, spec, _truncate), 2,
                                        template=tparts if tmpl else None)
        want, wdeg = jax_sanitize(build(jparts, spec, jax_truncate), 2,
                                  template=jparts if tmpl else None)
        assert gdeg == wdeg, spec
        for g, w in zip(got, want):
            assert (g.origin, g.extent, g.ghost, g.vmin, g.vmax) == \
                (tuple(w.origin), tuple(w.extent), w.ghost, w.vmin, w.vmax)
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
    with pytest.raises(ValueError, match="every published partition"):
        sanitize_partitions([None, None], 2)


# --------------------------------------------------------------------------- #
# the detector, the ladder, lr_scale
# --------------------------------------------------------------------------- #
def _vols(parts):
    return torch.stack([p.normalized() for p in parts])


def test_detector_flags_exactly_the_poisoned_partition():
    tparts = [_tpart(p) for p in _jparts()]
    tr = DVNRTrainer(CFG, 2, impl="cuda", device="cpu")
    vols = _vols(tparts)
    s, _ = tr.train_chunk(tr.init(0), vols, 4, key=1)
    assert s.finite.tolist() == [True, True]
    poisoned = vols.clone()
    poisoned[1] = float("nan")
    s, _ = tr.train_chunk(tr.init(0), poisoned, 4, key=1)
    assert s.finite.tolist() == [True, False]
    tr_off = DVNRTrainer(CFG.replace(guard_nonfinite=False), 2, impl="ref",
                         device="cpu")
    with pytest.raises(ValueError, match="guard_nonfinite"):
        train_with_recovery(tr_off, tr_off.init(0), poisoned, steps=2, key=1)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_train_chunk_lr_scale_matches_jax(fuse):
    """The lr-backoff rung's chunk: the fused op's schedule column and the
    unfused AdamW both take ``lr * lr_scale``."""
    jparts = _jparts()
    tparts = [_tpart(p) for p in jparts]
    jtr = JaxDVNRTrainer(JCFG.replace(fuse_train_step="off"), 2)
    tr = DVNRTrainer(CFG.replace(fuse_train_step=fuse), 2, impl="cuda",
                     device="cpu")
    jvols = jnp.stack([p.normalized() for p in jparts])
    for scale in (1.0, 0.25):
        js, jtrace = jtr.train_chunk(jtr.init(jax.random.PRNGKey(0)), jvols, 6,
                                     key=jax.random.PRNGKey(1), lr_scale=scale)
        s, trace = tr.train_chunk(tr.init(0), _vols(tparts), 6, key=1,
                                  lr_scale=scale)
        np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), atol=TOL,
                                   rtol=0)
        for g, w in zip(_leaves_np(s.params), jax.tree.leaves(js.params)):
            np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)


def test_snapshot_and_merge_share_no_storage():
    tr = DVNRTrainer(CFG, 2, impl="ref", device="cpu")
    st = tr.init(0)
    snap = snapshot_state(st)
    ptrs = {x.data_ptr() for x in tree_leaves((st.params, st.opt))}
    assert not ptrs & {x.data_ptr() for x in tree_leaves((snap.params, snap.opt))}
    other = tr.init(1)
    m = merge_partitions(torch.tensor([True, False]), snap.params, other.params)
    assert not ({x.data_ptr() for x in tree_leaves(m)}
                & (ptrs | {x.data_ptr() for x in tree_leaves(other.params)}))
    assert torch.equal(m["tables"][0], st.params["tables"][0])
    assert torch.equal(m["tables"][1], other.params["tables"][1])


def _make_flaky(trainer, state_cls, finite_of, fail_calls: int, part: int = 1):
    """JAX's flaky-chunk stub: partition ``part`` reports non-finite for the
    first ``fail_calls`` chunks; every chunk's lr_scale is recorded."""
    real = trainer.train_chunk
    rec = {"calls": 0, "lr_scales": []}

    def fake(state, volumes, n_steps, *, key, lr_scale=1.0):
        i, rec["calls"] = rec["calls"], rec["calls"] + 1
        rec["lr_scales"].append(float(lr_scale))
        s2, trace = real(state, volumes, n_steps, key=key, lr_scale=lr_scale)
        finite = np.ones(trainer.P, bool)
        if i < fail_calls:
            finite[part] = False
        return state_cls(s2.params, s2.opt, s2.loss_ma, s2.active, s2.step,
                         finite_of(finite)), trace

    trainer.train_chunk = fake
    return rec


def _ladder(fail_calls, policy_kw):
    """The same stubbed ladder in both packages -> (port, JAX) results."""
    jparts = _jparts()
    tr = DVNRTrainer(CFG, 2, impl="ref", device="cpu")
    jtr = JaxDVNRTrainer(JCFG, 2, impl="ref")
    rec = _make_flaky(tr, DVNRState, torch.from_numpy, fail_calls)
    jrec = _make_flaky(jtr, JaxDVNRState, jnp.asarray, fail_calls)
    pre = tr.init(0)
    pre_p1 = [x[1].clone() for x in tree_leaves(pre.params)]
    out = train_with_recovery(tr, pre, _vols([_tpart(p) for p in jparts]),
                              steps=4, key=2, policy=RecoveryPolicy(**policy_kw))
    jout = jax_train_with_recovery(
        jtr, jtr.init(jax.random.PRNGKey(0)),
        jnp.stack([p.normalized() for p in jparts]), steps=4,
        key=jax.random.PRNGKey(2), policy=JaxRecoveryPolicy(**policy_kw))
    return out, rec, jout, jrec, pre_p1


def _events(r):
    return [{k: (tuple(int(p) for p in v) if isinstance(v, tuple) else v)
             for k, v in e.items()} for e in r["events"]]


@pytest.mark.parametrize("fail_calls,policy_kw,scales", [
    (1, {}, [1.0, 1.0]),                                  # rung 1: reseed
    (3, {"max_retries": 3, "lr_backoff": 0.5}, [1.0, 1.0, 1.0, 0.5]),
    (10**9, {"max_retries": 2}, [1.0, 1.0, 1.0])])       # exhausted: frozen
def test_ladder_records_jax_events(fail_calls, policy_kw, scales):
    (state, info), rec, (jstate, jinfo), jrec, pre_p1 = _ladder(fail_calls,
                                                               policy_kw)
    r, jr = info["recovery"], jinfo["recovery"]
    assert rec["lr_scales"] == jrec["lr_scales"] == scales
    assert _events(r) == _events(jr)
    for k in ("retries", "recovered_partitions", "frozen_partitions"):
        assert r[k] == jr[k], k
    assert state.active.tolist() == np.asarray(jstate.active).tolist()
    assert bool(state.finite.all())
    if r["frozen_partitions"]:
        assert r["frozen_partitions"] == (1,) and not bool(state.active[1])
        for got, want in zip(tree_leaves(state.params), pre_p1):
            assert torch.equal(got[1], want)         # held at the pre-chunk params
    for g, w in zip(_leaves_np(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)


def test_ladder_raises_when_freezing_disabled():
    tr = DVNRTrainer(CFG, 2, impl="ref", device="cpu")
    _make_flaky(tr, DVNRState, torch.from_numpy, 10**9)
    with pytest.raises(NonFiniteTrainingError, match="stayed non-finite"):
        train_with_recovery(
            tr, tr.init(0), _vols([_tpart(p) for p in _jparts()]), steps=4,
            key=2, policy=RecoveryPolicy(max_retries=1, freeze_on_failure=False))


# --------------------------------------------------------------------------- #
# api.train(recovery=)
# --------------------------------------------------------------------------- #
def test_api_train_recovery_keeps_the_healthy_partition():
    """A NaN partition under recovery: the run ends finite, the partition is
    frozen after the ladder, and the healthy partition is bit for bit the
    port's clean run and within 1e-5 of JAX's recovered run."""
    jparts = _jparts()
    tparts = [_tpart(p) for p in jparts]
    clean, _ = api.train(tparts, CFG, backend="ref", key=3)
    model, info = api.train([tparts[0], _all_nan(tparts[1])], CFG,
                            backend="ref", key=3,
                            recovery=RecoveryPolicy(max_retries=2))
    jmodel, jinfo = japi.train([jparts[0], _jax_all_nan(jparts[1])], JCFG,
                               backend="ref", key=jax.random.PRNGKey(3),
                               recovery=JaxRecoveryPolicy(max_retries=2))
    r = info["recovery"]
    assert r["retries"] == jinfo["recovery"]["retries"] == 2
    assert r["frozen_partitions"] == (1,)
    assert _events(r) == _events(jinfo["recovery"])
    for got, want, jw in zip(tree_leaves(model.params), tree_leaves(clean.params),
                             jax.tree.leaves(jmodel.params)):
        assert torch.isfinite(got).all()
        assert torch.equal(got[0], want[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), atol=TOL, rtol=0)


def test_recovery_is_a_noop_on_a_clean_run():
    tparts = [_tpart(p) for p in _jparts()]
    plain, _ = api.train(tparts, CFG, backend="cuda", key=4)
    guarded, info = api.train(tparts, CFG, backend="cuda", key=4,
                              recovery=RecoveryPolicy())
    assert info["recovery"]["retries"] == 0 and info["recovery"]["events"] == []
    for a, b in zip(tree_leaves(plain.params), tree_leaves(guarded.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the in situ session
# --------------------------------------------------------------------------- #
def _acceptance_health():
    plan = FaultPlan(11, [
        FaultSpec("nan_field", cycle=3, partition=1, magnitude=1.0),
        FaultSpec("drop_partition", cycle=7, partition=0),
        FaultSpec("corrupt_blob", cycle=11, partition=0, magnitude=0.02),
        FaultSpec("slow_tick", cycle=15, latency_s=9.0),
        FaultSpec("kernel_exception", cycle=18),
    ])
    sess = InSituSession(SIM, CFG, impl="ref", device="cpu", window=4,
                         fault_plan=plan, deadline_s=1.0,
                         deadline_clock="injected",
                         recovery=RecoveryPolicy(max_retries=1))
    assert len(sess.run(20)) == 20
    return sess.health()


def test_acceptance_session_health_equals_jax_pinned_values():
    """The values tests/test_resilience.py pins for the JAX session."""
    h = _acceptance_health()
    assert h["cycles"] == 20
    assert h["retry_cycles"] == (3,)
    assert dict(h["degraded"]) == {3: (1,), 7: (0,)}
    assert h["blob_repair_cycles"] == (11,)
    assert h["blob_repairs"] == 1
    assert h["deadline_missed"] == (15,)
    assert h["fallbacks"] == (15, 18)
    assert h["trained"] == 18
    assert _acceptance_health() == h


def test_kernel_fault_on_first_tick_raises_without_fallback():
    plan = FaultPlan(0, [FaultSpec("kernel_exception", cycle=1)])
    sess = InSituSession(SIM, CFG, impl="ref", device="cpu", window=2,
                         fault_plan=plan)
    with pytest.raises(InjectedKernelFault):
        sess.run(1)


def test_fault_free_resilient_session_reports_clean_health():
    sess = InSituSession(SIM, CFG, impl="ref", device="cpu", window=2,
                         recovery=RecoveryPolicy(), deadline_s=60.0)
    sess.run(2)
    h = sess.health()
    assert h["cycles"] == 2 and h["trained"] == 2
    assert h["retries"] == 0 and h["degraded"] == {}
    assert h["deadline_missed"] == () and h["fallbacks"] == ()
