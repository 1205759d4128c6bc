"""repro_torch.reactive against repro.reactive: ``fold_in`` (the tick and
retry keys) bit for bit with ``jax.random.fold_in``, the lazy graph's
evaluation counts, triggers and windows against JAX's graph on the same
feeds, and the DVNR node: lazy, weight-cached (its second tick starts warm
from the first tick's params), a window of models rather than grids, and
its models within the trainer tests' tolerance (1e-5 absolute) of JAX's
node on the same partitions (SMOKE, the CPU)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import dvnr as jdvnr
from repro.data.volume import make_partition as jmake_partition
from repro.reactive import Runtime as JaxRuntime
from repro.reactive import dvnr_node as jax_dvnr_node
from repro_torch.configs import dvnr
from repro_torch.core.sampling import fold_in
from repro_torch.data.volume import VolumePartition
from repro_torch.optim.adamw import tree_leaves
from repro_torch.reactive import DVNRValue, Runtime, dvnr_node
from repro_torch.reactive import dvnr as dvnr_mod

TOL = 1e-5
CFG = dvnr.SMOKE.replace(epochs=1, n_train_min=2, batch_size=128)
JCFG = jdvnr.SMOKE.replace(epochs=1, n_train_min=2, batch_size=128)


def _jparts(t=0.1, n=2):
    return [jmake_partition("cloverleaf", p, (1, 1, 2), (8, 8, 8), t)
            for p in range(n)]


def _tparts(jparts):
    """The JAX partitions' data carried across as CPU tensors."""
    return [VolumePartition(torch.from_numpy(np.array(p.data)), p.origin,
                            p.extent, p.ghost, p.vmin, p.vmax) for p in jparts]


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 + 5])
def test_fold_in_matches_jax_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    for data in list(range(8)) + [1000004, 1000005, 1000006]:
        want = np.asarray(jax.random.fold_in(key, data)).astype(np.int64)
        got = fold_in(np.asarray(key), data)
        assert got.dtype == torch.int64 and got.tolist() == want.tolist()
        # a folded key folds again (the retry keys of a tick's key)
        want2 = np.asarray(jax.random.fold_in(jax.random.fold_in(key, data), 7))
        assert fold_in(got, 7).tolist() == want2.astype(np.int64).tolist()


def _graph(runtime_cls):
    """One graph: a never-pulled map, a pulled map, a rising-edge trigger, a
    window made live late; returns the per-tick observations."""
    rt = runtime_cls()
    s = rt.source("x")
    never = s.map(lambda v: v * 10, name="never")
    heavy = s.map(lambda v: v + 1, name="heavy")
    seen = []
    trig = rt.trigger("hot", s.map(lambda v: v > 2, name="cond"))
    trig.on_fire(lambda tick: seen.append(tick))
    w = heavy.window(3, name="win")
    obs = []
    for i, v in enumerate([0, 3, 4, 1, 5, 6, 0, 7, 8]):
        fired = rt.advance({"x": v})
        if i == 1:
            w.live = True
        pulled = heavy.value() if i % 2 else None
        obs.append((fired, pulled, list(w.buf)))
    return obs, rt.stats(), trig.fired_at, seen, never.evaluations, w.values()


def test_graph_matches_jax_laziness_triggers_and_windows():
    got, want = _graph(Runtime), _graph(JaxRuntime)
    assert got == want
    obs, stats, fired_at, seen, never_evals, win = got
    assert never_evals == 0                  # never pulled, never computed
    assert fired_at == seen == [1, 4, 7]     # rising edges only
    assert win == [1, 8, 9] and len(obs[-1][2]) == 3   # bounded, oldest evicted


def test_window_counts_tensor_bytes():
    rt = Runtime()
    s = rt.source("x")
    w = s.window(2)
    w.live = True
    for n in (3, 5, 7):
        rt.advance({"x": torch.zeros(n, dtype=torch.float64)})
    assert w.total_bytes == (5 + 7) * 8


def test_dvnr_node_lazy_weight_cached_and_warm(monkeypatch):
    calls = []
    real = dvnr_mod.api.train

    def spy(*a, **kw):
        calls.append(kw.get("cached_params"))
        return real(*a, **kw)

    monkeypatch.setattr(dvnr_mod.api, "train", spy)
    rt = Runtime()
    src = rt.source("field")
    node = dvnr_node(rt, src, CFG, field_name="field", n_partitions=2,
                     compress=True, impl="ref", device="cpu")
    rt.advance({"field": _tparts(_jparts(0.1))})
    assert node.evaluations == 0             # lazy: nothing pulled it
    val = node.value()
    assert node.evaluations == 1 and isinstance(val, DVNRValue)
    assert val.params["tables"].shape[0] == 2
    assert val.compressed is not None and val.bytes > 0
    assert len(val.parts_meta) == 2
    assert node.value() is val and node.evaluations == 1   # memoized in the tick
    rt.advance({"field": _tparts(_jparts(0.2))})
    val2 = node.value()
    assert node.evaluations == 2 and val2.steps >= 2
    # the first tick trained from a random init, the second from its params
    assert calls[0] is None
    for got, want in zip(tree_leaves(calls[1]), tree_leaves(val.params)):
        assert torch.equal(got, want)


def test_dvnr_window_holds_models_not_grids():
    rt = Runtime()
    src = rt.source("field")
    node = dvnr_node(rt, src, CFG, field_name="field", n_partitions=2,
                     impl="ref", device="cpu")
    w = node.window(2)
    w.live = True
    for i in range(4):
        rt.advance({"field": _tparts(_jparts(0.1 * i))})
    vals = w.values()
    assert len(vals) == 2 and all(isinstance(v, DVNRValue) for v in vals)
    raw_bytes = 2 * 10 * 10 * 10 * 4        # two 8^3+ghost partitions
    assert w.total_bytes == sum(v.bytes for v in vals) < raw_bytes * 4


def test_dvnr_node_models_match_jax():
    """Two ticks of both packages' DVNR nodes on the same partitions: the
    tick keys, the random init, the batches and the warm start are the same,
    so the models agree within the trainer tests' tolerance."""
    feeds = [_jparts(0.1), _jparts(0.15)]
    jrt, rt = JaxRuntime(), Runtime()
    jnode = jax_dvnr_node(jrt, jrt.source("f"), JCFG, field_name="f",
                          n_partitions=2, seed=7)
    node = dvnr_node(rt, rt.source("f"), CFG, field_name="f", n_partitions=2,
                     seed=7, impl="ref", device="cpu")
    for jp in feeds:
        jrt.advance({"f": jp})
        rt.advance({"f": _tparts(jp)})
        jv, tv = jnode.value(), node.value()
        assert tv.steps == jv.steps
        for got, want in zip(tree_leaves(tv.params), jax.tree.leaves(jv.params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                       rtol=0)
