"""``python -m repro_torch.analysis lock`` (``repro_torch.analysis.lock``):
the committed lock (``src/repro_torch/analysis/lock.json``) verifies on
the CPU, a planted fault drifts with the field's diff line and exit 1, a
missing or malformed lock file exits 2, and two derivations are equal.

The whole matrix is derived once for the module (the CLI's verify of the
committed file reads that derivation); the planted fault and the second
derivation each re-derive ``quickstart`` only.

Cost: ~30 s serial (the matrix ~20 s, quickstart twice ~5 s each), on
one intra-op thread (``one_thread``).
"""
import pytest
import torch

from repro_torch.analysis import lock as L
from repro_torch.analysis.__main__ import main
from repro_torch.core.trainer import DVNRTrainer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs. A derivation is ~60,000
    small ops under a dispatch mode; on a machine whose cores are all busy
    (pytest-xdist workers on each of them) every op's thread barrier waits
    for descheduled threads: six derivations at once on eight cores took
    12.7 s each on one thread and 475 s each on eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def derived():
    return L.compute_lock(device="cpu")


def _planted_rng():
    """A ``DVNRTrainer._mask_convergence`` that also draws from torch's RNG
    (``tests/test_torch_analysis.py``'s ``_planted("rng")``)."""
    import torch
    orig = DVNRTrainer._mask_convergence

    def mask(self, loss, loss_ma, active):
        torch.rand(1)
        return orig(self, loss, loss_ma, active)

    return mask


def test_verify_exits_0_on_the_committed_lock(derived, monkeypatch, capsys):
    assert L.diff_locks(L.read_lock(), derived) == []
    monkeypatch.setattr(L, "compute_lock", lambda *a, **k: derived)
    assert main(["lock", "verify", "--device", "cpu"]) == 0
    assert "analysis lock verified" in capsys.readouterr().out


def test_planted_fault_drifts_with_the_fields_diff(monkeypatch, capsys):
    monkeypatch.setattr(DVNRTrainer, "_mask_convergence", _planted_rng())
    assert main(["lock", "verify", "--device", "cpu", "--config", "quickstart",
                 "--backend", "cuda"]) == 1
    out = capsys.readouterr().out
    assert "quickstart/cuda/train_chunk :: rng_gather_placement.status: " \
           "lock=pass current=fail" in out
    assert "smoke/" not in out and "/ref/" not in out


def test_missing_or_malformed_lock_exits_2(tmp_path):
    assert main(["lock", "verify", "--path", str(tmp_path / "none.json")]) == 2
    for i, text in enumerate(("{", '{"version": 1}', '{"entries": {}, "matrix": 3}')):
        p = tmp_path / f"bad{i}.json"
        p.write_text(text)
        assert main(["lock", "verify", "--path", str(p), "--device", "cpu"]) == 2


def test_two_derivations_are_equal(derived):
    again = L.compute_lock(configs=["quickstart"], device="cpu")
    mine = {k: v for k, v in derived["entries"].items() if k.startswith("quickstart/")}
    assert again["entries"] == mine and len(mine) == 12


def test_write_then_verify_round_trips(derived, tmp_path, monkeypatch):
    monkeypatch.setattr(L, "compute_lock", lambda *a, **k: derived)
    p = tmp_path / "lock.json"
    assert main(["lock", "write", "--path", str(p), "--device", "cpu"]) == 0
    assert p.read_text() == L.dump_lock(derived)
    assert main(["lock", "verify", "--path", str(p), "--device", "cpu"]) == 0
