"""repro_torch foundations against the JAX package: DVNRConfig presets,
the precision policy, the backend registry, and the rule that the entry
points run on the GPU (``"auto"`` raises without one)."""
import dataclasses

import pytest
import torch

from repro import backends as jbackends
from repro import precision as jprecision
from repro.configs import dvnr as jdvnr
from repro_torch import api, backends, precision
from repro_torch.configs import dvnr


def _presets(module):
    return {k: v for k, v in vars(module).items()
            if isinstance(v, module.DVNRConfig)}


def test_every_preset_equals_jax():
    jp, tp = _presets(jdvnr), _presets(dvnr)
    assert set(jp) == set(tp)
    for name in jp:
        assert dataclasses.asdict(tp[name]) == dataclasses.asdict(jp[name]), name


@pytest.mark.parametrize("name", sorted(_presets(jdvnr)))
def test_preset_derived_shapes_equal_jax(name):
    j, t = getattr(jdvnr, name), getattr(dvnr, name)
    assert t.resolved_base_resolution == j.resolved_base_resolution
    assert t.table_size == j.table_size
    assert t.level_resolutions() == j.level_resolutions()
    assert t.replace(n_levels=3) == dvnr.DVNRConfig(
        **dataclasses.asdict(j.replace(n_levels=3)))


@pytest.mark.parametrize("policy", [None, "f32", "bf16", "mixed", "bf16_out",
                                    "bf16/f32/f32", "f16/bf16/f32"])
def test_precision_policy_equals_jax(policy):
    j, t = jprecision.resolve_precision(policy), precision.resolve_precision(policy)
    assert (t.param_dtype, t.compute_dtype, t.output_dtype, t.master_dtype) == \
        (j.param_dtype, j.compute_dtype, j.output_dtype, j.master_dtype)
    assert t.name == j.name
    assert precision.resolve_precision(t.name) == t
    assert t.compute_torch == getattr(torch, t.compute_dtype)


def test_precision_rejects_unknown():
    with pytest.raises(ValueError):
        precision.resolve_precision("f8")
    with pytest.raises(ValueError):
        precision.resolve_precision("bf16/f32")


def test_registry_op_names_equal_jax():
    assert backends.OPS == jbackends.OPS
    ref, cuda = backends.resolve("ref"), backends.resolve("cuda")
    assert cuda.priority > ref.priority and cuda.is_cuda and not ref.is_cuda
    assert backends.PORTED_OPS <= set(backends.OPS)
    assert all(b.supports(op) for b in (ref, cuda) for op in backends.PORTED_OPS)
    with pytest.raises(ValueError):
        backends.resolve("pallas")
    with pytest.raises(ValueError):
        cuda.require_dtype("float16")
    assert ref.require_dtype("bf16") == torch.bfloat16


def test_auto_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.resolve("auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.resolve_device("auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.DVNRModel.init(dvnr.SMOKE, 0, device="auto")
    assert backends.available_backends() == ()
    # the CPU runs only when the caller asks for it
    m = api.DVNRModel.init(dvnr.SMOKE, 0, device="cpu")
    assert m.device.type == "cpu"
