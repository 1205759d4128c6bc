"""The port's dry-run cells (``repro_torch.launch.cells``,
``repro_torch.core.dryrun_cells``, ``python -m repro_torch.launch.dryrun``)
against the JAX package's (``repro.launch.cells``,
``repro.core.dryrun_cells``).

- every applicable (arch, shape) cell's meta equals JAX's: params, active
  params, model FLOPs, tokens, and the decode cache's bytes against
  ``jax.eval_shape(model.init_cache)`` (nothing compiled, nothing
  allocated);
- the DVNR model FLOPs equal JAX's for PRODUCTION and SMOKE at P = 8, 256;
- the DVNR cells on rank 0 of a fake (2, 2) mesh: no collective in
  training; 2 permute rounds and 1 all-gather in rendering, whose wire
  bytes equal ``analyze_hlo`` of JAX's render cell on 4 host devices
  (one subprocess, ``tests/torch_dryrun_cases.py dvnr``);
- a dense SMOKE train cell on each rank of a fake (2, 2) mesh: the
  products' FLOPs summed over the ranks equal a closed form within 1%;
- ``measure`` counts no memory or work on the meta device (the shapes
  ``Model.param_specs`` makes inside a rank's run);
- the CLI's ``--dvnr`` and one ``--arch/--shape`` records.

Cost: ~35 s serial (the two subprocess cases ~9 s each, the CLI ~12 s,
the meta of 33 cells ~3 s).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.configs.dvnr import PRODUCTION as JPRODUCTION, SMOKE as JSMOKE
from repro.core import dryrun_cells as jcells
from repro.launch import cells as jlaunch
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_applicable, get_config
from repro_torch.configs.dvnr import PRODUCTION, SMOKE
from repro_torch.core import dryrun_cells as tcells
from repro_torch.launch.cells import cell_meta, measure
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
CASES = ROOT / "tests" / "torch_dryrun_cases.py"
APPLICABLE = [(a, s) for a in ARCH_IDS for s in SHAPES if cell_is_applicable(a, s)[0]]


def _case(name: str, **env) -> dict:
    out = subprocess.run([sys.executable, str(CASES), name], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", **env})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_applicable_cell_is_counted():
    assert len(APPLICABLE) == 33


@pytest.mark.parametrize("arch,shape", APPLICABLE, ids=lambda x: x)
def test_cell_meta_equals_jax(arch, shape):
    sc = SHAPES[shape]
    with FakeTensorMode():
        meta = cell_meta(build_model(get_config(arch)), sc, 256, arch=arch,
                         shape_name=shape)
    jcfg = jax_get_config(arch)
    assert meta["params"] == jcfg.param_count()
    assert meta["active_params"] == jcfg.active_param_count()
    assert meta["model_flops_global"] == jlaunch.model_flops(jcfg, sc)
    assert meta["tokens_global"] == sc.global_batch * sc.seq_len
    if sc.kind == "decode":
        jm = jax_build_model(jcfg)
        cache = jax.eval_shape(lambda: jm.init_cache(sc.global_batch, sc.seq_len))
        assert meta["cache_bytes_global"] == sum(
            s.size * s.dtype.itemsize for s in jax.tree.leaves(cache))


@pytest.mark.parametrize("P", [8, 256])
@pytest.mark.parametrize("name", ["PRODUCTION", "SMOKE"])
def test_dvnr_model_flops_equal_jax(name, P):
    tcfg, jcfg = {"PRODUCTION": (PRODUCTION, JPRODUCTION),
                  "SMOKE": (SMOKE, JSMOKE)}[name]
    assert tcells.model_flops_train(tcfg, P) == jcells.model_flops_train(jcfg, P)
    R, S = tcells.FRAME_W * tcells.FRAME_H, tcells.N_SAMPLES
    assert tcells.model_flops_render(tcfg, P, R, S) == \
        jcells.model_flops_render(jcfg, P, R, S)


@pytest.fixture(scope="module")
def dvnr():
    return _case("dvnr", XLA_FLAGS="--xla_force_host_platform_device_count=4")


def test_dvnr_train_cell_sends_nothing(dvnr):
    assert dvnr["train"]["calls"] == {} and dvnr["train"]["wire"] == 0


def test_dvnr_render_cell_rounds_and_wire_bytes_equal_jax(dvnr):
    assert dvnr["render"]["calls"] == {"collective-permute": 2, "all-gather": 1}
    assert dvnr["render"]["wire"] > 0
    assert dvnr["render"]["wire"] == dvnr["jax_render"]["wire"]
    assert dvnr["render"]["breakdown"] == dvnr["jax_render"]["breakdown"]


def test_dense_cell_flops_summed_over_ranks_match_the_closed_form():
    import torch_dryrun_cases as C
    from repro_torch.configs import get_smoke_config
    ranks = _case("dense")["ranks"]
    cfg = get_smoke_config(C.DENSE_ARCH)
    _, _, S, B = C.DENSE_SHAPE
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv, ff = cfg.n_heads * dh, cfg.n_kv_heads * dh, cfg.d_ff
    # the matmul weights: q, k, v, o; SwiGLU's wi, wg, wo; the head
    n_mm = cfg.n_layers * (d * (2 * hq + 2 * hkv) + 3 * d * ff) + d * cfg.vocab
    # QK^T and PV, forward 2 x 2*B*H*S^2*dh, backward twice that
    attn = cfg.n_layers * 12 * B * cfg.n_heads * S * S * dh
    want = 6 * n_mm * B * S + attn
    got = sum(r["flops"] for r in ranks)
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_measure_counts_no_memory_or_work_on_the_meta_device():
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(1024)

    def fn(x):
        torch.empty(2 ** 40, device="meta").add_(1)   # what param_specs() makes
        return x * 2

    _, an, mem = measure(fn, (x,), mode)
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["output_bytes"] == 8192
    assert an.op_bytes == 8192 and an.n_ops == 3


def test_cli_records(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for argv in (["--dvnr"], ["--arch", "qwen2_0_5b", "--shape", "decode_32k"]):
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                              *argv, "--out", str(tmp_path)], capture_output=True,
                             text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr[-3000:]
    keys = {"memory_analysis", "cost_analysis", "counted_flops_per_device",
            "op_bytes_per_device", "collective_wire_bytes_per_device",
            "collective_breakdown", "roofline", "model_flops_global",
            "model_flops_per_device", "useful_flops_ratio", "params",
            "active_params"}
    for name in ("dvnr__train", "dvnr__render", "qwen2_0_5b__decode_32k"):
        rec = json.loads((tmp_path / "single" / f"{name}.json").read_text())
        assert rec["status"] == "ok" and keys <= set(rec), name
        assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                               "temp_bytes", "peak_bytes",
                                               "alias_bytes"}
        assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                        "dominant", "step_time_s",
                                        "roofline_fraction"}
        assert rec["memory_analysis"]["peak_bytes"] >= \
            rec["memory_analysis"]["argument_bytes"] > 0
    train = json.loads((tmp_path / "single" / "dvnr__train.json").read_text())
    render = json.loads((tmp_path / "single" / "dvnr__render.json").read_text())
    assert train["zero_communication"] and train["collective_calls"] == {}
    assert render["collective_calls"] == {"collective-permute": 8, "all-gather": 1}
