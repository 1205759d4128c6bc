"""Guards of the port's boundaries: repro_torch and chip_smoke.py import
nothing of JAX or of the JAX package, and chip_smoke.py refuses to report a
result without a card or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_render_on_cpu_loads_no_jax():
    code = (
        "import sys\n"
        "from repro_torch import api\n"
        "from repro_torch.configs.dvnr import SMOKE\n"
        "from repro_torch.data.volume import make_partition\n"
        "parts = [make_partition('cloverleaf', p, (1, 1, 2), (6, 6, 6), device='cpu')"
        " for p in range(2)]\n"
        "m = api.DVNRModel.init(SMOKE, 0, n_partitions=2, parts_meta=parts,"
        " device='cpu')\n"
        "f = api.render(m, api.RenderRequest(width=8, height=8, n_samples=4),"
        " backend='cuda')\n"
        "assert f.shape == (8, 8, 4)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _run_smoke(script: Path, cwd: Path):
    env = _env()
    env.pop("PYTHONPATH")
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even on a GPU machine
    return subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""           # no result line at all
    assert "is_available() is false" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
