"""Import boundary: the port, its tools (``tools/torch_*.py``), the
checkpoint writer the card runs (``tests/torch_tf1_bundle.py``) and
chip_smoke.py never import JAX, flax, the JAX package or TensorFlow, so
they run on a machine that has none of them."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "hual_tpu", "tensorflow")


def _port_files() -> list[Path]:
    return (sorted((ROOT / "hual_tpu_torch").rglob("*.py"))
            + sorted((ROOT / "tools").glob("torch_*.py"))
            + [ROOT / "tests" / "torch_tf1_bundle.py", ROOT / "chip_smoke.py"])


def _forbidden(module: str) -> bool:
    # "hual_tpu_torch" shares a prefix with "hual_tpu" and is allowed
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_forbidden_prefix_rule():
    assert _forbidden("hual_tpu.serve") and _forbidden("jax.numpy")
    assert _forbidden("tensorflow.compat.v1")
    assert not _forbidden("hual_tpu_torch.serve")


def test_serve_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'hual_tpu', 'tensorflow'):\n"
        "    sys.modules[name] = None\n"
        "import hual_tpu_torch.serve, chip_smoke\n"
        "import hual_tpu_torch.utils.tf1_port\n"
        "import hual_tpu_torch.runtime.trainer\n"
        "import hual_tpu_torch.ops.kernels.fused_forward\n"
        "import hual_tpu_torch.orchestrate, hual_tpu_torch.cli\n"
        "import hual_tpu_torch.parallel\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'hual_tpu', 'tensorflow') "
        "and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
