"""Import boundary: the port, its tools (``tools/torch_*.py``) and scripts
(``scripts/torch_*.py``), the checkpoint writer the card runs
(``tests/torch_tf1_bundle.py``) and chip_smoke.py never import JAX, flax,
the JAX package or TensorFlow, so they run on a machine that has none of
them."""

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
            + sorted((ROOT / "scripts").glob("torch_*.py"))
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


# The port test modules that run no torch compute, each with its reason;
# every other tests/test_torch_*.py takes tests/torch_threads.py's fixture
# (one intra-op thread: under xdist the pools' barriers stall).
NO_TORCH_COMPUTE = {
    "test_torch_imports.py": "reads files, imports the port in a subprocess",
    "test_torch_config.py": "the config dataclasses and the precision table",
    "test_torch_native.py": "the feature loader, which reads into NumPy",
    "test_torch_api_parity.py": "data, label and io helpers in NumPy",
    "test_torch_data.py": "the data pipeline and metrics, in NumPy",
}
# where a module may take the fixture from: its home and the two modules
# that re-export it to their users
THREAD_FIXTURE_FROM = ("torch_threads", "torch_train_helpers", "test_torch_parallel")


def _takes_thread_fixture(path: Path, sources=THREAD_FIXTURE_FROM) -> bool:
    return any(isinstance(node, ast.ImportFrom) and node.module in sources
               and any(a.name == "one_torch_thread" for a in node.names)
               for node in ast.parse(path.read_text()).body)


def test_every_port_test_module_runs_one_torch_thread():
    tests = ROOT / "tests"
    tree = ast.parse((tests / "torch_threads.py").read_text())
    imported = ({a.name for n in tree.body if isinstance(n, ast.Import) for a in n.names}
                | {n.module for n in tree.body if isinstance(n, ast.ImportFrom)})
    assert imported == {"__future__", "pytest", "torch"}, imported
    fixture, = [n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "one_torch_thread"]
    call, = fixture.decorator_list
    assert ast.unparse(call.func) == "pytest.fixture"
    assert {k.arg: ast.literal_eval(k.value) for k in call.keywords} == {
        "scope": "module", "autouse": True}
    for relay in ("torch_train_helpers.py", "test_torch_parallel.py"):
        assert _takes_thread_fixture(tests / relay, ("torch_threads",)), relay
    modules = sorted(tests.glob("test_torch_*.py"))
    assert set(NO_TORCH_COMPUTE) <= {p.name for p in modules}
    missing = [p.name for p in modules
               if p.name not in NO_TORCH_COMPUTE and not _takes_thread_fixture(p)]
    assert not missing, f"take tests/torch_threads.py's fixture: {missing}"
    for name in NO_TORCH_COMPUTE:
        tree = ast.parse((tests / name).read_text())
        assert not any(isinstance(n, ast.Import) and any(a.name == "torch" for a in n.names)
                       for n in tree.body), f"{name} imports torch"
