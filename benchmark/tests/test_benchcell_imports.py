"""The import boundary: nothing the benchmark runs imports ``jax``,
``jaxlib``, ``flax`` or ``hual_tpu`` (top-level names compared whole, so
``hual_tpu_torch`` passes), and the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "hual_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


RUN_FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", RUN_FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "hual_tpu_torch" not in set(_imports(path))


def test_whole_names_are_compared():
    from benchmark import harness
    sys.modules.setdefault("hual_tpu_torch", __import__("hual_tpu_torch"))
    assert "hual_tpu_torch" not in harness.forbidden_modules()


def test_run_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for n in ('jax', 'jaxlib', 'flax', 'hual_tpu'):\n"
            "    sys.modules[n] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark import harness, calibrate\n"
            "import json\n"
            "bench = json.load(open(harness.ROOT / 'BENCHMARK.json'))\n"
            "for w in bench['workloads']:\n"
            "    harness.Cell(w['name'], bench)\n"
            "for m in bench['end_to_end'] + bench['per_layer']:\n"
            "    harness._load_module(harness.reader_path(m['name']), 'm')\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hual_tpu') and sys.modules[k] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
