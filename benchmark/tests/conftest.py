"""Shared pieces of the benchmark's tests: the repository on ``sys.path``,
the ``card`` marker (tests that need a CUDA device skip without one, decided
inside the test), one torch thread, and the cells at a tiny size."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_spec(spec: dict) -> dict:
    """A configuration file cut to a CPU test's size (widths included)."""
    spec = json.loads(json.dumps(spec))
    m = spec["config"]["model"]
    m.update(vdim=32, dim=16, num_heads=2, word_dim=12, char_dim=6,
             max_vlen=8 if m["max_vlen"] <= 64 else 10)
    spec["config"]["train"].update(eval_batch_size=8, infer_batch_size=8)
    spec["data"].update(splits={"train": [40, 12], "test": [20, 6]}, raw_clips=[4, 14],
                        query_words=[2, 5], glove_words=30)
    return spec


@pytest.fixture
def tiny_bench(tmp_path):
    """BENCHMARK.json with every configuration file cut to :func:`tiny_spec`."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(tiny_spec(json.loads((ROOT / c["file"]).read_text()))))
        c["file"] = str(path)
    return bench
