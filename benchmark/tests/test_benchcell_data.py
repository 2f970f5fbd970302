"""BENCHMARK.json against the contract's shape, and every cell,
configuration, traffic mix and metric found by name in its own files."""

import json
import re

import numpy as np
import torch

from benchmark import data, harness

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"], BENCH)
        e2e = {m["name"] for m in cell.metrics(False)}
        layers = cell.metrics(True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        assert all(m["moves"] in e2e for m in layers)
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_cells_configurations_and_metrics_are_found_by_name():
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"], BENCH)
        assert cell.spec["name"] == w["config"]
        assert hasattr(cell.entry, "Entry")
        assert set(cell.limits) and all(np.isfinite(v) for v in cell.limits.values())
    for c in BENCH["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["source"] == c["source"] and spec["reduced"] == c["reduced"]
        assert (ROOT / "benchmark" / spec["reference"]).exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.reader_path(m["name"]).exists(), m["name"]


def test_the_same_seed_gives_the_same_inputs(tiny_bench):
    spec = harness.Cell("charades.al_sweep", tiny_bench).spec
    cpu = torch.device("cpu")
    a, b = data.make_inputs(spec, 2**31 + 7, cpu), data.make_inputs(spec, 2**31 + 7, cpu)
    c = data.make_inputs(spec, 8, cpu)
    assert torch.equal(a.table, b.table) and not torch.equal(a.table, c.table)
    assert a.dataset["train_set"] == b.dataset["train_set"]
    fa, _ = data.make_weights(spec, 11, cpu)
    fb, _ = data.make_weights(spec, 11, cpu)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_inputs_match_the_records():
    """The device columns the reference reads are the records the port reads."""
    from conftest import tiny_spec
    spec = tiny_spec(json.loads((ROOT / "benchmark/configs/seqpan-anet.json").read_text()))
    inp = data.make_inputs(spec, 3, torch.device("cpu"))
    split, recs = inp.splits["test"], inp.dataset["test_set"]
    T = spec["config"]["model"]["max_vlen"]
    for i, r in enumerate(recs):
        assert inp.store.vid_index[r["vid"]] == int(split.feat_rows[i])
        assert r["w_ids"] == [w for w in split.word_ids[i].tolist() if w]
        assert 0 <= r["s_ind"] <= r["e_ind"] < r["v_len"] <= T
        assert float(inp.table[split.feat_rows[i], r["v_len"]:].abs().sum()) == 0.0
