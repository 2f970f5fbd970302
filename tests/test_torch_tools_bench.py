"""The port's measurement tools (tools/torch_{bench_step_breakdown,
bench_train_batch,bench_bf16_train,bench_eval_batch,sweep_ablation,
bench_int8_table,real_assets_parity}.py) run end to end on the CPU at tiny
sizes through their ``main(argv)`` with ``--device cpu``.  Each result
holds the keys of the JAX tool's committed result (``results/*.json``; for
``bench_train_batch``, which has none, the keys its source writes), but
for those it names JAX-only under ``not_applicable``; the launch counts are
0 (the kernel wrappers take their plain versions on the CPU).  The FLOP
counter and the guard on a share of the peak, and the real-assets kit's
validation, staging, delta table and dry run (the cases of
tests/test_real_assets_parity.py, through the port's own copies), are held
here too.  The card's runs are ``chip_smoke.py``'s ``tools_charades``.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_bench_bf16_train  # noqa: E402
import torch_bench_eval_batch  # noqa: E402
import torch_bench_int8_table  # noqa: E402
import torch_bench_step_breakdown  # noqa: E402
import torch_bench_train_batch  # noqa: E402
import torch_real_assets_parity as rap  # noqa: E402
import torch_sweep_ablation  # noqa: E402
import torch_tool_common as common  # noqa: E402
from make_synthetic_data import make_dataset  # noqa: E402
from torch_train_helpers import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(dim=16, num_heads=2, attn_layer=1, char_dim=8)
DATA = dict(n=24, T=16, vdim=8)
NO_LAUNCHES = {"span_decode": 0, "fused_forward": 0, "fused_forward_bf16": 0}


@pytest.fixture
def narrow(monkeypatch):
    """The tools' data and widths narrowed to a few samples at D=16."""
    for tool in (torch_bench_train_batch, torch_bench_bf16_train,
                 torch_bench_eval_batch, torch_sweep_ablation, torch_bench_int8_table):
        data = {k: v for k, v in DATA.items() if k in tool.DATA}
        monkeypatch.setattr(tool, "DATA", data)
        monkeypatch.setattr(tool, "WIDTHS", TINY)
    monkeypatch.setattr(torch_bench_step_breakdown, "DATA",
                        dict(n=24, B=4, T=16, W=5, C=4, vdim=8))
    monkeypatch.setattr(torch_bench_step_breakdown, "WIDTHS", TINY)
    monkeypatch.setattr(torch_bench_int8_table, "PROBE", dict(T=4, vdim=8))
    monkeypatch.setattr(torch_bench_int8_table, "SWEEP_BATCH", 8)


def _run(tool, argv: list[str], out) -> dict:
    assert tool.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        res = json.load(f)
    assert res["launches"] == NO_LAUNCHES
    assert res["device"] == "cpu" and res["card"] is None
    return res


def _missing(jax, port, skip=frozenset(), where="") -> list[str]:
    """The keys of the JAX result ``jax`` that ``port`` lacks, nested dicts
    and the first row of each list of rows followed; keys in ``skip`` are
    JAX-only."""
    out = []
    for key, value in jax.items():
        if key in skip:
            continue
        if key not in port:
            out.append(where + key)
        elif isinstance(value, dict):
            out += _missing(value, port[key], skip, f"{where}{key}.")
        elif isinstance(value, list) and value and isinstance(value[0], dict):
            for row in port[key]:
                out += _missing(value[0], row, skip, f"{where}{key}[].")
    return out


def _jax_result(name: str) -> dict:
    with open(os.path.join(ROOT, "results", name)) as f:
        return json.load(f)


def _source_keys(tool: str) -> dict[str, set]:
    """The string keys a JAX tool's source writes into each dict it names:
    ``name = {...}`` literals and ``name["key"] = ...`` assignments."""
    with open(os.path.join(ROOT, "tools", tool)) as f:
        tree = ast.parse(f.read())
    keys: dict[str, set] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and isinstance(node.value, ast.Dict):
                keys.setdefault(target.id, set()).update(
                    k.value for k in node.value.keys if isinstance(k, ast.Constant))
            elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                  and isinstance(target.slice, ast.Constant)):
                keys.setdefault(target.value.id, set()).add(target.slice.value)
    return keys


def test_step_breakdown(tmp_path, narrow):
    res = _run(torch_bench_step_breakdown, ["--iters", "2", "--epoch-steps", "3"],
               tmp_path / "sb.json")
    jax = _jax_result("step_breakdown.json")
    assert set(res["not_applicable"]) == {k for k in jax if k.startswith("scan_step")}
    assert _missing(jax, res, set(res["not_applicable"])) == []
    for k in ("gather_labels_ms", "forward_ms", "fwd_bwd_ms", "eager_step_ms",
              "graphed_step_ms", "step_flops_g"):
        assert res[k] > 0, k
    # nothing is graphed on the CPU: each stage's time is its eager one
    assert res["graphed"] is False and res["B"] == 4
    for k in ("gather_labels", "forward", "fwd_bwd"):
        assert res[f"{k}_ms"] == res[f"eager_{k}_ms"]
    assert res["graphed_step_ms"] == pytest.approx(res["graphed_epoch_ms"] / 3)
    assert 0 < res["mfu"] < 1


def test_train_batch(tmp_path, narrow):
    res = _run(torch_bench_train_batch, ["--batches", "8", "16", "--iters", "1"],
               tmp_path / "tb.json")
    src = _source_keys("bench_train_batch.py")
    assert src["out"] <= set(res)
    assert [r["batch_size"] for r in res["rows"]] == [8, 16]
    for r in res["rows"]:
        assert src["row"] <= set(r)
        assert r["steps_per_epoch"] == 24 // r["batch_size"]
        assert r["step_ms"] == pytest.approx(r["epoch_ms"] / r["steps_per_epoch"])
        assert 0 < r["mfu"] < 1
    assert res["best"] in res["rows"]
    assert res["speedup_vs_b16"] == pytest.approx(
        res["best"]["pairs_per_sec"] / res["rows"][1]["pairs_per_sec"])


def test_bf16_train(tmp_path, narrow):
    res = _run(torch_bench_bf16_train, ["--batch", "8", "--iters", "1"],
               tmp_path / "bf16.json")
    assert _missing(_jax_result("bf16_train_bench.json"), res) == []
    assert [r["compute_dtype"] for r in res["rows"]] == ["float32", "bfloat16"]
    f32, bf16 = res["rows"]
    assert res["bf16_speedup"] == pytest.approx(bf16["pairs_per_sec"]
                                                / f32["pairs_per_sec"])
    # the same work, against each dtype's peak
    assert bf16["step_flops_g"] == f32["step_flops_g"] > 0
    assert bf16["mfu"] == pytest.approx(f32["mfu"] * f32["scanned_epoch_ms"]
                                        / bf16["scanned_epoch_ms"] * 67 / 989)


def test_eval_batch(tmp_path, narrow):
    res = _run(torch_bench_eval_batch,
               ["--batches", "4", "8", "--pairs", "16", "--iters", "1"],
               tmp_path / "eval.json")
    assert _missing(_jax_result("eval_batch_bench.json"), res) == []
    assert [(r["T"], r["batch_size"], r["n_batches"]) for r in res["grid"]] == [
        (64, 4, 4), (64, 8, 2), (100, 4, 4), (100, 8, 2)]
    assert set(res["best"]) == {"T64", "T100"}


def test_sweep_ablation(tmp_path, narrow):
    res = _run(torch_sweep_ablation, ["--batches", "8", "--pairs", "16",
                                      "--iters", "1"], tmp_path / "sweep.json")
    assert _missing(_jax_result("sweep_ablation.json"), res) == []
    assert [(r["sweep_backend"], r["fold_mc"], r["folded"]) for r in res["grid"]] == [
        ("flax", False, False), ("fused", False, False), ("flax", True, True)]
    assert list(res["not_applicable"]) == ["fold_mc with sweep_backend fused"]
    # the folded and sequential passes do the same work, up to the folded
    # forward's shared masks
    flops = [r["step_flops_g"] for r in res["grid"]]
    assert max(flops) == pytest.approx(min(flops), rel=1e-3)
    # a bf16 MC model never folds; --out-suffix names the file
    assert torch_sweep_ablation.main(
        ["--batches", "8", "--pairs", "16", "--iters", "1", "--folds", "1",
         "--mc-dtype", "bfloat16", "--out-suffix", "_bf16",
         "--device", "cpu", "--out", str(tmp_path / "s.json")]) == 0
    with open(tmp_path / "s_bf16.json") as f:
        (row,) = json.load(f)["grid"]
    assert (row["sweep_backend"], row["fold_mc"], row["folded"], row["mc_dtype"]) == (
        "flax", True, False, "bfloat16")


def test_int8_table(tmp_path, narrow):
    res = _run(torch_bench_int8_table, ["--rows", "4", "--batch", "8", "--iters", "1"],
               tmp_path / "int8.json")
    assert _missing(_jax_result("int8_table_bench.json"), res) == []
    probe = res["upload_probe"]
    assert probe["shape"] == [4, 4, 8] and set(probe["upload_s"]) == {
        "float32", "bfloat16", "int8"}
    assert all(v > 0 for v in probe["upload_s"].values())
    rows = res["gather_path"]["rows"]
    assert [r["table_dtype"] for r in rows] == ["float32", "int8"]
    assert res["gather_path"]["train_ratio_int8_vs_f32"] == pytest.approx(
        rows[1]["train_pairs_per_sec"] / rows[0]["train_pairs_per_sec"])


def test_count_flops_and_the_guard(tmp_path, narrow, monkeypatch):
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    assert common.count_flops(lambda: a @ b) == 2 * 3 * 5 * 7
    assert common.peak_share("ok", 67e12 * 0.5, 1.0, "float32") == pytest.approx(0.5)
    assert common.peak_share("ok", 989e12, 2.0, "bfloat16") == pytest.approx(0.5)
    with pytest.raises(SystemExit, match="over 1"):
        common.peak_share("x", 67e12 * 1.01, 1.0, "float32")
    with pytest.raises(SystemExit, match="over 1"):
        common.peak_share("x", 1.0, 0.0, "float32")
    # a tool whose timing implies more than the peak exits non-zero
    monkeypatch.setitem(common.PEAK_FLOPS, "float32", 1.0)
    with pytest.raises(SystemExit, match="over 1"):
        torch_bench_eval_batch.main(["--batches", "8", "--pairs", "8", "--iters", "1",
                                     "--device", "cpu", "--out",
                                     str(tmp_path / "e.json")])
    assert not os.path.exists(tmp_path / "e.json")


# -- the real-assets kit --------------------------------------------------------
@pytest.fixture(scope="module")
def synth_assets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rap_assets"))
    make_dataset(root, task="charades", n_train=48, n_test=16, vdim=16,
                 max_raw_len=24, seed=11)
    return os.path.join(root, "data")


def _assets(synth_assets):
    return (os.path.join(synth_assets, "features", "charades_i3d"),
            os.path.join(synth_assets, "glove", "glove.840B.300d.txt"))


def test_validate_assets_names_missing_downloads(synth_assets, tmp_path):
    feats, glove = _assets(synth_assets)
    with pytest.raises(FileNotFoundError, match="--gt-train"):
        rap.validate_assets("charades", feats, glove, str(tmp_path / "nodata"))
    with pytest.raises(FileNotFoundError) as e:
        rap.validate_assets("charades", str(tmp_path / "nope"),
                            str(tmp_path / "nope.txt"), synth_assets)
    assert "--features" in str(e.value) and "--glove" in str(e.value)
    bad = tmp_path / "bad_glove.txt"
    bad.write_text("not an embedding line\n")
    with pytest.raises(FileNotFoundError, match="does not look like"):
        rap.validate_assets("charades", feats, str(bad), synth_assets)
    resolved = rap.validate_assets("charades", feats, glove, synth_assets)
    assert resolved["n_feature_files"] > 0
    assert resolved["gt_train"].endswith("charades_gt/train.json")


def test_stage_root_layout_and_repointing(synth_assets, tmp_path):
    feats, glove = _assets(synth_assets)
    resolved = rap.validate_assets("charades", feats, glove, synth_assets)
    root = str(tmp_path / "staged")
    rap.stage_root(root, "charades", resolved)
    for rel in ("charades_gt/train.json", "charades_gt/test.json",
                "charades_re0/train.json", "charades_re0/test.json"):
        assert os.path.isfile(os.path.join(root, "data", rel)), rel
    link = os.path.join(root, "data", "glove", "glove.840B.300d.txt")
    assert os.path.islink(os.path.join(root, "data", "features", "charades_i3d"))
    assert os.path.islink(link)
    rap.stage_root(root, "charades", resolved)            # idempotent
    glove2 = str(tmp_path / "glove2.txt")
    shutil.copyfile(glove, glove2)
    rap.stage_root(root, "charades", dict(resolved, glove=glove2))
    assert os.readlink(link) == os.path.abspath(glove2)
    os.remove(link)
    os.symlink(str(tmp_path / "gone.txt"), link)          # a dangling link
    rap.stage_root(root, "charades", resolved)
    assert os.readlink(link) == os.path.abspath(glove)
    gt2 = str(tmp_path / "gt_train2.json")
    with open(gt2, "w") as f:
        f.write("[]")
    rap.stage_root(root, "charades", dict(resolved, gt_train=gt2))
    with open(os.path.join(root, "data", "charades_gt", "train.json")) as f:
        assert f.read() == "[]"


def _fake_summary():
    return {"re0_best": {"test_metrics": {"r1i5": 45.0, "r1i7": 27.0}},
            "rounds": [{"round": 1, "test": {"r1i5": 46.0, "r1i7": 28.0}},
                       {"round": 2, "test": {"r1i5": 47.0, "r1i7": 29.0}}]}


def _ref():
    return {"rounds": [{"round": 0, "r1i5": 45.2, "r1i7": 27.1},
                       {"round": 1, "r1i5": 45.8, "r1i7": 28.3},
                       {"round": 2, "r1i5": 47.0, "r1i7": 29.0}]}


def test_delta_table_math():
    ref = _ref()
    t = rap.delta_table(_fake_summary(), ref, bar=0.3)
    assert t["all_within_bar"] is True
    assert t["rounds"][0]["delta_r1i5"] == pytest.approx(-0.2)
    assert t["rounds"][1]["delta_r1i7"] == pytest.approx(-0.3)
    assert t["rounds"][2]["delta_r1i5"] == 0.0
    assert "| re0 |" in t["markdown"] and "yes" in t["markdown"]
    ref["rounds"][1]["r1i7"] = 28.5
    t = rap.delta_table(_fake_summary(), ref, bar=0.3)
    assert t["all_within_bar"] is False and t["rounds"][1]["within_bar"] is False
    assert "NO" in t["markdown"]
    t = rap.delta_table(_fake_summary(), None, bar=0.3)
    assert t["all_within_bar"] is None
    assert all(r["within_bar"] is None for r in t["rounds"])
    assert "pending" in t["markdown"]
    t = rap.delta_table(_fake_summary(), {"rounds": ref["rounds"][:2]}, bar=0.3)
    assert t["all_within_bar"] is None


@pytest.mark.parametrize("empty", [{}, None])
def test_delta_table_tolerates_missing_own_metrics(empty):
    s = _fake_summary()
    s["re0_best"]["test_metrics"] = empty
    t = rap.delta_table(s, _ref(), bar=0.3)
    assert t["rounds"][0]["within_bar"] is None and t["rounds"][0]["ours_r1i5"] is None
    assert t["all_within_bar"] is None and "pending" in t["markdown"]
    assert t["rounds"][1]["delta_r1i7"] == pytest.approx(-0.3)
    s = _fake_summary()
    s["rounds"][1]["test"] = empty
    t = rap.delta_table(s, _ref(), bar=0.3)
    assert t["rounds"][2]["within_bar"] is None and t["all_within_bar"] is None


def test_real_assets_dry_run_end_to_end(tmp_path, monkeypatch, capsys):
    """The kit on synthetic assets through ``main``: stage, the loop on the
    CPU (1 epoch, re0 + 1 round, the D=16 model), the report; then the same
    summary against a reference equal to it passes."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "report.json"
    assert rap.main(["--dry-run", "--device", "cpu", "--root", str(tmp_path / "kit"),
                     "--n-train", "32", "--n-test", "16", "--epochs", "1",
                     "--out", str(out)]) == 0
    assert os.getcwd() == str(tmp_path)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"launches"')]
    with open(out) as f:
        report = json.load(f)
    assert printed == [{"launches": report["launches"]}]
    assert report["launches"] == NO_LAUNCHES
    assert report["dry_run"] is True and report["card"] is None
    assert report["loop_summary"]["sweep_backend"] == "fused"
    rounds = report["table"]["rounds"]
    assert [r["round"] for r in rounds] == [0, 1]
    assert report["table"]["all_within_bar"] is None
    for r in rounds:
        assert np.isfinite(r["ours_r1i5"]) and np.isfinite(r["ours_r1i7"])
    assert report["loop_summary"]["rounds"][0]["pseudo_miou"] > 0
    ref = {"rounds": [{"round": r["round"], "r1i5": r["ours_r1i5"],
                       "r1i7": r["ours_r1i7"]} for r in rounds]}
    assert rap.delta_table(report["loop_summary"], ref)["all_within_bar"] is True


def test_real_assets_needs_its_assets(tmp_path):
    with pytest.raises(SystemExit):
        rap.main(["--device", "cpu", "--root", str(tmp_path / "r")])
