"""The port's AL-quality tools (tools/torch_{synthetic_quality_comparison,
strategy_ablation_loop,mc_comparison}.py) and scripts/torch_viga_extend_label.py
against their JAX-package counterparts on the same inputs, on the CPU at
tiny sizes (``--device cpu``; SeqPAN's widths narrowed through
``torch_full_loop_demo.MODEL``).  The JAX tools import JAX only inside
``main``, so their functions are called here directly; the envelope and
spread rows, which the JAX tool computes inline, are held against the
numbers it committed in results/synthetic_quality_comparison.json.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import mc_comparison  # noqa: E402
import synthetic_quality_comparison  # noqa: E402
import torch_full_loop_demo  # noqa: E402
import torch_mc_comparison  # noqa: E402
import torch_strategy_ablation_loop  # noqa: E402
import torch_synthetic_quality_comparison as quality  # noqa: E402
from torch_train_helpers import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vdim=16, dim=16, num_heads=2, attn_layer=1, char_dim=8, max_tlen=10,
            word_dim=300)
# the JAX artifact's sections (results/synthetic_quality_comparison.json)
JAX_SECTIONS = {"workload", "contract", "reference", "reference_wall_min", "ours",
                "comparison", "ref_inside_envelope_all_rounds", "label_quality",
                "reference_spread", "spread_comparison"}


@pytest.fixture
def recorded():
    with open(quality.RECORDED) as f:
        return json.load(f)


@pytest.fixture
def tiny_model(monkeypatch):
    monkeypatch.setattr(torch_full_loop_demo, "MODEL", dict(TINY))


def _log(tmp_path, pairs) -> str:
    """A reference schedule log with one update_label block per round."""
    path = tmp_path / "reference_schedule.log"
    blocks = [f"===== update_label re{i + 1}: =====\nrenew done\n"
              f"mIoU[GT, pseudo]:\n{old} -> {new}\n" for i, (old, new) in enumerate(pairs)]
    path.write_text("===== train re0: =====\n" + "".join(blocks))
    return str(path)


def test_label_quality_matches_jax(tmp_path, recorded):
    """The port's label-quality rows on the reference rounds that the JAX
    tool harvests from a crafted log, against the JAX tool's section on the
    same log and the same ``run_loop`` summaries; then the committed
    reference side, read back as the tool reads it."""
    log = _log(tmp_path, [(0.5565, 0.5801), (0.5801, 0.597), (0.597, 0.6123)])
    summaries = [
        (12345, {"rounds": [{"pseudo_miou": 0.5793016636677303},
                            {"pseudo_miou": 0.599579712767777}]}),
        (777, {"rounds": [{"pseudo_miou": 0.58380533}]}),
        (20260820, {"rounds": []})]
    got = quality.label_quality_rows(
        synthetic_quality_comparison.harvest_ref_label_miou(log), copy.deepcopy(summaries))
    want = synthetic_quality_comparison.label_quality_section(log, summaries)
    assert json.dumps(got) == json.dumps(want)
    assert [r["ours"] for r in got["rounds"]] == [
        [0.5793016636677303, 0.58380533], [0.599579712767777], []]
    ours = [(o["train_seed"], {"rounds": [{"pseudo_miou": row["ours"][i]}
                                          for row in recorded["label_quality"]["rounds"]]})
            for i, o in enumerate(recorded["ours"])]
    assert (quality.label_quality_rows(quality.recorded_ref_rounds(recorded), ours)
            == recorded["label_quality"])


def test_envelope_and_spread_rows_match_recorded(recorded):
    """The JAX tool's comparison and spread_comparison, recomputed from the
    numbers it committed, come out equal."""
    ref = recorded["reference"]
    comparison = [quality.envelope_row(rnd, recorded["ours"], ref["rounds"], 300)
                  for rnd in range(3)]
    assert comparison == recorded["comparison"]
    all_ref = [{"rounds": ref["rounds"]}] + [{"rounds": s["rounds"]}
                                             for s in recorded["reference_spread"]]
    assert quality.spread_section(comparison, all_ref, 300) == recorded["spread_comparison"]


def test_band_failures():
    assert quality.band_failures({1: 0.55651}, {1: [0.58, 0.6]}) == []
    fails = quality.band_failures({1: 0.556}, {1: [0.567, 0.607], 2: [0.59]})
    assert len(fails) == 3 and "0.556" in fails[0] and "round 2" in fails[2]


def test_quality_comparison_smoke(tmp_path, tiny_model, capsys):
    out = tmp_path / "q.json"
    assert quality.main(["--smoke", "--device", "cpu", "--root", str(tmp_path / "r"),
                         "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert JAX_SECTIONS <= set(res) and {"card", "hual_tpu_ours", "launches"} <= set(res)
    assert res["device"] == "cpu" and res["card"] is None
    assert [o["train_seed"] for o in res["ours"]] == [12345]
    assert [r["round"] for r in res["ours"][0]["rounds"]] == [0, 1]
    assert [r["round"] for r in res["comparison"]] == [0, 1]
    assert res["seed_band"]["checked"] is False         # not the comparison's data
    assert res["hual_tpu_ours"] == json.loads(open(quality.RECORDED).read())["ours"]
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"launches"')]
    assert printed == [json.dumps({"launches": res["launches"]})]


@pytest.fixture
def deterministic_restored(monkeypatch):
    """The ablation turns deterministic mode on for its process: give the
    variable and the algorithms back afterwards."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    yield
    torch.use_deterministic_algorithms(was)


def test_strategy_ablation_at_mc0(tmp_path, tiny_model, deterministic_restored):
    out = tmp_path / "abl.json"
    assert torch_strategy_ablation_loop.main(
        ["--device", "cpu", "--n-train", "48", "--n-test", "24", "--vdim", "32",
         "--epochs", "1", "--rounds", "1", "--root", str(tmp_path / "r"),
         "--out", str(out)]) == 0
    assert torch.are_deterministic_algorithms_enabled()
    res = json.loads(out.read_text())
    variants = {(v["point_strategy"], v["selection"]): v for v in res["variants"]}
    assert list(variants) == torch_strategy_ablation_loop.VARIANTS
    assert len({v["re0_pickle_sha256"] for v in variants.values()}) == 1
    assert len({v["re0_best_r1i7"] for v in variants.values()}) == 1
    uh, dh = variants["uncertainty", "half"], variants["dichotomy", "half"]
    for key in ("pseudo_miou", "n_pos", "n_neg", "test_r1i7", "n_selected"):
        assert uh[key] == dh[key], key
    for (_, selection), v in variants.items():
        assert v["n_selected"] == [24 if selection == "half" else 48]
    bars = res["bars"]
    assert bars["re0_shared"] and bars["uncertainty_half_equals_dichotomy_half"]
    assert bars["n_selected_as_budgeted"]


def test_mc_comparison_selection_order_matches_jax(tmp_path, tiny_model):
    out = tmp_path / "mc.json"
    assert torch_mc_comparison.main(
        ["--device", "cpu", "--n-train", "48", "--n-test", "24", "--epochs", "1",
         "--rounds", "1", "--root", str(tmp_path / "r"), "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    for mc in ("mc00", "mc05"):
        root = str(tmp_path / "r" / mc)
        order, uv = torch_mc_comparison.selection_order(root)
        want_order, want_uv = mc_comparison.selection_order(root)
        assert order == want_order and np.array_equal(uv, want_uv)
        assert len(order) == 24
    assert res["uncert_video_mc0"] == {"max": 0.0, "nonzero_frac": 0.0}
    assert res["selection"]["mc0_is_dataset_order"] is True
    assert res["uncert_video_mc5"]["nonzero_frac"] == 1.0
    assert set(res["trajectories"]) == {"0.0", "0.5"}
    assert all(len(t["pseudo_miou"]) == 1 for t in res["trajectories"].values())


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_viga_extend_label_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(3)
    glances = {}
    for i in range(6):
        dur = float(rng.uniform(10, 60))
        spans = [sorted(rng.uniform(0, dur, 2).tolist()) for _ in range(1 + i % 3)]
        glances[f"v{i}"] = {"duration": dur, "timestamps": spans,
                            "sentences": [f"query {i} {k}" for k in range(len(spans))],
                            "glance": [float(rng.uniform(s, e)) for s, e in spans]}
    glances["v0"]["glance"][0] = 0.0                  # clipped at the start
    glances["v1"]["glance"][0] = glances["v1"]["duration"]  # and at the end
    src = tmp_path / "glance.json"
    src.write_text(json.dumps(glances))
    outputs = {}
    for name in ("viga_extend_label", "torch_viga_extend_label"):
        dst = tmp_path / f"{name}.json"
        monkeypatch.setattr(sys, "argv", [name, str(src), str(dst), "--factor", "0.3"])
        assert _script(name).main() == 0
        outputs[name] = (dst.read_bytes(), capsys.readouterr().out.splitlines())
    assert outputs["viga_extend_label"] == outputs["torch_viga_extend_label"]
    lines = outputs["torch_viga_extend_label"][1]
    assert lines[0] == "0.3" and lines[1].split()[0] == "12"
    assert math.isfinite(float(lines[1].split()[1]))
