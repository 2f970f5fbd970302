"""The port's tools (tools/torch_*.py) run end to end on the CPU at tiny
sizes through their ``main(argv)`` with ``--device cpu``, and write their
JSON with the expected keys; with ``--device cuda`` and no card they raise
before doing any work.  On the CPU the kernel wrappers take their plain
versions, so the launch counts the tools print are 0 here; the card's runs
are ``chip_smoke.py``'s ``tools_charades``.
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_bench_bf16_train  # noqa: E402
import torch_bench_eval_batch  # noqa: E402
import torch_bench_fused  # noqa: E402
import torch_bench_int8_table  # noqa: E402
import torch_bench_serve  # noqa: E402
import torch_bench_span_decode  # noqa: E402
import torch_bench_step_breakdown  # noqa: E402
import torch_bench_train_batch  # noqa: E402
import torch_full_loop_demo  # noqa: E402
import torch_mc_comparison  # noqa: E402
import torch_real_assets_parity  # noqa: E402
import torch_strategy_ablation_loop  # noqa: E402
import torch_sweep_ablation  # noqa: E402
import torch_synthetic_quality_comparison  # noqa: E402
import torch_validate_pipeline  # noqa: E402
from torch_train_helpers import one_torch_thread  # noqa: E402,F401

TINY = dict(vdim=16, dim=16, num_heads=2, attn_layer=1, char_dim=8)
LAUNCHES = {"span_decode", "fused_forward", "fused_forward_bf16"}


def _run(tool, argv: list[str], out) -> dict:
    assert tool.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        res = json.load(f)
    assert set(res["launches"]) == LAUNCHES
    return res


def test_bench_span_decode(tmp_path, monkeypatch):
    tool = torch_bench_span_decode
    monkeypatch.setattr(tool, "SHAPES", ((4, 16), (3, 20)))
    monkeypatch.setattr(tool, "INFER_BATCH", 4)
    monkeypatch.setattr(tool, "INFER_SAMPLES", 8)
    monkeypatch.setattr(tool, "INFER_T", 16)
    monkeypatch.setattr(tool, "WIDTHS", TINY)
    res = _run(tool, ["--iters", "2"], tmp_path / "k1.json")
    want = {f"decode_{v}_b{b}_t{t}_us" for v in ("plain", "kernel")
            for b, t in ((4, 16), (3, 20))}
    want |= {f"infer_step_{v}_b4_t16_ms" for v in ("plain", "kernel")}
    assert want <= set(res) and all(res[k] > 0 for k in want)
    assert res["device"] == "cpu" and res["card"] is None


@pytest.mark.parametrize("flags,names", [
    ([], ["eval_flax", "eval_fused", "infer_flax_mc0.5", "infer_fusedclean_mc0.5",
          "infer_flax_mc0.5_bf16stoch", "infer_fusedclean_bf16stoch"]),
    (["--mxu-bf16", "--skip-flax"], ["eval_fused_bf16mxu",
                                     "infer_fusedclean_mc0.5_bf16mxu",
                                     "infer_fusedclean_bf16stoch_bf16mxu"])])
def test_bench_fused(tmp_path, monkeypatch, flags, names):
    tool = torch_bench_fused
    monkeypatch.setattr(tool, "N_SAMPLES", 12)
    monkeypatch.setattr(tool, "WIDTHS", dict(TINY, max_vlen=16))
    res = _run(tool, ["--iters", "1", "--batch", "4", "--steps", "2"] + flags,
               tmp_path / "k2.json")
    assert [r["name"] for r in res["rows"]] == names
    for r in res["rows"]:
        assert r["pairs_per_sec"] > 0 and r["sweep_ms"] > 0
    assert res["graphed"] is False


def test_bench_serve(tmp_path, monkeypatch):
    tool = torch_bench_serve
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tool, "WIDTHS", dict(TINY, max_vlen=16))
    monkeypatch.setattr(tool, "DATA", dict(n_train=12, n_test=6, max_raw_len=24,
                                           min_raw_len=4, seed=5))
    res = _run(tool, ["--single", "3", "--chunks", "1", "--batch-sizes", "2", "4",
                      "--root", str(tmp_path / "root")], tmp_path / "serve.json")
    assert set(res["single_latency_ms"]) == {"p50", "p90", "mean", "n"}
    assert res["single_latency_ms"]["n"] == 3
    assert set(res["batched"]) == {"b2", "b4"}
    for row in res["batched"].values():
        assert set(row) == {"requests_per_s", "ms_per_batch_end_to_end",
                            "ms_per_batch_device_only", "device_only_share"}


def test_validate_pipeline(tmp_path, monkeypatch):
    tool = torch_validate_pipeline
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tool, "MODEL", {k: v for k, v in TINY.items() if k != "vdim"})
    res = _run(tool, ["--root", str(tmp_path / "root"), "--n-train", "24",
                      "--n-test", "8", "--epochs", "1", "--vdim", "16",
                      "--max-vlen", "16", "--batch-size", "8"], tmp_path / "v.json")
    stages = res["stages"]
    for key in ("datagen_s", "train_total_s", "steady_train_epoch_s", "test_s",
                "infer_trainset_s", "label_update_s", "extrapolated_full_round_s",
                "pseudo_miou_new"):
        assert key in stages, key
    assert res["sweep_backend"] == "fused"


def test_full_loop_demo(tmp_path, monkeypatch):
    tool = torch_full_loop_demo
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tool, "MODEL", dict(TINY, max_tlen=10, word_dim=300))
    res = _run(tool, ["--root", str(tmp_path / "root"), "--n-train", "24",
                      "--n-test", "8", "--epochs", "1", "--rounds", "1"],
               tmp_path / "loop.json")
    assert {"re0_train_s", "re0_infer_s", "rounds_1_to_N_s",
            "total_loop_s"} <= set(res["times"])
    assert [r["round"] for r in res["rounds"]] == [1]
    assert len(res["round_stages"]) == 1
    assert {"update_s", "train_s", "infer_s"} <= set(res["round_stages"][0])
    assert res["sweep_backend"] == "fused"


@pytest.mark.parametrize("tool", [torch_bench_span_decode, torch_bench_fused,
                                  torch_bench_serve, torch_validate_pipeline,
                                  torch_full_loop_demo, torch_bench_step_breakdown,
                                  torch_bench_train_batch, torch_bench_bf16_train,
                                  torch_bench_eval_batch, torch_sweep_ablation,
                                  torch_bench_int8_table, torch_real_assets_parity,
                                  torch_synthetic_quality_comparison,
                                  torch_strategy_ablation_loop, torch_mc_comparison],
                         ids=lambda t: t.__name__)
def test_tools_raise_without_a_card(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--root", str(tmp_path / "r")] if tool in (
            torch_full_loop_demo, torch_validate_pipeline, torch_bench_serve,
            torch_real_assets_parity, torch_synthetic_quality_comparison,
            torch_strategy_ablation_loop, torch_mc_comparison) else [])
    assert not os.listdir(tmp_path)
