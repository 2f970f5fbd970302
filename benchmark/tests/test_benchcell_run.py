"""Runs of the harness: ``run.py`` refuses without a card and without the
port beside it; on the CPU at a tiny size (the harness's look for a chip
skipped) every cell comes out correct, and comes out not correct with its
timed path broken underneath: a train step that leaves its state
unchanged, half of each batch left out with the mean taken over the rest,
a span altered where the decode produces it."""

import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

from conftest import ROOT

CELLS = ("charades.train", "anet.test_sweep", "charades.al_sweep")


def _run(bench, workload):
    return harness.run(workload, 2**31 + 99, 0.2, False, time.perf_counter(), device="cpu",
                       bench=bench)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "charades.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "charades.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_bench, workload):
    r = _run(tiny_bench, workload)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["device"]["platform"] == "cpu"
    assert set(r["metrics"]) >= {"setup_s"}


def test_train_step_that_leaves_its_state_unchanged_is_caught(tiny_bench, monkeypatch):
    from hual_tpu_torch.ops import optim

    monkeypatch.setattr(optim.BertAdamW, "step", lambda self, grads, lr: torch.zeros(()))
    r = _run(tiny_bench, "charades.train")
    assert not r["correct"] and r["compared"]["change_gap"]["value"] > 0.99


def test_half_of_each_batch_left_out_is_caught(tiny_bench, monkeypatch):
    from hual_tpu_torch.runtime import steps

    train_step = steps.train_step

    def half(model, opt, batch, *args, **kw):
        n = batch["video_features"].shape[0] // 2
        return train_step(model, opt, {k: v[:n] for k, v in batch.items()}, *args, **kw)

    monkeypatch.setattr(steps, "train_step", half)
    r = _run(tiny_bench, "charades.train")
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("workload", ("anet.test_sweep", "charades.al_sweep"))
def test_a_span_altered_where_decoded_is_caught(tiny_bench, monkeypatch, workload):
    from hual_tpu_torch.ops.kernels import span_decode as k1

    decode = k1.span_decode

    def altered(start, end, mask):
        s, e = decode(start, end, mask)
        return torch.zeros_like(s), e

    altered.launches = 0
    monkeypatch.setattr(k1, "span_decode", altered)
    r = _run(tiny_bench, workload)
    assert not r["correct"], r["compared"]
