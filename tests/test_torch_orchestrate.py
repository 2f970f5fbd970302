"""The port's round loop (``hual_tpu_torch.orchestrate``), the cases of
``tests/test_orchestrate.py``.

The label updates, config derivation, round files and the summary are
real; the trainer is a stub where a case tests the loop's plumbing, and
the port's ``Trainer`` on the CPU where it tests the epoch resume from
``state.pt``.
"""

from __future__ import annotations

import functools
import importlib
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

import hual_tpu_torch.cli as cli  # noqa: E402
import hual_tpu_torch.orchestrate as orch  # noqa: E402
from hual_tpu_torch.config import (Config, ModelConfig, PathsConfig,  # noqa: E402
                                   TrainConfig)
from hual_tpu_torch.utils.io import load_json, save_pickle  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

TEST_METRICS = {"r1i3": 30.0, "r1i5": 20.0, "r1i7": 10.0, "miou": 25.0}


class StubTrainer:
    """The Trainer surface the loop calls; infer_trainset writes a pickle
    of random logits for the round's records."""

    def __init__(self, config, features=None, device_features=None,
                 base_dataset=None, device="cuda"):
        self.config = config
        self.features = features if features is not None else object()
        self._table = (device_features if device_features is not None
                       else (object(), None))
        self.dataset = {"train_set": []}
        self.device = device
        self.closed = False

    def export_device_features(self):
        return self._table

    def init_state(self):
        pass

    def train(self):
        return {"r1i7": 10.0, "epoch": 0, "train_line": "t", "test_line": "t",
                "test_metrics": dict(TEST_METRICS)}

    def restore(self):
        pass

    def infer_trainset(self, save_path=None):
        _write_fake_predictions(self.config, save_path)
        return dict(TEST_METRICS)

    def close(self):
        self.closed = True


def _write_fake_predictions(config, save_path, T=16):
    rng = np.random.default_rng(0)
    preds = []
    for vid, dur, (s, e), sent in (r[:4] for r in load_json(config.paths.train_path)):
        logits = lambda: rng.normal(size=T).astype(np.float32)  # noqa: E731
        preds.append({
            "vid": vid, "duration": dur, "psuedo_idx": [1, 5],
            "sentence": sent.strip(), "v_len": T, "prop_idx": [2, 6],
            "prop_logits": [logits(), logits()],
            "prop_logits1": [logits(), logits()],
            "prop_logits2": [logits(), logits()],
            "m_score": rng.uniform(size=(T, 4)).astype(np.float32),
        })
    save_pickle(preds, save_path)


def _world(tmp_path, monkeypatch, n_train=12, seed=5, **train) -> str:
    """A synthetic set under tmp_path (the cwd), a base config with the
    reference's relative paths, and round 0's pickle; returns the config's
    path."""
    root = str(tmp_path)
    make_dataset(root, task="charades", n_train=n_train, n_test=4, vdim=8,
                 max_raw_len=16, seed=seed)
    monkeypatch.chdir(root)
    base_path = os.path.join(root, "configs", "charades", "SeqPAN.yaml")
    cfg = Config(task="charades",
                 paths=PathsConfig(feature_path="./data/features/charades_i3d",
                                   glove_path="./data/glove/glove.840B.300d.txt",
                                   train_path="./data/charades_gt/train.json",
                                   test_path="./data/charades_gt/test.json"),
                 train=TrainConfig(**dict({"epochs": 1, "batch_size": 4}, **train)))
    cfg.save(base_path)
    _write_fake_predictions(cfg.derive_round(0), "./results/charades/re0.pkl")
    return base_path


def _points(records) -> int:
    return sum(len(r[4]["pos_idx"]) + len(r[4]["neg_idx"]) for r in records)


def test_run_rounds_plumbing(tmp_path, monkeypatch):
    base_path = _world(tmp_path, monkeypatch, n_train=20, seed=3)
    built = []
    monkeypatch.setattr(cli, "build_trainer",
                        lambda c, **kw: built.append(StubTrainer(c, **kw)) or built[-1])
    history = orch.run_rounds("charades", rounds=2, base_config_path=base_path,
                              device="cpu")
    assert len(history) == 2
    cfg_dir = os.path.dirname(base_path)
    for i in (1, 2):
        assert os.path.exists(f"./data/charades_re{i}/train.json")
        assert os.path.exists(f"./data/charades_re{i}/test.json")
        assert os.path.exists(f"./results/charades/re{i}.pkl")
        derived = Config.load(os.path.join(cfg_dir, f"SeqPAN_re{i}.yaml"))
        assert derived.suffix == f"re{i}"
        assert derived.paths.train_path == f"./data/charades_re{i}/train.json"
    # the device reaches every round's trainer, each closed at its round's end
    assert [t.device for t in built] == ["cpu", "cpu"] and all(t.closed for t in built)
    # round 2 reuses round 1's table
    assert built[1].export_device_features() is built[0].export_device_features()
    with open("./results/charades/rounds_summary.json") as f:
        summary = json.load(f)
    assert summary == json.loads(json.dumps(history))
    assert summary[0]["round"] == 1
    assert summary[0]["best"]["test_metrics"]["r1i7"] == 10.0
    assert "train_line" not in summary[0]["best"]
    assert set(summary[1]["label_stats"]) >= {"old_miou", "new_miou", "n_selected",
                                              "selection_overlap_prev"}
    # round 2 builds on round 1's annotations: cumulative points grow
    assert _points(load_json("./data/charades_re1/train.json")) == 10   # ceil(20/2)
    assert _points(load_json("./data/charades_re2/train.json")) == 20


def test_cli_point_strategy_and_selection_flags(tmp_path, monkeypatch):
    """orchestrate.main's ablation flags: --point-strategy dichotomy
    --selection all annotates every record with the dichotomy midpoint."""
    base_path = _world(tmp_path, monkeypatch, seed=7)
    monkeypatch.setattr(cli, "build_trainer", lambda c, **kw: StubTrainer(c, **kw))
    assert orch.main(["charades", "--rounds", "1", "--config", base_path,
                      "--point-strategy", "dichotomy", "--selection", "all"]) == 0
    r1 = load_json("./data/charades_re1/train.json")
    assert all(len(r[4]["pos_idx"]) + len(r[4]["neg_idx"]) == 1 for r in r1)
    # dichotomy with no earlier points bisects [0, vlen): frame 7 at T=16
    assert [(r[4]["pos_idx"] + r[4]["neg_idx"])[0] for r in r1] == [7] * len(r1)


def test_main_runs_on_the_card(tmp_path, monkeypatch):
    """orchestrate.main builds its trainers for the card: without one, the
    first round raises and nothing moves to the CPU."""
    base_path = _world(tmp_path, monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orch.main(["charades", "--rounds", "1", "--config", base_path])


def test_run_rounds_retry_on_transient_failure(tmp_path, monkeypatch):
    base_path = _world(tmp_path, monkeypatch)
    calls = {"n": 0}

    class FlakyTrainer(StubTrainer):
        def train(self):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient device error")
            return super().train()

    monkeypatch.setattr(cli, "build_trainer", lambda c, **kw: FlakyTrainer(c, **kw))
    history = orch.run_rounds("charades", rounds=1, base_config_path=base_path,
                              max_retries=1, device="cpu")
    assert len(history) == 1 and calls["n"] == 2
    calls["n"] = -10
    monkeypatch.setattr(StubTrainer, "train", lambda self: 1 / 0)
    with pytest.raises(ZeroDivisionError):                 # retries exhausted
        orch.run_rounds("charades", rounds=1, base_config_path=base_path,
                        max_retries=1, device="cpu")


def test_resume_preserves_completed_rounds_in_summary(tmp_path, monkeypatch):
    base_path = _world(tmp_path, monkeypatch)
    monkeypatch.setattr(cli, "build_trainer", lambda c, **kw: StubTrainer(c, **kw))
    orch.run_rounds("charades", rounds=1, base_config_path=base_path, device="cpu")
    # stopped after round 1; resumed at round 2
    orch.run_rounds("charades", rounds=2, base_config_path=base_path,
                    start_round=2, device="cpu")
    with open("./results/charades/rounds_summary.json") as f:
        assert [h["round"] for h in json.load(f)] == [1, 2]


def test_retry_keeps_selection_overlap_vs_previous_round(monkeypatch, tmp_path):
    """A retried round compares its selection with round I-1's, not with
    its own first attempt's."""

    class FailingOnce(StubTrainer):
        fail_next = False

        def train(self):
            if FailingOnce.fail_next:
                FailingOnce.fail_next = False
                raise RuntimeError("transient device error")
            return {"r1i7": 1.0}

        def infer_trainset(self, save_path=None):
            return {"miou": 1.0}

    selections = {1: [0, 1, 2], 2: [0, 1, 5]}

    def fake_update_labels(task, round_idx, data_root=".", results_root=".", **kw):
        return {"old_miou": 0.5, "new_miou": 0.6,
                "selected_idx": list(selections[round_idx])}

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "build_trainer", lambda c, **kw: FailingOnce(c, **kw))
    monkeypatch.setattr(orch, "update_labels", fake_update_labels)
    logger = logging.getLogger("test_torch_orchestrate")
    shared: dict = {}
    history: list = []
    args = (Config(), str(tmp_path / "c.yaml"), ".", ".", logger, history, shared)
    orch._run_one_round("charades", 1, *args)
    FailingOnce.fail_next = True
    with pytest.raises(RuntimeError):
        orch._run_one_round("charades", 2, *args)
    orch._run_one_round("charades", 2, *args)
    # overlap({0,1,5}, {0,1,2}) / 3, not 1.0 against its own first attempt
    assert history[-1]["label_stats"]["selection_overlap_prev"] == \
        pytest.approx(2 / 3, abs=1e-4)
    assert "selection_overlap_prev" not in history[0]["label_stats"]


def test_shared_feature_cache_invalidated_on_feature_path_change(monkeypatch, tmp_path):
    """The reused table and dataset are dropped when a round's
    (feature_path, max_vlen) changes."""
    seen = []

    def fake_build_trainer(cfg, features=None, device_features=None,
                           base_dataset=None, device="cuda"):
        seen.append((features, device_features, base_dataset))
        return StubTrainer(cfg, features, device_features, base_dataset, device)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "build_trainer", fake_build_trainer)
    monkeypatch.setattr(orch, "update_labels",
                        lambda task, r, **kw: {"old_miou": 0.5, "new_miou": 0.6})
    monkeypatch.setattr(StubTrainer, "infer_trainset", lambda self, save_path=None: {})
    base = Config()
    base.paths.feature_path = "/feat/v1"
    logger = logging.getLogger("test_torch_orchestrate")
    shared: dict = {}
    history: list = []
    args = (str(tmp_path / "c.yaml"), ".", ".", logger, history, shared)

    orch._run_one_round("charades", 1, base, *args)
    first = (shared["features"], shared["device_features"], shared["dataset"])
    assert shared["feat_key"] == ("/feat/v1", base.model.max_vlen)
    orch._run_one_round("charades", 2, base, *args)       # same key: reused
    assert seen[1] == first
    base.paths.feature_path = "/feat/v2"                  # new key: dropped
    orch._run_one_round("charades", 3, base, *args)
    assert seen[2] == (None, None, None)
    assert shared["feat_key"] == ("/feat/v2", base.model.max_vlen)
    base.model.max_vlen = 32
    orch._run_one_round("charades", 4, base, *args)
    assert seen[3] == (None, None, None)


def test_summary_script_reads_the_port_summary(tmp_path, monkeypatch, capsys):
    base_path = _world(tmp_path, monkeypatch)
    monkeypatch.setattr(cli, "build_trainer", lambda c, **kw: StubTrainer(c, **kw))
    history = orch.run_rounds("charades", rounds=1, base_config_path=base_path,
                              device="cpu")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "..", "scripts"))
    import summary_performance
    importlib.reload(summary_performance)
    monkeypatch.setattr(sys, "argv", ["summary_performance.py", "charades"])
    assert summary_performance.main() == 0
    out = capsys.readouterr().out.splitlines()
    row = out[-1].split()
    assert row[0] == "re1"
    assert float(row[1]) == round(history[0]["label_stats"]["new_miou"], 4)
    assert [float(x) for x in row[2:]] == [30.0, 20.0, 10.0, 25.0]


# -- epoch resume, with the port's Trainer on the CPU ---------------------------
def test_retry_resumes_from_epoch_state(tmp_path, monkeypatch):
    """A round whose first attempt stops after epoch 0 leaves
    ``<model_dir>/state.pt``; the retry loads it, trains only epoch 1, ends
    bit-equal to an uninterrupted round, and the file is gone afterwards."""
    base_path = _world(tmp_path, monkeypatch, n_train=20, epochs=2,
                       save_state_every=1)
    base = Config.load(base_path)
    base.model = ModelConfig(max_vlen=16, vdim=8, dim=16, num_heads=2,
                             char_dim=4, attn_layer=1, span_decode="pallas")
    base.train.sweep_backend = "fused"
    base.save(base_path)
    real_build = cli.build_trainer
    events, trainers = [], []

    def build(c, **kw):
        tr = real_build(c, **kw)
        trainers.append(tr)
        train, load_state = tr.train, tr.load_state

        def train_once():
            events.append(("train from epoch", tr.state.epoch))
            if len(trainers) == 1:                  # the first attempt stops

                def stop(epoch, _):
                    raise RuntimeError(f"preempted after epoch {epoch}")
                return train(epoch_callback=stop)
            return train()

        def load(path):
            events.append(("load_state", os.path.basename(path)))
            load_state(path)

        tr.train, tr.load_state = train_once, load
        return tr

    monkeypatch.setattr(cli, "build_trainer", build)
    history = orch.run_rounds("charades", rounds=1, base_config_path=base_path,
                              max_retries=1, device="cpu")
    assert events == [("train from epoch", 0), ("load_state", "state.pt"),
                      ("train from epoch", 1)], events
    assert len(history) == 1
    model_dir = os.path.abspath(base.derive_round(1).model_dir())
    assert not os.path.exists(os.path.join(model_dir, "state.pt"))
    resumed = trainers[1]
    # the uninterrupted round, from the same labels
    monkeypatch.setattr(cli, "build_trainer", real_build)
    cfg = Config.load(os.path.join(os.path.dirname(base_path), "SeqPAN_re1.yaml"))
    cfg.paths.ckpt_dir = str(tmp_path / "ckpt_whole")
    whole = functools.partial(real_build, device="cpu")(cfg)
    whole.init_state()
    whole.train()
    assert whole.state.step == resumed.state.step == 10      # 2 x ceil(20 / 4)
    assert whole.state.best_r1i7 == resumed.state.best_r1i7
    with np.load(os.path.join(whole.config.model_dir(), "best.npz")) as a, \
            np.load(os.path.join(model_dir, "best.npz")) as b:
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
