"""The port's CLI (``hual_tpu_torch.cli``), the cases of
``tests/test_cli.py``, on a synthetic set on the CPU.

``main`` builds its trainer for the card; the tests reach the CPU by
giving ``build_trainer`` ``device="cpu"``.
"""

from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

import hual_tpu_torch.cli as cli  # noqa: E402
from hual_tpu_torch.config import (Config, LossConfig, ModelConfig,  # noqa: E402
                                   PathsConfig, TrainConfig)
from hual_tpu_torch.utils.io import load_pickle  # noqa: E402
from hual_tpu_torch.weights import to_jax_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_cli"))
    make_dataset(root, task="charades", n_train=24, n_test=8, vdim=32,
                 max_raw_len=24, seed=11)
    cfg = Config(
        task="charades", suffix="re0",
        paths=PathsConfig(
            ckpt_dir=os.path.join(root, "ckpt"),
            cache_dir=os.path.join(root, "data_pkl"),
            feature_path=os.path.join(root, "data/features/charades_i3d"),
            glove_path=os.path.join(root, "data/glove/glove.840B.300d.txt"),
            train_path=os.path.join(root, "data/charades_re0/train.json"),
            test_path=os.path.join(root, "data/charades_re0/test.json"),
        ),
        train=TrainConfig(epochs=2, batch_size=8, lr=1e-3,
                          sweep_backend="fused"),
        model=ModelConfig(max_vlen=16, vdim=32, dim=32, num_heads=4,
                          char_dim=8, attn_layer=1, span_decode="pallas"),
        loss=LossConfig(),
    )
    cfg_path = os.path.join(root, "SeqPAN.yaml")
    cfg.save(cfg_path)
    return root, cfg_path


@pytest.fixture
def on_cpu(monkeypatch):
    """cli.main's trainers on the CPU; returns the trainers it built."""
    built = []
    real = cli.build_trainer

    def build(config, **kw):
        built.append(functools.partial(real, device="cpu")(config, **kw))
        return built[-1]

    monkeypatch.setattr(cli, "build_trainer", build)
    return built


def assert_params_are(trainer, npz: str) -> None:
    got = to_jax_params(trainer.model)
    with np.load(npz) as flat:
        assert set(flat) == set(got)
        for k in flat:
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


def _epochs(root: str, suffix: str) -> list[int]:
    with open(os.path.join(root, "logs", "charades", f"metrics_{suffix}.jsonl")) as f:
        return [r["epoch"] for r in map(json.loads, f) if r["kind"] == "epoch"]


def test_cli_train_test_infer(cli_env, monkeypatch, on_cpu):
    root, cfg_path = cli_env
    monkeypatch.chdir(root)
    # --mode train writes the best checkpoint
    assert cli.main(["--config", cfg_path, "--mode", "train", "--suffix", "re0",
                     "--gpu_idx", "3"]) == 0
    assert os.path.exists(os.path.join(root, "ckpt", "charades_re0", "best.npz"))
    assert _epochs(root, "re0") == [0, 1]
    trained = on_cpu[-1]
    assert trained.config.train.seed == 12345 and trained.metrics is None  # closed
    # --mode test restores it
    assert cli.main(["--config", cfg_path, "--mode", "test", "--suffix", "re0"]) == 0
    assert_params_are(on_cpu[-1], os.path.join(root, "ckpt", "charades_re0", "best.npz"))
    # --mode infer_trainset writes the round pickle
    assert cli.main(["--config", cfg_path, "--mode", "infer_trainset",
                     "--suffix", "re0"]) == 0
    rows = load_pickle(os.path.join(root, "results", "charades", "re0.pkl"))
    assert len(rows) == 24 and all(r["prop_idx"][0] <= r["prop_idx"][1] for r in rows)


def test_cli_debug_flag_limits_epochs(cli_env, monkeypatch, on_cpu):
    root, cfg_path = cli_env
    monkeypatch.chdir(root)
    assert cli.main(["--config", cfg_path, "--mode", "train",
                     "--suffix", "debug", "--debug"]) == 0
    assert on_cpu[-1].config.train.epochs == 1 and on_cpu[-1].state.epoch == 1
    assert _epochs(root, "debug") == [0]


def test_cli_checkpoint_flag_resumes_training(cli_env, monkeypatch, on_cpu):
    """--checkpoint in train mode loads a Trainer.save_state file and
    continues at its epoch (the reference declared the flag and never read
    it, main.py:17)."""
    root, cfg_path = cli_env
    monkeypatch.chdir(root)
    cfg = Config.load(cfg_path)
    cfg.suffix = "resume"
    t = cli.build_trainer(cfg)
    t.init_state()
    t.train()
    state_path = os.path.join(root, "ckpt", "resume_state.pt")
    t.save_state(state_path)                 # epoch 2 of 2: a finished run
    saved = {k: v.clone() for k, v in t.model.state_dict().items()}
    # resumed at epoch == epochs: no further epoch, the params stay the saved
    assert cli.main(["--config", cfg_path, "--mode", "train", "--suffix", "resume2",
                     "--checkpoint", state_path]) == 0
    resumed = on_cpu[-1]
    assert resumed.state.epoch == 2 and resumed.state.step == t.state.step
    assert _epochs(root, "resume2") == []
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    # test mode: --checkpoint names a best.npz
    best = os.path.join(root, "ckpt", "charades_resume", "best.npz")
    assert cli.main(["--config", cfg_path, "--mode", "test", "--suffix", "other",
                     "--checkpoint", best]) == 0
    assert_params_are(on_cpu[-1], best)


def test_cli_needs_a_card(cli_env, monkeypatch):
    """Without the device keyword the CLI's trainer is on the card: no card,
    no run, and nothing moves to the CPU."""
    root, cfg_path = cli_env
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", cfg_path, "--mode", "test", "--suffix", "re0"])
