"""The port's ``Trainer`` state save and resume on the CPU (split from
``test_torch_train.py``, whose synthetic set and trainer it shares through
``tests/torch_train_helpers.py``: 48 train / 24 test queries, T=16, D=32,
``span_decode: pallas``, ``sweep_backend: fused``):

* ``save_state`` / ``load_state`` round-trip bit for bit;
* a run stopped after epoch 1 and resumed in a fresh ``Trainer`` from the
  periodic state save ends bit-equal to the uninterrupted run (params,
  step, best R@1@0.7 and the best checkpoint; the counterpart of
  ``tests/test_train_e2e.py``'s resume test);
* a resume whose threshold is above what it reaches leaves the best
  checkpoint untouched.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from torch_train_helpers import assert_same_params, make_trainer, params_of
from torch_train_helpers import one_torch_thread, world  # noqa: F401  (fixtures)


def test_state_round_trips(world, tmp_path):
    a = make_trainer(world, str(tmp_path / "ckpt"), epochs=1)
    a.state.step, a.state.best_r1i7, a.state.epoch = 7, 12.5, 1
    with torch.no_grad():
        for mu in a.state.opt.mu:
            mu.normal_()
    a.save_state(str(tmp_path / "state.pt"))
    b = make_trainer(world, str(tmp_path / "ckpt"), epochs=1, seed=3)
    b.init_state(seed=5)
    b.load_state(str(tmp_path / "state.pt"))
    assert_same_params(params_of(a), params_of(b))
    for x, y in zip(a.state.opt.mu + a.state.opt.nu, b.state.opt.mu + b.state.opt.nu):
        assert torch.equal(x, y)
    assert (b.state.step, b.state.best_r1i7, b.state.epoch) == (7, 12.5, 1)


class Preempted(Exception):
    pass


def _stop_after(n: int):
    def callback(epoch, test_metrics):
        if epoch == n:
            raise Preempted
    return callback


def test_resume_replays_the_uninterrupted_run(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = dict(epochs=4, save_state_every=1)
    a = make_trainer(world, str(tmp_path / "a"), **run)
    a.train()
    with np.load(tmp_path / "a" / "charades_re0" / "best.npz") as f:
        best_a = dict(f)

    b = make_trainer(world, str(tmp_path / "b"), **run)
    with pytest.raises(Preempted):
        b.train(epoch_callback=_stop_after(1))
    state_path = tmp_path / "b" / "charades_re0" / "state.pt"
    assert state_path.exists()
    c = make_trainer(world, str(tmp_path / "b"), **run)
    c.init_state(seed=1)                           # the resume overwrites it
    c.load_state(str(state_path))
    assert (c.state.epoch, c.state.step) == (2, 12)
    c.train()
    assert_same_params(params_of(a), params_of(c))
    assert c.state.step == a.state.step == 24
    assert c.state.best_r1i7 == a.state.best_r1i7
    with np.load(tmp_path / "b" / "charades_re0" / "best.npz") as f:
        for k, v in f.items():
            np.testing.assert_array_equal(v, best_a[k], err_msg=k)


def test_resume_keeps_a_better_checkpoint(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = dict(epochs=3, save_state_every=1)
    a = make_trainer(world, str(tmp_path / "ckpt"), **run)
    with pytest.raises(Preempted):
        a.train(epoch_callback=_stop_after(0))
    best = tmp_path / "ckpt" / "charades_re0" / "best.npz"
    mtime, content = os.path.getmtime(best), best.read_bytes()
    b = make_trainer(world, str(tmp_path / "ckpt"), **run)
    b.load_state(str(tmp_path / "ckpt" / "charades_re0" / "state.pt"))
    b.state.best_r1i7 = 1000.0                    # as if from a better run
    record = b.train()
    assert b.state.epoch == 3
    assert os.path.getmtime(best) == mtime and best.read_bytes() == content
    assert record["improved"] is False and record["epoch"] == -1
    assert record["test_metrics"] == {} and record["train_metrics"] == {}
