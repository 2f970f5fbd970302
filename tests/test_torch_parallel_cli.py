"""The entry points launched data-parallel, as ``torchrun --nproc_per_node=2``
launches them: two spawned ranks with ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set, gloo on the CPU (``device="cpu"``, a ``file://``
rendezvous), against the same commands without a launch in this process.

Round 0 through ``cli.main`` (train, then infer_trainset), then one round of
``orchestrate.main``, each world in its own copy of a
``tools/make_synthetic_data`` set (43 train / 24 test queries, T=16, D=32).
Both worlds write the same files (rank 1 none of its own: no log file);
the checkpoints and pickles agree within the bounds of
``test_torch_parallel_trainer.py``; round 1 starts from world 2's round-0
pickle in both, so its labels and config are byte-identical.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu_torch import cli, orchestrate  # noqa: E402
from hual_tpu_torch.config import Config, ModelConfig, PathsConfig, TrainConfig  # noqa: E402
from hual_tpu_torch.utils.io import load_json, load_pickle  # noqa: E402
from test_torch_parallel import one_torch_thread  # noqa: E402,F401

BASE = os.path.join("configs", "charades", "SeqPAN.yaml")
ROUND0 = os.path.join("configs", "charades", "SeqPAN_re0.yaml")


def make_world(work: str) -> None:
    """The synthetic set under ``work`` and a base config with the
    reference's relative paths, and round 0's config derived from it."""
    make_dataset(work, task="charades", n_train=43, n_test=24, vdim=32,
                 max_raw_len=24, seed=7)
    cfg = Config(task="charades",
                 paths=PathsConfig(feature_path="./data/features/charades_i3d",
                                   glove_path="./data/glove/glove.840B.300d.txt",
                                   train_path="./data/charades_gt/train.json",
                                   test_path="./data/charades_gt/test.json"),
                 train=TrainConfig(epochs=1, batch_size=8, lr=2e-3,
                                   sweep_backend="fused", eval_batch_size=16,
                                   infer_batch_size=16),
                 model=ModelConfig(max_vlen=16, vdim=32, dim=32, num_heads=4,
                                   char_dim=8, attn_layer=1, span_decode="pallas"))
    cfg.save(os.path.join(work, BASE))
    cfg.derive_round(0).save(os.path.join(work, ROUND0))


ROUND0_ARGV = [["--config", ROUND0, "--mode", mode, "--suffix", "re0"]
               for mode in ("train", "infer_trainset")]
LOOP_ARGV = ["charades", "--config", BASE, "--rounds", "1"]


def round0(**kw) -> None:
    for argv in ROUND0_ARGV:
        assert cli.main(argv, device="cpu", **kw) == 0


def launched(rank: int, world: int, tmp: str, work: str) -> None:
    """One rank of the launched commands: round 0, then the loop."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    os.chdir(work)
    for i, argv in enumerate(ROUND0_ARGV):
        assert cli.main(argv, device="cpu", init_method=f"file://{tmp}/cli{i}") == 0
    assert orchestrate.main(LOOP_ARGV, device="cpu",
                            init_method=f"file://{tmp}/loop") == 0


def written(work: str, since: set) -> dict:
    """The files under ``work`` not in ``since``, a log file by its tag."""
    out = {}
    for dirpath, _, files in os.walk(work):
        for f in files:
            path = os.path.relpath(os.path.join(dirpath, f), work)
            if path in since:
                continue
            key = (os.path.join(os.path.dirname(path), f.split("_", 2)[-1])
                   if f.endswith(".log") else path)
            out.setdefault(key, []).append(path)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_parallel_cli")
    works = {w: str(base / f"world{w}") for w in (1, 2)}
    for work in works.values():
        make_world(work)
    before = {w: set(written(work, set())) for w, work in works.items()}
    here = os.getcwd()
    try:
        os.chdir(works[1])
        round0()
        rendezvous = str(base / "rendezvous")
        os.makedirs(rendezvous)
        mp.start_processes(launched, args=(2, rendezvous, works[2]), nprocs=2,
                           start_method="spawn", join=True)
        # round 1 from the same round-0 pickle in both worlds
        pkl = os.path.join("results", "charades", "re0.pkl")
        shutil.copy(pkl, pkl + ".world1")
        shutil.copy(os.path.join(works[2], pkl), pkl)
        assert orchestrate.main(LOOP_ARGV, device="cpu") == 0
    finally:
        os.chdir(here)
    return works, before


def test_launch_writes_the_files_of_world1(worlds):
    works, before = worlds
    w1 = written(works[1], before[1] | {os.path.join("results", "charades",
                                                       "re0.pkl.world1")})
    w2 = written(works[2], before[2])
    assert set(w1) == set(w2)
    # one file of each kind: rank 1 wrote no log of its own
    assert all(len(v) == len(w1[k]) for k, v in w2.items())
    for must in ("data/charades_re1/train.json", "configs/charades/SeqPAN_re1.yaml",
                 "results/charades/re0.pkl", "results/charades/re1.pkl",
                 "results/charades/rounds_summary.json",
                 "ckpt/charades_re0/best.npz", "ckpt/charades_re1/best.npz"):
        assert must in w2, must


def _close_npz(a: str, b: str) -> None:
    with np.load(a) as x, np.load(b) as y:
        assert set(x) == set(y)
        for k in x:
            # one epoch of Adam steps: test_torch_parallel_trainer.py's bound
            np.testing.assert_allclose(x[k], y[k], rtol=2e-4, atol=1e-5, err_msg=k)


def test_launch_checkpoints_and_pickles_agree(worlds):
    works, _ = worlds
    for r in (0, 1):
        _close_npz(os.path.join(works[1], "ckpt", f"charades_re{r}", "best.npz"),
                   os.path.join(works[2], "ckpt", f"charades_re{r}", "best.npz"))
    a = load_pickle(os.path.join(works[1], "results", "charades", "re0.pkl.world1"))
    b = load_pickle(os.path.join(works[2], "results", "charades", "re0.pkl"))
    assert [r["vid"] for r in a] == [r["vid"] for r in b]
    for x, y in zip(a, b):
        assert x["prop_idx"] == y["prop_idx"]
        np.testing.assert_allclose(x["prop_logits"], y["prop_logits"],
                                   rtol=1e-4, atol=2e-4)


def test_launch_round_files_are_identical(worlds):
    works, _ = worlds
    for path in ("data/charades_re1/train.json", "configs/charades/SeqPAN_re1.yaml"):
        with open(os.path.join(works[1], path), "rb") as a, \
                open(os.path.join(works[2], path), "rb") as b:
            assert a.read() == b.read(), path
    s1, s2 = (load_json(os.path.join(w, "results", "charades", "rounds_summary.json"))
              for w in (works[1], works[2]))
    assert [h["label_stats"] for h in s1] == [h["label_stats"] for h in s2]


def test_no_launch_variables_no_group(monkeypatch):
    for k in cli._LAUNCH_VARIABLES:
        monkeypatch.delenv(k, raising=False)
    assert cli.init_distributed("cpu", "file:///nonexistent") is None
    assert not torch.distributed.is_initialized()
