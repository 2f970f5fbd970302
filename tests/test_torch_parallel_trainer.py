"""The Trainer data-parallel (``Trainer(mesh=)``), gloo on the CPU at world
size 2 against the unsharded Trainer in this process, on a
``tools/make_synthetic_data`` set (43 train / 24 test queries, T=16,
D=32): one epoch of ``train()`` at batch 8 (a ragged last batch of 3, whole
on every rank), ``test()`` and ``infer_trainset()`` at mc 0.5 in batches of
16 with the fused sweeps (K2's and K1's plain versions on the CPU); only
rank 0 writes; the table has half the rows on each rank and the residency
budget is per rank; host streaming at world 2 replays the resident run.
One spawn of two ranks in a module-scoped fixture; the cases share
``test_torch_parallel.py``'s helpers.
"""

from __future__ import annotations

import logging
import os
import pickle
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.parallel import RowShard, make_mesh  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from hual_tpu_torch.weights import to_jax_params  # noqa: E402
from test_torch_parallel import (assert_params_close, assert_same,  # noqa: E402,F401
                                 one_torch_thread, run_ranks)

LOGGER = logging.getLogger("test_torch_parallel_trainer")


def trainer_config(root: str, **train) -> Config:
    """43 train queries at batch 8 (a ragged last batch of 3, whole on every
    rank at world 2), sweeps in batches of 16."""
    return Config.from_dict({
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "train": dict({"epochs": 1, "batch_size": 8, "lr": 2e-3, "droprate": 0.2,
                       "clip_norm": 1.0, "seed": 12345, "sweep_backend": "fused",
                       "mc_droprate": 0.5, "eval_batch_size": 16,
                       "infer_batch_size": 16}, **train),
        "model": {"max_vlen": 16, "max_tlen": 10, "vdim": 32, "dim": 32,
                  "num_heads": 4, "word_dim": 300, "char_dim": 8,
                  "attn_layer": 1, "span_decode": "pallas"},
    })


def run_trainer(root: str, mesh, tag: str, **train) -> dict:
    """One epoch of Trainer.train(), test() and infer_trainset() in
    ``root/<tag>``; the pickle goes to ``<tag>/rank<r>.pkl``."""
    cfg = trainer_config(root, **train)
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    work = os.path.join(root, tag)
    os.makedirs(work, exist_ok=True)
    cfg.paths.ckpt_dir = os.path.join(work, "ckpt")
    here = os.getcwd()
    os.chdir(work)                      # train() writes ./logs/<task>/
    try:
        tr = Trainer(cfg, dataset, store, device="cpu", mesh=mesh)
        tr.init_state()
        best = tr.train()
        test = tr.test()
        rank = 0 if mesh is None else mesh.rank
        pkl = os.path.join(work, f"rank{rank}.pkl")
        infer = tr.infer_trainset(save_path=pkl)
        out = {"params": to_jax_params(tr.model), "best_epoch": best["epoch"],
               "test": test, "infer": infer, "host_streaming": tr.host_streaming,
               "wrote_pickle": os.path.exists(pkl),
               "wrote_best": os.path.exists(os.path.join(cfg.model_dir(), "best.npz")),
               "pickle": None}
        if out["wrote_pickle"]:
            with open(pkl, "rb") as f:
                out["pickle"] = pickle.load(f)
        table = tr.export_device_features()
        out["table_rows"] = (None if table is None else
                             (table[0].local if isinstance(table[0], RowShard)
                              else table[0]).shape[0])
        tr.close()
        return out
    finally:
        os.chdir(here)


def budget_streams(root: str, mesh) -> bool:
    """Whether a Trainer whose budget is 3/4 of the whole table streams."""
    cfg = trainer_config(root)
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    cfg.train.hbm_budget_gb = 0.75 * store.packed.nbytes / 1e9
    tr = Trainer(cfg, dataset, store, device="cpu", mesh=mesh, logger=LOGGER)
    return tr.host_streaming


def trainer_ranks(rank: int, root: str) -> dict:
    mesh = make_mesh()
    return {"budget_streams": budget_streams(root, mesh),
            "trainer": run_trainer(root, mesh, "world2"),
            "streamed": run_trainer(root, mesh, "world2_streamed",
                                    host_streaming=True)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The synthetic set, its dataset cache written here before any rank
    reads it."""
    root = str(tmp_path_factory.mktemp("torch_parallel_trainer"))
    make_dataset(root, task="charades", n_train=43, n_test=24, vdim=32,
                 max_raw_len=24, seed=7)
    gen_or_load_dataset(trainer_config(root))
    return root


@pytest.fixture(scope="module")
def world2(root):
    return run_ranks(trainer_ranks, 2, os.path.join(root, "ranks"), root)


@pytest.fixture(scope="module")
def world1(root):
    return {"budget_streams": budget_streams(root, None),
            "trainer": run_trainer(root, None, "world1")}


# Trainer.train + test() + infer_trainset() at world 2 equal world 1
def test_trainer_world2_equals_world1(world2, world1):
    want = world1["trainer"]
    for r in world2:
        got = r["trainer"]
        assert not got["host_streaming"]
        # six Adam steps, not one: a parameter near zero whose gradients
        # differ in the last bits drifts by more than test_sharding's one-step
        # atol; held at the golden harness's atol for Adam updates (1e-5,
        # tests/test_torch_train_step.py)
        assert_params_close(got["params"], want["params"], atol=1e-5)
        assert got["test"] == pytest.approx(want["test"])
        assert got["infer"] == pytest.approx(want["infer"])
    rows0, rows_w1 = world2[0]["trainer"]["pickle"], want["pickle"]
    assert len(rows0) == len(rows_w1)
    for a, b in zip(rows0, rows_w1):
        assert a["prop_idx"] == b["prop_idx"] and a["vid"] == b["vid"]
        # logits of params within the bound above: K2's logits bound
        # (rtol 1e-4 / atol 2e-4, tests/test_fused_forward.py)
        np.testing.assert_allclose(a["prop_logits"], b["prop_logits"],
                                   rtol=1e-4, atol=2e-4)


def test_only_rank0_writes(world2):
    assert [r["trainer"]["wrote_pickle"] for r in world2] == [True, False]
    assert world2[0]["trainer"]["wrote_best"]


def test_trainer_table_is_sharded(world2, world1):
    n = world1["trainer"]["table_rows"]
    for r in world2:
        assert r["trainer"]["table_rows"] == -(-n // 2)


def test_residency_budget_per_rank(world2, world1):
    """A budget of 3/4 of the table: crossed unsharded, not by half of it."""
    assert world1["budget_streams"]
    assert [r["budget_streams"] for r in world2] == [False, False]


# host streaming at world 2 equals resident at world 2
def test_streaming_world2_equals_resident(world2):
    for r in world2:
        s, res = r["streamed"], r["trainer"]
        assert s["host_streaming"] and s["table_rows"] is None
        assert_same(s["params"], res["params"])
        # the streamed sweeps run the eager model (hual_tpu's fused -> flax
        # fallback), the resident ones K2's plain version
        assert s["test"] == pytest.approx(res["test"], rel=1e-5)
        assert s["infer"] == pytest.approx(res["infer"], rel=1e-5)
