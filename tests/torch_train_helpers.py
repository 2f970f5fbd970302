"""Shared pieces of the port's training tests: the synthetic set and its
Trainer (``test_torch_train.py``, ``test_torch_train_resume.py``), and the
MC passes' split and distributional bounds (``test_torch_train.py``,
``test_torch_fold_mc.py``).

The bounds are ``docs/PARITY.md``'s, as ``tests/test_golden_mc.py``
computes them: per-position mean z p99 < 4 and max < 6, per-sample noise
std ratio in [0.7, 1.4], acquisition Spearman >= 0.85, relative difference
of the per-video uncertainty median < 0.2 and max < 0.5.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu.active.uncertainty import model_uncertainty_batch  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (re-exported)

LOGGER = logging.getLogger("test_torch_train")


def train_config(root: str, ckpt: str, **train) -> Config:
    return Config.from_dict({
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": ckpt,
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "train": dict({"epochs": 3, "batch_size": 8, "lr": 2e-3, "droprate": 0.1,
                       "clip_norm": 1.0, "seed": 12345, "sweep_backend": "fused"},
                      **train),
        "model": {"max_vlen": 16, "max_tlen": 10, "vdim": 32, "dim": 32,
                  "num_heads": 4, "word_dim": 300, "char_dim": 8,
                  "attn_layer": 1, "span_decode": "pallas"},
    })


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A ``tools/make_synthetic_data`` set (48 train / 24 test queries,
    T=16, D=32): (root, dataset, feature store)."""
    root = str(tmp_path_factory.mktemp("torch_train"))
    make_dataset(root, task="charades", n_train=48, n_test=24, vdim=32,
                 max_raw_len=24, seed=7)
    cfg = train_config(root, os.path.join(root, "ckpt"))
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    return root, dataset, store


def make_trainer(world, ckpt: str, **train) -> Trainer:
    root, dataset, store = world
    tr = Trainer(train_config(root, ckpt, **train), dataset, store, logger=LOGGER,
                 device="cpu")
    tr.init_state()
    return tr


def params_of(tr: Trainer) -> dict:
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


def assert_same_params(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- MC passes ------------------------------------------------------------------
MC_B, MC_T, MC_W, MC_C, MC_V, N_PASSES = 32, 16, 6, 5, 48, 64
MC_WIDTHS = dict(dim=32, num_heads=4, attn_layer=1, max_vlen=MC_T, word_dim=20,
                 char_dim=8, num_chars=30)


def mc_split(rng) -> dict:
    """A split of MC_B samples in the device-resident layout."""
    v_len = rng.integers(6, MC_T + 1, MC_B).astype(np.int32)
    v_len[0] = MC_T
    q_len = rng.integers(2, MC_W + 1, MC_B)
    word_ids = np.where(np.arange(MC_W)[None] < q_len[:, None],
                        rng.integers(1, 40, (MC_B, MC_W)), 0).astype(np.int32)
    char_ids = rng.integers(1, 30, (MC_B, MC_W, MC_C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    feats = rng.normal(size=(MC_B, MC_T, MC_V)).astype(np.float32)
    feats[np.arange(MC_T)[None] >= v_len[:, None]] = 0.0
    s = rng.integers(0, v_len).astype(np.int32)
    return {"features": feats, "feat_rows": np.arange(MC_B, dtype=np.int32),
            "v_len": v_len, "word_ids": word_ids, "char_ids": char_ids,
            "s_ind": s, "e_ind": np.minimum(s + 3, v_len - 1).astype(np.int32),
            "duration": rng.uniform(5, 30, MC_B).astype(np.float32)}


def _mean_z(a, b, vmask):
    n = a.shape[0]
    se = np.sqrt(a.std(0, ddof=1) ** 2 / n + b.std(0, ddof=1) ** 2 / n)
    return (np.abs(a.mean(0) - b.mean(0)) / np.maximum(se, 1e-9))[vmask]


def _spearman(x, y) -> float:
    rx = np.argsort(np.argsort(x)).astype(np.float64)
    ry = np.argsort(np.argsort(y)).astype(np.float64)
    return float(np.corrcoef(rx, ry)[0, 1])


def assert_mc_in_distribution(p: dict, n_passes: int = N_PASSES) -> None:
    """``p``: ``n_passes`` stochastic start and end logits of each package,
    (n_passes, MC_B, MC_T) each (``jax_s``, ``jax_e``, ``ours_s``,
    ``ours_e``), consecutive pairs being one sweep's two passes, with
    ``v_len`` and ``vmask``; held to the bounds above."""
    vmask = p["vmask"]
    nvalid = vmask.sum(1)
    for side in ("s", "e"):
        a, b = p[f"jax_{side}"], p[f"ours_{side}"]
        assert a.shape == b.shape == (n_passes, MC_B, MC_T)
        assert np.median(b.std(0, ddof=1)[vmask]) > 0.05          # live passes
        z = _mean_z(a, b, vmask)
        assert np.percentile(z, 99) < 4.0 and z.max() < 6.0, (side, z.max())
        pa = np.sqrt((a.std(0, ddof=1) ** 2 * vmask).sum(1) / nvalid)
        pb = np.sqrt((b.std(0, ddof=1) ** 2 * vmask).sum(1) / nvalid)
        ratio = pa / pb
        assert 0.7 < ratio.min() and ratio.max() < 1.4, (side, ratio.min(), ratio.max())

    def uncert_video(S, E):
        uv = [model_uncertainty_batch(S[i], E[i], S[i + 1], E[i + 1],
                                      p["v_len"]).sum(1)
              for i in range(0, n_passes, 2)]
        return np.mean(uv, axis=0)

    uv_jax = uncert_video(p["jax_s"], p["jax_e"])
    uv_ours = uncert_video(p["ours_s"], p["ours_e"])
    rel = np.abs(uv_jax - uv_ours) / uv_jax
    assert _spearman(uv_jax, uv_ours) >= 0.85
    assert np.median(rel) < 0.2 and rel.max() < 0.5, (np.median(rel), rel.max())
