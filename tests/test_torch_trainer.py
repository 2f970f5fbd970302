"""The port's sweep Trainer against ``hual_tpu``'s on one synthetic dataset.

``hual_tpu``'s ``Trainer.init_state`` draws the params; the port's Trainer
loads them (``load_params``) and runs ``test()`` and ``infer_trainset()``
with both sweep backends, on the CPU.  Metrics agree within 1e-6; the
pickle has ``hual_tpu``'s keys, value types and dtypes, its logits agree
within rtol 1e-4 / atol 2e-4, match scores within atol 1e-5 and indices
exactly; ``hual_tpu``'s and the port's ``update_labels`` write the same
``train.json`` from either pickle.  Also: the live MC passes written to the pickle, the
weights rule and the training entry points, and the device rule (the card
unless ``device="cpu"``).  Host streaming and ``fold_mc`` are in
``test_torch_streaming.py`` and ``test_torch_fold_mc.py``.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu.active.engine import update_labels  # noqa: E402
from hual_tpu.config import Config as JaxConfig  # noqa: E402
from hual_tpu.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu.data.features import FeatureStore as JaxFeatureStore  # noqa: E402
from hual_tpu.runtime.trainer import Trainer as JaxTrainer  # noqa: E402
from hual_tpu.serve import _flatten_params  # noqa: E402
from hual_tpu.utils.io import load_json, load_pickle  # noqa: E402
from hual_tpu_torch.active.engine import update_labels as port_update_labels  # noqa: E402
from hual_tpu_torch.config import Config, resolve_device  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset as port_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.runtime import trainer as trainer_module  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

LOGGER = logging.getLogger("test_torch_trainer")


def _config(root: str, **train) -> dict:
    return {
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        # eval and infer batches that leave a ragged, padded final batch
        "train": dict({"batch_size": 6, "eval_batch_size": 5,
                       "infer_batch_size": 7}, **train),
        "model": {"max_vlen": 8, "max_tlen": 8, "vdim": 16, "dim": 16,
                  "num_heads": 2, "word_dim": 300, "char_dim": 4,
                  "attn_layer": 1, "span_decode": "pallas"},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_trainer"))
    make_dataset(root, task="charades", n_train=23, n_test=12, vdim=16,
                 max_raw_len=12, seed=3)
    cfg = JaxConfig.from_dict(_config(root))
    dataset = gen_or_load_dataset(cfg)
    store = JaxFeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    jt = JaxTrainer(cfg, dataset, store)
    jt.init_state()
    metrics = jt.test()
    jax_pkl = os.path.join(root, "results_jax", "charades", "re0.pkl")
    infer_metrics = jt.infer_trainset(save_path=jax_pkl)
    flat = _flatten_params(jax.device_get(jt.state.params))
    jt.close()
    return root, dataset, flat, metrics, infer_metrics, jax_pkl


def _port(world, backend: str = "flax", **train) -> Trainer:
    root, dataset, flat, *_ = world
    cfg = Config.from_dict(_config(root, sweep_backend=backend, **train))
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    tr = Trainer(cfg, dataset, store, logger=LOGGER, device="cpu")
    tr.load_params(flat)
    return tr


@pytest.mark.parametrize("backend", ["flax", "fused"])
def test_test_metrics_match(world, backend):
    metrics = _port(world, backend).test()
    assert set(metrics) == set(world[3])
    for k, v in world[3].items():
        assert abs(metrics[k] - v) < 1e-6, (k, metrics, world[3])


@pytest.mark.parametrize("backend", ["flax", "fused"])
def test_infer_trainset_pickle_matches(world, backend, tmp_path):
    path = str(tmp_path / "re0.pkl")
    metrics = _port(world, backend).infer_trainset(save_path=path)
    for k, v in world[4].items():
        assert abs(metrics[k] - v) < 1e-6, k
    got, want = load_pickle(path), load_pickle(world[5])
    assert len(got) == len(want) == 23
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert type(g[key]) is type(w[key]), key
        for key in ("vid", "duration", "psuedo_idx", "sentence", "v_len",
                    "prop_idx"):
            assert g[key] == w[key], key
        assert all(type(i) is int for i in g["prop_idx"] + g["psuedo_idx"])
        for key in ("prop_logits", "prop_logits1", "prop_logits2"):
            for a, b in zip(g[key], w[key]):
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4)
        assert g["m_score"].dtype == np.float32
        np.testing.assert_allclose(g["m_score"], w["m_score"], rtol=0, atol=1e-5)


def test_update_labels_reads_the_port_pickle(world, tmp_path):
    """Both engines (``hual_tpu.active`` and the port's ``active``) on both
    pickles (``hual_tpu``'s and the port's): one train.json, byte for byte."""
    root, *_, jax_pkl = world
    stats, files = {}, {}
    for name, make in (("jax", lambda p: shutil.copy(jax_pkl, p)),
                       ("port", lambda p: _port(world, "fused").infer_trainset(
                           save_path=p))):
        for engine, update in (("jax", update_labels),
                               ("port", port_update_labels)):
            base = tmp_path / name / engine
            for sub in ("charades_gt", "charades_re0"):
                shutil.copytree(os.path.join(root, "data", sub), base / "data" / sub)
            pkl = base / "results" / "charades" / "re0.pkl"
            pkl.parent.mkdir(parents=True)
            make(str(pkl))
            stats[name, engine] = update("charades", 1, data_root=str(base / "data"),
                                         results_root=str(base / "results"))
            path = base / "data" / "charades_re1" / "train.json"
            stats[name, engine]["records"] = load_json(str(path))
            files[name, engine] = path.read_bytes()
    for name in ("jax", "port"):
        assert files[name, "port"] == files[name, "jax"], name
        assert stats[name, "port"]["selected_idx"] == stats[name, "jax"]["selected_idx"]
    assert stats["port", "port"]["selected_idx"] == stats["jax", "jax"]["selected_idx"]
    assert len(stats["port", "port"]["selected_idx"]) > 0
    assert stats["port", "port"]["records"] == stats["jax", "jax"]["records"]


def test_init_state_is_seeded_and_table_is_reused(world):
    a = _port(world)
    a.init_state()
    b = Trainer(a.config, a.dataset, a.features, logger=LOGGER, device="cpu",
                device_features=a.export_device_features())
    b.init_state()
    assert b.export_device_features()[0] is a.export_device_features()[0]
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert a.test() == b.test()
    b.init_state(seed=7)
    assert any(not torch.equal(pa, pb) for pa, pb in
               zip(a.model.parameters(), b.model.parameters()))


@pytest.mark.parametrize("feature_dtype", ["bfloat16", "int8"])
def test_compressed_feature_tables(world, feature_dtype):
    root, dataset, flat, *_ = world
    cfg = Config.from_dict(_config(root))
    cfg.model.feature_dtype = feature_dtype
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    tr = Trainer(cfg, dataset, store, logger=LOGGER, device="cpu")
    tr.load_params(flat)
    table, scales = tr.export_device_features()
    assert table.dtype == {"bfloat16": torch.bfloat16, "int8": torch.int8}[feature_dtype]
    assert (scales is not None) == (feature_dtype == "int8")
    metrics = tr.test()
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("backend", ["flax", "fused"])
def test_stochastic_infer_writes_live_passes(world, backend, tmp_path):
    """mc_droprate 0.5 and the gumbel head write pickles whose MC logits
    are live passes, while the clean pass stays the JAX package's."""
    want = load_pickle(world[5])
    path = str(tmp_path / "mc.pkl")
    metrics = _port(world, backend, mc_droprate=0.5).infer_trainset(save_path=path)
    for k, v in world[4].items():
        assert abs(metrics[k] - v) < 1e-6, k
    got = load_pickle(path)
    for g, w in zip(got, want):
        assert g["prop_idx"] == w["prop_idx"]
        for a, b in zip(g["prop_logits"], w["prop_logits"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4)
        for k in ("prop_logits1", "prop_logits2"):
            assert all(a.dtype == np.float32 and np.isfinite(a).all() for a in g[k])
    assert any(not np.array_equal(g["prop_logits1"][0], g["prop_logits"][0])
               for g in got)
    assert any(not np.array_equal(g["prop_logits1"][1], g["prop_logits2"][1])
               for g in got)

    root, dataset, flat, *_ = world
    d = _config(root, sweep_backend=backend)
    d["loss"] = {"no_gumbel": False}
    cfg = Config.from_dict(d)
    tr = Trainer(cfg, dataset, FeatureStore.from_dir(cfg.paths.feature_path, 8),
                 logger=LOGGER, device="cpu")
    tr.load_params(flat)
    tr.test()
    tr.infer_trainset(save_path=str(tmp_path / "gumbel.pkl"))
    got = load_pickle(str(tmp_path / "gumbel.pkl"))
    assert any(not np.array_equal(g["prop_logits1"][0], g["prop_logits2"][0])
               for g in got)


def test_weights_are_required_and_training_runs(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                     # train() writes ./logs
    root, dataset, *_ = world
    cfg = Config.from_dict(_config(root, epochs=1))
    cfg.paths.ckpt_dir = str(tmp_path / "ckpt")
    tr = Trainer(cfg, dataset, FeatureStore.from_dir(cfg.paths.feature_path, 8),
                 logger=LOGGER, device="cpu")
    with pytest.raises(RuntimeError, match="init_state"):
        tr.test()
    with pytest.raises(RuntimeError, match="init_state"):
        tr.save_state(str(tmp_path / "s.pt"))
    with pytest.raises(ValueError, match="no pre-trained model"):
        tr.restore()
    best = tr.train()                               # initialises on its own
    assert tr.state.epoch == 1 and tr.state.step == 4   # ceil(23 / 6)
    assert best["improved"] and best["epoch"] == 0  # any R@1 beats -1
    tr.save_state(str(tmp_path / "s.pt"))
    tr.load_state(str(tmp_path / "s.pt"))
    tr.restore()
    tr.close()


def test_trainer_needs_a_card_unless_cpu(world, monkeypatch):
    root, dataset, *_ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.from_dict(_config(root))
    store = FeatureStore.from_dir(cfg.paths.feature_path, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, dataset, store, logger=LOGGER)
    assert resolve_device("cpu").type == "cpu"
    tr = Trainer(cfg, dataset, store, logger=LOGGER, device="cpu")
    assert tr.word_vectors.device.type == "cpu"
    assert tr.export_device_features()[0].device.type == "cpu"


@pytest.mark.parametrize("max_vlen,dim", [(128, 16), (8, 132)])
def test_fused_trainer_past_k2s_old_limit(world, max_vlen, dim):
    """K2 on the card took T and W up to 100 and D a multiple of 4 up to 128
    until its stages tiled, and a fused Trainer on ``cuda`` checked that
    limit when it was built.  Now nothing refuses one at such a shape: the
    check is gone, and the fused Trainer's test sweep (K2's plain version
    on the CPU, as on the card past the old limit) gives the R@1 and mIoU
    of the flax backend's on the same weights."""
    assert not hasattr(trainer_module, "check_fused_shape")
    root = world[0]
    metrics, state = {}, None
    for backend in ("flax", "fused"):
        cfg = Config.from_dict(_config(root, sweep_backend=backend))
        cfg.model.max_vlen, cfg.model.dim = max_vlen, dim
        dataset = port_dataset(cfg)
        store = FeatureStore.from_dir(cfg.paths.feature_path, max_vlen)
        tr = Trainer(cfg, dataset, store, logger=LOGGER, device="cpu")
        assert tr._fused == (backend == "fused")
        tr.init_state()
        if state is None:
            state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        metrics[backend] = tr.test()
        assert all(np.isfinite(v) for v in metrics[backend].values()), metrics
        tr.close()
    assert metrics["fused"] == metrics["flax"]
