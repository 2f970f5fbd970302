"""Host streaming in the port's Trainer (counterpart of
``tests/test_host_streaming.py``), on the CPU at a tiny size (dim 16, one
layer, T 16, 32 train and 16 test queries).

* One whole-dataset train step (batch 32), streamed against resident in
  the port: bit-equal params, for an f32 and an int8 table (the streamed
  int8 batch is quantized per clip on the prefetch thread, the resident
  table as a whole: the same values).
* The port's streamed step against ``hual_tpu``'s ``make_train_step`` on
  ``hual_tpu``'s host batch (its labels built on the host in f64), at
  ``tests/test_torch_train_step.py``'s bounds: clipped grads within rtol
  1e-3 / atol 1e-6 * max(1, max|g|), deltas within rtol 2e-2 / atol 1e-5,
  drop rate 0, ``label_emb`` moved off its orthogonal init.
* A bf16 table streams f32 features, as in ``hual_tpu``: a streamed bf16
  step equals a streamed f32 step, not a resident bf16 one.
* Auto mode streams a table over ``train.hbm_budget_gb``; an explicit
  option wins.
* ``sweep_backend: fused`` under streaming falls back to the eager sweeps
  with a warning, builds no device table and ignores one passed in.
* ``run_rounds`` over 2 rounds streams every round and writes the resident
  loop's labels and pickles.
* The streamed AL sweep at ``mc_droprate`` 0.5 writes the resident sweep's
  pickle, sequential and folded.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

import hual_tpu_torch.cli as cli  # noqa: E402
import hual_tpu_torch.orchestrate as orch  # noqa: E402
from hual_tpu.config import Config as JaxConfig  # noqa: E402
from hual_tpu.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu.data.features import FeatureStore as JaxFeatureStore  # noqa: E402
from hual_tpu.data.loader import PackedDataset as JaxPackedDataset  # noqa: E402
from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN  # noqa: E402
from hual_tpu.ops.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from hual_tpu.runtime import steps as jsteps  # noqa: E402
from hual_tpu.serve import _flatten_params, _unflatten_like  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.data.loader import TrainLoader  # noqa: E402
from hual_tpu_torch.runtime import steps  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from hual_tpu_torch.utils.io import load_pickle  # noqa: E402
from hual_tpu_torch.weights import _leaves, to_jax_params  # noqa: E402
from torch_train_helpers import one_torch_thread  # noqa: E402,F401  (a fixture)

LOGGER = logging.getLogger("test_torch_streaming")
N_TRAIN, N_TEST, LR = 32, 16, 2e-3


def _config(root: str, **train) -> dict:
    return {
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        # one whole-dataset step an epoch; eval and infer batches that leave
        # a ragged, padded final batch
        "train": dict({"epochs": 1, "batch_size": N_TRAIN, "lr": LR,
                       "droprate": 0.1, "eval_batch_size": 6,
                       "infer_batch_size": 7, "seed": 12345}, **train),
        "model": {"max_vlen": 16, "max_tlen": 10, "vdim": 16, "dim": 16,
                  "num_heads": 2, "word_dim": 300, "char_dim": 4,
                  "attn_layer": 1, "span_decode": "pallas"},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_streaming"))
    make_dataset(root, task="charades", n_train=N_TRAIN, n_test=N_TEST, vdim=16,
                 max_raw_len=24, seed=3)
    cfg = JaxConfig.from_dict(_config(root))
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    return root, dataset, store


def _trainer(world, feature_dtype: str = "float32", **train) -> Trainer:
    root, dataset, store = world
    cfg = Config.from_dict(_config(root, **train))
    cfg.model.feature_dtype = feature_dtype
    return Trainer(cfg, dataset, store, logger=LOGGER, device="cpu")


def _trained(world, tmp_path, name: str, feature_dtype: str = "float32",
             **train) -> Trainer:
    tr = _trainer(world, feature_dtype, **train)
    tr.config.paths.ckpt_dir = str(tmp_path / name)
    tr.init_state()
    tr.train()
    tr.close()
    return tr


def _same_params(a: Trainer, b: Trainer) -> bool:
    pa, pb = a.model.state_dict(), b.model.state_dict()
    return pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("feature_dtype", ["float32", "int8"])
def test_streamed_step_equals_resident(world, tmp_path, monkeypatch, feature_dtype):
    monkeypatch.chdir(tmp_path)                     # train() writes ./logs
    resident = _trained(world, tmp_path, "resident", feature_dtype,
                        host_streaming=False)
    streamed = _trained(world, tmp_path, "streamed", feature_dtype,
                        host_streaming=True)
    assert streamed.host_streaming and not resident.host_streaming
    assert resident.state.step == streamed.state.step == 1
    assert _same_params(resident, streamed)
    assert resident.test() == streamed.test()
    best = [np.load(tmp_path / name / "charades_re0" / "best.npz")
            for name in ("resident", "streamed")]
    assert set(best[0]) == set(best[1])
    for k in best[0]:
        np.testing.assert_array_equal(best[0][k], best[1][k], err_msg=k)


def test_streamed_step_matches_jax(world, tmp_path, monkeypatch):
    """The port's streamed step (device labels) against ``hual_tpu``'s
    ``make_train_step`` on its host batch (host labels)."""
    root, dataset, _ = world
    monkeypatch.chdir(tmp_path)
    jstore = JaxFeatureStore.from_dir(os.path.join(
        root, "data/features/charades_i3d"), 16)
    jset = JaxPackedDataset(dataset["train_set"], jstore, dataset["max_wlen"],
                            dataset["max_clen"])
    sel = next(TrainLoader(jset, N_TRAIN, seed=12345).index_iter(0))
    jbatch = jset.gather(sel, with_labels=True)
    wv = np.asarray(dataset["word_vector"], np.float32)
    jmodel = JaxSeqPAN(dim=16, num_heads=2, attn_layer=1, max_vlen=16,
                       word_dim=300, char_dim=4, num_chars=dataset["n_chars"],
                       span_decode="xla")
    params = jax.jit(lambda key: jmodel.init({"params": key}, jbatch, wv, 0.0,
                                             deterministic=True))(jax.random.key(1))
    flat = _flatten_params(params)
    emb = flat["params/label_emb"]
    flat["params/label_emb"] = (emb + 0.1 * np.random.default_rng(4).normal(
        size=emb.shape)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, _unflatten_like(params, flat))
    tx = jax_make_optimizer(1.0, 0.01)
    jparams, jopt, _ = jax.jit(jsteps.make_train_step(jmodel, tx, 1.0, 0.0))(
        params, tx.init(params), jbatch, wv, jnp.float32(LR), jax.random.key(0))

    tr = _trainer(world, droprate=0.0, host_streaming=True)
    tr.config.paths.ckpt_dir = str(tmp_path / "ckpt")
    tr.load_params(flat)
    before = to_jax_params(tr.model)
    tr.train()
    tr.close()
    after, jafter = to_jax_params(tr.model), _flatten_params(jparams)
    jmu = _flatten_params(jopt.inner_state[1].mu)
    to_jax = {key: move for key, _, _, move in _leaves(tr.model)}
    for key, mu in zip(tr.state.opt.keys, tr.state.opt.mu):
        g, want = to_jax[key](mu.numpy()) / 0.1, np.asarray(jmu[key]) / 0.1
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-6 * scale,
                                   err_msg=key)
    for key in flat:
        np.testing.assert_allclose(after[key] - before[key],
                                   np.asarray(jafter[key]) - flat[key],
                                   rtol=2e-2, atol=1e-5, err_msg=key)


def test_bf16_table_streams_f32(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    f32 = _trained(world, tmp_path, "f32", host_streaming=True)
    bf16 = _trained(world, tmp_path, "bf16", "bfloat16", host_streaming=True)
    resident = _trained(world, tmp_path, "resident", "bfloat16",
                        host_streaming=False)
    assert _same_params(f32, bf16)
    assert not _same_params(bf16, resident)      # the resident table rounds


def test_auto_mode_streams_over_budget(world):
    assert _trainer(world, hbm_budget_gb=1e-9).host_streaming
    assert not _trainer(world).host_streaming      # 12 GB default
    assert not _trainer(world, hbm_budget_gb=1e-9,
                        host_streaming=False).host_streaming
    assert _trainer(world, host_streaming=True).host_streaming


def test_fused_falls_back_to_flax_with_a_warning(world, caplog, monkeypatch):
    resident = _trainer(world)
    resident.init_state()
    table = resident.export_device_features()

    def fused(*args, **kwargs):
        raise AssertionError("a streaming trainer ran a fused sweep")

    monkeypatch.setattr(steps, "fused_eval_sweep", fused)
    monkeypatch.setattr(steps, "fused_infer_sweep", fused)
    with caplog.at_level(logging.WARNING, logger=LOGGER.name):
        tr = Trainer(Config.from_dict(_config(world[0], sweep_backend="fused",
                                              hbm_budget_gb=1e-9)),
                     world[1], world[2], logger=LOGGER, device_features=table,
                     device="cpu")
    assert tr.host_streaming and tr.export_device_features() is None
    assert [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING] == [
        "train.sweep_backend='fused' requires a device-resident dataset; "
        "host-streaming mode is active, using the flax sweep backend instead"]
    tr.load_params(to_jax_params(resident.model))
    assert tr.test() == resident.test()


@pytest.mark.parametrize("fold_mc", [False, True])
def test_streamed_infer_pickle_equals_resident(world, tmp_path, fold_mc):
    rows = {}
    for hs in (False, True):
        tr = _trainer(world, host_streaming=hs, mc_droprate=0.5, fold_mc=fold_mc)
        tr.init_state()
        path = str(tmp_path / f"{hs}.pkl")
        tr.infer_trainset(save_path=path)
        rows[hs] = load_pickle(path)
    assert len(rows[False]) == len(rows[True]) == N_TRAIN
    for a, b in zip(rows[False], rows[True]):
        assert list(a) == list(b)
        for key, value in a.items():
            if key in ("prop_logits", "prop_logits1", "prop_logits2"):
                for x, y in zip(value, b[key]):
                    assert x.dtype == y.dtype == np.float32
                    np.testing.assert_array_equal(x, y, err_msg=key)
            elif key == "m_score":
                np.testing.assert_array_equal(value, b[key])
            else:
                assert value == b[key], key
    assert any(not np.array_equal(r["prop_logits1"][0], r["prop_logits2"][0])
               for r in rows[True])


LOOP_CONFIG = {
    "task": "charades",
    "paths": {"ckpt_dir": "./ckpt", "cache_dir": "./data_pkl/",
              "feature_path": "./data/features/charades_i3d",
              "glove_path": "./data/glove/glove.840B.300d.txt",
              "train_path": "./data/charades_gt/train.json",
              "test_path": "./data/charades_gt/test.json"},
    "train": {"epochs": 1, "batch_size": 8, "lr": 1e-3, "droprate": 0.1,
              "mc_droprate": 0.5, "seed": 12345},
    "model": {"max_vlen": 16, "max_tlen": 10, "vdim": 16, "dim": 16,
              "num_heads": 2, "char_dim": 4, "attn_layer": 1,
              "span_decode": "pallas"},
}


def test_run_rounds_streams_every_round(world, tmp_path, monkeypatch):
    """Two rounds of ``run_rounds`` streamed and resident from one round-0
    pickle: every streamed round builds no table and is handed none, and
    both loops write the same labels and pickles."""
    src = world[0]
    re0 = tmp_path / "re0.pkl"
    tr = _trainer(world, mc_droprate=0.5)
    tr.init_state()
    tr.infer_trainset(save_path=str(re0), seed=5)

    built = []
    real = cli.build_trainer

    def build(cfg, **kw):
        tr = real(cfg, **kw)
        built.append((tr.host_streaming, kw.get("device_features"),
                      tr.export_device_features()))
        return tr

    monkeypatch.setattr(cli, "build_trainer", build)
    roots = {}
    for hs in (False, True):
        root = tmp_path / ("streamed" if hs else "resident")
        for sub in ("charades_gt", "charades_re0", "features"):
            shutil.copytree(os.path.join(src, "data", sub), root / "data" / sub)
        shutil.copytree(os.path.join(src, "data", "glove"), root / "data" / "glove")
        (root / "results" / "charades").mkdir(parents=True)
        shutil.copy(re0, root / "results" / "charades" / "re0.pkl")
        monkeypatch.chdir(root)
        d = json.loads(json.dumps(LOOP_CONFIG))
        d["train"]["host_streaming"] = hs
        base = os.path.join("configs", "charades", "SeqPAN.yaml")
        Config.from_dict(d).save(base)
        orch.run_rounds("charades", rounds=2, base_config_path=base, device="cpu")
        roots[hs] = root
    assert [b[0] for b in built] == [False, False, True, True]
    assert all(b[1] is None and b[2] is None for b in built[2:])
    assert built[1][1] is not None                 # the resident loop reuses its table
    for rnd in (1, 2):
        files = [(roots[hs] / "data" / f"charades_re{rnd}" / "train.json").read_bytes()
                 for hs in (False, True)]
        assert files[0] == files[1], rnd
        pkls = [load_pickle(str(roots[hs] / "results" / "charades" / f"re{rnd}.pkl"))
                for hs in (False, True)]
        for a, b in zip(*pkls):
            assert a["prop_idx"] == b["prop_idx"]
            for x, y in zip(a["prop_logits"] + a["prop_logits1"],
                            b["prop_logits"] + b["prop_logits1"]):
                np.testing.assert_array_equal(x, y)
