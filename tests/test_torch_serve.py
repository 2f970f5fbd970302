"""The port's serving Predictor vs the JAX package's, on real bundles.

A bundle written by ``hual_tpu``'s own ``export_bundle`` (an initialised,
untrained Trainer on the synthetic corpus) serves the same raw requests
through both Predictors, with ``model.span_decode`` xla and pallas; a bundle
written by the port's ``export_model_bundle`` serves in ``hual_tpu`` too.
The trainer-facing API: a bundle of either package's
``export_bundle(trainer)`` (the port's Trainer on the same params) serves
in both; ``Predictor.from_trainer``'s spans equal the trainer's own eval
path on the packed test split (the counterpart of ``tests/test_serve.py``'s
``test_bundle_matches_trainer_eval_path``) and its exported bundle's.
Indices and lengths are exact, times within rtol 1e-6, scores within atol
1e-5 (the frameworks sum the forward in different orders).
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu.config import (Config, LossConfig, ModelConfig,  # noqa: E402
                             PathsConfig, TrainConfig)
from hual_tpu.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu.data.features import FeatureStore  # noqa: E402
from hual_tpu.runtime.trainer import Trainer  # noqa: E402
from hual_tpu.serve import Predictor as JaxPredictor  # noqa: E402
from hual_tpu.serve import _flatten_params  # noqa: E402
from hual_tpu.serve import export_bundle as jax_export_bundle  # noqa: E402
from hual_tpu.utils.io import load_json  # noqa: E402
from hual_tpu_torch import serve  # noqa: E402
from hual_tpu_torch.config import Config as PortConfig  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore as PortFeatureStore  # noqa: E402
from hual_tpu_torch.models.seqpan import SeqPAN  # noqa: E402
from hual_tpu_torch.runtime import steps  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer as PortTrainer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

BATCH = 4


def _with_decode(src: str, dst: str, decode: str) -> str:
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "meta.json")) as f:
        meta = json.load(f)
    meta["config"]["model"]["span_decode"] = decode
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    return dst


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_serve"))
    # raw videos up to 40 clips > max_vlen 16: downsampling runs
    make_dataset(root, task="charades", n_train=24, n_test=10, vdim=16,
                 max_raw_len=40, seed=11)
    cfg = Config(
        task="charades", suffix="srv",
        paths=PathsConfig(
            ckpt_dir=os.path.join(root, "ckpt"),
            cache_dir=os.path.join(root, "data_pkl"),
            feature_path=os.path.join(root, "data/features/charades_i3d"),
            glove_path=os.path.join(root, "data/glove/glove.840B.300d.txt"),
            train_path=os.path.join(root, "data/charades_re0/train.json"),
            test_path=os.path.join(root, "data/charades_re0/test.json"),
        ),
        train=TrainConfig(epochs=1, batch_size=8, seed=12345),
        model=ModelConfig(name="SeqPAN", max_vlen=16, max_tlen=10, vdim=16,
                          dim=16, num_heads=2, word_dim=300, char_dim=8,
                          attn_layer=1),
        loss=LossConfig(),
    )
    dataset = gen_or_load_dataset(cfg)
    features = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    trainer = Trainer(cfg, dataset, features)
    trainer.init_state()
    base = jax_export_bundle(trainer, os.path.join(root, "bundle"))
    bundles = {d: _with_decode(base, os.path.join(root, f"bundle_{d}"), d)
               for d in ("xla", "pallas")}

    requests = []
    for vid, duration, _gt, sentence in load_json(cfg.paths.test_path):
        feats = np.load(os.path.join(cfg.paths.feature_path, f"{vid}.npy"))
        requests.append((feats, duration, sentence))
    rng = np.random.default_rng(0)
    requests.append((rng.normal(size=(37, 16)).astype(np.float32), 21.5,
                     "zzzunseenword qqqq " + requests[0][2]))
    assert len(requests) % BATCH != 0           # a ragged final chunk
    assert any(r[0].shape[0] > cfg.model.max_vlen for r in requests)
    return {"root": root, "trainer": trainer, "bundles": bundles,
            "requests": requests}


def _assert_same_predictions(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        for key in ("start_index", "end_index", "v_len"):
            assert p[key] == r[key], (key, p, r)
        np.testing.assert_allclose(p["start_time"], r["start_time"], rtol=1e-6)
        np.testing.assert_allclose(p["end_time"], r["end_time"], rtol=1e-6)
        np.testing.assert_allclose(p["score"], r["score"], rtol=0, atol=1e-5)
        assert 0.0 < p["score"] <= 1.0


@pytest.mark.parametrize("decode", ["xla", "pallas"])
def test_port_predictor_serves_jax_bundle(served, decode):
    bundle = served["bundles"][decode]
    ref = JaxPredictor.from_bundle(bundle, batch_size=BATCH)
    port = serve.Predictor.from_bundle(bundle, batch_size=BATCH, device="cpu")
    assert port.model.span_decode == decode
    _assert_same_predictions(port.predict_batch(served["requests"]),
                             ref.predict_batch(served["requests"]))
    single = served["requests"][-1]
    assert port.predict(*single) == port.predict_batch([single])[0]
    assert port.predict_batch([]) == []


def test_encode_query_is_bit_exact(served):
    bundle = served["bundles"]["xla"]
    ref = JaxPredictor.from_bundle(bundle, batch_size=BATCH)
    port = serve.Predictor.from_bundle(bundle, batch_size=BATCH, device="cpu")
    long_query = " ".join(["person"] * 40) + " zzzunseenword."
    for _, _, query in served["requests"] + [(None, 0, long_query)]:
        for a, b in zip(port.encode_query(query), ref.encode_query(query)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=query)
    for feats, _, _ in served["requests"]:
        a, b = port.encode_video(feats), ref.encode_video(feats)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def test_jax_reads_port_bundle(served, tmp_path):
    src = served["bundles"]["pallas"]
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(src, "vocab.json")) as f:
        vocab = json.load(f)
    config = PortConfig.from_dict(meta["config"])
    model = SeqPAN.from_config(config, generator=torch.Generator().manual_seed(5))
    path = serve.export_model_bundle(
        model, str(tmp_path / "port_bundle"), config=config,
        word_dict=vocab["word_dict"], char_dict=vocab["char_dict"],
        word_vectors=np.load(os.path.join(src, "word_vectors.npy")),
        max_wlen=meta["max_wlen"], max_clen=meta["max_clen"])
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f) == meta | {"config": config.to_dict()}
    ref = JaxPredictor.from_bundle(path, batch_size=BATCH)
    port = serve.Predictor.from_bundle(path, batch_size=BATCH, device="cpu")
    _assert_same_predictions(port.predict_batch(served["requests"]),
                             ref.predict_batch(served["requests"]))


def test_predictor_needs_a_card_unless_asked_for_cpu(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Predictor.from_bundle(served["bundles"]["xla"])


@pytest.fixture(scope="module")
def port_trainer(served):
    """The port's Trainer on the served corpus with the JAX trainer's
    params, decoding with K1's wrapper (its plain version here)."""
    jt = served["trainer"]
    cfg = PortConfig.from_dict(jt.config.to_dict())
    cfg.model.span_decode = "pallas"
    store = PortFeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    tr = PortTrainer(cfg, jt.dataset, store, device="cpu")
    tr.load_params(_flatten_params(jax.device_get(jt.state.params)))
    return tr


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trainer_bundles_serve_in_both(served, port_trainer, tmp_path, writer):
    path = str(tmp_path / "bundle")
    if writer == "port":
        assert serve.export_bundle(port_trainer, path) == path
    else:
        jax_export_bundle(served["trainer"], path)
    ref = JaxPredictor.from_bundle(path, batch_size=BATCH)
    port = serve.Predictor.from_bundle(path, batch_size=BATCH, device="cpu")
    _assert_same_predictions(port.predict_batch(served["requests"]),
                             ref.predict_batch(served["requests"]))


def test_from_trainer_matches_trainer_eval_path(served, port_trainer, tmp_path):
    pred = serve.Predictor.from_trainer(port_trainer, batch_size=BATCH)
    assert pred.device == port_trainer.device and pred.model.span_decode == "pallas"
    requests = served["requests"][:-1]          # the test split, in order
    preds = pred.predict_batch(requests)
    ds = port_trainer.test_set
    assert len(preds) == len(ds)
    out = steps.eval_step(port_trainer.model,
                          steps.gather_batch(port_trainer._test_data,
                                             torch.arange(len(ds))),
                          port_trainer.word_vectors)
    for i, p in enumerate(preds):
        assert p["start_index"] == int(out["start_index"][i]), i
        assert p["end_index"] == int(out["end_index"][i]), i
        assert p["v_len"] == int(ds.v_len[i])
    bundle = serve.export_bundle(port_trainer, str(tmp_path / "bundle"))
    assert serve.Predictor.from_bundle(bundle, batch_size=BATCH,
                                       device="cpu").predict_batch(requests) == preds
    param = next(port_trainer.model.parameters())
    kept = param.detach().clone()
    with torch.no_grad():                       # the Predictor holds a copy
        param.add_(1.0)
    try:
        assert pred.predict_batch(requests) == preds
    finally:
        with torch.no_grad():
            param.copy_(kept)
