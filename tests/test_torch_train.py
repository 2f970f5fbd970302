"""The port's ``Trainer.train`` on the CPU, and its live MC passes against
``hual_tpu``'s.

On a ``tools/make_synthetic_data`` set (48 train / 24 test queries, T=16,
D=32), ``span_decode: pallas`` and ``sweep_backend: fused`` (the kernels'
plain versions on the CPU):

* training learns: the last epoch's mean loss is below the first's;
* the best checkpoint is written, and ``restore()`` brings its params back
  exactly (test metrics equal to the best epoch's);
* ``save_state`` / ``load_state`` round-trip bit for bit;
* a run stopped after epoch 1 and resumed in a fresh ``Trainer`` from the
  periodic state save ends bit-equal to the uninterrupted run (params,
  step, best R@1@0.7 and the best checkpoint; the counterpart of
  ``tests/test_train_e2e.py``'s resume test);
* a resume whose threshold is above what it reaches leaves the best
  checkpoint untouched;
* MC passes at mc 0.5: 64 passes of the port's AL sweep against 64 of
  ``hual_tpu``'s infer step on the same weights and batch, held to the
  distributional bounds of ``docs/PARITY.md`` as ``tests/test_golden_mc.py``
  computes them (z p99 < 4, z max < 6, noise std ratio in [0.7, 1.4],
  acquisition Spearman >= 0.85, rel diff median < 0.2 and max < 0.5);
* the port's mc-0.5 pickle drives ``hual_tpu.active.engine.update_labels``.
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

from hual_tpu.active.engine import update_labels  # noqa: E402
from hual_tpu.active.uncertainty import model_uncertainty_batch  # noqa: E402
from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN  # noqa: E402
from hual_tpu.runtime import steps as jsteps  # noqa: E402
from hual_tpu.serve import _flatten_params  # noqa: E402
from hual_tpu.utils.io import load_json  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.models.seqpan import SeqPAN  # noqa: E402
from hual_tpu_torch.runtime import steps  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from hual_tpu_torch.weights import load_jax_params, to_jax_params  # noqa: E402

LOGGER = logging.getLogger("test_torch_train")


def _config(root: str, ckpt: str, **train) -> Config:
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
    root = str(tmp_path_factory.mktemp("torch_train"))
    make_dataset(root, task="charades", n_train=48, n_test=24, vdim=32,
                 max_raw_len=24, seed=7)
    cfg = _config(root, os.path.join(root, "ckpt"))
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    return root, dataset, store


def _trainer(world, ckpt: str, **train) -> Trainer:
    root, dataset, store = world
    tr = Trainer(_config(root, ckpt, **train), dataset, store, logger=LOGGER,
                 device="cpu")
    tr.init_state()
    return tr


@pytest.fixture(scope="module")
def trained(world, tmp_path_factory):
    work = tmp_path_factory.mktemp("trained")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)                                  # train() writes ./logs
    try:
        tr = _trainer(world, str(work / "ckpt"))
        best = tr.train()
        tr.close()
        with open(work / "logs" / "charades" / "metrics_re0.jsonl") as f:
            records = [json.loads(line) for line in f]
    finally:
        mp.undo()
    return tr, best, records


def _params(tr: Trainer) -> dict:
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_training_learns(trained):
    tr, best, records = trained
    epochs = [r for r in records if r["kind"] == "epoch"]
    assert [r["epoch"] for r in epochs] == [0, 1, 2]
    losses = [r["train"]["loss"] for r in epochs]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert records[-1]["kind"] == "best"
    assert tr.state.step == 3 * 6 and tr.state.epoch == 3
    assert best["r1i7"] == tr.state.best_r1i7 >= 0.0


def test_best_checkpoint_restores(trained):
    tr, best, _ = trained
    path = os.path.join(os.path.abspath(tr.config.model_dir()), "best.npz")
    assert os.path.exists(path)
    with np.load(path) as flat:
        saved = dict(flat)
    final = _params(tr)
    tr.init_state(seed=99)                         # other weights
    tr.restore(path)
    for k, v in to_jax_params(tr.model).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert tr.test() == best["test_metrics"]
    tr.model.load_state_dict(final)


def test_state_round_trips(world, tmp_path):
    a = _trainer(world, str(tmp_path / "ckpt"), epochs=1)
    a.state.step, a.state.best_r1i7, a.state.epoch = 7, 12.5, 1
    with torch.no_grad():
        for mu in a.state.opt.mu:
            mu.normal_()
    a.save_state(str(tmp_path / "state.pt"))
    b = _trainer(world, str(tmp_path / "ckpt"), epochs=1, seed=3)
    b.init_state(seed=5)
    b.load_state(str(tmp_path / "state.pt"))
    _assert_same(_params(a), _params(b))
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
    a = _trainer(world, str(tmp_path / "a"), **run)
    a.train()
    with np.load(tmp_path / "a" / "charades_re0" / "best.npz") as f:
        best_a = dict(f)

    b = _trainer(world, str(tmp_path / "b"), **run)
    with pytest.raises(Preempted):
        b.train(epoch_callback=_stop_after(1))
    state_path = tmp_path / "b" / "charades_re0" / "state.pt"
    assert state_path.exists()
    c = _trainer(world, str(tmp_path / "b"), **run)
    c.init_state(seed=1)                           # the resume overwrites it
    c.load_state(str(state_path))
    assert (c.state.epoch, c.state.step) == (2, 12)
    c.train()
    _assert_same(_params(a), _params(c))
    assert c.state.step == a.state.step == 24
    assert c.state.best_r1i7 == a.state.best_r1i7
    with np.load(tmp_path / "b" / "charades_re0" / "best.npz") as f:
        for k, v in f.items():
            np.testing.assert_array_equal(v, best_a[k], err_msg=k)


def test_resume_keeps_a_better_checkpoint(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = dict(epochs=3, save_state_every=1)
    a = _trainer(world, str(tmp_path / "ckpt"), **run)
    with pytest.raises(Preempted):
        a.train(epoch_callback=_stop_after(0))
    best = tmp_path / "ckpt" / "charades_re0" / "best.npz"
    mtime, content = os.path.getmtime(best), best.read_bytes()
    b = _trainer(world, str(tmp_path / "ckpt"), **run)
    b.load_state(str(tmp_path / "ckpt" / "charades_re0" / "state.pt"))
    b.state.best_r1i7 = 1000.0                    # as if from a better run
    record = b.train()
    assert b.state.epoch == 3
    assert os.path.getmtime(best) == mtime and best.read_bytes() == content
    assert record["improved"] is False and record["epoch"] == -1
    assert record["test_metrics"] == {} and record["train_metrics"] == {}


# -- MC passes against hual_tpu's ------------------------------------------------
MC_B, MC_T, MC_W, MC_C, MC_V, N_PASSES = 32, 16, 6, 5, 48, 64
MC_WIDTHS = dict(dim=32, num_heads=4, attn_layer=1, max_vlen=MC_T, word_dim=20,
                 char_dim=8, num_chars=30)


def _mc_split(rng) -> dict:
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


@pytest.fixture(scope="module")
def mc_passes():
    rng = np.random.default_rng(20260819)
    data = _mc_split(rng)
    wv = rng.normal(size=(40, 20)).astype(np.float32)
    sels = np.arange(MC_B, dtype=np.int32)[None]

    jmodel = JaxSeqPAN(**MC_WIDTHS)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    batch = jsteps.gather_batch(jdata, jnp.asarray(sels[0]), with_labels=False)
    params = jmodel.init({"params": jax.random.key(0)}, batch, wv, 0.0,
                         deterministic=True)
    step = jax.jit(jsteps.make_infer_step(jmodel, mc_droprate=0.5))
    ref = [step(params, batch, wv, jax.random.key(i)) for i in range(N_PASSES // 2)]

    model = load_jax_params(SeqPAN(vdim=MC_V, **MC_WIDTHS), _flatten_params(params))
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    ours = [steps.infer_sweep(model, tdata, torch.from_numpy(sels), torch.from_numpy(wv),
                              mc_droprate=0.5, seed=i) for i in range(N_PASSES // 2)]

    def stack(outs, key, getter):
        return np.stack([getter(o[f"{key}_logits{k}"]) for o in outs for k in (1, 2)])

    vmask = np.arange(MC_T)[None, :] < data["v_len"][:, None]
    return {"jax_s": stack(ref, "start", np.asarray),
            "jax_e": stack(ref, "end", np.asarray),
            "ours_s": stack(ours, "start", lambda t: t[0].numpy()),
            "ours_e": stack(ours, "end", lambda t: t[0].numpy()),
            "v_len": data["v_len"], "vmask": vmask}


def _mean_z(a, b, vmask):
    se = np.sqrt(a.std(0, ddof=1) ** 2 / N_PASSES + b.std(0, ddof=1) ** 2 / N_PASSES)
    return (np.abs(a.mean(0) - b.mean(0)) / np.maximum(se, 1e-9))[vmask]


def _spearman(x, y) -> float:
    rx = np.argsort(np.argsort(x)).astype(np.float64)
    ry = np.argsort(np.argsort(y)).astype(np.float64)
    return float(np.corrcoef(rx, ry)[0, 1])


def test_mc_passes_match_jax_in_distribution(mc_passes):
    p, vmask = mc_passes, mc_passes["vmask"]
    nvalid = vmask.sum(1)
    for side in ("s", "e"):
        a, b = p[f"jax_{side}"], p[f"ours_{side}"]
        assert a.shape == b.shape == (N_PASSES, MC_B, MC_T)
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
              for i in range(0, N_PASSES, 2)]
        return np.mean(uv, axis=0)

    uv_jax = uncert_video(p["jax_s"], p["jax_e"])
    uv_ours = uncert_video(p["ours_s"], p["ours_e"])
    rel = np.abs(uv_jax - uv_ours) / uv_jax
    assert _spearman(uv_jax, uv_ours) >= 0.85
    assert np.median(rel) < 0.2 and rel.max() < 0.5, (np.median(rel), rel.max())


def test_mc_pickle_drives_update_labels(world, tmp_path):
    root, dataset, store = world
    base = tmp_path / "loop"
    for sub in ("charades_gt", "charades_re0"):
        shutil.copytree(os.path.join(root, "data", sub), base / "data" / sub)
    tr = _trainer(world, str(tmp_path / "ckpt"), mc_droprate=0.5)
    pkl = base / "results" / "charades" / "re0.pkl"
    tr.infer_trainset(save_path=str(pkl))
    stats = update_labels("charades", 1, data_root=str(base / "data"),
                          results_root=str(base / "results"))
    assert len(stats["selected_idx"]) > 0
    records = load_json(str(base / "data" / "charades_re1" / "train.json"))
    assert len(records) == len(dataset["train_set"])
