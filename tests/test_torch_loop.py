"""The whole round loop of both packages on one tiny synthetic set.

``hual_tpu.orchestrate.run_rounds`` and ``hual_tpu_torch.orchestrate.
run_rounds`` (on the CPU) run rounds 1 and 2 from the same round-0 pickle,
at drop rate 0 and ``mc_droprate`` 0, 1 epoch a round, ``span_decode:
xla``; each round's trainer of the port starts from the params that
``hual_tpu``'s drew for that round (``load_params``), with ``label_emb``
moved off its orthogonal init in both: there the penalty's gradient is
rounding noise, which BERT-AdamW's normalized step turns into full-size
updates in a direction of each framework's own (see
``tests/test_torch_train_step.py``).  Then:

* round 1's ``train.json`` is byte-identical and its label stats equal
  exactly (the same pickle through two engines);
* the trained models agree: best-epoch and infer metrics within 1e-6,
  the round pickles' logits within rtol 1e-3 / atol 1e-4 and their spans
  equal;
* round 2's ``train.json`` (each package's own round-1 pickle through its
  own engine) is identical, except for a record where a near-tie of the
  decoded spans flipped, which the test names; the rest must match.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import warnings

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

import hual_tpu.cli as jcli  # noqa: E402
import hual_tpu.orchestrate as jorch  # noqa: E402
import hual_tpu_torch.cli as cli  # noqa: E402
import hual_tpu_torch.orchestrate as orch  # noqa: E402
from hual_tpu.config import Config as JaxConfig  # noqa: E402
from hual_tpu.serve import _flatten_params, _unflatten_like  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.utils.io import load_json, load_pickle  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

CONFIG = {
    "task": "charades",
    "paths": {"ckpt_dir": "./ckpt", "cache_dir": "./data_pkl/",
              "feature_path": "./data/features/charades_i3d",
              "glove_path": "./data/glove/glove.840B.300d.txt",
              "train_path": "./data/charades_gt/train.json",
              "test_path": "./data/charades_gt/test.json"},
    "train": {"epochs": 1, "batch_size": 4, "lr": 1e-3, "droprate": 0.0,
              "mc_droprate": 0.0, "seed": 12345},
    "model": {"max_vlen": 16, "max_tlen": 10, "vdim": 16, "dim": 16,
              "num_heads": 2, "char_dim": 4, "attn_layer": 1, "span_decode": "xla"},
}


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("torch_loop_data"))
    make_dataset(src, task="charades", n_train=20, n_test=8, vdim=16,
                 max_raw_len=20, seed=21)
    # the round-0 pickle both loops start from: the port's Trainer at
    # mc_droprate 0.5, so the first ranking is not the dataset order
    cfg0 = Config.from_dict(CONFIG).derive_round(0, data_root=os.path.join(src, "data"))
    cfg0.paths.feature_path = os.path.join(src, "data/features/charades_i3d")
    cfg0.paths.glove_path = os.path.join(src, "data/glove/glove.840B.300d.txt")
    cfg0.paths.cache_dir = os.path.join(src, "data_pkl")
    cfg0.train.mc_droprate = 0.5
    t0 = cli.build_trainer(cfg0, device="cpu")
    t0.init_state()
    re0 = os.path.join(src, "re0.pkl")
    t0.infer_trainset(save_path=re0, seed=5)

    init_params = {}

    def jax_build(cfg, **kw):
        tr = jax_build_real(cfg, **kw)
        init = tr.init_state

        def init_state(seed=None):
            state = init(seed)
            flat = _flatten_params(jax.device_get(state.params))
            emb = flat["params/label_emb"]
            flat["params/label_emb"] = (emb + 0.1 * np.random.default_rng(3).normal(
                size=emb.shape)).astype(np.float32)
            state.params = jax.device_put(_unflatten_like(state.params, flat), tr._repl)
            init_params[cfg.suffix] = flat
            return state

        tr.init_state = init_state
        return tr

    def port_build(cfg, **kw):
        tr = port_build_real(cfg, **kw)
        tr.init_state = lambda seed=None: tr.load_params(init_params[cfg.suffix])
        return tr

    jax_build_real, port_build_real = jcli.build_trainer, cli.build_trainer
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.setattr(jcli, "build_trainer", jax_build)
        mp.setattr(cli, "build_trainer", port_build)
        for name, config_cls, run in (("jax", JaxConfig, jorch.run_rounds),
                                      ("port", Config, orch.run_rounds)):
            root = os.path.join(src, name)
            shutil.copytree(os.path.join(src, "data"), os.path.join(root, "data"))
            os.makedirs(os.path.join(root, "results", "charades"))
            shutil.copy(re0, os.path.join(root, "results", "charades", "re0.pkl"))
            mp.chdir(root)
            base_path = os.path.join("configs", "charades", "SeqPAN.yaml")
            config_cls.from_dict(CONFIG).save(base_path)
            kw = {"device": "cpu"} if name == "port" else {}
            history = run("charades", rounds=2, base_config_path=base_path, **kw)
            out[name] = {"history": json.loads(json.dumps(history)), "root": root}
    finally:
        mp.undo()
    return out


def _read(root: str, rel: str) -> bytes:
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


def test_round_one_labels_identical(loops):
    jax_, port = loops["jax"], loops["port"]
    for split in ("train", "test"):
        rel = os.path.join("data", "charades_re1", f"{split}.json")
        assert _read(port["root"], rel) == _read(jax_["root"], rel)
    assert port["history"][0]["label_stats"] == jax_["history"][0]["label_stats"]


@pytest.mark.parametrize("round_idx", [1, 2])
def test_trained_rounds_agree(loops, round_idx):
    jax_, port = (loops[k]["history"][round_idx - 1] for k in ("jax", "port"))
    for part in ("infer", "best"):
        got = port[part] if part == "infer" else port[part]["test_metrics"]
        want = jax_[part] if part == "infer" else jax_[part]["test_metrics"]
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) < 1e-6, (part, k, got, want)
    assert port["best"]["epoch"] == jax_["best"]["epoch"]
    rel = os.path.join("results", "charades", f"re{round_idx}.pkl")
    got, want = (load_pickle(os.path.join(loops[k]["root"], rel)) for k in ("port", "jax"))
    assert [g["vid"] for g in got] == [w["vid"] for w in want]
    for g, w in zip(got, want):
        assert g["prop_idx"] == w["prop_idx"], g["vid"]
        for key in ("prop_logits", "prop_logits1", "prop_logits2"):
            for a, b in zip(g[key], w[key]):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_round_two_labels_identical(loops):
    """Round 2 reads each package's own round-1 pickle."""
    jax_, port = loops["jax"], loops["port"]
    rel = os.path.join("data", "charades_re2", "train.json")
    got, want = load_json(os.path.join(port["root"], rel)), load_json(
        os.path.join(jax_["root"], rel))
    assert len(got) == len(want) == 20
    flipped = [w[0] for g, w in zip(got, want) if g != w]
    assert len(flipped) <= 1, f"records differ: {flipped}"
    if flipped:
        warnings.warn(f"a near-tie flipped record {flipped[0]}; the other "
                      f"{len(got) - 1} records are equal")
        return
    assert _read(port["root"], rel) == _read(jax_["root"], rel)
    assert (port["history"][1]["label_stats"]["selection_overlap_prev"]
            == jax_["history"][1]["label_stats"]["selection_overlap_prev"])
