"""The port's ``Trainer.train`` on the CPU, and its live MC passes against
``hual_tpu``'s.

On a ``tools/make_synthetic_data`` set (48 train / 24 test queries, T=16,
D=32), ``span_decode: pallas`` and ``sweep_backend: fused`` (the kernels'
plain versions on the CPU):

* training learns: the last epoch's mean loss is below the first's;
* the best checkpoint is written, and ``restore()`` brings its params back
  exactly (test metrics equal to the best epoch's);
* MC passes at mc 0.5: 64 passes of the port's AL sweep against 64 of
  ``hual_tpu``'s infer step on the same weights and batch, held to the
  distributional bounds of ``docs/PARITY.md`` as ``tests/test_golden_mc.py``
  computes them (z p99 < 4, z max < 6, noise std ratio in [0.7, 1.4],
  acquisition Spearman >= 0.85, rel diff median < 0.2 and max < 0.5;
  ``tests/torch_train_helpers.py``);
* the port's mc-0.5 pickle drives ``hual_tpu.active.engine.update_labels``.

The state save and the resume are in ``test_torch_train_resume.py``.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hual_tpu.active.engine import update_labels
from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.runtime import steps as jsteps
from hual_tpu.serve import _flatten_params
from hual_tpu.utils.io import load_json
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.weights import load_jax_params, to_jax_params
from torch_train_helpers import (MC_B, MC_T, MC_V, MC_WIDTHS, N_PASSES,
                                 assert_mc_in_distribution, make_trainer,
                                 mc_split, params_of)
from torch_train_helpers import one_torch_thread, world  # noqa: F401  (fixtures)


@pytest.fixture(scope="module")
def trained(world, tmp_path_factory):
    work = tmp_path_factory.mktemp("trained")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)                                  # train() writes ./logs
    try:
        tr = make_trainer(world, str(work / "ckpt"))
        best = tr.train()
        tr.close()
        with open(work / "logs" / "charades" / "metrics_re0.jsonl") as f:
            records = [json.loads(line) for line in f]
    finally:
        mp.undo()
    return tr, best, records


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
    final = params_of(tr)
    tr.init_state(seed=99)                         # other weights
    tr.restore(path)
    for k, v in to_jax_params(tr.model).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert tr.test() == best["test_metrics"]
    tr.model.load_state_dict(final)


# -- MC passes against hual_tpu's ------------------------------------------------
@pytest.fixture(scope="module")
def mc_passes():
    rng = np.random.default_rng(20260819)
    data = mc_split(rng)
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
    ours = [steps.infer_sweep(model, steps.resident_batches(tdata, torch.from_numpy(sels)),
                              torch.from_numpy(wv), mc_droprate=0.5, seed=i)
            for i in range(N_PASSES // 2)]

    def stack(outs, key, getter):
        return np.stack([getter(o[f"{key}_logits{k}"]) for o in outs for k in (1, 2)])

    vmask = np.arange(MC_T)[None, :] < data["v_len"][:, None]
    return {"jax_s": stack(ref, "start", np.asarray),
            "jax_e": stack(ref, "end", np.asarray),
            "ours_s": stack(ours, "start", lambda t: t.numpy()),
            "ours_e": stack(ours, "end", lambda t: t.numpy()),
            "v_len": data["v_len"], "vmask": vmask}


def test_mc_passes_match_jax_in_distribution(mc_passes):
    assert_mc_in_distribution(mc_passes)


def test_mc_pickle_drives_update_labels(world, tmp_path):
    root, dataset, store = world
    base = tmp_path / "loop"
    for sub in ("charades_gt", "charades_re0"):
        shutil.copytree(os.path.join(root, "data", sub), base / "data" / sub)
    tr = make_trainer(world, str(tmp_path / "ckpt"), mc_droprate=0.5)
    pkl = base / "results" / "charades" / "re0.pkl"
    tr.infer_trainset(save_path=str(pkl))
    stats = update_labels("charades", 1, data_root=str(base / "data"),
                          results_root=str(base / "results"))
    assert len(stats["selected_idx"]) > 0
    records = load_json(str(base / "data" / "charades_re1" / "train.json"))
    assert len(records) == len(dataset["train_set"])
