"""The port's AL engine (``hual_tpu_torch.active``) against ``hual_tpu.active``.

Every function of the four modules runs on the same seeded NumPy inputs in
both packages, and the results must be equal exactly: same values, same
dtypes, same Python types.  ``update_labels`` must write a ``train.json``
byte-identical to ``hual_tpu``'s over two rounds, from the same records and
the same round pickles (written by the port's ``Trainer`` on the CPU at
``mc_droprate`` 0.5, so the uncertainty ranking is not the dataset order),
for both selections and all three point strategies.
"""

from __future__ import annotations

import copy
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu.active import coefficients as jcoef  # noqa: E402
from hual_tpu.active import engine as jengine  # noqa: E402
from hual_tpu.active import renew as jrenew  # noqa: E402
from hual_tpu.active import uncertainty as junc  # noqa: E402
from hual_tpu_torch.active import coefficients as coef  # noqa: E402
from hual_tpu_torch.active import engine  # noqa: E402
from hual_tpu_torch.active import renew  # noqa: E402
from hual_tpu_torch.active import uncertainty as unc  # noqa: E402
from hual_tpu_torch.cli import build_trainer  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)


def assert_same(a, b):
    """Equal values of equal types, recursively; arrays also equal dtypes."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def annotations(rng, vlen: int) -> tuple[list[int], list[int]]:
    """A random annotation state: up to 3 positives inside a span and up to
    3 negatives outside it (or anywhere, when there is no positive)."""
    s = int(rng.integers(0, vlen))
    e = int(rng.integers(s, vlen))
    n_pos = int(rng.integers(0, 4))
    pos = [int(p) for p in rng.integers(s, e + 1, n_pos)]
    outside = [i for i in range(vlen) if not (pos and s <= i <= e)]
    n_neg = min(int(rng.integers(0, 4)), len(outside))
    neg = [int(i) for i in rng.choice(outside, n_neg, replace=False)]
    return pos, neg


CASES = [(seed, vlen, max_vlen) for seed, (vlen, max_vlen) in
         enumerate([(16, 16), (9, 16), (1, 8), (2, 2), (64, 64), (37, 64), (100, 100)])]


def test_coefficients_equal():
    assert coef.F_RENEW == jcoef.F_RENEW
    for task in ("charades", "anet"):
        assert coef.max_rounds(coef.F_RENEW, task) == jcoef.max_rounds(jcoef.F_RENEW, task)
        for i in (1, 2, 3, 6, 7, 10):
            got = coef.get_coff(coef.F_RENEW, task, i)
            want = jcoef.get_coff(jcoef.F_RENEW, task, i)
            for branch in ("pos", "neg"):
                for k in ("old", "model", "distance"):
                    assert getattr(getattr(got, branch), k) == getattr(getattr(want, branch), k)
            assert got.uncert == want.uncert
    with pytest.raises(ValueError):
        coef.get_coff(coef.F_RENEW, "charades", 0)


@pytest.mark.parametrize("seed,vlen,max_vlen", CASES)
def test_geometry_equal(seed, vlen, max_vlen):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        pos, neg = annotations(rng, vlen)
        a = unc.fill_isactivate(pos, neg, vlen, max_vlen)
        assert_same(a, junc.fill_isactivate(pos, neg, vlen, max_vlen))
        assert_same(unc.zero_runs(a), junc.zero_runs(a))
        assert_same(unc.distance_score(pos, neg, vlen, max_vlen),
                    junc.distance_score(pos, neg, vlen, max_vlen))
        for shift in (-0.3, 0.9):
            assert_same(unc.distance_score_shift(pos, neg, vlen, max_vlen, shift),
                        junc.distance_score_shift(pos, neg, vlen, max_vlen, shift))
        center = float(rng.uniform(-2, vlen + 2))
        width = float(rng.uniform(0.3, 1.0)) * vlen
        assert_same(unc.center_width_gauss(center, width, vlen, max_vlen),
                    junc.center_width_gauss(center, width, vlen, max_vlen))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_model_uncertainty_equal(dtype):
    rng = np.random.default_rng(5)
    n, t = 33, 64
    s1, e1, s2, e2 = (rng.normal(scale=3, size=(n, t)).astype(dtype) for _ in range(4))
    vlens = rng.integers(1, t + 1, size=n)
    assert_same(unc.sigmoid(s1), junc.sigmoid(s1))
    assert_same(unc.model_uncertainty_batch(s1, e1, s2, e2, vlens),
                junc.model_uncertainty_batch(s1, e1, s2, e2, vlens))


@pytest.mark.parametrize("seed,vlen,max_vlen", CASES)
def test_renewal_equal(seed, vlen, max_vlen):
    rng = np.random.default_rng(100 + seed)
    branches = set()
    for i in range(30):
        pos, neg = annotations(rng, vlen)
        s = rng.uniform(0, 1, max_vlen).astype(np.float32)
        e = rng.uniform(0, 1, max_vlen).astype(np.float32)
        if i % 5 == 0:
            s[: max_vlen // 2] = e[: max_vlen // 2] = 0.5     # ties go first
        assert_same(renew.mask_activepoints(s.copy(), e.copy(), pos, neg, vlen),
                    jrenew.mask_activepoints(s.copy(), e.copy(), pos, neg, vlen))
        assert_same(renew._segmented_span_decode(s, e, sorted(neg), vlen),
                    jrenew._segmented_span_decode(s, e, sorted(neg), vlen))
        assert_same(renew.infer_idx(s, e), jrenew.infer_idx(s, e))
        old = sorted(int(x) for x in rng.integers(0, vlen, 2))
        for r in (1, 2):
            ap = {"pos_idx": list(pos), "neg_idx": list(neg)}
            assert_same(
                renew.renew_label(old, ap, s, e, vlen, max_vlen,
                                  coef.get_coff(coef.F_RENEW, "charades", r)),
                jrenew.renew_label(old, copy.deepcopy(ap), s, e, vlen, max_vlen,
                                   jcoef.get_coff(jcoef.F_RENEW, "charades", r)))
        branches.add(bool(pos))
        point = int(rng.integers(0, vlen))
        gt = sorted(int(x) for x in rng.integers(0, vlen, 2))
        assert_same(renew.append_annotation(point, {"pos_idx": [1], "neg_idx": []}, gt),
                    jrenew.append_annotation(point, {"pos_idx": [1], "neg_idx": []}, gt))
    assert branches == {True, False}              # both renewal branches ran


def _records(rng, n: int, widths: list[int], vlens: list[int]):
    data_old, data_gt, last_prop = [], [], []
    for i, (w, vlen) in enumerate(zip(widths, vlens)):
        dur = round(float(rng.uniform(10, 40)), 2)
        s = round(float(rng.uniform(0, dur / 2)), 2)
        pos, neg = annotations(rng, vlen) if i % 2 else ([], [])
        data_old.append([f"v{i}", dur, [s, round(s + dur / 3, 2)], "q",
                         {"pos_idx": pos, "neg_idx": neg}])
        data_gt.append([f"v{i}", dur, [round(s + 1, 2), round(s + dur / 2, 2)], "q"])
        mk = lambda: rng.normal(scale=2, size=w).astype(np.float32)  # noqa: E731
        last_prop.append({"vid": f"v{i}", "v_len": vlen, "duration": dur,
                          "prop_logits": [mk(), mk()], "prop_logits1": [mk(), mk()],
                          "prop_logits2": [mk(), mk()]})
    return data_old, data_gt, last_prop


@pytest.mark.parametrize("ragged", [False, True])
def test_ranking_and_points_equal(ragged):
    """rank_uncertainty and choose_observation_point, also over a
    reference-style pickle whose rows are ragged (each padded to its own
    batch's max v_len; the case of tests/test_active.py:171)."""
    rng = np.random.default_rng(3 + ragged)
    n, t = 24, 16
    vlens = [int(v) for v in rng.integers(1, t + 1, n)]
    widths = [int(rng.integers(v, t + 1)) for v in vlens] if ragged else [t] * n
    data_old, data_gt, last_prop = _records(rng, n, widths, vlens)
    for r in (1, 2):
        got = engine.rank_uncertainty(copy.deepcopy(data_old), data_gt, last_prop,
                                      coef.get_coff(coef.F_RENEW, "charades", r))
        want = jengine.rank_uncertainty(copy.deepcopy(data_old), data_gt, last_prop,
                                        jcoef.get_coff(jcoef.F_RENEW, "charades", r))
        assert_same(got, want)
        assert len({rec["uncert_video"] for rec in got}) > n // 2   # not all tied
        for strategy in ("uncertainty", "random", "dichotomy"):
            g_rng, w_rng = np.random.default_rng([7, r]), np.random.default_rng([7, r])
            if strategy != "random":
                g_rng = w_rng = None
            for g, w in zip(got, want):
                assert (engine.choose_observation_point(g, strategy, g_rng)
                        == jengine.choose_observation_point(w, strategy, w_rng))
    with pytest.raises(ValueError, match="unknown point strategy"):
        engine.choose_observation_point(got[0], "nearest", None)
    with pytest.raises(ValueError, match="pickle"):
        engine.rank_uncertainty(data_old, data_gt, last_prop[1:],
                                coef.get_coff(coef.F_RENEW, "charades", 1))


# -- update_labels, file level ------------------------------------------------
@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """A tiny synthetic set and two round pickles of the port's Trainer on
    the CPU at mc_droprate 0.5 (other MC seeds: other rankings)."""
    root = str(tmp_path_factory.mktemp("torch_active"))
    make_dataset(root, task="charades", n_train=37, n_test=8, vdim=16,
                 max_raw_len=20, seed=13)
    cfg = Config.from_dict({
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "train": {"batch_size": 8, "infer_batch_size": 16, "mc_droprate": 0.5,
                  "sweep_backend": "fused"},
        "model": {"max_vlen": 16, "vdim": 16, "dim": 16, "num_heads": 2,
                  "char_dim": 4, "attn_layer": 1, "span_decode": "pallas"}})
    tr = build_trainer(cfg, device="cpu")
    tr.init_state()
    paths = []
    for i in range(2):
        paths.append(os.path.join(root, f"re{i}.pkl"))
        tr.infer_trainset(save_path=paths[-1], seed=100 + i)
    return root, paths


@pytest.mark.parametrize("strategy", ["uncertainty", "random", "dichotomy"])
@pytest.mark.parametrize("selection", ["half", "all"])
def test_update_labels_writes_identical_files(pickles, tmp_path, strategy, selection):
    root, pkls = pickles
    files, stats = {}, {}
    for name, update in (("jax", jengine.update_labels), ("port", engine.update_labels)):
        base = tmp_path / name
        for sub in ("charades_gt", "charades_re0"):
            shutil.copytree(os.path.join(root, "data", sub), base / "data" / sub)
        for r in (1, 2):
            pkl = base / "results" / "charades" / f"re{r - 1}.pkl"
            pkl.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(pkls[r - 1], pkl)
            st = update("charades", r, data_root=str(base / "data"),
                        results_root=str(base / "results"), selection=selection,
                        point_strategy=strategy, seed=4321)
            for k in ("old_path", "new_path"):
                st[k] = os.path.relpath(st[k], base)
            stats[name, r] = st
            for split in ("train", "test"):
                with open(base / "data" / f"charades_re{r}" / f"{split}.json", "rb") as f:
                    files[name, r, split] = f.read()
    for r in (1, 2):
        assert files["port", r, "train"] == files["jax", r, "train"], f"round {r}"
        assert files["port", r, "test"] == files["jax", r, "test"]
        assert_same(stats["port", r], stats["jax", r])
        n_sel = stats["port", r]["n_selected"]
        assert n_sel == (37 if selection == "all" else 19)
    assert files["port", 1, "train"] != files["port", 2, "train"]
