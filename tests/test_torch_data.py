"""The port's data pipeline against ``hual_tpu``'s, on one synthetic dataset
(``tools/make_synthetic_data``): the dataset dict field for field with its
cache path, the AL re-span path, the feature store and ``PackedDataset``
columns, the loaders' index order, label synthesis, int8 quantization and
the metric helpers.  All host-side NumPy: every comparison is exact.
"""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu import config as jcfg  # noqa: E402
from hual_tpu.data import datasets as jds  # noqa: E402
from hual_tpu.data import features as jfeat  # noqa: E402
from hual_tpu.data import labels as jlabels  # noqa: E402
from hual_tpu.data import loader as jloader  # noqa: E402
from hual_tpu.utils import metrics as jmetrics  # noqa: E402
from hual_tpu_torch import config as pcfg  # noqa: E402
from hual_tpu_torch.data import datasets as pds  # noqa: E402
from hual_tpu_torch.data import features as pfeat  # noqa: E402
from hual_tpu_torch.data import labels as plabels  # noqa: E402
from hual_tpu_torch.data import loader as ploader  # noqa: E402
from hual_tpu_torch.utils import metrics as pmetrics  # noqa: E402

MAX_VLEN = 16


def _config_dict(root: str, cache: str) -> dict:
    return {
        "task": "charades", "suffix": "re0",
        "paths": {"cache_dir": os.path.join(root, cache),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "model": {"max_vlen": MAX_VLEN, "vdim": 8, "word_dim": 300},
    }


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data"))
    # raw videos up to 40 clips > max_vlen: downsampling runs
    make_dataset(root, task="charades", n_train=30, n_test=11, vdim=8,
                 max_raw_len=40, seed=5)
    jc = jcfg.Config.from_dict(_config_dict(root, "cache_jax"))
    pc = pcfg.Config.from_dict(_config_dict(root, "cache_port"))
    jdata, pdata = jds.gen_or_load_dataset(jc), pds.gen_or_load_dataset(pc)
    jstore = jfeat.FeatureStore.from_dir(jc.paths.feature_path, MAX_VLEN)
    pstore = pfeat.FeatureStore.from_dir(pc.paths.feature_path, MAX_VLEN)
    return root, jc, pc, jdata, pdata, jstore, pstore


def _assert_same(a, b, where=""):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_dataset_dict_field_for_field(both):
    _, _, _, jdata, pdata, _, _ = both
    assert jdata["n_train"] == 30 and jdata["n_test"] == 11
    _assert_same(jdata, pdata)


def test_cache_path_and_cache_hit(both):
    root, jc, pc, _, pdata, _, _ = both
    jpath, ppath = jds.gen_train_data_cache_path(jc), pds.gen_train_data_cache_path(pc)
    assert os.path.basename(jpath) == os.path.basename(ppath)
    assert os.path.exists(ppath)
    # a second call loads the cache pickle instead of rebuilding
    _assert_same(pds.gen_or_load_dataset(pc), pdata)
    # either package reads the other's cache
    _assert_same(pds.gen_or_load_dataset(pcfg.Config.from_dict(
        _config_dict(root, "cache_jax"))), pdata)


def test_respan_across_rounds(both, tmp_path):
    root, _, _, jdata, pdata, _, _ = both
    with open(os.path.join(root, "data/charades_re0/train.json")) as f:
        records = json.load(f)
    rng = np.random.default_rng(2)
    for rec in records:
        dur = rec[1]
        s = float(rng.uniform(0, dur / 2))
        rec[2] = [round(s, 2), round(min(dur, s + dur / 3), 2)]
    new_dir = tmp_path / "charades_re1"
    new_dir.mkdir()
    with open(new_dir / "train.json", "w") as f:
        json.dump(records, f)
    jout = jds._respan_dataset(jdata, str(new_dir))
    pout = pds._respan_dataset(pdata, str(new_dir))
    assert pout is not None
    _assert_same(jout, pout)
    assert pout["train_set"] != pdata["train_set"]


def test_feature_store_and_max_vlen_truncation(both):
    *_, jstore, pstore = both
    np.testing.assert_array_equal(jstore.packed, pstore.packed)
    np.testing.assert_array_equal(jstore.lengths, pstore.lengths)
    assert jstore.vid_index == pstore.vid_index
    assert pstore.lengths.max() == MAX_VLEN


@pytest.mark.parametrize("split", ["train_set", "test_set"])
def test_packed_dataset_columns(both, split):
    _, _, _, jdata, pdata, jstore, pstore = both
    j = jloader.PackedDataset(jdata[split], jstore, jdata["max_wlen"], jdata["max_clen"])
    p = ploader.PackedDataset(pdata[split], pstore, pdata["max_wlen"], pdata["max_clen"])
    for col in ("word_ids", "char_ids", "s_ind", "e_ind", "v_len", "duration",
                "feat_rows"):
        _assert_same(getattr(j, col), getattr(p, col), col)
    sel = np.array([3, 0, 7, 7], np.int32)
    _assert_same(j.gather(sel, with_labels=True), p.gather(sel, with_labels=True))


@pytest.mark.parametrize("batch_size,pad", [(8, True), (8, False), (11, True)])
def test_eval_loader_indices(both, batch_size, pad):
    _, _, _, jdata, pdata, jstore, pstore = both
    j = jloader.PackedDataset(jdata["test_set"], jstore, jdata["max_wlen"], jdata["max_clen"])
    p = ploader.PackedDataset(pdata["test_set"], pstore, pdata["max_wlen"], pdata["max_clen"])
    jl = jloader.EvalLoader(j, batch_size, pad_to_batch=pad)
    pl = ploader.EvalLoader(p, batch_size, pad_to_batch=pad)
    assert jl.num_batches() == pl.num_batches()
    _assert_same([list(x) for x in jl.index_iter()], [list(x) for x in pl.index_iter()])


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_train_loader_shuffle_epochs(both, drop_remainder):
    _, _, _, jdata, pdata, jstore, pstore = both
    j = jloader.PackedDataset(jdata["train_set"], jstore, jdata["max_wlen"], jdata["max_clen"])
    p = ploader.PackedDataset(pdata["train_set"], pstore, pdata["max_wlen"], pdata["max_clen"])
    jl = jloader.TrainLoader(j, 8, seed=12345, drop_remainder=drop_remainder)
    pl = ploader.TrainLoader(p, 8, seed=12345, drop_remainder=drop_remainder)
    assert jl.num_batches() == pl.num_batches()
    for epoch in (0, 1):
        _assert_same(list(jl.index_iter(epoch)), list(pl.index_iter(epoch)))
    # the implicit epoch counter advances the same way
    _assert_same(list(jl.index_iter()) + list(jl.index_iter()),
                 list(pl.index_iter()) + list(pl.index_iter()))


def test_prefetch_order_and_errors():
    assert list(ploader.prefetch(iter(range(7)))) == list(range(7))

    def broken():
        yield 1
        raise KeyError("producer")

    with pytest.raises(KeyError):
        list(ploader.prefetch(broken()))


def test_prefetch_abandoned_stream_ends_its_thread():
    """A consumer that stops early (a step raised) closes the stream; the
    producer, blocked on a full queue, ends instead of holding its items."""
    before = set(threading.enumerate())
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    stream = ploader.prefetch(endless(), depth=2)
    assert next(stream) == 0
    (producer,) = set(threading.enumerate()) - before
    stream.close()
    producer.join(timeout=5.0)
    assert not producer.is_alive()
    assert len(produced) <= 5


@pytest.mark.parametrize("seed", [0, 1])
def test_make_span_labels_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    T, n = 16, 40
    vlen = rng.integers(1, T + 1, n)
    s = rng.integers(0, vlen)
    e = np.minimum(s + rng.integers(0, 6, n), vlen - 1)
    vlen[:3], s[:3], e[:3] = (1, 2, T), (0, 0, 0), (0, 1, T - 1)
    for a, b in zip(jlabels.make_span_labels(s, e, vlen, T),
                    plabels.make_span_labels(s, e, vlen, T)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_quantize_features_bit_for_bit():
    rng = np.random.default_rng(3)
    packed = rng.normal(size=(9, 6, 16)).astype(np.float32)
    packed[2, 3:] = 0.0                                  # all-zero clips
    for jq, pq in zip(jfeat.quantize_features(packed, chunk_rows=4),
                      pfeat.quantize_features(packed, chunk_rows=4)):
        assert jq.dtype == pq.dtype
        np.testing.assert_array_equal(jq, pq)


def test_metric_helpers_match():
    rng = np.random.default_rng(4)
    pred, gt = rng.uniform(0, 30, (50, 2)), rng.uniform(0, 30, (50, 2))
    pred.sort(axis=1)
    gt.sort(axis=1)
    np.testing.assert_array_equal(jmetrics.batched_iou(pred, gt),
                                  pmetrics.batched_iou(pred, gt))
    ious = jmetrics.batched_iou(pred, gt)
    assert jmetrics.rank1_metrics(ious) == pmetrics.rank1_metrics(ious)
    for (s, e), d, n in zip(gt[:10], rng.uniform(30, 40, 10), rng.integers(5, 64, 10)):
        assert jmetrics.time_to_index(s, e, n, d) == pmetrics.time_to_index(s, e, n, d)
        assert jmetrics.calculate_iou((s, e), (0, d)) == pmetrics.calculate_iou((s, e), (0, d))
        assert jmetrics.time_to_index_al([s, e], d, n) == pmetrics.time_to_index_al([s, e], d, n)
        assert jmetrics.index_to_time_al([2, 5], d, n) == pmetrics.index_to_time_al([2, 5], d, n)
    idx = rng.integers(0, 16, (2, 20))
    vl, du = rng.integers(16, 64, 20), rng.uniform(5, 40, 20)
    for a, b in zip(jmetrics.index_to_time_batch(idx[0], idx[1], vl, du),
                    pmetrics.index_to_time_batch(idx[0], idx[1], vl, du)):
        np.testing.assert_array_equal(a, b)
