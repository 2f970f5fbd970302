"""Dataset record processing and caching (counterpart of
``hual_tpu/data/datasets.py``).

Record JSON: a list of ``[vid, duration, [s_time, e_time], sentence,
...extras]``; the extras are ignored.  On top of the reference pipeline two
static shape bounds make every batch one fixed shape: ``max_wlen`` (longest
tokenized query after truncation) and ``max_clen`` (longest word in
characters), stored in the cached dataset dict.  The cache pickle holds
plain Python and NumPy values, so either package reads the other's.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from hual_tpu_torch.config import Config
from hual_tpu_torch.data.tokenize import tokenize
from hual_tpu_torch.data.vocab import UNK, vocab_emb_gen
from hual_tpu_torch.utils.io import load_json, load_pickle, save_pickle
from hual_tpu_torch.utils.metrics import time_to_index


class Processor:
    """Raw JSON records -> tokenized dicts with running sample ids."""

    def __init__(self):
        self.idx_counter = 0

    def reset_idx_counter(self):
        self.idx_counter = 0

    def process_data(self, data, scope: str | None = None) -> list[dict]:
        """``scope`` ("train", "test", ...) is the reference's argument,
        accepted and unused there too."""
        results = []
        for record in data:
            vid, duration, gt_label, sentence = record[:4]
            start_time, end_time = gt_label
            results.append({
                "sample_id": self.idx_counter,
                "vid": str(vid),
                "s_time": start_time,
                "e_time": end_time,
                "duration": duration,
                "words": tokenize(sentence),
            })
            self.idx_counter += 1
        return results

    def convert(self, data_dir: str):
        self.reset_idx_counter()
        if not os.path.exists(data_dir):
            raise ValueError(f"data dir {data_dir} does not exist")
        train_data = load_json(os.path.join(data_dir, "train.json"))
        test_data = load_json(os.path.join(data_dir, "test.json"))
        return (self.process_data(train_data, scope="train"), None,
                self.process_data(test_data, scope="test"))


def dataset_gen(data, vfeat_lens, word_dict, char_dict,
                max_pos_len: int) -> list[dict]:
    """Map words/chars to ids and times to unit indices.  Words are cut at
    ``max_pos_len``: the reference passes max_vlen here, not max_tlen, and
    the quirk is kept on purpose."""
    dataset = []
    for record in data:
        vid = record["vid"]
        if vid not in vfeat_lens:
            continue
        s_ind, e_ind = time_to_index(record["s_time"], record["e_time"],
                                     vfeat_lens[vid], record["duration"])
        dataset.append(_sample(record, vfeat_lens[vid], s_ind, e_ind,
                               word_dict, char_dict, max_pos_len))
    return dataset


def dataset_gen_active(data, vfeat_lens, word_dict, char_dict,
                       max_pos_len: int, scope: str | None = None) -> list[dict]:
    """:func:`dataset_gen` with the spans taken from per-frame active
    weights instead of the timestamps (reference dataset_gen_active,
    utils/data_gen.py:119-152; on no path of the pipeline).  Records carry
    an ``active_weight`` list; the first and last frames of weight >= 0.5
    bound the span.  Raises ValueError for a record with no such frame."""
    dataset = []
    for record in data:
        vid = record["vid"]
        if vid not in vfeat_lens:
            continue
        flen = vfeat_lens[vid]
        w = np.asarray(record["active_weight"])
        hits = np.where(w >= 0.5)[0]
        if len(hits) < 1:
            raise ValueError(f"no active frames for {vid}")
        s_ind = round(hits[0] / len(w) * (flen - 1))
        e_ind = round(hits[-1] / len(w) * (flen - 1))
        dataset.append(_sample(record, flen, s_ind, e_ind, word_dict,
                               char_dict, max_pos_len))
    return dataset


def _sample(record: dict, v_len: int, s_ind, e_ind, word_dict, char_dict,
            max_pos_len: int) -> dict:
    unk_w, unk_c = word_dict[UNK], char_dict[UNK]
    word_ids, char_ids = [], []
    for word in record["words"][0:max_pos_len]:
        word_ids.append(word_dict.get(word, unk_w))
        char_ids.append([char_dict.get(c, unk_c) for c in word])
    return {"sample_id": record["sample_id"], "vid": record["vid"],
            "s_time": record["s_time"], "e_time": record["e_time"],
            "duration": record["duration"], "words": record["words"],
            "s_ind": int(s_ind), "e_ind": int(e_ind),
            "v_len": v_len, "w_ids": word_ids, "c_ids": char_ids}


def _records_fingerprint(data_dir: str) -> str:
    """crc32 over the round's record JSONs: the cache key follows the
    content of the round directory, not only its suffix, so a rewritten
    train.json never reuses stale pseudo labels."""
    crc = 0
    for name in ("train.json", "val.json", "test.json"):
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                crc = zlib.crc32(f.read(), crc)
    return f"{crc:08x}"


def _default_data_dir(config: Config) -> str:
    if config.paths.train_path:
        return os.path.dirname(config.paths.train_path)
    return os.path.join("data", f"{config.task}_{config.suffix}")


def gen_train_data_cache_path(config: Config, data_dir: str | None = None) -> str:
    """Cache key = (task, feature version, max_vlen, suffix, record-content
    fingerprint)."""
    feat_version = os.path.split(config.paths.feature_path.rstrip("/"))[-1]
    fp = _records_fingerprint(data_dir or _default_data_dir(config))
    name = "_".join([config.task, feat_version, str(config.model.max_vlen),
                     config.suffix, fp]) + ".pkl"
    return os.path.join(config.paths.cache_dir, name)


def _static_shape_bounds(datasets) -> tuple[int, int]:
    max_wlen, max_clen = 1, 1
    for ds in datasets:
        if ds is None:
            continue
        for rec in ds:
            max_wlen = max(max_wlen, len(rec["w_ids"]))
            for cid in rec["c_ids"]:
                max_clen = max(max_clen, len(cid))
    return max_wlen, max_clen


def _respan_dataset(base: dict, data_dir: str) -> dict | None:
    """AL-round fast path: between rounds only the pseudo spans of
    train.json change, so the new s/e indices are recomputed against the
    new spans instead of re-tokenizing the corpus.  None when the vids,
    order, durations or sentences changed."""
    try:
        new_train = load_json(os.path.join(data_dir, "train.json"))
    except (OSError, ValueError):
        return None
    old = base.get("train_set")
    if not old or len(new_train) != len(old):
        return None
    train_set = []
    for rec, new in zip(old, new_train):
        vid, duration, (s_time, e_time) = new[0], new[1], new[2]
        if str(vid) != rec["vid"] or duration != rec["duration"]:
            return None
        # records may share vid and duration: the query is checked too
        if tokenize(new[3]) != rec["words"]:
            return None
        s_ind, e_ind = time_to_index(s_time, e_time, rec["v_len"], duration)
        r2 = dict(rec)
        r2.update(s_time=s_time, e_time=e_time,
                  s_ind=int(s_ind), e_ind=int(e_ind))
        train_set.append(r2)
    ds = dict(base)
    ds["train_set"] = train_set
    return ds


def gen_or_load_dataset(config: Config, data_dir: str | None = None,
                        base: dict | None = None) -> dict:
    """Build or load the cached dataset dict.

    ``config.paths.train_path`` names the record directory when set, else
    ``data/<task>_<suffix>/``.  ``base`` (a previous round's dataset dict)
    enables the re-span fast path across AL rounds.
    """
    os.makedirs(config.paths.cache_dir, exist_ok=True)
    if data_dir is None:
        data_dir = _default_data_dir(config)

    save_path = gen_train_data_cache_path(config, data_dir)
    if os.path.exists(save_path):
        return load_pickle(save_path)

    if base is not None:
        dataset = _respan_dataset(base, data_dir)
        if dataset is not None:
            save_pickle(dataset, save_path)
            return dataset

    vfeat_lens = load_json(os.path.join(config.paths.feature_path,
                                        "feature_shapes.json"))
    for vid, vfeat_len in vfeat_lens.items():
        vfeat_lens[vid] = min(config.model.max_vlen, vfeat_len)

    train_data, val_data, test_data = Processor().convert(data_dir)
    data_list = ([train_data, test_data] if val_data is None
                 else [train_data, val_data, test_data])
    word_dict, char_dict, vectors = vocab_emb_gen(
        data_list, config.paths.glove_path, word_dim=config.model.word_dim)

    max_vlen = config.model.max_vlen
    train_set = dataset_gen(train_data, vfeat_lens, word_dict, char_dict, max_vlen)
    val_set = None if val_data is None else dataset_gen(
        val_data, vfeat_lens, word_dict, char_dict, max_vlen)
    test_set = dataset_gen(test_data, vfeat_lens, word_dict, char_dict, max_vlen)

    max_wlen, max_clen = _static_shape_bounds([train_set, val_set, test_set])
    dataset = {
        "train_set": train_set, "val_set": val_set, "test_set": test_set,
        "word_dict": word_dict, "char_dict": char_dict,
        "word_vector": np.asarray(vectors, dtype=np.float32),
        "n_train": len(train_set), "n_val": 0 if val_set is None else len(val_set),
        "n_test": len(test_set), "n_words": len(word_dict), "n_chars": len(char_dict),
        "max_wlen": int(max_wlen), "max_clen": int(max_clen),
    }
    save_pickle(dataset, save_path)
    return dataset
