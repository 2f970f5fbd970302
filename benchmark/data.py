"""The inputs of a run, made from ``--seed``: records, GloVe rows, the video
feature table on the device and SeqPAN's weights.

A configuration file (``configs/<config>.json``) gives the port's
``Config`` dict and, under ``data``, the split sizes and the ranges the
records are drawn from.  The same seed gives the same inputs.  Both sides
get them: the port as its ``Trainer`` takes them (the dataset dict, the
device table through ``device_features``, the weights as the JAX package's
flat dict through ``Trainer.load_params``), the reference as device tensors.
"""

from __future__ import annotations

import string
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import seqpan as ref

CHARS = list(string.ascii_lowercase + string.digits + ".,'-!?&:;()/\"")


def substream(seed: int, *words: int) -> int:
    """A 64-bit seed for the part ``words`` of the run ``seed``."""
    return ref.stream_seed(seed, *words)


@dataclass
class Split:
    """One split as device columns, in the program's sample order."""
    feat_rows: torch.Tensor
    v_len: torch.Tensor
    word_ids: torch.Tensor
    char_ids: torch.Tensor
    s_ind: torch.Tensor
    e_ind: torch.Tensor
    duration: torch.Tensor

    def __len__(self) -> int:
        return int(self.v_len.shape[0])

    def data(self, table: torch.Tensor) -> dict:
        return {"features": table, **self.__dict__}


class DeviceOnlyStore:
    """What ``Trainer`` reads of a ``FeatureStore`` when the table is
    handed in on the device: the table's shape (``packed``, a zero-stride
    view that holds no memory), the clip counts and the video index."""

    def __init__(self, shape: tuple, lengths: np.ndarray, vids: list[str]):
        self.max_vlen = shape[1]
        self.packed = np.broadcast_to(np.zeros((), np.float32), shape)
        self.lengths = lengths
        self.vid_index = {v: i for i, v in enumerate(vids)}

    def rows(self, vids: list[str]) -> np.ndarray:
        return np.asarray([self.vid_index[v] for v in vids], dtype=np.int32)


@dataclass
class Inputs:
    dataset: dict                 # the port's dataset dict
    store: DeviceOnlyStore
    table: torch.Tensor           # (videos, T, vdim) f32 on the device
    word_vectors: torch.Tensor    # (glove rows, word_dim) f32 on the device
    splits: dict                  # split name -> Split


def _vocabulary(rng: np.random.Generator, n: int, lengths: tuple) -> tuple[list, np.ndarray]:
    """``n`` distinct lowercase words and their char ids (n, max len), 0-padded."""
    words: set[str] = set()
    letters = np.array(list(string.ascii_lowercase))
    while len(words) < n:
        k = int(rng.integers(lengths[0], lengths[1] + 1))
        words.add("".join(rng.choice(letters, size=k)))
    vocab = sorted(words)
    char_id = {c: i + 2 for i, c in enumerate(CHARS)}
    cids = np.zeros((n, lengths[1]), np.int32)
    for i, w in enumerate(vocab):
        cids[i, :len(w)] = [char_id[c] for c in w]
    return vocab, cids


def make_inputs(spec: dict, seed: int, device: torch.device) -> Inputs:
    """The run's inputs from its configuration file ``spec`` and ``seed``."""
    d, m = spec["data"], spec["config"]["model"]
    T, vdim, word_dim = m["max_vlen"], m["vdim"], m["word_dim"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
    vocab, vocab_cids = _vocabulary(rng, d["glove_words"], tuple(d["word_chars"]))
    word_vectors = rng.normal(scale=0.3, size=(len(vocab), word_dim)).astype(np.float32)

    vids, lengths, splits_np = [], [], {}
    for split, (n_queries, n_videos) in d["splits"].items():
        raw = rng.integers(d["raw_clips"][0], d["raw_clips"][1] + 1, size=n_videos)
        v_len_video = np.minimum(raw, T).astype(np.int32)
        dur_video = rng.uniform(*d["duration_s"], size=n_videos).round(2).astype(np.float32)
        row0 = len(vids)
        vids += [f"{split}{i:05d}" for i in range(n_videos)]
        lengths.append(v_len_video)
        # every video gets a query, the rest go to videos drawn at random
        owner = np.concatenate([np.arange(n_videos),
                                rng.integers(0, n_videos, size=n_queries - n_videos)])
        owner = owner[rng.permutation(n_queries)]
        vl = v_len_video[owner]
        share = rng.uniform(*d["span_share"], size=n_queries)
        span = np.maximum(1, np.rint(share * vl)).astype(np.int32)
        s = (rng.random(n_queries) * (vl - span + 1)).astype(np.int32)
        n_words = rng.integers(d["query_words"][0], d["query_words"][1] + 1, size=n_queries)
        W = int(d["query_words"][1])
        wpick = rng.integers(0, len(vocab), size=(n_queries, W))
        word_ids = np.where(np.arange(W)[None] < n_words[:, None], wpick + 2, 0).astype(np.int32)
        # about one word in fifty is out of the GloVe vocabulary (UNK, id 1)
        unk = (rng.random((n_queries, W)) < 0.02) & (word_ids > 0)
        char_ids = np.where((word_ids > 0)[..., None], vocab_cids[wpick], 0).astype(np.int32)
        word_ids[unk] = 1
        splits_np[split] = dict(feat_rows=(owner + row0).astype(np.int32), v_len=vl,
                                word_ids=word_ids, char_ids=char_ids, s_ind=s,
                                e_ind=(s + span - 1).astype(np.int32),
                                duration=dur_video[owner], n_words=n_words, wpick=wpick)
    lengths = np.concatenate(lengths)

    # the feature table, drawn on the device in one call; clips past a
    # video's length are zero, as the port's FeatureStore packs them
    gen = torch.Generator(device=device).manual_seed(substream(seed, 1))
    table = torch.randn((len(vids), T, vdim), generator=gen, device=device)
    clip_ok = (torch.arange(T, device=device)[None, :]
               < torch.from_numpy(lengths).to(device)[:, None])
    table.mul_(clip_ok[:, :, None])

    max_clen = max(int(d["word_chars"][1]), 4)
    records = {}
    for split, c in splits_np.items():
        recs = []
        for i in range(len(c["v_len"])):
            k = int(c["n_words"][i])
            w_ids = c["word_ids"][i, :k].tolist()
            words = [vocab[j] for j in c["wpick"][i, :k]]
            recs.append({"sample_id": i, "vid": vids[c["feat_rows"][i]],
                         "duration": float(c["duration"][i]), "words": words,
                         "s_ind": int(c["s_ind"][i]), "e_ind": int(c["e_ind"][i]),
                         "v_len": int(c["v_len"][i]), "w_ids": w_ids,
                         "c_ids": [c["char_ids"][i, j][c["char_ids"][i, j] > 0].tolist()
                                   for j in range(k)]})
        records[split] = recs
    dataset = {"train_set": records.get("train"), "val_set": None,
               "test_set": records.get("test"),
               "word_vector": word_vectors, "n_words": len(vocab) + 2,
               "n_chars": len(CHARS) + 2, "max_wlen": int(d["query_words"][1]),
               "max_clen": int(d["word_chars"][1])}
    splits = {}
    for split, c in splits_np.items():
        cols = {k: torch.from_numpy(np.ascontiguousarray(c[k])).to(device)
                for k in ("feat_rows", "v_len", "word_ids", "s_ind", "e_ind", "duration")}
        cc = np.zeros((*c["char_ids"].shape[:2], max_clen), np.int32)
        cc[..., :c["char_ids"].shape[2]] = c["char_ids"]
        splits[split] = Split(char_ids=torch.from_numpy(cc).to(device), **cols)
    store = DeviceOnlyStore(tuple(table.shape), lengths, vids)
    return Inputs(dataset, store, table, torch.from_numpy(word_vectors).to(device), splits)


def reference_model(spec: dict, device: torch.device) -> ref.SeqPAN:
    m = spec["config"]["model"]
    return ref.SeqPAN(vdim=m["vdim"], dim=m["dim"], num_heads=m["num_heads"],
                      attn_layer=m["attn_layer"], max_vlen=m["max_vlen"],
                      word_dim=m["word_dim"], char_dim=m["char_dim"],
                      num_chars=len(CHARS) + 2).to(device)


def make_weights(spec: dict, seed: int, device: torch.device) -> tuple[dict, dict]:
    """SeqPAN's weights from ``seed``, drawn on the device in one call
    (glorot-uniform kernels and tables, zero biases, unit LayerNorm
    scales): (the JAX package's flat dict, which ``Trainer.load_params``
    takes; the reference's state dict on the device)."""
    model = reference_model(spec, device)
    gen = torch.Generator(device=device).manual_seed(substream(seed, 2))
    u = torch.rand(ref.glorot_count(model), generator=gen, device=device)
    ref.init_from_uniform(model, u)
    flat = {key: ref.to_jax_layout(key, p, jshape) for key, p, jshape, _ in ref.jax_leaves(model)}
    return flat, {k: v.detach().clone() for k, v in model.state_dict().items()}
