"""Fixed-shape batch loaders (counterpart of ``hual_tpu/data/loader.py``).

Each split is packed once into contiguous fixed-shape NumPy columns, and a
batch is one fancy-index gather.  The device-resident sweeps take only the
index arrays (``index_iter``); ``Trainer`` puts the columns on the card.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

from hual_tpu_torch.data.features import FeatureStore
from hual_tpu_torch.data.labels import make_span_labels


def prefetch(iterator: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator on a background thread with a bounded queue;
    exceptions of the producer re-raise at the consumer.  Closing the
    returned generator (or dropping it) stops the producer at its next
    item, so an abandoned stream ends its thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
            put((_ERR, e))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()


class PackedDataset:
    """Columnar fixed-shape arrays for one record list."""

    def __init__(self, records: list[dict], feature_store: FeatureStore,
                 max_wlen: int, max_clen: int):
        self.records = records
        self.features = feature_store
        n = len(records)
        # the char CNN's kernels go up to width 4
        max_clen = max(int(max_clen), 4)
        self.max_wlen, self.max_clen = int(max_wlen), max_clen
        self.word_ids = np.zeros((n, max_wlen), dtype=np.int32)
        self.char_ids = np.zeros((n, max_wlen, max_clen), dtype=np.int32)
        self.s_ind = np.zeros((n,), dtype=np.int32)
        self.e_ind = np.zeros((n,), dtype=np.int32)
        self.v_len = np.zeros((n,), dtype=np.int32)
        self.duration = np.zeros((n,), dtype=np.float32)
        self.feat_rows = feature_store.rows([r["vid"] for r in records])
        for i, rec in enumerate(records):
            w = rec["w_ids"][:max_wlen]
            self.word_ids[i, :len(w)] = w
            for j, cid in enumerate(rec["c_ids"][:max_wlen]):
                c = cid[:max_clen]
                self.char_ids[i, j, :len(c)] = c
            self.s_ind[i] = rec["s_ind"]
            self.e_ind[i] = rec["e_ind"]
            self.v_len[i] = rec["v_len"]
            self.duration[i] = rec["duration"]

    def __len__(self) -> int:
        return len(self.records)

    def gather(self, sel: np.ndarray, with_labels: bool) -> dict[str, np.ndarray]:
        vfeats, _ = self.features.gather(self.feat_rows[sel])
        batch = {
            "video_features": vfeats,                  # (B, T, vdim) f32
            "video_seq_len": self.v_len[sel],          # (B,) i32
            "word_ids": self.word_ids[sel],            # (B, W) i32
            "char_ids": self.char_ids[sel],            # (B, W, C) i32
            "s_ind": self.s_ind[sel],                  # (B,) i32 (pseudo GT)
            "e_ind": self.e_ind[sel],
            "duration": self.duration[sel],            # (B,) f32
        }
        if with_labels:
            s_lab, e_lab, match, inner = make_span_labels(
                batch["s_ind"], batch["e_ind"], batch["video_seq_len"],
                self.features.max_vlen)
            batch.update(y1=s_lab, y2=e_lab, match_labels=match,
                         inner_labels=inner.astype(np.float32))
        return batch


class TrainLoader:
    """Shuffled batches with labels.  The shuffle is a seeded per-epoch
    generator (the reference's was unseeded)."""

    def __init__(self, dataset: PackedDataset, batch_size: int,
                 seed: int = 12345, drop_remainder: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def num_samples(self) -> int:
        return len(self.dataset)

    def num_batches(self) -> int:
        if self.drop_remainder:
            return len(self.dataset) // self.batch_size
        return math.ceil(len(self.dataset) / self.batch_size)

    def index_iter(self, epoch: Optional[int] = None) -> Iterator[np.ndarray]:
        """The shuffled batch index arrays of one epoch."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        perm = rng.permutation(len(self.dataset)).astype(np.int32)
        stop = (len(perm) // self.batch_size * self.batch_size
                if self.drop_remainder else len(perm))
        for lo in range(0, stop, self.batch_size):
            yield perm[lo:lo + self.batch_size]

    def batch_iter(self, epoch: Optional[int] = None
                   ) -> Iterator[tuple[np.ndarray, dict]]:
        for sel in self.index_iter(epoch):
            yield sel, self.dataset.gather(sel, with_labels=True)


class EvalLoader:
    """Order-preserving unlabeled batches.  ``pad_to_batch`` pads the final
    ragged batch by repeating its last sample and yields the count of valid
    rows, so every batch has one shape."""

    def __init__(self, dataset: PackedDataset, batch_size: int,
                 pad_to_batch: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to_batch = pad_to_batch

    def num_samples(self) -> int:
        return len(self.dataset)

    def num_batches(self) -> int:
        return math.ceil(len(self.dataset) / self.batch_size)

    def index_iter(self) -> Iterator[tuple[np.ndarray, int]]:
        n = len(self.dataset)
        for lo in range(0, n, self.batch_size):
            sel = np.arange(lo, min(lo + self.batch_size, n), dtype=np.int32)
            n_valid = len(sel)
            if self.pad_to_batch and n_valid < self.batch_size:
                sel = np.concatenate(
                    [sel, np.full(self.batch_size - n_valid, sel[-1],
                                  dtype=sel.dtype)])
            yield sel, n_valid

    def batch_iter(self) -> Iterator[tuple[np.ndarray, dict, int]]:
        for sel, n_valid in self.index_iter():
            yield sel, self.dataset.gather(sel, with_labels=False), n_valid
