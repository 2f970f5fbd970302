"""Video feature store (counterpart of ``hual_tpu/data/features.py``).

Per-clip visual features (one ``.npy`` per video) are loaded into RAM,
videos longer than ``max_vlen`` are mean-pooled down to ``max_vlen`` clips,
and the store packs them into one zero-padded (num_videos, max_vlen, vdim)
table.  ``FeatureStore.from_dir`` reads a directory with the multithreaded
C++ loader (``hual_tpu_torch/native``) by default, and with NumPy for any
file the loader cannot parse, or for all of them if it cannot be built.
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

_log = logging.getLogger(__name__)


def visual_feature_sampling(feature: np.ndarray, max_num_clips: int) -> np.ndarray:
    """Mean-pool (num_clips, D) down to (max_num_clips, D) when too long.

    idxs = round(arange(0..max+1)/max*num_clips), clipped to num_clips-1;
    bucket i = mean(feature[idxs[i]:idxs[i+1]]) or feature[idxs[i]] if
    empty.  The clip drops the final row from the last bucket, a quirk kept
    from the reference (docs/PARITY.md).
    """
    num_clips = feature.shape[0]
    if num_clips <= max_num_clips:
        return feature
    idxs = np.arange(0, max_num_clips + 1, 1.0) / max_num_clips * num_clips
    idxs = np.round(idxs).astype(np.int32)
    idxs[idxs > num_clips - 1] = num_clips - 1
    starts, ends = idxs[:-1], idxs[1:]
    counts = (ends - starts).astype(np.float64)
    csum = np.concatenate([np.zeros((1, feature.shape[1]), dtype=np.float64),
                           np.cumsum(feature, axis=0, dtype=np.float64)], axis=0)
    out = (csum[ends] - csum[starts]) / np.maximum(counts, 1.0)[:, None]
    empty = counts < 1.0
    if np.any(empty):
        out[empty] = feature[starts[empty]]
    return out.astype(feature.dtype)


def load_video_features(root: str, max_position_length: int | None
                        ) -> dict[str, np.ndarray]:
    """Load all <root>/*.npy into a dict vid -> (T<=max, D) float32 array."""
    video_features: dict[str, np.ndarray] = {}
    for filename in sorted(glob.glob(os.path.join(root, "*.npy"))):
        video_id = os.path.basename(filename).rsplit(".", 1)[0]
        feature = np.load(filename)
        if max_position_length is not None:
            feature = visual_feature_sampling(feature,
                                              max_num_clips=max_position_length)
        video_features[video_id] = np.asarray(feature, dtype=np.float32)
    return video_features


def quantize_features(packed: np.ndarray,
                      chunk_rows: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-clip int8 quantization of a packed (N, T, D) table.

    ``scale[n, t] = amax(|packed[n, t, :]|) / 127`` (1.0 for all-zero clips,
    so padding dequantizes to exact zeros); dequantized on gather as
    ``q.float() * scale[..., None]`` (``runtime/steps.gather_batch``).
    Chunked over rows to bound the f32 temporaries.
    """
    n = packed.shape[0]
    q = np.empty(packed.shape, dtype=np.int8)
    scales = np.empty(packed.shape[:2], dtype=np.float32)
    for lo in range(0, n, chunk_rows):
        x = packed[lo:lo + chunk_rows].astype(np.float32, copy=False)
        amax = np.abs(x).max(axis=-1)
        s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q[lo:lo + chunk_rows] = np.clip(np.rint(x / s[..., None]),
                                        -127, 127).astype(np.int8)
        scales[lo:lo + chunk_rows] = s
    return q, scales


class FeatureStore:
    """RAM-resident features packed into one contiguous zero-padded
    (num_videos, max_vlen, D) table plus a vid -> row index."""

    def __init__(self, features: dict[str, np.ndarray], max_vlen: int):
        self.max_vlen = max_vlen
        self.vid_index: dict[str, int] = {}
        vids = list(features)
        dim = features[vids[0]].shape[1] if vids else 0
        self.packed = np.zeros((len(vids), max_vlen, dim), dtype=np.float32)
        self.lengths = np.zeros((len(vids),), dtype=np.int32)
        for i, vid in enumerate(vids):
            feat = features[vid]
            n = min(feat.shape[0], max_vlen)
            self.packed[i, :n] = feat[:n]
            self.lengths[i] = n
            self.vid_index[vid] = i

    @classmethod
    def from_dir(cls, root: str, max_vlen: int,
                 use_native: bool = True) -> "FeatureStore":
        """The packed store of a feature directory.

        ``use_native``: the C++ loader parses, downsamples and packs every
        ``.npy`` file straight into the table; a file it cannot parse
        (nonzero status) is read by NumPy.  If the loader cannot be built or
        loaded, a warning names the cause and NumPy reads every file.
        """
        filenames = sorted(glob.glob(os.path.join(root, "*.npy")))
        if use_native and filenames:
            from hual_tpu_torch import native

            vdim = int(np.load(filenames[0], mmap_mode="r").shape[1])
            res = native.load_npy_batch(filenames, max_vlen, vdim)
            if res is not None:
                return cls._from_native(filenames, max_vlen, *res)
            _log.warning("reading %d feature files with NumPy: the native "
                         "loader is unavailable (%s)", len(filenames),
                         native.error())
        return cls(load_video_features(root, max_vlen), max_vlen)

    @classmethod
    def _from_native(cls, filenames: list[str], max_vlen: int,
                     packed: np.ndarray, lengths: np.ndarray,
                     statuses: np.ndarray) -> "FeatureStore":
        store = cls.__new__(cls)
        store.max_vlen = max_vlen
        store.packed = packed
        store.lengths = lengths.astype(np.int32)
        store.vid_index = {}
        for i, fn in enumerate(filenames):
            store.vid_index[os.path.basename(fn).rsplit(".", 1)[0]] = i
            if statuses[i] != 0:        # a format the loader does not parse
                feat = visual_feature_sampling(np.load(fn), max_vlen)
                n = min(feat.shape[0], max_vlen)
                store.packed[i, :n] = feat[:n]
                store.packed[i, n:] = 0
                store.lengths[i] = n
        return store

    def rows(self, vids: list[str]) -> np.ndarray:
        return np.asarray([self.vid_index[v] for v in vids], dtype=np.int32)

    def gather(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.packed[rows], self.lengths[rows]
