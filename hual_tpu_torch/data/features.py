"""Video feature downsampling (counterpart of ``hual_tpu/data/features.py``)."""

from __future__ import annotations

import numpy as np


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
