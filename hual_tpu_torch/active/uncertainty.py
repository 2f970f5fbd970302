"""Uncertainty scoring geometry (counterpart of
``hual_tpu/active/uncertainty.py``; reference utils/utils_hual.py:37-161).

Host NumPy by design, as in the JAX package: the round pickle holds NumPy
f32 arrays, the ranking sorts by a float sum (one ulp can reorder
near-ties), and ``train.json`` must come out byte for byte as
``hual_tpu`` writes it, so every operation here is the counterpart's, in
its order and dtype.  Model uncertainty is one array op over the train set;
the active-point geometry (activity painting, zero-run segments,
per-segment Gaussians) is per-sample NumPy, tiny (T <= 100) and
data-dependent.
"""

from __future__ import annotations

import math

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def model_uncertainty_batch(s1: np.ndarray, e1: np.ndarray, s2: np.ndarray,
                            e2: np.ndarray, vlens: np.ndarray) -> np.ndarray:
    """|sig(S1)-sig(S2)| + |sig(E1)-sig(E2)|, zeroed past each vlen.

    Vectorized form of reference get_uncert_model (utils/utils_hual.py:144-161)
    over the whole train set: inputs (N, T) logits from the two MC-dropout
    passes, vlens (N,).
    """
    mask = np.arange(s1.shape[1])[None, :] < np.asarray(vlens)[:, None]
    su = np.abs(sigmoid(s1) - sigmoid(s2)) * mask
    eu = np.abs(sigmoid(e1) - sigmoid(e2)) * mask
    return su + eu


def fill_isactivate(pos_idx: list[int], neg_idx: list[int], vlen: int,
                    max_vlen: int) -> np.ndarray:
    """Paint the annotation state vector (reference utils/utils_hual.py:37-58):
    +1 spanning the extreme positive points, -1 beyond bracketing negatives
    (or at isolated negatives when no positive exists), -100 past vlen."""
    isactive = np.zeros(max_vlen)
    if len(pos_idx) > 0:
        ll, rr = min(pos_idx), max(pos_idx)
        isactive[ll:rr + 1] = 1
        ll_negs = [i for i in neg_idx if i < ll]
        rr_negs = [i for i in neg_idx if i > rr]
        if ll_negs:
            isactive[:max(ll_negs) + 1] = -1
        if rr_negs:
            isactive[min(rr_negs):] = -1
    else:
        for i in neg_idx:
            isactive[i] = -1
    isactive[vlen:] = -100
    return isactive


def zero_runs(isactive: np.ndarray) -> list[list[int]]:
    """Maximal runs of zeros, as inclusive [start, end] pairs (reference
    get_segment, utils/utils_hual.py:63-76), from boundary diffs."""
    zero = np.concatenate([[False], isactive == 0, [False]])
    d = np.diff(zero.astype(np.int8))
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0] - 1
    return [[int(s), int(e)] for s, e in zip(starts, ends)]


def center_width_gauss(center: float, width: float, vlen: int,
                       max_vlen: int) -> np.ndarray:
    """Width-scaled Gaussian bump (reference utils/utils_hual.py:79-89):
    sigma = 0.4*width/max_vlen on a [-1,1] grid of max_vlen points, peak
    normalized then scaled by width/vlen, zeroed past vlen."""
    sigma = 0.4
    x = np.linspace(-1, 1, num=max_vlen, dtype=np.float32)
    sig = (vlen / max_vlen) * (width / vlen) * sigma
    u = (center / (max_vlen - 1)) * 2 - 1
    weight = np.exp(-((x - u) ** 2) / (2 * sig ** 2)) / (math.sqrt(2 * math.pi) * sig)
    weight /= np.max(weight)
    weight = weight * (width / vlen)
    weight[vlen:] = 0.0
    return weight


def distance_score(pos_idx: list[int], neg_idx: list[int], vlen: int,
                   max_vlen: int) -> np.ndarray:
    """Per-frame 'distance from annotations' score: a centered Gaussian per
    unannotated segment (reference get_distance_score,
    utils/utils_hual.py:92-103)."""
    segments = zero_runs(fill_isactivate(pos_idx, neg_idx, vlen, max_vlen))
    score = np.zeros(max_vlen)
    for s, e in segments:
        center = (e - s) / 2 + s
        width = e - s + 1
        g = center_width_gauss(center, width, vlen, max_vlen)
        score[s:e + 1] = g[s:e + 1]
    return score


def distance_score_shift(pos_idx: list[int], neg_idx: list[int], vlen: int,
                         max_vlen: int, shift: float
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Start/end variants with the Gaussian center shifted by ∓shift*width/2
    (reference get_distance_score_shift, utils/utils_hual.py:107-124)."""
    segments = zero_runs(fill_isactivate(pos_idx, neg_idx, vlen, max_vlen))
    start_score = np.zeros(max_vlen)
    end_score = np.zeros(max_vlen)
    for s, e in segments:
        width = e - s + 1
        g = center_width_gauss((e - s) / 2 + s - width * shift / 2,
                               width, vlen, max_vlen)
        start_score[s:e + 1] = g[s:e + 1]
        g = center_width_gauss((e - s) / 2 + s + width * shift / 2,
                               width, vlen, max_vlen)
        end_score[s:e + 1] = g[s:e + 1]
    return start_score, end_score
