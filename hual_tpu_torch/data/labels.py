"""Vectorized training-label synthesis (counterpart of
``hual_tpu/data/labels.py``), NumPy.

Each quirk of the reference is kept on purpose:

* soft start/end labels: every in-length frame gets a 1e-10 floor; the
  target index gets +0.5; each existing neighbour is *assigned*
  y = (1 - vlen*1e-10 - 0.5)/2; a missing neighbour folds its y into the
  target;
* match labels: B=1 / I=2 / E=3 painted over +-2-extended windows in that
  order, with the collision clamp ``new_st_r = max(st, new_et_l - 1)``;
* inner labels: 1 exactly on the I region.
"""

from __future__ import annotations

import math

import numpy as np


def make_span_labels(s_inds: np.ndarray, e_inds: np.ndarray, vlens: np.ndarray,
                     max_len: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(B,) start/end indices and lengths -> s_labels, e_labels (B, T) f32,
    match_labels, inner_labels (B, T) int32, with T = ``max_len``."""
    s_inds = np.asarray(s_inds, dtype=np.int64)
    e_inds = np.asarray(e_inds, dtype=np.int64)
    vlens = np.asarray(vlens, dtype=np.int64)
    bsz = s_inds.shape[0]
    rows = np.arange(bsz)
    idx = np.arange(max_len)[None, :]
    valid = idx < vlens[:, None]

    y = ((1.0 - vlens.astype(np.float64) * 1e-10 - 0.5) / 2.0).astype(np.float64)

    def soft(target: np.ndarray) -> np.ndarray:
        lab = np.where(valid, 1e-10, 0.0)
        lab[rows, target] += 0.5
        has_left = target > 0
        has_right = target < vlens - 1
        lab[rows[has_left], target[has_left] - 1] = y[has_left]
        np.add.at(lab, (rows[~has_left], target[~has_left]), y[~has_left])
        lab[rows[has_right], target[has_right] + 1] = y[has_right]
        np.add.at(lab, (rows[~has_right], target[~has_right]), y[~has_right])
        return lab.astype(np.float32)

    s_labels = soft(s_inds)
    e_labels = soft(e_inds)

    ext = 2
    st_l = np.maximum(0, s_inds - ext)
    st_r = np.minimum(s_inds + ext, vlens - 1)
    et_l = np.maximum(0, e_inds - ext)
    et_r = np.minimum(e_inds + ext, vlens - 1)
    clash = st_r >= et_l
    st_r = np.where(clash, np.maximum(s_inds, et_l - 1), st_r)

    m1 = (idx >= st_l[:, None]) & (idx <= st_r[:, None])
    m2 = (idx > st_r[:, None]) & (idx < et_l[:, None])
    m3 = (idx >= et_l[:, None]) & (idx <= et_r[:, None])
    match_labels = np.where(m3, 3, np.where(m2, 2, np.where(m1, 1, 0))).astype(np.int32)
    inner_labels = m2.astype(np.int32)
    return s_labels, e_labels, match_labels, inner_labels


# Gaussian soft labels (reference utils/data_utils.py:176-206): dead in the
# reference train path (computed, then discarded), kept as public API.


def get_gaussian_weight(center: float, vlen: int, L: int, alpha: float) -> np.ndarray:
    """A Gaussian over ``L`` positions around ``center``, width ``vlen / L *
    alpha``, scaled to a maximum of 1 and zero from ``vlen`` on."""
    x = np.linspace(-1, 1, num=L, dtype=np.float32)
    sig = vlen / L * alpha
    u = (center / (L - 1)) * 2 - 1
    weight = np.exp(-((x - u) ** 2) / (2 * sig ** 2)) / (math.sqrt(2 * math.pi) * sig)
    weight /= np.max(weight)
    weight[vlen:] = 0.0
    return weight


def gene_soft_label(sidx: int, eidx: int, vlen: int, L: int, alpha: float):
    """Soft start, end and (O, S, I, E) match labels of a span: (L,), (L,)
    and (L, 4)."""
    Ssoft = get_gaussian_weight(sidx, vlen, L, alpha)
    Esoft = get_gaussian_weight(eidx, vlen, L, alpha)
    IOsoft = 1 - Ssoft - Esoft
    mask_I = np.zeros(L)
    mask_I[sidx:eidx + 1] = 1
    Isoft = IOsoft * mask_I
    mask_O = np.zeros(L)
    mask_O[:sidx] = 1
    mask_O[eidx + 1:vlen] = 1
    Osoft = IOsoft * mask_O
    Ssoft = Ssoft / np.sum(Ssoft)
    Esoft = Esoft / np.sum(Esoft)
    Msoft = np.stack([Osoft, Ssoft, Isoft, Esoft]).T
    return Ssoft, Esoft, Msoft
