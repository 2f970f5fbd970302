"""Pseudo-label renewal from binary annotations (counterpart of
``hual_tpu/active/renew.py``; reference update_label.py:62-123).

Given a sample's accumulated positive/negative annotation points, combine
three per-frame score sources — shifted distance Gaussians, model
start/end probabilities, and a Gaussian around the previous label — then
hard-mask by the annotation constraints and decode the new span.  Ties go
to the first index (``np.argmax``), as in the counterpart.
"""

from __future__ import annotations

import numpy as np

from hual_tpu_torch.active.coefficients import RoundCoeffs
from hual_tpu_torch.active.uncertainty import (center_width_gauss,
                                               distance_score_shift)


def append_annotation(point: int, active_point: dict, gt_idx) -> dict:
    """Simulated expert binary answer: is `point` inside the GT span?
    (reference append_AP, utils/utils_hual.py:133-139)."""
    gt_s, gt_e = gt_idx
    if gt_s <= point <= gt_e:
        active_point["pos_idx"].append(point)
    else:
        active_point["neg_idx"].append(point)
    return active_point


def mask_activepoints(start_prob: np.ndarray, end_prob: np.ndarray,
                      pos_idx: list[int], neg_idx: list[int], vlen: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Hard constraints from annotations (reference update_label.py:62-84):
    with positives, start must lie at/before the leftmost positive and after
    any bracketing negative (symmetric for end); with only negatives, each
    negative suppresses a soft Gaussian neighborhood (width 0.3*vlen)."""
    if len(pos_idx) == 0:
        for i in neg_idx:
            soft = 1.0 - center_width_gauss(i, 0.3 * vlen, vlen=vlen,
                                            max_vlen=len(start_prob))
            start_prob = soft * start_prob
            end_prob = soft * end_prob
    else:
        lpos = min(pos_idx)
        start_prob[lpos + 1:] = 0
        left_negs = [i for i in neg_idx if i < lpos]
        if left_negs:
            start_prob[:max(left_negs) + 1] = 0
        rpos = max(pos_idx)
        end_prob[:rpos] = 0
        right_negs = [i for i in neg_idx if i > rpos]
        if right_negs:
            end_prob[min(right_negs):] = 0
    return start_prob, end_prob


def _segmented_span_decode(start_score: np.ndarray, end_score: np.ndarray,
                           neg_idx: list[int], vlen: int) -> tuple[int, int]:
    """Outer-product span decode restricted to blocks between negative
    annotations, upper-triangular (reference update_label.py:108-122)."""
    outer = start_score[:, None] * end_score[None, :]
    score_matrix = np.zeros_like(outer)
    bounds = sorted(list(neg_idx) + [-1, vlen])
    for i in range(len(bounds) - 1):
        ll, rr = bounds[i], bounds[i + 1]
        score_matrix[ll + 1:rr, ll + 1:rr] = outer[ll + 1:rr, ll + 1:rr]
    score_matrix = np.triu(score_matrix, k=0)
    sidx = int(np.argmax(np.max(score_matrix, axis=1)))
    eidx = int(np.argmax(np.max(score_matrix, axis=0)))
    return sidx, eidx


def infer_idx(start_prob: np.ndarray, end_prob: np.ndarray) -> tuple[int, int]:
    """Plain upper-triangular outer-product decode without segment
    restrictions (reference infer_idx, utils/utils_hual.py:163-170; the
    loop does not call it)."""
    outer = np.triu(start_prob[:, None] * end_prob[None, :], k=0)
    sidx = int(np.argmax(np.max(outer, axis=1)))
    eidx = int(np.argmax(np.max(outer, axis=0)))
    return sidx, eidx


def renew_label(old_idx, annotations: dict, sprob: np.ndarray, eprob: np.ndarray,
                vlen: int, max_vlen: int, coff: RoundCoeffs) -> list[int]:
    """New [start, end] indices for one sample (reference update_label.py:85-123)."""
    pos_idx = annotations["pos_idx"]
    neg_idx = annotations["neg_idx"]

    old_sprop = center_width_gauss(old_idx[0], 0.5 * vlen, vlen=vlen, max_vlen=max_vlen)
    old_eprop = center_width_gauss(old_idx[1], 0.5 * vlen, vlen=vlen, max_vlen=max_vlen)

    if len(pos_idx) > 0:
        c = coff.pos
        s_dis, e_dis = distance_score_shift(pos_idx, neg_idx, vlen=vlen,
                                            max_vlen=max_vlen, shift=-0.3)
        start_score = s_dis * c.distance + sprob * c.model + old_sprop * c.old
        end_score = e_dis * c.distance + eprob * c.model + old_eprop * c.old
        start_score, end_score = mask_activepoints(start_score, end_score,
                                                   pos_idx, neg_idx, vlen=vlen)
        sidx = int(np.argmax(start_score))
        eidx = int(np.argmax(end_score))
    else:
        c = coff.neg
        s_dis, e_dis = distance_score_shift(pos_idx, neg_idx, vlen=vlen,
                                            max_vlen=max_vlen, shift=0.9)
        start_score = s_dis * c.distance + sprob * c.model + old_sprop * c.old
        end_score = e_dis * c.distance + eprob * c.model + old_eprop * c.old
        start_score, end_score = mask_activepoints(start_score, end_score,
                                                   pos_idx, neg_idx, vlen=vlen)
        sidx, eidx = _segmented_span_decode(start_score, end_score, neg_idx, vlen)
    return [sidx, eidx]
