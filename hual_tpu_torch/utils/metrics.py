"""Interval IoU metrics and the two time <-> index conventions (counterpart
of ``hual_tpu/utils/metrics.py``).

Both conventions of the reference are kept, because label parity depends on
them:

* trainer convention: ``time_to_index`` is the argmax-IoU span over the
  (s, e) candidate grid; ``index_to_time`` is ``s = i*dur/T``,
  ``e = (i+1)*dur/T``;
* active-learning convention: ``time_to_index_al`` is
  ``round(t/dur*(T-1))``; ``index_to_time_al`` is ``round(t/(T-1)*dur, 2)``.
"""

from __future__ import annotations

import json

import numpy as np


# -- interval IoU -------------------------------------------------------------
def calculate_iou(i0, i1) -> float:
    """IoU of two [start, end] intervals; 0.0 on a zero-length union."""
    union = (min(i0[0], i1[0]), max(i0[1], i1[1]))
    inter = (max(i0[0], i1[0]), min(i0[1], i1[1]))
    if (union[1] - union[0]) == 0.0:
        return 0.0
    iou = 1.0 * (inter[1] - inter[0]) / (union[1] - union[0])
    return max(0.0, iou)


def batched_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Vectorized interval IoU.  pred/gt: (N, 2) float arrays of [s, e]."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    inter = np.minimum(pred[:, 1], gt[:, 1]) - np.maximum(pred[:, 0], gt[:, 0])
    union = np.maximum(pred[:, 1], gt[:, 1]) - np.minimum(pred[:, 0], gt[:, 0])
    iou = np.where(union == 0.0, 0.0, inter / np.where(union == 0.0, 1.0, union))
    return np.maximum(iou, 0.0)


def calculate_iou_accuracy(ious, threshold: float) -> float:
    """R@1,IoU>=threshold as a percentage."""
    ious = np.asarray(ious, dtype=np.float64)
    if ious.size == 0:
        return 0.0
    return float(np.count_nonzero(ious >= threshold)) / float(ious.size) * 100.0


def rank1_metrics(ious) -> dict[str, float]:
    """R1@{0.3,0.5,0.7} and mIoU*100."""
    ious = np.asarray(ious, dtype=np.float64)
    return {
        "r1i3": calculate_iou_accuracy(ious, 0.3),
        "r1i5": calculate_iou_accuracy(ious, 0.5),
        "r1i7": calculate_iou_accuracy(ious, 0.7),
        "miou": float(np.mean(ious) * 100.0) if ious.size else 0.0,
    }


# -- trainer convention -------------------------------------------------------
def compute_overlap_grid(num_units: int, start_time: float, end_time: float,
                         duration: float) -> np.ndarray:
    """IoU of every unit-aligned (s_idx, e_idx) candidate vs [start, end]."""
    s_times = np.arange(0, num_units, dtype=np.float32) / float(num_units) * duration
    e_times = np.arange(1, num_units + 1, dtype=np.float32) / float(num_units) * duration
    inter = np.maximum(
        0.0,
        np.minimum(e_times[None, :], end_time) - np.maximum(s_times[:, None], start_time),
    )
    union = np.maximum(
        1e-12,
        np.maximum(e_times[None, :], end_time) - np.minimum(s_times[:, None], start_time),
    )
    return (1.0 * inter / union).astype(np.float64)


def time_to_index(start_time: float, end_time: float, num_units: int,
                  duration: float) -> tuple[int, int]:
    """Best unit-aligned span by IoU."""
    overlaps = compute_overlap_grid(num_units, start_time, end_time, duration)
    flat = int(np.argmax(overlaps))
    return flat // num_units, flat % num_units


def index_to_time(start_index: int, end_index: int, num_units: int,
                  duration: float) -> tuple[float, float]:
    """Trainer convention: s = i*dur/T, e = (i+1)*dur/T."""
    start_time = float(start_index) * float(duration) / float(num_units)
    end_time = float(end_index + 1) * float(duration) / float(num_units)
    return start_time, end_time


def index_to_time_batch(start_idx: np.ndarray, end_idx: np.ndarray,
                        num_units: np.ndarray, duration: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``index_to_time`` in float32."""
    num_units = np.asarray(num_units, dtype=np.float32)
    duration = np.asarray(duration, dtype=np.float32)
    s = start_idx.astype(np.float32) * duration / num_units
    e = (end_idx.astype(np.float32) + 1.0) * duration / num_units
    return s, e


# -- active-learning convention -----------------------------------------------
def time_to_index_al(t, duration: float, vlen: int):
    """round(t/dur*(vlen-1)); recursive over lists."""
    if isinstance(t, (list, tuple)):
        return [time_to_index_al(x, duration, vlen) for x in t]
    return round(t / duration * (vlen - 1))


def index_to_time_al(t, duration: float, vlen: int):
    """round(t/(vlen-1)*dur, 2); recursive over lists."""
    if isinstance(t, (list, tuple)):
        return [index_to_time_al(x, duration, vlen) for x in t]
    return round(t / (vlen - 1) * duration, 2)


def miou_two_record_lists(data1: list, data2: list) -> float:
    """mIoU between two train.json record lists."""
    assert len(data1) == len(data2)
    ious = []
    for x1, x2 in zip(data1, data2):
        assert x1[0] == x2[0]
        ious.append(calculate_iou(x1[2], x2[2]))
    return float(np.mean(ious))


def miou_two_dataset(path1: str, path2: str) -> float:
    """File-path variant of :func:`miou_two_record_lists`."""
    with open(path1) as f1, open(path2) as f2:
        return miou_two_record_lists(json.load(f1), json.load(f2))
