#!/usr/bin/env python
"""Convert 'glance' annotations (one timestamp per moment) into fixed-width
pseudo spans, the port's side of scripts/viga_extend_label.py (reference
scripts/viga_extend_label.py): each glance t becomes
[t - f*dur/2, t + f*dur/2] clipped to the video, written in the standard
train.json record format, and the mean IoU vs GT is reported.

    python scripts/torch_viga_extend_label.py data/anet_viga/train_old.json \
        data/anet_viga/train.json --factor 0.4
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from hual_tpu_torch.utils.metrics import calculate_iou  # noqa: E402


def extend_glances(data: dict, factor: float) -> tuple[list, float]:
    new_data, ious = [], []
    for vid, rec in data.items():
        duration = rec["duration"]
        for time_gt, sentence, glance in zip(rec["timestamps"],
                                             rec["sentences"], rec["glance"]):
            s = max(glance - duration * factor / 2, 0)
            e = min(glance + duration * factor / 2, duration)
            new_data.append([vid, duration, [s, e], sentence])
            ious.append(calculate_iou([s, e], time_gt))
    return new_data, float(np.mean(ious)) if ious else 0.0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--factor", type=float, default=0.4)
    a = p.parse_args(argv)
    with open(a.src) as f:
        data = json.load(f)
    new_data, miou = extend_glances(data, a.factor)
    with open(a.dst, "w") as f:
        json.dump(new_data, f)
    print(a.factor)
    print(len(new_data), miou)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
