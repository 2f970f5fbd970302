"""Debug plots of the training labels (counterpart of
``hual_tpu/runtime/debug.py``; reference plot_se_label,
utils/runner_utils.py:40-50).

Saves one plot per sample: the soft start/end label curves and the 4-class
match labels.  Returns no paths when matplotlib is missing.
"""

from __future__ import annotations

import os

import numpy as np


def plot_se_label(s_labels, e_labels, match_labels,
                  out_dir: str = "./imgs/debug") -> list[str]:
    """(B, T) labels, as NumPy arrays or tensors on any device -> the paths
    of the B plots written under ``out_dir``."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except ImportError:
        return []
    s_labels, e_labels, match_labels = (
        np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)
        for a in (s_labels, e_labels, match_labels))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(s_labels.shape[0]):
        plt.plot(s_labels[i], label="start")
        plt.plot(e_labels[i], label="end")
        plt.scatter(np.arange(match_labels.shape[1]), match_labels[i],
                    s=8, c="k", label="match")
        plt.legend()
        path = os.path.join(out_dir, f"{i}.jpg")
        plt.savefig(path)
        plt.cla()
        paths.append(path)
    return paths
