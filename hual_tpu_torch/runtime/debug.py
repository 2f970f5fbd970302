"""Debug helpers: plots of the training labels (counterpart of
``hual_tpu/runtime/debug.py``; reference plot_se_label,
utils/runner_utils.py:40-50) and the deterministic mode that makes a resumed
run replay the uninterrupted one bit for bit on the card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# cuBLAS's deterministic workspace setting (PyTorch's reproducibility notes)
CUBLAS_WORKSPACE = ":4096:8"


def enable_deterministic() -> None:
    """Deterministic mode for this process: ``CUBLAS_WORKSPACE_CONFIG``
    (set to ``:4096:8`` where it is unset) and
    ``torch.use_deterministic_algorithms(True)``.

    cuBLAS reads the variable when it starts, so it must be set before CUDA
    is initialised: raises RuntimeError if CUDA is initialised and the
    variable was not set, rather than promise a replay it cannot give.
    """
    if not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "deterministic mode needs CUBLAS_WORKSPACE_CONFIG before CUDA "
                "starts: enable it first in the process, or set "
                f"CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} in the environment")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)


def plot_se_label(s_labels, e_labels, match_labels,
                  out_dir: str = "./imgs/debug") -> list[str]:
    """(B, T) labels, as NumPy arrays or tensors on any device -> the paths
    of the B plots written under ``out_dir``: per sample the soft start/end
    label curves and the 4-class match labels.  Returns no paths when
    matplotlib is missing."""
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
