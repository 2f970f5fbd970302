"""Per-round pseudo-label mixing coefficients (counterpart of
``hual_tpu/active/coefficients.py``; reference update_label.py:11-37).

``F_RENEW[task][pos|neg][old|model|distance][I]`` weights the three score
sources (previous label Gaussian / model probability / distance Gaussian)
when regenerating labels at round I; ``uncert[I]`` scales the model
uncertainty inside the per-frame acquisition score.  Rounds are 1-indexed;
index 0 is unused (None).
"""

from __future__ import annotations

from dataclasses import dataclass

F_RENEW = {
    "charades": {
        "pos": {
            "old":      [None, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
            "model":    [None, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8],
            "distance": [None, 4.0, 0.2, 0.2, 0.2, 0.2, 0.2],
        },
        "neg": {
            "old":      [None, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
            "model":    [None, 2.4, 0.2, 0.2, 0.2, 0.2, 0.2],
            "distance": [None, 2.0, 0.2, 0.2, 0.2, 0.2, 0.2],
        },
        "uncert": [None, 0.25, 0.25, 0.25, 0.25, 0.25, 0.25],
    },
    "anet": {
        "pos": {
            "old":      [None, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
            "model":    [None, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
            "distance": [None, 2.0, 1.8, 1.6, 1.5, 1.5, 1.5],
        },
        "neg": {
            "old":      [None, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
            "model":    [None, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
            "distance": [None, 2.0, 1.8, 1.6, 1.5, 1.5, 1.5],
        },
        "uncert": [None, 0.25, 0.25, 0.25, 0.25, 0.25, 0.25],
    },
}


@dataclass(frozen=True)
class BranchCoeffs:
    old: float
    model: float
    distance: float


@dataclass(frozen=True)
class RoundCoeffs:
    pos: BranchCoeffs
    neg: BranchCoeffs
    uncert: float


def get_coff(table: dict, task: str, round_idx: int) -> RoundCoeffs:
    """Slice the coefficient table at round I (reference update_label.py:212-218).

    Rounds past the table (the reference stops at 6) hold the last defined
    round's weights: the schedules are constant from round 2 on, so this is
    their natural continuation.  An extrapolation, not reference data.
    """
    t = table[task]
    i = min(round_idx, len(t["uncert"]) - 1)
    if round_idx < 1:
        raise ValueError(f"rounds are 1-indexed, got {round_idx}")
    return RoundCoeffs(
        pos=BranchCoeffs(**{k: v[i] for k, v in t["pos"].items()}),
        neg=BranchCoeffs(**{k: v[i] for k, v in t["neg"].items()}),
        uncert=t["uncert"][i],
    )


def max_rounds(table: dict, task: str) -> int:
    return len(table[task]["uncert"]) - 1
