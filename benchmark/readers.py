"""What the metric readers (``metrics/<name>.py``) share."""

from __future__ import annotations

from benchmark import flops


def untraced_calls(facts: dict) -> list[float]:
    """Seconds of the window's calls, the traced first call left out when
    there are others."""
    calls = facts["calls"]
    return calls[1:] if "trace" in facts and len(calls) > 1 else calls


def sweep_mfu(facts: dict, passes: int):
    """``passes`` reference forwards of every valid row of the split, at the
    padded widths, over a call's mean seconds, as a percentage of the f32 peak."""
    e = facts["entry"]
    per_row = flops.reference_flops(facts["spec"], 1, e["W"], e["C"], train=False)
    calls = untraced_calls(facts)
    return flops.peak_share("mfu", passes * per_row * e["queries"], sum(calls) / len(calls))
