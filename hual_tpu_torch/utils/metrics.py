"""Time <-> index conversion (counterpart of ``hual_tpu/utils/metrics.py``)."""

from __future__ import annotations


def index_to_time(start_index: int, end_index: int, num_units: int,
                  duration: float) -> tuple[float, float]:
    """Trainer convention: s = i*dur/T, e = (i+1)*dur/T."""
    start_time = float(start_index) * float(duration) / float(num_units)
    end_time = float(end_index + 1) * float(duration) / float(num_units)
    return start_time, end_time
