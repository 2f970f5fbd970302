"""Percent of the traced AL call spent outside the port's ``infer_sweep``
range: the host's work after the sweep, mostly the round pickle's write.
The call's length is the trace's window, which opens and closes on a device
synchronisation around the call (the call's host-clock time would also hold
the profiler's own teardown)."""

from benchmark import trace as tracing


def read(facts: dict):
    tr = facts.get("trace")
    spans = tracing.range_seconds(tr, "infer_sweep") if tr else []
    if len(spans) != 1 or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - spans[0]) / tr["window_s"]
