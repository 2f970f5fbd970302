"""Observability (counterpart of ``hual_tpu/runtime/observability.py``).

* :class:`MetricsWriter` appends one JSON object per event to a .jsonl file.
* :func:`trace` names a block as a ``torch.profiler.record_function`` range,
  so a torch.profiler trace shows the block and the kernels under it; with
  a profile directory (the argument or ``$HUAL_PROFILE_DIR``) it also
  records a torch.profiler trace of the block into that directory.
* :class:`StepTimer` tracks wall time and pairs/s with warmup steps skipped.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch


class MetricsWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def write(self, kind: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "kind": kind, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


@contextlib.contextmanager
def trace(name: str, profile_dir: Optional[str] = None):
    """A named range for torch.profiler; costs a few µs of host time when
    no profiler is recording.  With ``profile_dir``, or ``$HUAL_PROFILE_DIR``
    set, the block runs under a torch.profiler recording (CPU activities,
    and CUDA activities where a card is present) whose Chrome trace is
    written to ``<profile_dir>/<name>-<pid>-<ns>.pt.trace.json``."""
    profile_dir = profile_dir or os.environ.get("HUAL_PROFILE_DIR")
    if not profile_dir:
        with torch.profiler.record_function(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{name}-{os.getpid()}-{time.time_ns()}.pt.trace.json"))


class StepTimer:
    """Step-time / throughput accounting with warmup-step exclusion."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._seen = 0
        self._time = 0.0
        self._items = 0
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, n_items: int) -> None:
        assert self._last is not None
        dt = time.perf_counter() - self._last
        self._seen += 1
        if self._seen > self.warmup:
            self._time += dt
            self._items += n_items

    @property
    def pairs_per_sec(self) -> float:
        return self._items / self._time if self._time > 0 else 0.0

    @property
    def mean_step_ms(self) -> float:
        steps = self._seen - self.warmup
        return (self._time / steps * 1e3) if steps > 0 else 0.0
