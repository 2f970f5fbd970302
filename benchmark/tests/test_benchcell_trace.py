"""The traced window's reduction, on made-up profiler events: the busy time
is the union of device intervals inside the window, the device copies of
host ranges are left out, idle gaps are named by the innermost host range,
and a trace with fewer K2 launches than the port counted is refused."""

import pytest
import torch

from benchmark import harness
from benchmark import trace as tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


EVENTS = [Ev(tracing.WINDOW, CPU, 0, 1000),
          Ev("infer_sweep", CPU, 10, 700),
          Ev("aten::copy_", CPU, 750, 900),
          Ev("infer_sweep", CUDA, 10, 700),            # the range's device copy
          Ev("void fused_forward_kernel<false>(Params)", CUDA, 100, 300),
          Ev("void fused_forward_kernel<false>(Params)", CUDA, 250, 400),
          Ev("span_decode_kernel", CUDA, 600, 650),
          Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 950, 1100)]


def test_busy_gaps_and_names():
    f = tracing.reduce(EVENTS)
    assert f["window_s"] == pytest.approx(1e-6)
    assert f["busy_s"] == pytest.approx((300 + 50 + 50) * 1e-9)
    gaps = dict((round(s * 1e9), n) for n, s in f["breakdown"]["idle_gaps"])
    assert gaps == {300: "infer_sweep", 200: "infer_sweep", 100: tracing.WINDOW}
    assert f["breakdown"]["device_ops"][0][0].startswith("void fused_forward_kernel")
    assert tracing.range_seconds(f, "infer_sweep") == [pytest.approx(690e-9)]
    idle = harness._load_module(harness.reader_path("idle_share.al_sweep"), "idle_share")
    assert idle.read({"trace": f}) == pytest.approx(60.0)


def test_launch_counts_must_match_the_trace():
    f = tracing.reduce(EVENTS)
    tracing.check_launches(f, {"span_decode": 1, "fused_forward": 2, "fused_forward_bf16": 0})
    with pytest.raises(RuntimeError):
        tracing.check_launches(f, {"span_decode": 1, "fused_forward": 3,
                                   "fused_forward_bf16": 0})


@pytest.mark.parametrize("traced, ok", [(200, True), (199, True), (198, True), (197, False),
                                        (201, False)])
def test_a_trace_may_miss_one_launch_in_a_hundred(traced, ok):
    facts = {"kernels": {"span_decode_kernel": [(0, 1)] * traced}}
    launched = {"span_decode": 200, "fused_forward": 0, "fused_forward_bf16": 0}
    if ok:
        tracing.check_launches(facts, launched)
    else:
        with pytest.raises(RuntimeError):
            tracing.check_launches(facts, launched)
