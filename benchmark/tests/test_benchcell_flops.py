"""The copied arithmetic: K2's FLOPs, the peak-share guard, the reference's
FLOP count."""

import json

import pytest

from benchmark import flops

from conftest import ROOT


def test_k2_flops_at_charades_width():
    assert flops.k2_flops(96, 64, 13) == 15_459_225_600


def test_peak_share_refuses_over_105_percent():
    assert flops.peak_share("x", 67e12, 1.0) == pytest.approx(100.0)
    assert flops.peak_share("x", 70e12, 1.0) == pytest.approx(104.477, rel=1e-4)
    with pytest.raises(RuntimeError):
        flops.peak_share("x", 71e12, 1.0)
    with pytest.raises(RuntimeError):
        flops.peak_share("x", 1.0, 0.0)


def test_reference_flops_scale_with_the_batch_and_count_the_backward():
    spec = json.loads((ROOT / "benchmark/configs/seqpan-charades.json").read_text())
    one = flops.reference_flops(spec, 1, 13, 10, train=False)
    assert flops.reference_flops(spec, 4, 13, 10, train=False) == pytest.approx(4 * one, rel=1e-3)
    # the products K2 computes are a lower bound of the forward's
    assert 0.9 * flops.k2_flops(1, 64, 13) < one
    assert flops.reference_flops(spec, 1, 13, 10, train=True) > 2.5 * one
