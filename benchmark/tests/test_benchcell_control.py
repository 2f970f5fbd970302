"""On the card, at each cell's own size: the control (the reference at TF32
in the port's place) comes out not correct, and so does training's fault of
half of each batch left out.  ``calibrate.py`` takes the same readings on
more seeds; the limits in ``workloads/<cell>.json`` were set from them."""

import time

import pytest

from benchmark import harness

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def _run(workload, seed, mode):
    return harness.run(workload, seed, 0.0, False, time.perf_counter(), device="cuda",
                       entry_options={"mode": mode})


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ("charades.train", "anet.test_sweep", "charades.al_sweep"))
def test_control_is_not_correct(card, workload, seed):
    r = _run(workload, seed, "control")
    assert not r["correct"], r["compared"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_half_batch_fault_is_not_correct(card, seed):
    r = _run("charades.train", seed, "fault_half_batch")
    assert not r["correct"], r["compared"]
