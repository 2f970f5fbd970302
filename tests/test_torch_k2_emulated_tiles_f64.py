"""K2's f64 path past the shape limit it had (T and W up to 100, D up to
128 and a multiple of 4), emulated on the CPU, against its plain version in
f64 within 1e-5 (``tests/torch_k2_emulation.py``).  Each case names the
routes it reaches (``fused_forward_routes``); the budget-driven ones in the
build of a smaller shared-memory budget (``F64_TIGHT``)."""

from __future__ import annotations

import pytest

from torch_k2_emulation import F64_TIGHT, build, emu
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib():
    return build(general=True)


@pytest.fixture(scope="module")
def resident():
    return build()


@pytest.fixture(scope="module")
def tight():
    return build(F64_TIGHT, general=True)


CASES = {
    # name: (B, T, W, D, H), tight build, the routes it must take
    "streamed_scores_masks_in_workspace": (
        (1, 200, 9, 16, 4), True, dict(f64_attention=2, f64_masks_smem=0)),
    "grouped_heads": ((1, 100, 9, 32, 4), True, dict(f64_attention=1, f64_heads=2)),
    # T past 100 at D not a multiple of 4 (the JAX parity case's shape)
    "t120_d30": ((1, 120, 5, 30, 5), False, dict(f64_attention=0)),
    "layer_norm_in_chunks_d136": ((1, 17, 5, 136, 8), False, {}),
    "scalar_tails_d90": ((1, 17, 5, 90, 6), False, dict(f64_attention=0, f64_heads=6)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_f64_tiled_routes_equal_the_plain_version(lib, tight, resident, name):
    (B, T, W, D, H), is_tight, want = CASES[name]
    use = tight if is_tight else lib
    if not is_tight:  # the general kernel's shape
        assert resident.fused_forward_takes(T, W, D, H, 0) == 0
    got = emu.routes(use, T, W, D, H)
    assert {k: got[k] for k in want} == want, got
    res = emu.compare(use, B, T, W, D, H, 1, mxu_bf16=False)
    for out, r in res.items():
        assert r["finite"], out
        assert r["exact"] <= 1e-5, (out, r)
