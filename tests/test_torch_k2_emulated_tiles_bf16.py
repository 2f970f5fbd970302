"""K2's bf16 path past the shape limit it had (T and W up to 100, D up to
128 and a multiple of 4), emulated on the CPU, against its plain version
(``tests/torch_k2_emulation.py``): within 1e-5 where no bf16 rounding flips,
else S (rms distance from the f64 version over the plain bf16 version's) in
[0.5, 2], which a wrong fragment, slab, pass or chunk (errors of O(1))
cannot meet.  Each case names the routes it reaches; the budget-driven ones
in the build of a smaller shared-memory budget (``BF16_TIGHT``).  S is
taken over every output of the batch, so the single-sample cases flip few
roundings and the tight streamed case runs B=2."""

from __future__ import annotations

import pytest

from torch_k2_emulation import BF16_TIGHT, build, emu
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib():
    return build(general=True)


@pytest.fixture(scope="module")
def resident():
    return build()


@pytest.fixture(scope="module")
def tight():
    return build(BF16_TIGHT, general=True)


CASES = {
    # name: (B, T, W, D, H), tight build, routes, bound ("plain" or "S")
    # every attention streamed (no head fits), 130 keys in three chunks; CQ
    # products in 64-wide tiles with k split; row passes; masks in the
    # workspace
    "streamed_cq_tiles_masks_in_workspace": (
        (2, 130, 5, 16, 4), True,
        dict(bf16_heads=0, bf16_cq_tile=64, bf16_masks_smem=0), "S"),
    "head_groups": ((1, 40, 9, 16, 4), True, dict(bf16_heads=2, bf16_cq_tile=0), "plain"),
    # 136 columns: two column passes; k of 272: chunks; head dim 68: two
    # streamed dim chunks over 120 keys; LayerNorm in chunks
    "column_passes_split_k_d136": ((1, 120, 5, 136, 2), False, dict(bf16_heads=1), "S"),
    # wgmma (65 rows, whole slabs) in column passes and chunks of k
    "wgmma_passes_d192": ((1, 65, 13, 192, 8), False, dict(bf16_heads=4), "S"),
    "scalar_tails_d90": ((2, 17, 5, 90, 6), False, dict(bf16_heads=6), "S"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_tiled_routes_against_the_plain_version(lib, tight, resident, name):
    (B, T, W, D, H), is_tight, want, bound = CASES[name]
    use = tight if is_tight else lib
    if not is_tight:  # the general kernel's shape
        assert resident.fused_forward_takes(T, W, D, H, 1) == 0
    got = emu.routes(use, T, W, D, H)
    assert {k: got[k] for k in want} == want, got
    res = emu.compare(use, B, T, W, D, H, 1, mxu_bf16=True)
    for out, r in res.items():
        assert r["finite"], out
        if bound == "plain":
            assert r["plain"] <= 1e-5, (out, r)
        else:
            assert 0.5 <= r["S"] <= 2.0, (out, r)
            assert r["exact"] <= 0.3, (out, r)
