"""K2's CUDA source run on the CPU (``tools/torch_k2_emulate.py``: g++, a
stand-in runtime, the PTX helpers emulated by their hardware layouts)
against its plain version, both product paths, at small widths.

The bf16 path's product routes: mma.sync for every product at D=32, 36
and 20 (k and heads not multiples of 16, or rows up to 48); wgmma
m64n64k16 (49-64 rows) and m64n128k16 (65-128 rows) where every leaf is
whole 64-deep slabs (D=64 here, D=128 on the card).  At the D=32/36/20
shapes the f32 sums, which differ from torch's in order, flip no bf16
rounding, so the kernel equals ``forward_math(mxu_bf16=True)`` to 5e-7
(the bound: 1e-5).  Where a rounding flips, as in every D=64 case, the
two agree only statistically: S (rms distance from the f64 version over
the plain bf16 version's) in [0.5, 2], which a wrong fragment or
descriptor layout (errors of O(1)) cannot meet.  The f64 path is held
within 1e-5 of the plain version in f64.  The (3, 1, 1) cases run a model
of ``max_vlen`` 1, whose position tables are (1, D).  One build (~15 s of g++) serves
the module.
"""

from __future__ import annotations

import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_k2_emulate as emu  # noqa: E402


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernel")
    return emu.load(emu.build(str(tmp_path_factory.mktemp("k2_emulate"))))


@pytest.mark.parametrize("B,T,W,D,H", [(1, 17, 5, 32, 4), (1, 49, 13, 32, 4),
                                       (1, 65, 13, 32, 4), (1, 17, 5, 36, 4),
                                       (1, 17, 5, 20, 5), (3, 1, 1, 32, 4)])
def test_bf16_path_equals_its_plain_version(lib, B, T, W, D, H):
    res = emu.compare(lib, B, T, W, D, H, 1, mxu_bf16=True)
    for name, r in res.items():
        assert r["finite"], name
        assert r["plain"] <= 1e-5, (name, r)


@pytest.mark.parametrize("B,T,W,D,L", [(4, 64, 13, 32, 2), (2, 49, 13, 64, 1),
                                       (2, 65, 13, 64, 1)])
def test_bf16_path_statistically(lib, B, T, W, D, L):
    res = emu.compare(lib, B, T, W, D, 4, L, mxu_bf16=True, seed=4)
    for name, r in res.items():
        assert r["finite"], name
        assert 0.5 <= r["S"] <= 2.0, (name, r)
        assert r["exact"] <= 0.3, (name, r)


@pytest.mark.parametrize("B,T,W,D,H", [(2, 17, 5, 36, 4), (1, 49, 13, 32, 4),
                                       (3, 1, 1, 32, 4)])
def test_f64_path_equals_its_plain_version(lib, B, T, W, D, H):
    res = emu.compare(lib, B, T, W, D, H, 1, mxu_bf16=False)
    for name, r in res.items():
        assert r["finite"], name
        assert r["exact"] <= 1e-5, (name, r)
