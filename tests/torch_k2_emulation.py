"""K2's CUDA source run on the CPU (``tools/torch_k2_emulate.py``: g++, a
stand-in runtime, the PTX helpers emulated by their hardware layouts)
against its plain version, both product paths, at small widths: the
shared build of ``tests/test_torch_k2_emulated_{bf16,bf16_stats,f64}.py``.

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
of ``max_vlen`` 1, whose position tables are (1, D).

One build (~15 s of g++) serves the three modules: ``emu.build()`` keys
the library by the source's digest under ``build/k2_emulate/`` and lets
the first of the xdist workers that ask build it while the others wait.
"""

from __future__ import annotations

import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_k2_emulate as emu  # noqa: E402


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernel")
    return emu.load(emu.build())
