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

One build (~15 s of g++) serves the modules: ``emu.build()`` keys the
library by the source's digest under ``build/k2_emulate/`` and lets the
first of the xdist workers that ask build it while the others wait.

The tiled routes (``tests/test_torch_k2_emulated_tiles_{f64,bf16}.py``)
run in builds of the general kernel (``build(general=True)``; the other
files build the resident one):
the ones that follow fixed lengths (more than 112 keys, 128 rows, 128
output columns or 4 slabs of k to a product, D past 128 or not a
multiple of 4) open at shapes the emulator affords with this build; the
ones that follow the shared-memory budget open at small shapes in a build
whose budget (kSmemLimit) ``emu.build(smem_limit=...)`` rewrites, one a
path: :data:`F64_TIGHT` bytes, where the f64 path's attention groups its
heads from T=100 at D=32 and streams its scores, with the masks in the
workspace, at T=200; :data:`BF16_TIGHT`, where the bf16 path's attention
groups two of four heads at T=40 and at T=130 has no head that fits,
its CQ products tile at 64 and its masks go to the workspace.
"""

from __future__ import annotations

import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_k2_emulate as emu  # noqa: E402


F64_TIGHT = 192_000
BF16_TIGHT = 115_000


def build(smem_limit: int | None = None, general: bool = False):
    """The emulated library: the resident kernel, or with ``general`` the
    general one, with kSmemLimit at ``smem_limit`` bytes if given."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernel")
    return emu.load(emu.build(smem_limit=smem_limit, general=general))


@pytest.fixture(scope="module")
def lib():
    return build()
