"""K2's bf16 path, emulated on the CPU, against its plain version where
bf16 roundings flip: in distribution (``tests/torch_k2_emulation.py``)."""

from __future__ import annotations

import pytest

from torch_k2_emulation import emu, lib  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


@pytest.mark.parametrize("B,T,W,D,L", [(4, 64, 13, 32, 2), (2, 49, 13, 64, 1),
                                       (2, 65, 13, 64, 1)])
def test_bf16_path_statistically(lib, B, T, W, D, L):
    res = emu.compare(lib, B, T, W, D, 4, L, mxu_bf16=True, seed=4)
    for name, r in res.items():
        assert r["finite"], name
        assert 0.5 <= r["S"] <= 2.0, (name, r)
        assert r["exact"] <= 0.3, (name, r)
