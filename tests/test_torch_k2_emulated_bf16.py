"""K2's bf16 path, emulated on the CPU, against its plain version where no
bf16 rounding flips (``tests/torch_k2_emulation.py``)."""

from __future__ import annotations

import pytest

from torch_k2_emulation import emu, lib  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


@pytest.mark.parametrize("B,T,W,D,H", [(1, 17, 5, 32, 4), (1, 49, 13, 32, 4),
                                       (1, 65, 13, 32, 4), (1, 17, 5, 36, 4),
                                       (1, 17, 5, 20, 5), (3, 1, 1, 32, 4)])
def test_bf16_path_equals_its_plain_version(lib, B, T, W, D, H):
    res = emu.compare(lib, B, T, W, D, H, 1, mxu_bf16=True)
    for name, r in res.items():
        assert r["finite"], name
        assert r["plain"] <= 1e-5, (name, r)
