"""Training labels built on the device (counterpart of
``hual_tpu/data/labels_jax.py``).

The same labels as ``data/labels.py`` (reference utils/data_loader.py:57-97)
from ``(s_ind, e_ind, v_len)`` alone, as broadcast compares in f32 rather
than scatters, so no (B, T) label tensor crosses from the host:

* every in-length frame gets the 1e-10 floor,
* the target frame gets +0.5 plus the folds of any missing neighbour,
* existing neighbours are ASSIGNED y = (1 - vlen*1e-10 - 0.5)/2,
* match windows painted B(1) -> I(2) -> E(3), later paints win, with the
  collision clamp st_r = max(st, et_l - 1).

The NumPy path computes y in f64 and casts; this one stays in f32, as the
JAX package's does (below 1e-7 apart).
"""

from __future__ import annotations

import torch


def make_span_labels_device(s_inds: torch.Tensor, e_inds: torch.Tensor,
                            vlens: torch.Tensor, max_len: int):
    """(y1, y2, match_labels, inner_labels), each (B, max_len): f32, f32,
    int32, f32; on the inputs' device."""
    s = s_inds.to(torch.int32)
    e = e_inds.to(torch.int32)
    vl = vlens.to(torch.int32)
    idx = torch.arange(max_len, dtype=torch.int32, device=s.device)[None, :]
    valid = idx < vl[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    base = torch.where(valid, torch.full_like(zero, 1e-10), zero)

    y = (1.0 - vl.to(torch.float32) * 1e-10 - 0.5) / 2.0

    def soft(t):
        has_left = (t > 0).to(torch.float32)
        has_right = (t < vl - 1).to(torch.float32)
        center = (base + 0.5
                  + (1.0 - has_left)[:, None] * y[:, None]
                  + (1.0 - has_right)[:, None] * y[:, None])
        is_t = idx == t[:, None]
        is_l = idx == (t[:, None] - 1)
        is_r = (idx == (t[:, None] + 1)) & valid
        yb = y[:, None].expand_as(base)
        return torch.where(is_t, center, torch.where(is_l | is_r, yb, base))

    y1 = soft(s)
    y2 = soft(e)

    ext = 2
    st_l = torch.clamp(s - ext, min=0)
    st_r = torch.minimum(s + ext, vl - 1)
    et_l = torch.clamp(e - ext, min=0)
    et_r = torch.minimum(e + ext, vl - 1)
    st_r = torch.where(st_r >= et_l, torch.maximum(s, et_l - 1), st_r)

    m1 = (idx >= st_l[:, None]) & (idx <= st_r[:, None])
    m2 = (idx > st_r[:, None]) & (idx < et_l[:, None])
    m3 = (idx >= et_l[:, None]) & (idx <= et_r[:, None])
    match = torch.where(m3, 3, torch.where(m2, 2, torch.where(m1, 1, 0)))
    return y1, y2, match.to(torch.int32), m2.to(torch.float32)
