"""Masking primitives (counterpart of ``hual_tpu/ops/masking.py``).

Validity travels as 0/1 int masks and is applied with the additive -1e30
convention.  A fully padded ``from`` row gets -1e30 added to every score,
which absorbs the finite scores in f32, so it attends uniformly: a boolean
mask would give NaNs or zeros there instead, so none is used.
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e30


def sequence_mask(lengths: torch.Tensor, maxlen: int,
                  dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(B,) lengths -> (B, maxlen) 0/1 mask."""
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def mask_logits(inputs: torch.Tensor, mask: torch.Tensor,
                mask_value: float = MASK_VALUE) -> torch.Tensor:
    """inputs*mask + mask_value*(1-mask), mask broadcastable to inputs."""
    mask = mask.to(inputs.dtype)
    return inputs * mask + mask_value * (1.0 - mask)


def attention_bias(from_mask: torch.Tensor,
                   to_mask: torch.Tensor) -> torch.Tensor:
    """(B,1,F,T) additive bias: (1 - from_mask⊗to_mask) * -1e30."""
    pair = (from_mask[:, :, None] * to_mask[:, None, :]).to(torch.float32)
    return ((1.0 - pair) * MASK_VALUE)[:, None, :, :]
