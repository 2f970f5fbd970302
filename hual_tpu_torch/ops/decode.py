"""Span decoding, plain PyTorch (counterpart of ``hual_tpu/ops/decode.py``).

Softmax the masked start/end logits, outer-product them, keep the upper
triangle (start <= end), and take the row / column argmax of the max-reduced
grid.  Ties go to the first index (``torch.argmax`` returns the first
maximum).  This is the plain version of the Hopper kernel in
``ops/kernels/span_decode.py``: the CPU path and the kernel's reference.
"""

from __future__ import annotations

import torch

from hual_tpu_torch.ops.masking import mask_logits


def span_decode(start_logits: torch.Tensor, end_logits: torch.Tensor,
                mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,T) f32 logits, (B,T) 0/1 mask -> (start_index, end_index), (B,) int32."""
    start_prob = torch.softmax(mask_logits(start_logits, mask), dim=1)
    end_prob = torch.softmax(mask_logits(end_logits, mask), dim=1)
    outer = start_prob[:, :, None] * end_prob[:, None, :]          # (B, T, T)
    outer = torch.triu(outer)
    start_index = outer.amax(dim=2).argmax(dim=1).to(torch.int32)
    end_index = outer.amax(dim=1).argmax(dim=1).to(torch.int32)
    return start_index, end_index
