"""TF1-compatible initializers (counterpart of ``hual_tpu/models/initializers.py``).

Fans follow TF's rule on the JAX package's parameter shapes: rank>=3 kernels
count every axis but the last two as the receptive field.  The port's
modules store some weights in PyTorch's layouts, so they draw in the JAX
shape and then move the axes (``weights.py`` documents each move).  Every
draw comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def tf_fans(shape: Sequence[int]) -> tuple[float, float]:
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = float(math.prod(shape[:-2]))
    return receptive * shape[-2], receptive * shape[-1]


def glorot_limit(shape: Sequence[int]) -> float:
    fan_in, fan_out = tf_fans(shape)
    return math.sqrt(6.0 / (fan_in + fan_out))


def glorot_uniform_tf(shape: Sequence[int],
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-limit, limit) with TF's glorot limit for a kernel of ``shape``."""
    limit = glorot_limit(shape)
    return torch.empty(tuple(shape)).uniform_(-limit, limit,
                                              generator=generator)


def orthogonal(shape: Sequence[int],
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Orthonormal rows or columns, as ``jax.nn.initializers.orthogonal()``."""
    n_rows, n_cols = shape
    flip = n_rows < n_cols
    a = torch.randn((n_cols, n_rows) if flip else (n_rows, n_cols),
                    generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q.T if flip else q).to(torch.float32).contiguous()
