"""Gumbel sampling utilities (counterpart of ``hual_tpu/ops/gumbel.py``).

``gumbel_sample`` backs the gumbel path of the matching head (off by
default: ``loss.no_gumbel: true`` in both reference configs);
``gumbel_softmax``, ``gumbel_sigmoid`` and ``label_smoothing`` complete the
reference's op surface.  Every draw takes an explicit ``torch.Generator`` on
the tensor's device.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _uniform(shape: Sequence[int], generator: torch.Generator,
             like: torch.Tensor) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=like.device,
                      dtype=like.dtype)


def gumbel_sample(generator: torch.Generator, shape: Sequence[int],
                  like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise of ``shape``, on ``like``'s device and dtype."""
    u = _uniform(shape, generator, like)
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def _hard(y: torch.Tensor) -> torch.Tensor:
    # the reference's straight-through estimator takes the max over axis 1
    y_hard = (y == y.amax(dim=1, keepdim=True)).to(y.dtype)
    return (y_hard - y).detach() + y


def gumbel_softmax(generator: torch.Generator, logits: torch.Tensor, tau: float,
                   hard: bool = False) -> torch.Tensor:
    noise = gumbel_sample(generator, logits.shape, logits)
    y = torch.softmax((logits + noise) / tau, dim=-1)
    return _hard(y) if hard else y


def gumbel_sigmoid(generator: torch.Generator, logits: torch.Tensor, tau: float,
                   hard: bool = False) -> torch.Tensor:
    u1 = _uniform(logits.shape, generator, logits)
    u2 = _uniform(logits.shape, generator, logits)
    noise = -torch.log(torch.log(u2 + 1e-20) / torch.log(u1 + 1e-20) + 1e-20)
    y = torch.sigmoid((logits + noise) / tau)
    return _hard(y) if hard else y


def label_smoothing(labels: torch.Tensor, mask: torch.Tensor,
                    epsilon: float = 0.1) -> torch.Tensor:
    mask = mask.to(torch.float32)
    labels = labels.to(torch.float32)
    seq_len = mask.sum(dim=1)
    smooth = (1.0 - epsilon) * labels + (epsilon / seq_len)[:, None]
    return smooth * mask
