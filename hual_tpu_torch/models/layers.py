"""Neural building blocks, deterministic forward (counterpart of
``hual_tpu/models/layers.py``).

Layouts are PyTorch's: a dense kernel is ``(out, in)`` as in ``F.linear``,
the depthwise filter ``(D, 1, k)`` as in a grouped ``F.conv1d``.  Each module
draws its weights in the JAX package's shape with TF's fan rule and moves
the axes (``reset_parameters``); ``weights.py`` maps them to the JAX
package's leaves.  Submodules carry the JAX scope names, so a module's path
here is its path in a bundle's ``params.npz``.  Dropout, gumbel noise and
the losses other than the matching loss come with the training slice.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hual_tpu_torch.models.initializers import glorot_uniform_tf
from hual_tpu_torch.ops.masking import attention_bias, mask_logits


class LayerNorm(nn.Module):
    """eps=1e-6 (not PyTorch's 1e-5), statistics in f32, scale + bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        variance = (xf - mean).square().mean(dim=-1, keepdim=True)
        norm = (xf - mean) * torch.rsqrt(variance + 1e-6)
        return (norm * self.weight + self.bias).to(x.dtype)


class Conv1D(nn.Module):
    """Kernel-size-1 conv == dense over the last axis; JAX kernel (1,in,out)."""

    def __init__(self, in_dim: int, dim: int, use_bias: bool = False,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.in_dim, self.dim = in_dim, dim
        self.weight = nn.Parameter(torch.empty(dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None
        self.activation = activation

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.weight.copy_(glorot_uniform_tf((1, self.in_dim, self.dim),
                                                generator)[0].T)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, self.weight, self.bias)
        return out if self.activation is None else self.activation(out)


class DepthwiseSeparableConv(nn.Module):
    """k=7 depthwise over time (SAME) + 1x1 pointwise + bias + relu."""

    def __init__(self, dim: int, kernel_size: int = 7):
        super().__init__()
        self.dim, self.kernel_size = dim, kernel_size
        self.depthwise_filter = nn.Parameter(torch.empty(dim, 1, kernel_size))
        self.pointwise_filter = nn.Parameter(torch.empty(dim, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        k, d = self.kernel_size, self.dim
        with torch.no_grad():
            dw = glorot_uniform_tf((k, 1, d, 1), generator)
            self.depthwise_filter.copy_(dw[:, 0, :, 0].T[:, None, :])
            pw = glorot_uniform_tf((1, 1, d, d), generator)
            self.pointwise_filter.copy_(pw[0, 0].T)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # SAME padding for an odd kernel: (k-1)/2 each side
        dw = F.conv1d(x.transpose(1, 2), self.depthwise_filter,
                      padding=(self.kernel_size - 1) // 2, groups=self.dim)
        out = F.linear(dw.transpose(1, 2), self.pointwise_filter, self.bias)
        return torch.relu(out)


class Bilinear(nn.Module):
    """Two bias-free dense projections summed + bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.dense_1 = Conv1D(dim, dim)
        self.dense_2 = Conv1D(dim, dim)
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.dense_1(x1) + self.dense_2(x2) + self.bias


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attend(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias) v over (B, H, T, hd) heads."""
    scale = 1.0 / math.sqrt(float(query.shape[-1]))
    scores = torch.matmul(query, key.transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(scores + bias, dim=-1), value)


class DualMultiheadAttention(nn.Module):
    """One query projection attends over the from-stream (self) and the
    to-stream (cross); the two results are cross-gated, fused, and gated
    once more: sigmoid(mask(bilinear_1)) * bilinear_2."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        for name in ("query", "f_key", "f_value", "t_key", "t_value",
                     "s_dense", "x_dense", "guided_dense"):
            self.add_module(name, Conv1D(dim, dim, True))
        self.s_gate = Conv1D(dim, dim, True, activation=torch.sigmoid)
        self.x_gate = Conv1D(dim, dim, True, activation=torch.sigmoid)
        self.bilinear_1 = Bilinear(dim)
        self.bilinear_2 = Bilinear(dim)

    def forward(self, from_tensor, to_tensor, from_mask, to_mask):
        h = self.num_heads
        query = _split_heads(self.query(from_tensor), h)
        s_out = attend(query, _split_heads(self.f_key(from_tensor), h),
                       _split_heads(self.f_value(from_tensor), h),
                       attention_bias(from_mask, from_mask))
        x_out = attend(query, _split_heads(self.t_key(to_tensor), h),
                       _split_heads(self.t_value(to_tensor), h),
                       attention_bias(from_mask, to_mask))
        s_value = self.s_dense(_merge_heads(s_out))
        x_value = self.x_dense(_merge_heads(x_out))
        outputs = self.s_gate(s_value) * x_value + self.x_gate(x_value) * s_value
        outputs = self.guided_dense(outputs)
        scores = self.bilinear_1(from_tensor, outputs)
        values = self.bilinear_2(from_tensor, outputs)
        return torch.sigmoid(mask_logits(scores, from_mask[:, :, None])) * values


class TrilinearAttention(nn.Module):
    """QANet trilinear similarity x1·w0 + (x2·w1)^T + (x1*wm)·x2^T."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.linear_kernel4arg0 = nn.Parameter(torch.empty(dim))
        self.linear_kernel4arg1 = nn.Parameter(torch.empty(dim))
        self.linear_kernel4mul = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        d = self.dim
        with torch.no_grad():
            self.linear_kernel4arg0.copy_(glorot_uniform_tf((d, 1), generator)[:, 0])
            self.linear_kernel4arg1.copy_(glorot_uniform_tf((d, 1), generator)[:, 0])
            self.linear_kernel4mul.copy_(glorot_uniform_tf((1, 1, d), generator)[0, 0])

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        sub0 = torch.matmul(x1, self.linear_kernel4arg0)[:, :, None]   # (B,L1,1)
        sub1 = torch.matmul(x2, self.linear_kernel4arg1)[:, None, :]   # (B,1,L2)
        sub2 = torch.matmul(x1 * self.linear_kernel4mul, x2.transpose(1, 2))
        return sub0 + sub1 + sub2


class CQAttention(nn.Module):
    """Context-query attention.  The row softmax masks the ``to`` columns,
    the column softmax masks the ``from`` rows."""

    def __init__(self, dim: int):
        super().__init__()
        self.efficient_trilinear = TrilinearAttention(dim)
        self.dense = Conv1D(4 * dim, dim)

    def forward(self, inputs1, inputs2, mask1, mask2):
        score = self.efficient_trilinear(inputs1, inputs2)            # (B,L1,L2)
        score_ = torch.softmax(mask_logits(score, mask2[:, None, :]), dim=-1)
        score_t = torch.softmax(mask_logits(score, mask1[:, :, None]), dim=1)
        c2q = torch.matmul(score_, inputs2)
        q2c = torch.matmul(torch.matmul(score_, score_t.transpose(1, 2)),
                           inputs1)
        att = torch.cat([inputs1, c2q, inputs1 * c2q, inputs1 * q2c], dim=-1)
        return self.dense(att), score


class WeightedPooling(nn.Module):
    """Attention-pool a sequence to one vector."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.weight.copy_(glorot_uniform_tf((self.dim, 1), generator)[:, 0])

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = torch.matmul(inputs, self.weight)[:, :, None]              # (B,L,1)
        alphas = torch.softmax(mask_logits(x, mask[:, :, None]), dim=1)
        return (inputs * alphas).sum(dim=1)


class CQConcat(nn.Module):
    """Pool the query, tile it along the video, concat + dense."""

    def __init__(self, dim: int):
        super().__init__()
        self.weighted_pooling = WeightedPooling(dim)
        self.dense = Conv1D(2 * dim, dim, True)

    def forward(self, inputs, pool_inputs, pool_mask):
        pooled = self.weighted_pooling(pool_inputs, pool_mask)
        tiled = pooled[:, None, :].expand(-1, inputs.shape[1], -1)
        return self.dense(torch.cat([inputs, tiled], dim=-1))


class MatchingHead(nn.Module):
    """Per-frame 4-class logits + masked CE.  Deterministic pass only: with
    gumbel on it keeps the 1/tau sharpening and draws no noise, as the JAX
    package's deterministic passes do."""

    def __init__(self, dim: int, label_size: int = 4, tau: float = 0.3,
                 gumbel: bool = False):
        super().__init__()
        self.label_size, self.tau, self.gumbel = label_size, tau, gumbel
        self.dense = Conv1D(dim, label_size, True)

    def forward(self, inputs, labels, mask):
        logits = self.dense(inputs).float()
        if self.gumbel:
            logits = logits / self.tau
        log_probs = torch.log_softmax(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        per_pos = -log_probs.gather(-1, labels.long()[..., None])[..., 0]
        m = mask.to(logits.dtype)
        loss = (per_pos * m).sum() / (m.sum() + 1e-12)
        return loss, probs
