"""Neural building blocks (counterpart of ``hual_tpu/models/layers.py``).

Layouts are PyTorch's: a dense kernel is ``(out, in)`` as in ``F.linear``,
the depthwise filter ``(D, 1, k)`` as in a grouped ``F.conv1d``.  Each module
draws its weights in the JAX package's shape with TF's fan rule and moves
the axes (``reset_parameters``); ``weights.py`` maps them to the JAX
package's leaves.  Submodules carry the JAX scope names, so a module's path
here is its path in a bundle's ``params.npz``.

A pass is stochastic iff it is given a ``torch.Generator``: dropout and the
matching head's gumbel noise draw from it, and without one the pass is the
deterministic one (JAX's ``deterministic=True``).  ``module.train()`` and
``.eval()`` change nothing.  Under data parallelism the generator is a
``parallel.RowDraws``: every draw takes the global batch's shape and keeps
this rank's rows, so a sharded pass draws the unsharded pass's masks.

The losses take the batch's ``parallel.Rows`` (this rank's rows of the
global batch; None for a whole batch) and return this rank's share of the
global loss, so the shares summed over the data group are the global loss
and every term counts once: the match loss's mask count and the localizing
loss's batch size are the global batch's, and the alignment loss's (B x B)
softmax runs over the whole batch, this rank's rows of it.

Activations run in the dtype they arrive in (f32 or bf16, the model's
``compute_dtype``), as in the JAX package: parameters stay f32 and are cast
to it at each use, products sum in f32 (a dense layer's output is then
rounded back), LayerNorm statistics and softmaxes are f32, and attention
scores, the trilinear similarity and the pooling logits stay f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from hual_tpu_torch.models.initializers import glorot_uniform_tf
from hual_tpu_torch.ops.masking import attention_bias, mask_logits
from hual_tpu_torch.parallel import Rows, gather_rows, sum_over, uniform

Rate = Union[float, torch.Tensor]


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in f32, whatever the operands' dtype (the JAX package's
    ``preferred_element_type=f32`` where the result stays f32)."""
    return torch.matmul(a.float(), b.float())


def dropout(x: torch.Tensor, rate: Rate, generator) -> torch.Tensor:
    """Inverted dropout with the rate as a value (tf.nn.dropout semantics).

    ``rate`` is a scalar or a per-sample ``(B,)`` vector.  The keep mask is
    ``rand < 1 - rate`` with ``rand`` in [0, 1), so a rate-0 row keeps every
    element and equals a deterministic pass bit for bit.  No generator, or a
    scalar rate of 0, returns ``x`` without drawing.  ``generator`` is a
    ``torch.Generator`` or a ``parallel.RowDraws``.
    """
    if generator is None:
        return x
    if torch.is_tensor(rate):
        r = rate.to(device=x.device, dtype=torch.float32)
        if r.dim() == 1:                # per-sample rates over trailing axes
            r = r.reshape(r.shape[0], *([1] * (x.dim() - 1)))
        keep, inv = 1.0 - r, (1.0 / (1.0 - r)).to(x.dtype)
    elif rate == 0.0:
        return x
    else:
        # a Python float stays on the host: a device scalar made from it
        # would be a blocking copy at every site
        keep, inv = 1.0 - rate, 1.0 / (1.0 - rate)
    u = uniform(x.shape, generator, x.device)
    return torch.where(u < keep, x * inv, 0.0)


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
        bias = None if self.bias is None else self.bias.to(x.dtype)
        out = F.linear(x, self.weight.to(x.dtype), bias)
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
        dt = x.dtype
        dw = F.conv1d(x.transpose(1, 2), self.depthwise_filter.to(dt),
                      padding=(self.kernel_size - 1) // 2, groups=self.dim)
        out = F.linear(dw.transpose(1, 2), self.pointwise_filter.to(dt),
                       self.bias.to(dt))
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
        out = self.dense_1(x1) + self.dense_2(x2)
        return out + self.bias.to(out.dtype)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attend(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
           bias: torch.Tensor, drop_rate: Rate = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias) v over (B, H, T, hd) heads, with
    dropout on the probabilities; scores and probabilities in f32, the
    result in the value's dtype."""
    scale = 1.0 / math.sqrt(float(query.shape[-1]))
    scores = _mm32(query, key.transpose(-1, -2)) * scale
    probs = dropout(torch.softmax(scores + bias, dim=-1), drop_rate, generator)
    return torch.matmul(probs.to(value.dtype), value)


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

    def forward(self, from_tensor, to_tensor, from_mask, to_mask,
                drop_rate: Rate = 0.0, generator=None):
        h = self.num_heads
        query = _split_heads(self.query(from_tensor), h)
        s_out = attend(query, _split_heads(self.f_key(from_tensor), h),
                       _split_heads(self.f_value(from_tensor), h),
                       attention_bias(from_mask, from_mask), drop_rate, generator)
        x_out = attend(query, _split_heads(self.t_key(to_tensor), h),
                       _split_heads(self.t_value(to_tensor), h),
                       attention_bias(from_mask, to_mask), drop_rate, generator)
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

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, drop_rate: Rate = 0.0,
                generator=None) -> torch.Tensor:
        x1 = dropout(x1, drop_rate, generator)
        x2 = dropout(x2, drop_rate, generator)
        dt = x1.dtype
        sub0 = _mm32(x1, self.linear_kernel4arg0.to(dt))[:, :, None]   # (B,L1,1)
        sub1 = _mm32(x2, self.linear_kernel4arg1.to(dt))[:, None, :]   # (B,1,L2)
        sub2 = _mm32(x1 * self.linear_kernel4mul.to(dt), x2.transpose(1, 2))
        return sub0 + sub1 + sub2                                      # f32


class CQAttention(nn.Module):
    """Context-query attention.  The row softmax masks the ``to`` columns,
    the column softmax masks the ``from`` rows."""

    def __init__(self, dim: int):
        super().__init__()
        self.efficient_trilinear = TrilinearAttention(dim)
        self.dense = Conv1D(4 * dim, dim)

    def forward(self, inputs1, inputs2, mask1, mask2, drop_rate: Rate = 0.0,
                generator=None):
        score = self.efficient_trilinear(inputs1, inputs2, drop_rate,
                                         generator)                   # (B,L1,L2)
        score_ = torch.softmax(mask_logits(score, mask2[:, None, :]), dim=-1)
        score_t = torch.softmax(mask_logits(score, mask1[:, :, None]), dim=1)
        dt = inputs1.dtype
        score_, score_t = score_.to(dt), score_t.to(dt)
        c2q = torch.matmul(score_, inputs2)
        # both products in f32, rounded once (the JAX package's one
        # three-operand einsum)
        q2c = _mm32(_mm32(score_, score_t.transpose(1, 2)), inputs1).to(dt)
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
        dt = inputs.dtype
        x = _mm32(inputs, self.weight.to(dt))[:, :, None]              # (B,L,1)
        alphas = torch.softmax(mask_logits(x, mask[:, :, None]), dim=1)
        return (inputs.float() * alphas.to(dt).float()).sum(dim=1).to(dt)


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
    """Per-frame 4-class logits + masked CE.  With gumbel on, a stochastic
    pass adds gumbel noise before the 1/tau sharpening; a deterministic pass
    keeps the sharpening only, as the JAX package's do."""

    def __init__(self, dim: int, label_size: int = 4, tau: float = 0.3,
                 gumbel: bool = False):
        super().__init__()
        self.label_size, self.tau, self.gumbel = label_size, tau, gumbel
        self.dense = Conv1D(dim, label_size, True)

    def forward(self, inputs, labels, mask, generator=None,
                rows: Optional[Rows] = None):
        """(this rank's share of the masked CE, the class probabilities):
        the masked sum over the mask count of the global batch (``rows``'s
        group)."""
        logits = self.dense(inputs).float()
        if self.gumbel:
            if generator is not None:
                u = uniform(logits.shape, generator, logits.device, logits.dtype)
                logits = logits - torch.log(-torch.log(u + 1e-20) + 1e-20)
            logits = logits / self.tau
        log_probs = torch.log_softmax(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        # a one-hot product, as the JAX package takes it; built by a compare,
        # so neither it nor its backward scatters
        classes = torch.arange(self.label_size, device=labels.device)
        onehot = (labels.long()[..., None] == classes).to(logits.dtype)
        per_pos = -(onehot * log_probs).sum(dim=-1)
        m = mask.to(logits.dtype)
        loss = (per_pos * m).sum() / (sum_over(m.sum(), rows) + 1e-12)
        return loss, probs


def localizing_loss(start_logits, end_logits, y1, y2, mask,
                    rows: Optional[Rows] = None) -> torch.Tensor:
    """Masked softmax-CE of the start/end logits against soft labels,
    averaged over the global batch (this rank's sum over its size)."""
    sl = mask_logits(start_logits, mask)
    el = mask_logits(end_logits, mask)
    start_losses = -(y1 * torch.log_softmax(sl, dim=-1)).sum(dim=-1)
    end_losses = -(y2 * torch.log_softmax(el, dim=-1)).sum(dim=-1)
    total = start_losses.shape[0] if rows is None else rows.total
    return (start_losses + end_losses).sum() / total


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    # tf.nn.l2_normalize: x * rsqrt(max(sum(x^2), eps))
    sq = x.square().sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def _kl_for_log_probs(log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """The reference's kl_for_log_probs.  Callers pass probabilities as
    ``log_q``: a reference quirk kept as it is."""
    p = torch.exp(log_p)
    return (p * log_p).sum(dim=-1) - (p * log_q).sum(dim=-1)


def alignment_loss(tfeat, vfeat, tmask, vmask, inner_label,
                   rows: Optional[Rows] = None) -> torch.Tensor:
    """Video-level contrastive KL, with both reference quirks: the query
    mean-pool sums over padded positions and divides by the mask count, and
    ``_kl_for_log_probs`` gets probabilities where log-probabilities are
    expected.

    A cross-sample loss: each sample's softmax runs over the videos of the
    whole batch.  This rank computes its rows of the (B x B) similarities
    against every rank's pooled videos (``gather_rows``, whose backward
    hands each rank the gradient of its videos from every row) and returns
    the KL summed over its rows."""
    tsum = tfeat.sum(dim=1)                                         # (B, D)
    tcount = tmask.sum(dim=1, keepdim=True).to(tsum.dtype)
    tfeat_n = _l2_normalize(tsum / tcount, dim=1)

    vm = vmask.to(inner_label.dtype)
    frame_w = inner_label / vm.sum(dim=1, keepdim=True)
    vsum = (vfeat * frame_w[:, :, None]).sum(dim=1)
    vfeat_n = _l2_normalize(vsum, dim=1)

    videos = gather_rows(vfeat_n, rows)                             # (B, D)
    video_sim = torch.softmax(vfeat_n @ videos.T, dim=-1)
    query_sim = torch.softmax(tfeat_n @ videos.T, dim=-1)
    kl = (_kl_for_log_probs(torch.log(query_sim), video_sim)
          + _kl_for_log_probs(torch.log(video_sim), query_sim))
    return kl.sum()
