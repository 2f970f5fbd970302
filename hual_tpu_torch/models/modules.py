"""Model modules (counterpart of ``hual_tpu/models/modules.py``).

Weight sharing is one module instance called several times, exactly where
the JAX package shares: the feature encoder between the start and the end
pass here, and (``seqpan.py``) the positional embedding and conv block
between the video and query streams and each dual-attention block between
both directions.

Every ``forward`` takes ``drop_rate`` and ``generator`` and puts dropout
where the JAX package's modules do; without a generator the pass is
deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hual_tpu_torch.models.initializers import glorot_uniform_tf
from hual_tpu_torch.models.layers import (Conv1D, DepthwiseSeparableConv,
                                          DualMultiheadAttention, LayerNorm,
                                          Rate, _merge_heads, _split_heads,
                                          attend, dropout)
from hual_tpu_torch.ops.masking import attention_bias


class WordEmbedding(nn.Module):
    """Table [zero PAD, trainable UNK, frozen GloVe rows]; the GloVe rows
    are passed at call time, as in the JAX package.  Gathered by id range
    rather than by concatenating the table on every call."""

    def __init__(self, word_dim: int):
        super().__init__()
        self.word_dim = word_dim
        self.unk = nn.Parameter(torch.empty(1, word_dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.unk.copy_(glorot_uniform_tf((1, self.word_dim), generator))

    def forward(self, word_ids: torch.Tensor, word_vectors: torch.Tensor,
                drop_rate: Rate = 0.0, generator=None) -> torch.Tensor:
        ids = word_ids.long()
        emb = word_vectors[(ids - 2).clamp(min=0)]
        emb = torch.where((ids == 1)[..., None], self.unk[0], emb)
        emb = torch.where((ids == 0)[..., None], torch.zeros_like(emb), emb)
        return dropout(emb, drop_rate, generator)


class CharEmbedding(nn.Module):
    """Char table + per-word VALID char CNN (k 1-4, filters 10/20/30/40),
    relu, max over chars.  Filters are (ch, dim, k), JAX's HWIO (1,k,dim,ch)."""

    def __init__(self, char_size: int, dim: int,
                 kernels: Sequence[int] = (1, 2, 3, 4),
                 filters: Sequence[int] = (10, 20, 30, 40)):
        super().__init__()
        self.char_size, self.dim = char_size, dim
        self.kernels, self.filters = tuple(kernels), tuple(filters)
        self.char_table = nn.Parameter(torch.empty(char_size - 1, dim))
        for i, (k, ch) in enumerate(zip(self.kernels, self.filters)):
            self.register_parameter(f"filter_{i}",
                                    nn.Parameter(torch.empty(ch, dim, k)))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(ch)))

    @property
    def out_dim(self) -> int:
        return sum(self.filters)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.char_table.copy_(glorot_uniform_tf(
                (self.char_size - 1, self.dim), generator))
            for i, (k, ch) in enumerate(zip(self.kernels, self.filters)):
                w = glorot_uniform_tf((1, k, self.dim, ch), generator)
                getattr(self, f"filter_{i}").copy_(w[0].permute(2, 1, 0))
                getattr(self, f"bias_{i}").zero_()

    def forward(self, char_ids: torch.Tensor, drop_rate: Rate = 0.0,
                generator=None) -> torch.Tensor:
        b, w, c = char_ids.shape
        full = F.pad(self.char_table, (0, 0, 1, 0))          # zero PAD row
        emb = dropout(full[char_ids.long()], drop_rate, generator)
        emb = emb.reshape(b * w, c, self.dim).transpose(1, 2)
        outs = []
        for i in range(len(self.kernels)):
            conv = F.conv1d(emb, getattr(self, f"filter_{i}"),
                            getattr(self, f"bias_{i}"))       # VALID
            outs.append(torch.relu(conv).amax(dim=2))        # (B*W, ch)
        return torch.cat(outs, dim=-1).reshape(b, w, self.out_dim)


class PositionalEmbedding(nn.Module):
    """Learned absolute positions, sliced to the sequence length.  The query
    stream shares the video's table, so a query may not be longer than
    ``max_vlen`` (kept from the JAX package)."""

    def __init__(self, max_pos_len: int, dim: int):
        super().__init__()
        self.max_pos_len, self.dim = max_pos_len, dim
        self.position_embeddings = nn.Parameter(torch.empty(max_pos_len, dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.position_embeddings.copy_(glorot_uniform_tf(
                (self.max_pos_len, self.dim), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq_len = x.shape[1]
        if seq_len > self.max_pos_len:
            raise ValueError(f"sequence length {seq_len} exceeds the "
                             f"positional table's {self.max_pos_len}")
        return x + self.position_embeddings[None, :seq_len, :].to(x.dtype)


class ConvBlock(nn.Module):
    """num_layers x {LN -> depthwise-separable conv(k=7) -> dropout +
    residual}."""

    def __init__(self, dim: int, kernel_size: int = 7, num_layers: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_norm_{i}", LayerNorm(dim))
            self.add_module(f"depthwise_conv_layers_{i}",
                            DepthwiseSeparableConv(dim, kernel_size))

    def forward(self, x: torch.Tensor, drop_rate: Rate = 0.0,
                generator=None) -> torch.Tensor:
        for i in range(self.num_layers):
            y = getattr(self, f"layer_norm_{i}")(x)
            y = getattr(self, f"depthwise_conv_layers_{i}")(y)
            x = dropout(y, drop_rate, generator) + x
        return x


class DualAttnBlock(nn.Module):
    """Pre-LN dual attention + FFN with residuals."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.layer_norm_1 = LayerNorm(dim)
        self.layer_norm_t = LayerNorm(dim)
        self.dual_multihead_attention = DualMultiheadAttention(dim, num_heads)
        self.dense_1 = Conv1D(dim, dim, True)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense_2 = Conv1D(dim, dim, True)

    def forward(self, from_tensor, to_tensor, from_mask, to_mask,
                drop_rate: Rate = 0.0, generator=None):
        out = self.dual_multihead_attention(
            self.layer_norm_1(from_tensor), self.layer_norm_t(to_tensor),
            from_mask, to_mask, drop_rate, generator)
        residual = dropout(self.dense_1(out), drop_rate, generator) + from_tensor
        out = dropout(self.layer_norm_2(residual), drop_rate, generator)
        return dropout(self.dense_2(out), drop_rate, generator) + residual


class TopSelfAttention(nn.Module):
    """Plain multi-head self-attention with the additive mask bias."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Conv1D(dim, dim, True)
        self.key = Conv1D(dim, dim, True)
        self.value = Conv1D(dim, dim, True)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                drop_rate: Rate = 0.0, generator=None) -> torch.Tensor:
        h = self.num_heads
        out = attend(_split_heads(self.query(x), h),
                     _split_heads(self.key(x), h),
                     _split_heads(self.value(x), h), attention_bias(mask, mask),
                     drop_rate, generator)
        return _merge_heads(out)


class FeatureEncoder(nn.Module):
    """pos-emb -> conv block -> LN -> self-attention -> FFN, with residuals;
    the self-attention's probabilities take ``attn_drop``."""

    def __init__(self, dim: int, num_heads: int, max_pos_len: int):
        super().__init__()
        self.pos_emb = PositionalEmbedding(max_pos_len, dim)
        self.conv_block = ConvBlock(dim)
        self.layer_norm_1 = LayerNorm(dim)
        self.top_self_attention = TopSelfAttention(dim, num_heads)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense = Conv1D(dim, dim, True)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, drop_rate: Rate = 0.0,
                attn_drop: Rate = 0.0, generator=None) -> torch.Tensor:
        feats = self.conv_block(self.pos_emb(x), drop_rate, generator)
        out = dropout(self.layer_norm_1(feats), drop_rate, generator)
        out = self.top_self_attention(out, mask, attn_drop, generator)
        residual = dropout(out, drop_rate, generator) + feats
        out = dropout(self.layer_norm_2(residual), drop_rate, generator)
        return dropout(self.dense(out), drop_rate, generator) + residual


class ConditionedPredictor(nn.Module):
    """Start/end span logits; one feature encoder for the start pass and the
    start-conditioned end pass."""

    def __init__(self, dim: int, num_heads: int, max_pos_len: int):
        super().__init__()
        self.feature_encoder = FeatureEncoder(dim, num_heads, max_pos_len)
        self.start_layer_norm = LayerNorm(dim)
        self.end_layer_norm = LayerNorm(dim)
        self.start_hidden = Conv1D(2 * dim, dim, True, activation=torch.relu)
        self.end_hidden = Conv1D(2 * dim, dim, True, activation=torch.relu)
        self.start_dense = Conv1D(dim, 1, True)
        self.end_dense = Conv1D(dim, 1, True)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, drop_rate: Rate = 0.0,
                attn_drop: Rate = 0.0, generator=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        start_feats = self.feature_encoder(x, mask, drop_rate, attn_drop,
                                           generator)
        end_feats = self.feature_encoder(start_feats, mask, drop_rate,
                                         attn_drop, generator)
        start_feats = self.start_hidden(
            torch.cat([self.start_layer_norm(start_feats), x], dim=-1))
        end_feats = self.end_hidden(
            torch.cat([self.end_layer_norm(end_feats), x], dim=-1))
        return (self.start_dense(start_feats)[..., 0],
                self.end_dense(end_feats)[..., 0])
