"""SeqPAN (counterpart of ``hual_tpu/models/seqpan.py``).

Text/video encoders -> shared pos-emb + conv block -> N x dual attention
(one block per layer, both directions) -> CQ fusion -> matching head (+ the
label-embedding orthogonality penalty) -> conditioned span predictor ->
span decode.  ``span_decode="pallas"`` decodes with the Hopper kernel
(``ops/kernels/span_decode.py``), ``"xla"`` with the plain PyTorch decode;
either decodes the detached logits, so the train step launches the kernel
too.  The forward returns logits and scores; :func:`seqpan_loss` adds the
losses, so one forward serves train, eval and MC-dropout passes.

``compute_dtype`` ("float32" or "bfloat16") is the activation dtype after
the embeddings, as in the JAX package; the logits, the CQ features and
everything loss-facing leave in f32.

Under data parallelism a pass runs on this rank's rows of the global batch
(``rows``, a ``parallel.Rows``): its draws are those rows of the global
batch's draws, and :func:`seqpan_loss` returns this rank's share of the
global loss, the label-embedding penalty counted once (on the data group's
first rank).  :meth:`SeqPAN.with_compute_dtype` is
the JAX package's ``model.clone(compute_dtype=...)``: the same modules and
parameters at another activation dtype.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

import torch
from torch import nn

from hual_tpu_torch.config import Config
from hual_tpu_torch.models.initializers import orthogonal
from hual_tpu_torch.models.layers import (CQAttention, CQConcat, Conv1D,
                                          LayerNorm, MatchingHead, Rate,
                                          alignment_loss, dropout,
                                          localizing_loss)
from hual_tpu_torch.models.modules import (CharEmbedding, ConditionedPredictor,
                                           ConvBlock, DualAttnBlock,
                                           PositionalEmbedding, WordEmbedding)
from hual_tpu_torch.ops.decode import span_decode as span_decode_plain
from hual_tpu_torch.ops.kernels import span_decode as span_decode_kernel
from hual_tpu_torch.ops.masking import sequence_mask
from hual_tpu_torch.parallel import Rows, row_draws


class SeqPAN(nn.Module):
    def __init__(self, vdim: int = 1024, dim: int = 128, num_heads: int = 8,
                 attn_layer: int = 2, max_vlen: int = 64, word_dim: int = 300,
                 char_dim: int = 50, num_chars: int = 100, tau: float = 0.3,
                 use_gumbel: bool = False, span_decode: str = "xla",
                 compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if span_decode not in ("xla", "pallas"):
            raise ValueError(f"span_decode must be 'xla' or 'pallas', "
                             f"got {span_decode!r}")
        self.compute_dtype = _check_dtype(compute_dtype)
        self.max_vlen, self.attn_layer = max_vlen, attn_layer
        self.dim, self.num_heads = dim, num_heads
        self.tau, self.use_gumbel = tau, use_gumbel
        self.span_decode = span_decode
        self.word_embs = WordEmbedding(word_dim)
        self.char_embs = CharEmbedding(num_chars, char_dim)
        self.query_conv1d = Conv1D(word_dim + self.char_embs.out_dim, dim, True)
        self.q_layer_norm = LayerNorm(dim)
        self.video_conv1d = Conv1D(vdim, dim, True)
        self.v_layer_norm = LayerNorm(dim)
        self.pos_emb = PositionalEmbedding(max_vlen, dim)
        self.conv_block = ConvBlock(dim)
        for i in range(attn_layer):
            self.add_module(f"d_attn_{i}", DualAttnBlock(dim, num_heads))
        self.q2v_attn = CQAttention(dim)
        self.v2q_attn = CQAttention(dim)
        self.cq_cat = CQConcat(dim)
        self.matching_head = MatchingHead(dim, 4, tau, use_gumbel)
        self.label_emb = nn.Parameter(torch.empty(4, dim))
        self.predictor = ConditionedPredictor(dim, num_heads, max_vlen)
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, config: Config,
                    generator: Optional[torch.Generator] = None) -> "SeqPAN":
        m = config.model
        return cls(vdim=m.vdim, dim=m.dim, num_heads=m.num_heads,
                   attn_layer=m.attn_layer, max_vlen=m.max_vlen,
                   word_dim=m.word_dim, char_dim=m.char_dim,
                   num_chars=m.num_chars, tau=config.loss.tau,
                   use_gumbel=not config.loss.no_gumbel,
                   span_decode=m.span_decode, compute_dtype=m.compute_dtype,
                   generator=generator)

    def with_compute_dtype(self, compute_dtype: str) -> "SeqPAN":
        """This model at another activation dtype: a shallow copy whose
        modules and parameters are this model's own, so it adds no weights
        and nothing to a checkpoint."""
        view = copy.copy(self)
        view.compute_dtype = _check_dtype(compute_dtype)
        return view

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Draw every weight from ``generator`` (a fresh seed-0 generator if
        None), module by module in registration order."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        with torch.no_grad():
            self.label_emb.copy_(orthogonal((4, self.label_emb.shape[1]),
                                            generator))

    def forward(self, batch: dict[str, torch.Tensor],
                word_vectors: torch.Tensor,
                match_labels: Optional[torch.Tensor] = None, *,
                drop_rate: Rate = 0.0,
                generator: Optional[torch.Generator] = None,
                decode: bool = True,
                rows: Optional[Rows] = None) -> dict[str, torch.Tensor]:
        """One pass; stochastic (dropout at ``drop_rate``, a scalar or a
        per-sample vector, and gumbel noise) iff ``generator`` is given.
        ``decode=False`` skips the span decode (the MC passes keep only
        their logits): the outputs then have no indices.  ``rows``: the
        batch is this rank's rows of a global batch (draws and, with
        ``match_labels``, the match loss take the global batch's)."""
        generator = row_draws(generator, rows)
        v_mask = sequence_mask(batch["video_seq_len"], self.max_vlen)
        q_mask = (batch["word_ids"] != 0).to(torch.int32)
        drop = dict(drop_rate=drop_rate, generator=generator)
        dt = _DTYPES[self.compute_dtype]

        qfeats = torch.cat([self.word_embs(batch["word_ids"], word_vectors, **drop),
                            self.char_embs(batch["char_ids"], **drop)], dim=-1)
        qfeats = self.q_layer_norm(self.query_conv1d(qfeats.to(dt)))
        vfeats = dropout(batch["video_features"].to(dt), drop_rate, generator)
        vfeats = self.v_layer_norm(self.video_conv1d(vfeats))

        vfeats = self.conv_block(self.pos_emb(vfeats), **drop)
        qfeats = self.conv_block(self.pos_emb(qfeats), **drop)

        for i in range(self.attn_layer):
            blk = getattr(self, f"d_attn_{i}")
            vfeats, qfeats = (blk(vfeats, qfeats, v_mask, q_mask, **drop),
                              blk(qfeats, vfeats, q_mask, v_mask, **drop))

        q2v_feats, _ = self.q2v_attn(vfeats, qfeats, v_mask, q_mask, **drop)
        v2q_feats, _ = self.v2q_attn(qfeats, vfeats, q_mask, v_mask, **drop)
        fuse_feats = self.cq_cat(q2v_feats, v2q_feats, q_mask)

        labels = match_labels if match_labels is not None else torch.zeros(
            fuse_feats.shape[:2], dtype=torch.int32, device=fuse_feats.device)
        match_loss, match_scores = self.matching_head(
            fuse_feats, labels, v_mask, generator,
            rows if match_labels is not None else None)
        if rows is None or rows.lo == 0:
            eye = torch.eye(4, device=self.label_emb.device)
            ortho = self.label_emb @ self.label_emb.T * (1.0 - eye)
            match_loss = match_loss + ortho.square().sum().sqrt()

        soft_label_embs = (match_scores @ self.label_emb).to(dt)
        outputs = (fuse_feats + soft_label_embs) * v_mask[:, :, None].to(dt)
        start_logits, end_logits = self.predictor(outputs, v_mask, drop_rate,
                                                  drop_rate, generator)
        start_logits, end_logits = start_logits.float(), end_logits.float()
        q2v_feats, v2q_feats = q2v_feats.float(), v2q_feats.float()

        out = {"v_mask": v_mask, "q_mask": q_mask,
               "q2v_feats": q2v_feats, "v2q_feats": v2q_feats,
               "match_loss": match_loss, "match_scores": match_scores,
               "start_logits": start_logits, "end_logits": end_logits}
        if decode:
            decoder = (span_decode_kernel.span_decode if self.span_decode == "pallas"
                       else span_decode_plain)
            # integer outputs: no gradient, so the kernel decodes detached logits
            out["start_index"], out["end_index"] = decoder(
                start_logits.detach(), end_logits.detach(), v_mask)
        return out


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_dtype(name: str) -> str:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return name


def seqpan_loss(outputs: dict[str, torch.Tensor], batch: dict[str, torch.Tensor],
                match_lambda: float = 1.0, rows: Optional[Rows] = None
                ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Total loss = loc + lambda*match + 1.0*align (this rank's share of
    each under ``rows``; the forward must have had the same ``rows``)."""
    loc = localizing_loss(outputs["start_logits"], outputs["end_logits"],
                          batch["y1"], batch["y2"], outputs["v_mask"], rows)
    align = alignment_loss(outputs["v2q_feats"], outputs["q2v_feats"],
                           outputs["q_mask"], outputs["v_mask"],
                           batch["inner_labels"], rows)
    total = loc + match_lambda * outputs["match_loss"] + align * 1.0
    return total, {"loc_loss": loc, "match_loss": outputs["match_loss"],
                   "align_loss": align, "loss": total}
