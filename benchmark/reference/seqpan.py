"""Plain reference of SeqPAN, its losses, BERT-AdamW and the span decode.

A frozen copy of the mathematics the benchmark holds the port to, written in
plain PyTorch and importing nothing of the port, of ``jax`` or of
``hual_tpu``.  It follows SeqPAN (Zhang et al., "Parallel attention network
with sequence matching for video grounding", Findings of ACL 2021) as the
port and the JAX package implement it, quirks included:

* text: [PAD, UNK, GloVe] word embeddings + a char CNN (kernels 1-4,
  filters 10/20/30/40), a dense layer and LayerNorm (eps 1e-6); video: a
  dense layer and LayerNorm;
* one positional table and one conv block (4 x LN, depthwise k=7 +
  pointwise + relu, residual) shared by both streams;
* ``attn_layer`` dual-attention blocks, each run in both directions;
* two CQ attentions (trilinear similarity), the CQ concat, the four-class
  matching head with the label-embedding orthogonality penalty;
* the conditioned span predictor (one feature encoder run twice);
* losses: localising (soft labels), matching (masked CE), alignment
  (the batch-level KL with both reference quirks);
* BERT-AdamW after a global-norm clip, no bias correction, weight decay on
  every leaf whose key names neither ``layer_norm`` nor ``bias``;
* the span decode: softmax, upper-triangular outer product, first argmax.

Dropout draws ``torch.rand`` of each site's shape from the pass's generator,
site after site in the order of the forward, and keeps ``u < 1 - rate``; a
pass is stochastic iff it is given a generator.  That is the random-stream
contract the port documents (``runtime/steps.py``): train step ``k`` draws
from ``stream_seed(train.seed + 17, k)``, AL batch ``i``'s MC pass ``j`` from
``stream_seed(seed, i, j)``, the epoch's shuffle from
``SeedSequence([train.seed, epoch])``.  Given the same weights, inputs and
streams on the same device, this module and the port compute the same
function; only their rounding differs.

Parameters carry the JAX package's leaf names (``params/d_attn_0/...``) so
the benchmark can hand the same weights to both sides
(:func:`jax_leaves`).  Matrix products run in f32 with TF32 off unless a
caller asks for the control's lower precision (:func:`set_precision`).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MASK_VALUE = -1e30


def set_precision(tf32: bool) -> None:
    """f32 products with TF32 off (the configuration's precision), or the
    control's TF32 for cuBLAS and cuDNN alike."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


set_precision(False)


# -- random streams and batches -------------------------------------------------
def stream_seed(*words: int) -> int:
    """The seed of the random stream named by ``words``."""
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])


def generator(device, *words: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(*words))


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The shuffled sample order of one training epoch."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n).astype(np.int32)


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(torch.int32)


def mask_logits(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(x.dtype)
    return x * mask + MASK_VALUE * (1.0 - mask)


def attention_bias(from_mask: torch.Tensor, to_mask: torch.Tensor) -> torch.Tensor:
    pair = (from_mask[:, :, None] * to_mask[:, None, :]).to(torch.float32)
    return ((1.0 - pair) * MASK_VALUE)[:, None, :, :]


def span_labels(s: torch.Tensor, e: torch.Tensor, vl: torch.Tensor, T: int):
    """(y1, y2, match_labels, inner_labels) of each sample's span: soft
    start/end labels with the 1e-10 floor, and the B(1)/I(2)/E(3) windows
    of half-width 2 (later windows win; the start window ends before the end
    window starts)."""
    s, e, vl = s.to(torch.int32), e.to(torch.int32), vl.to(torch.int32)
    idx = torch.arange(T, dtype=torch.int32, device=s.device)[None, :]
    valid = idx < vl[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    base = torch.where(valid, torch.full_like(zero, 1e-10), zero)
    y = (1.0 - vl.to(torch.float32) * 1e-10 - 0.5) / 2.0

    def soft(t):
        has_left = (t > 0).to(torch.float32)
        has_right = (t < vl - 1).to(torch.float32)
        center = (base + 0.5 + (1.0 - has_left)[:, None] * y[:, None]
                  + (1.0 - has_right)[:, None] * y[:, None])
        is_t = idx == t[:, None]
        near = (idx == (t[:, None] - 1)) | ((idx == (t[:, None] + 1)) & valid)
        return torch.where(is_t, center, torch.where(near, y[:, None].expand_as(base), base))

    st_l, st_r = torch.clamp(s - 2, min=0), torch.minimum(s + 2, vl - 1)
    et_l, et_r = torch.clamp(e - 2, min=0), torch.minimum(e + 2, vl - 1)
    st_r = torch.where(st_r >= et_l, torch.maximum(s, et_l - 1), st_r)
    m1 = (idx >= st_l[:, None]) & (idx <= st_r[:, None])
    m2 = (idx > st_r[:, None]) & (idx < et_l[:, None])
    m3 = (idx >= et_l[:, None]) & (idx <= et_r[:, None])
    match = torch.where(m3, 3, torch.where(m2, 2, torch.where(m1, 1, 0)))
    return soft(s), soft(e), match.to(torch.int32), m2.to(torch.float32)


def gather(data: dict, sel: torch.Tensor, with_labels: bool = False) -> dict:
    """One batch of the split ``data`` (the feature table and the
    per-sample columns) at the sample indices ``sel``."""
    take = {k: data[k].index_select(0, sel) for k in
            ("feat_rows", "v_len", "word_ids", "char_ids", "s_ind", "e_ind", "duration")}
    batch = {"video_features": data["features"].index_select(0, take["feat_rows"]),
             "video_seq_len": take["v_len"], "word_ids": take["word_ids"],
             "char_ids": take["char_ids"], "s_ind": take["s_ind"],
             "e_ind": take["e_ind"], "duration": take["duration"]}
    if with_labels:
        y1, y2, match, inner = span_labels(batch["s_ind"], batch["e_ind"], batch["video_seq_len"],
                                           batch["video_features"].shape[1])
        batch.update(y1=y1, y2=y2, match_labels=match, inner_labels=inner)
    return batch


# -- layers -----------------------------------------------------------------------
def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return x
    u = torch.rand(tuple(x.shape), generator=gen, device=x.device, dtype=torch.float32)
    return torch.where(u < 1.0 - rate, x * (1.0 / (1.0 - rate)), 0.0)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-6) * self.weight + self.bias


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, bias: bool = False, act=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out)) if bias else None
        self.act = act

    def forward(self, x):
        out = F.linear(x, self.weight, self.bias)
        return out if self.act is None else self.act(out)


class SepConv(nn.Module):
    def __init__(self, dim: int, k: int = 7):
        super().__init__()
        self.dim, self.k = dim, k
        self.depthwise_filter = nn.Parameter(torch.zeros(dim, 1, k))
        self.pointwise_filter = nn.Parameter(torch.zeros(dim, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        dw = F.conv1d(x.transpose(1, 2), self.depthwise_filter, padding=(self.k - 1) // 2,
                      groups=self.dim)
        return torch.relu(F.linear(dw.transpose(1, 2), self.pointwise_filter, self.bias))


class Bilinear(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense_1, self.dense_2 = Dense(dim, dim), Dense(dim, dim)
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, a, b):
        return self.dense_1(a) + self.dense_2(b) + self.bias


def heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def merge(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attend(q, k, v, bias, rate, gen):
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(float(q.shape[-1])))
    return torch.matmul(dropout(torch.softmax(scores + bias, dim=-1), rate, gen), v)


class DualAttention(nn.Module):
    def __init__(self, dim: int, h: int):
        super().__init__()
        self.h = h
        for name in ("query", "f_key", "f_value", "t_key", "t_value", "s_dense", "x_dense",
                     "guided_dense"):
            self.add_module(name, Dense(dim, dim, True))
        self.s_gate = Dense(dim, dim, True, torch.sigmoid)
        self.x_gate = Dense(dim, dim, True, torch.sigmoid)
        self.bilinear_1, self.bilinear_2 = Bilinear(dim), Bilinear(dim)

    def forward(self, x, y, xm, ym, rate, gen):
        q = heads(self.query(x), self.h)
        s = attend(q, heads(self.f_key(x), self.h), heads(self.f_value(x), self.h),
                   attention_bias(xm, xm), rate, gen)
        c = attend(q, heads(self.t_key(y), self.h), heads(self.t_value(y), self.h),
                   attention_bias(xm, ym), rate, gen)
        sv, xv = self.s_dense(merge(s)), self.x_dense(merge(c))
        out = self.guided_dense(self.s_gate(sv) * xv + self.x_gate(xv) * sv)
        scores, values = self.bilinear_1(x, out), self.bilinear_2(x, out)
        return torch.sigmoid(mask_logits(scores, xm[:, :, None])) * values


class DualAttnBlock(nn.Module):
    def __init__(self, dim: int, h: int):
        super().__init__()
        self.layer_norm_1, self.layer_norm_t = LayerNorm(dim), LayerNorm(dim)
        self.dual_multihead_attention = DualAttention(dim, h)
        self.dense_1 = Dense(dim, dim, True)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense_2 = Dense(dim, dim, True)

    def forward(self, x, y, xm, ym, rate, gen):
        out = self.dual_multihead_attention(self.layer_norm_1(x), self.layer_norm_t(y), xm, ym,
                                            rate, gen)
        res = dropout(self.dense_1(out), rate, gen) + x
        out = dropout(self.layer_norm_2(res), rate, gen)
        return dropout(self.dense_2(out), rate, gen) + res


class Trilinear(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear_kernel4arg0 = nn.Parameter(torch.zeros(dim))
        self.linear_kernel4arg1 = nn.Parameter(torch.zeros(dim))
        self.linear_kernel4mul = nn.Parameter(torch.zeros(dim))

    def forward(self, a, b, rate, gen):
        a, b = dropout(a, rate, gen), dropout(b, rate, gen)
        return (torch.matmul(a, self.linear_kernel4arg0)[:, :, None]
                + torch.matmul(b, self.linear_kernel4arg1)[:, None, :]
                + torch.matmul(a * self.linear_kernel4mul, b.transpose(1, 2)))


class CQAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.efficient_trilinear = Trilinear(dim)
        self.dense = Dense(4 * dim, dim)

    def forward(self, a, b, am, bm, rate, gen):
        score = self.efficient_trilinear(a, b, rate, gen)
        s_row = torch.softmax(mask_logits(score, bm[:, None, :]), dim=-1)
        s_col = torch.softmax(mask_logits(score, am[:, :, None]), dim=1)
        c2q = torch.matmul(s_row, b)
        q2c = torch.matmul(torch.matmul(s_row, s_col.transpose(1, 2)), a)
        return self.dense(torch.cat([a, c2q, a * c2q, a * q2c], dim=-1))


class Pooling(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask):
        alphas = torch.softmax(mask_logits(torch.matmul(x, self.weight)[:, :, None],
                                           mask[:, :, None]), dim=1)
        return (x * alphas).sum(dim=1)


class CQConcat(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weighted_pooling = Pooling(dim)
        self.dense = Dense(2 * dim, dim, True)

    def forward(self, x, pool_x, pool_mask):
        pooled = self.weighted_pooling(pool_x, pool_mask)
        return self.dense(torch.cat([x, pooled[:, None, :].expand(-1, x.shape[1], -1)], dim=-1))


class WordEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.unk = nn.Parameter(torch.zeros(1, dim))

    def forward(self, ids, vectors, rate, gen):
        ids = ids.long()
        emb = vectors[(ids - 2).clamp(min=0)]
        emb = torch.where((ids == 1)[..., None], self.unk[0], emb)
        emb = torch.where((ids == 0)[..., None], torch.zeros_like(emb), emb)
        return dropout(emb, rate, gen)


class CharEmbedding(nn.Module):
    KERNELS, FILTERS = (1, 2, 3, 4), (10, 20, 30, 40)

    def __init__(self, n_chars: int, dim: int):
        super().__init__()
        self.dim = dim
        self.char_table = nn.Parameter(torch.zeros(n_chars - 1, dim))
        for i, (k, ch) in enumerate(zip(self.KERNELS, self.FILTERS)):
            self.register_parameter(f"filter_{i}", nn.Parameter(torch.zeros(ch, dim, k)))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(ch)))

    def forward(self, ids, rate, gen):
        b, w, c = ids.shape
        emb = dropout(F.pad(self.char_table, (0, 0, 1, 0))[ids.long()], rate, gen)
        emb = emb.reshape(b * w, c, self.dim).transpose(1, 2)
        outs = [torch.relu(F.conv1d(emb, getattr(self, f"filter_{i}"),
                                    getattr(self, f"bias_{i}"))).amax(dim=2)
                for i in range(len(self.KERNELS))]
        return torch.cat(outs, dim=-1).reshape(b, w, sum(self.FILTERS))


class Positions(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.position_embeddings = nn.Parameter(torch.zeros(n, dim))

    def forward(self, x):
        return x + self.position_embeddings[None, :x.shape[1], :]


class ConvBlock(nn.Module):
    def __init__(self, dim: int, n: int = 4):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"layer_norm_{i}", LayerNorm(dim))
            self.add_module(f"depthwise_conv_layers_{i}", SepConv(dim))

    def forward(self, x, rate, gen):
        for i in range(self.n):
            y = getattr(self, f"depthwise_conv_layers_{i}")(getattr(self, f"layer_norm_{i}")(x))
            x = dropout(y, rate, gen) + x
        return x


class SelfAttention(nn.Module):
    def __init__(self, dim: int, h: int):
        super().__init__()
        self.h = h
        self.query, self.key, self.value = (Dense(dim, dim, True) for _ in range(3))

    def forward(self, x, mask, rate, gen):
        return merge(attend(heads(self.query(x), self.h), heads(self.key(x), self.h),
                            heads(self.value(x), self.h), attention_bias(mask, mask), rate, gen))


class FeatureEncoder(nn.Module):
    def __init__(self, dim: int, h: int, n_pos: int):
        super().__init__()
        self.pos_emb = Positions(n_pos, dim)
        self.conv_block = ConvBlock(dim)
        self.layer_norm_1 = LayerNorm(dim)
        self.top_self_attention = SelfAttention(dim, h)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense = Dense(dim, dim, True)

    def forward(self, x, mask, rate, gen):
        feats = self.conv_block(self.pos_emb(x), rate, gen)
        out = self.top_self_attention(dropout(self.layer_norm_1(feats), rate, gen), mask, rate, gen)
        res = dropout(out, rate, gen) + feats
        return dropout(self.dense(dropout(self.layer_norm_2(res), rate, gen)), rate, gen) + res


class Predictor(nn.Module):
    def __init__(self, dim: int, h: int, n_pos: int):
        super().__init__()
        self.feature_encoder = FeatureEncoder(dim, h, n_pos)
        self.start_layer_norm, self.end_layer_norm = LayerNorm(dim), LayerNorm(dim)
        self.start_hidden = Dense(2 * dim, dim, True, torch.relu)
        self.end_hidden = Dense(2 * dim, dim, True, torch.relu)
        self.start_dense, self.end_dense = Dense(dim, 1, True), Dense(dim, 1, True)

    def forward(self, x, mask, rate, gen):
        s = self.feature_encoder(x, mask, rate, gen)
        e = self.feature_encoder(s, mask, rate, gen)
        s = self.start_hidden(torch.cat([self.start_layer_norm(s), x], dim=-1))
        e = self.end_hidden(torch.cat([self.end_layer_norm(e), x], dim=-1))
        return self.start_dense(s)[..., 0], self.end_dense(e)[..., 0]


class MatchingHead(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = Dense(dim, 4, True)

    def forward(self, x, labels, mask):
        logits = self.dense(x)              # gumbel off: no noise, no 1/tau
        log_probs = torch.log_softmax(logits, dim=-1)
        onehot = (labels.long()[..., None] == torch.arange(4, device=x.device)).to(logits.dtype)
        m = mask.to(logits.dtype)
        loss = (-(onehot * log_probs).sum(-1) * m).sum() / (m.sum() + 1e-12)
        return loss, torch.softmax(logits, dim=-1)


class SeqPAN(nn.Module):
    """The model; module names are the JAX package's scopes."""

    def __init__(self, vdim: int, dim: int, num_heads: int, attn_layer: int, max_vlen: int,
                 word_dim: int, char_dim: int, num_chars: int):
        super().__init__()
        self.max_vlen, self.attn_layer = max_vlen, attn_layer
        self.word_embs = WordEmbedding(word_dim)
        self.char_embs = CharEmbedding(num_chars, char_dim)
        self.query_conv1d = Dense(word_dim + sum(CharEmbedding.FILTERS), dim, True)
        self.q_layer_norm = LayerNorm(dim)
        self.video_conv1d = Dense(vdim, dim, True)
        self.v_layer_norm = LayerNorm(dim)
        self.pos_emb = Positions(max_vlen, dim)
        self.conv_block = ConvBlock(dim)
        for i in range(attn_layer):
            self.add_module(f"d_attn_{i}", DualAttnBlock(dim, num_heads))
        self.q2v_attn, self.v2q_attn = CQAttention(dim), CQAttention(dim)
        self.cq_cat = CQConcat(dim)
        self.matching_head = MatchingHead(dim)
        self.label_emb = nn.Parameter(torch.zeros(4, dim))
        self.predictor = Predictor(dim, num_heads, max_vlen)

    def forward(self, batch: dict, vectors: torch.Tensor, match_labels=None, rate: float = 0.0,
                gen: Optional[torch.Generator] = None) -> dict:
        vm = sequence_mask(batch["video_seq_len"], self.max_vlen)
        qm = (batch["word_ids"] != 0).to(torch.int32)
        q = torch.cat([self.word_embs(batch["word_ids"], vectors, rate, gen),
                       self.char_embs(batch["char_ids"], rate, gen)], dim=-1)
        q = self.q_layer_norm(self.query_conv1d(q))
        v = self.v_layer_norm(self.video_conv1d(dropout(batch["video_features"], rate, gen)))
        v = self.conv_block(self.pos_emb(v), rate, gen)
        q = self.conv_block(self.pos_emb(q), rate, gen)
        for i in range(self.attn_layer):
            blk = getattr(self, f"d_attn_{i}")
            v, q = blk(v, q, vm, qm, rate, gen), blk(q, v, qm, vm, rate, gen)
        q2v = self.q2v_attn(v, q, vm, qm, rate, gen)
        v2q = self.v2q_attn(q, v, qm, vm, rate, gen)
        fuse = self.cq_cat(q2v, v2q, qm)
        labels = (match_labels if match_labels is not None
                  else torch.zeros(fuse.shape[:2], dtype=torch.int32, device=fuse.device))
        match_loss, scores = self.matching_head(fuse, labels, vm)
        eye = torch.eye(4, device=fuse.device)
        ortho = self.label_emb @ self.label_emb.T * (1.0 - eye)
        match_loss = match_loss + ortho.square().sum().sqrt()
        out = (fuse + scores @ self.label_emb) * vm[:, :, None].to(fuse.dtype)
        start, end = self.predictor(out, vm, rate, gen)
        return {"v_mask": vm, "q_mask": qm, "q2v_feats": q2v, "v2q_feats": v2q,
                "match_loss": match_loss, "match_scores": scores,
                "start_logits": start, "end_logits": end}


# -- losses, optimizer, decode --------------------------------------------------
def _l2n(x):
    return x * torch.rsqrt(torch.clamp(x.square().sum(dim=1, keepdim=True), min=1e-12))


def _kl(log_p, log_q):
    p = torch.exp(log_p)
    return (p * log_p).sum(-1) - (p * log_q).sum(-1)


def loss(out: dict, batch: dict) -> torch.Tensor:
    """loc + match + align."""
    vm = out["v_mask"]
    sl, el = mask_logits(out["start_logits"], vm), mask_logits(out["end_logits"], vm)
    loc = (-(batch["y1"] * torch.log_softmax(sl, -1)).sum(-1)
           - (batch["y2"] * torch.log_softmax(el, -1)).sum(-1)).sum() / sl.shape[0]
    tsum = out["v2q_feats"].sum(dim=1)
    tn = _l2n(tsum / out["q_mask"].sum(dim=1, keepdim=True).to(tsum.dtype))
    inner = batch["inner_labels"]
    w = inner / vm.to(inner.dtype).sum(dim=1, keepdim=True)
    vn = _l2n((out["q2v_feats"] * w[:, :, None]).sum(dim=1))
    vsim = torch.softmax(vn @ vn.T, dim=-1)
    qsim = torch.softmax(tn @ vn.T, dim=-1)
    align = (_kl(torch.log(qsim), vsim) + _kl(torch.log(vsim), qsim)).sum()
    return loc + out["match_loss"] + align


class BertAdamW:
    """Global-norm clip (optax's rule), then Adam moments without bias
    correction, eps 1e-6, decoupled weight decay on ``decay`` leaves."""

    def __init__(self, params, decay, clip=1.0, wd=0.01, b1=0.9, b2=0.999, eps=1e-6):
        self.params, self.decay = list(params), list(decay)
        self.clip, self.wd, self.b1, self.b2, self.eps = clip, wd, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        for p, g, m, v, dec in zip(self.params, grads, self.mu, self.nu, self.decay):
            g = g * scale
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = m / (v.sqrt() + self.eps)
            if dec and self.wd:
                upd = upd + self.wd * p
            p.sub_(lr * upd)


def decayed(key: str) -> bool:
    return "layer_norm" not in key.lower() and "bias" not in key.lower()


def span_decode(start, end, mask):
    """(start_index, end_index) of the best span s <= e."""
    outer = torch.triu(torch.softmax(mask_logits(start, mask), 1)[:, :, None]
                       * torch.softmax(mask_logits(end, mask), 1)[:, None, :])
    return outer.amax(2).argmax(1).to(torch.int32), outer.amax(1).argmax(1).to(torch.int32)


def span_log_probs(start, end, mask):
    """log p(s) + log p(e) for every span s <= e, -inf elsewhere: (B, T, T), f64."""
    ls = torch.log_softmax(mask_logits(start.double(), mask), 1)
    le = torch.log_softmax(mask_logits(end.double(), mask), 1)
    grid = ls[:, :, None] + le[:, None, :]
    T = grid.shape[1]
    upper = torch.ones(T, T, dtype=torch.bool, device=grid.device).triu()
    valid = upper[None] & (mask[:, :, None] > 0) & (mask[:, None, :] > 0)
    return torch.where(valid, grid, torch.full_like(grid, -math.inf))


def ious(s_idx, e_idx, s_ind, e_ind, v_len, duration) -> torch.Tensor:
    """Interval IoU of predicted and labelled spans, s = i*dur/T, e = (i+1)*dur/T."""
    vl, dur = v_len.to(torch.float32), duration.to(torch.float32)
    ps, pe = s_idx.float() * dur / vl, (e_idx.float() + 1.0) * dur / vl
    gs, ge = s_ind.float() * dur / vl, (e_ind.float() + 1.0) * dur / vl
    inter = torch.minimum(pe, ge) - torch.maximum(ps, gs)
    union = torch.maximum(pe, ge) - torch.minimum(ps, gs)
    return torch.clamp(torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0),
                       min=0.0)


def rank1(ious_: np.ndarray) -> dict:
    """R@1 at IoU 0.3 / 0.5 / 0.7 and mIoU, in percent."""
    x = np.asarray(ious_, np.float64)
    return {"r1i3": float(np.count_nonzero(x >= 0.3)) / x.size * 100.0,
            "r1i5": float(np.count_nonzero(x >= 0.5)) / x.size * 100.0,
            "r1i7": float(np.count_nonzero(x >= 0.7)) / x.size * 100.0,
            "miou": float(np.mean(x) * 100.0)}


# -- weights --------------------------------------------------------------------
def _vec_col(shape):
    return (shape[0], 1)


def jax_leaves(model: SeqPAN) -> Iterator[tuple[str, nn.Parameter, tuple, str]]:
    """(JAX key, parameter, JAX shape, init) of every leaf, in the JAX
    package's module order; init is ``glorot``, ``zeros`` or ``ones``, and
    the JAX shape is what the TF fan rule of ``glorot`` reads."""
    for path, mod in model.named_modules():
        pre = "/".join(["params", *path.split(".")]) if path else "params"
        if isinstance(mod, LayerNorm):
            yield f"{pre}/scale", mod.weight, tuple(mod.weight.shape), "ones"
            yield f"{pre}/bias", mod.bias, tuple(mod.bias.shape), "zeros"
        elif isinstance(mod, Dense):
            n_out, n_in = mod.weight.shape
            yield f"{pre}/kernel", mod.weight, (1, n_in, n_out), "glorot"
            if mod.bias is not None:
                yield f"{pre}/bias", mod.bias, (1, 1, n_out), "zeros"
        elif isinstance(mod, SepConv):
            yield (f"{pre}/depthwise_filter", mod.depthwise_filter, (mod.k, 1, mod.dim, 1),
                   "glorot")
            yield (f"{pre}/pointwise_filter", mod.pointwise_filter, (1, 1, mod.dim, mod.dim),
                   "glorot")
            yield f"{pre}/bias", mod.bias, (mod.dim,), "zeros"
        elif isinstance(mod, Bilinear):
            yield f"{pre}/bias", mod.bias, tuple(mod.bias.shape), "zeros"
        elif isinstance(mod, Trilinear):
            d = mod.linear_kernel4arg0.shape[0]
            yield f"{pre}/linear_kernel4arg0", mod.linear_kernel4arg0, (d, 1), "glorot"
            yield f"{pre}/linear_kernel4arg1", mod.linear_kernel4arg1, (d, 1), "glorot"
            yield f"{pre}/linear_kernel4mul", mod.linear_kernel4mul, (1, 1, d), "glorot"
        elif isinstance(mod, Pooling):
            yield f"{pre}/weight", mod.weight, _vec_col(mod.weight.shape), "glorot"
        elif isinstance(mod, CharEmbedding):
            yield f"{pre}/char_table", mod.char_table, tuple(mod.char_table.shape), "glorot"
            for i, (k, ch) in enumerate(zip(mod.KERNELS, mod.FILTERS)):
                yield (f"{pre}/filter_{i}", getattr(mod, f"filter_{i}"), (1, k, mod.dim, ch),
                       "glorot")
                yield f"{pre}/bias_{i}", getattr(mod, f"bias_{i}"), (ch,), "zeros"
        elif isinstance(mod, Positions):
            p = mod.position_embeddings
            yield f"{pre}/position_embeddings", p, tuple(p.shape), "glorot"
        elif isinstance(mod, WordEmbedding):
            yield f"{pre}/unk", mod.unk, tuple(mod.unk.shape), "glorot"
        elif isinstance(mod, SeqPAN):
            yield f"{pre}/label_emb", mod.label_emb, tuple(mod.label_emb.shape), "glorot"


def glorot_limit(shape) -> float:
    """TF's glorot-uniform limit: axes but the last two are the receptive field."""
    if len(shape) == 1:
        fan_in = fan_out = float(shape[0])
    elif len(shape) == 2:
        fan_in, fan_out = float(shape[0]), float(shape[1])
    else:
        rf = float(math.prod(shape[:-2]))
        fan_in, fan_out = rf * shape[-2], rf * shape[-1]
    return math.sqrt(6.0 / (fan_in + fan_out))


def to_jax_layout(key: str, value: torch.Tensor, jax_shape: tuple) -> np.ndarray:
    """A reference parameter in the JAX package's layout (the exchange
    format the port loads)."""
    v = value.detach().cpu().numpy()
    leaf = key.rsplit("/", 1)[1]
    if leaf == "kernel":
        return np.ascontiguousarray(v.T[None])
    if leaf == "depthwise_filter":
        return np.ascontiguousarray(v[:, 0, :].T[:, None, :, None])
    if leaf == "pointwise_filter":
        return np.ascontiguousarray(v.T[None, None])
    if leaf.startswith("filter_"):
        return np.ascontiguousarray(v.transpose(2, 1, 0)[None])
    return np.ascontiguousarray(v.reshape(jax_shape))


@torch.no_grad()
def init_from_uniform(model: SeqPAN, u: torch.Tensor) -> None:
    """Fill every glorot leaf from ``u``, uniform draws in [0, 1) on the
    model's device, consumed leaf after leaf in :func:`jax_leaves` order;
    biases zero, LayerNorm scales one."""
    lo = 0
    for _, p, jshape, init in jax_leaves(model):
        if init == "glorot":
            lim = glorot_limit(jshape)
            p.copy_((u[lo:lo + p.numel()] * (2 * lim) - lim).view_as(p))
            lo += p.numel()
        elif init == "ones":
            p.fill_(1.0)
        else:
            p.zero_()


def glorot_count(model: SeqPAN) -> int:
    return sum(p.numel() for _, p, _, init in jax_leaves(model) if init == "glorot")
