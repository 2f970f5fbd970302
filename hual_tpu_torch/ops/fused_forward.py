"""The fused deterministic SeqPAN forward (counterpart of
``hual_tpu/ops/pallas/fused_forward.py``).

K2 computes everything after the input projections: the shared positional
embedding and conv block on both streams, the dual-attention stack, CQ
fusion, the matching softmax with the soft label embedding, and the
conditioned predictor.  Its inputs are the projected and normalised streams
``vf (B,T,D)`` and ``qf (B,W,D)`` with their 0/1 masks; its outputs are
``start_logits (B,T)``, ``end_logits (B,T)`` and ``match_scores (B,T,4)``.

* :func:`pack_weights` packs K2's 152 leaves into one contiguous f32 buffer,
  in the order ``csrc/fused_forward.cu`` walks it (:func:`pack_order`), and
  the leaves that the bf16 path's products round into a bf16 companion
  buffer, each in the shared-memory layout its product reads
  (``_bf16_parts``), with the kernel's schedule of their slabs
  (:func:`bf16_schedule`).
* :func:`forward_math` is the plain PyTorch version of K2's function, with
  ordinary per-sample masked attention; it reads every weight from the
  packed buffer, so it checks the packing too.  With ``mxu_bf16`` it is
  the JAX kernel's ``mxu_bf16`` branch: each product that
  ``_forward_math`` runs through ``mm``/``mmt`` rounds both operands to
  bf16 and sums in the working dtype; the layout moves (``mm_exact``), the
  elementwise sums and everything else keep full precision.
* :func:`encoder_inputs` runs the model's own embedding, projection and LN
  submodules in f32, whatever the model's ``compute_dtype`` (as the JAX
  package's fused path does); :func:`seqpan_forward_fused` chains them, K2
  and K1.

Packed layout: each leaf is stored row-major in the JAX package's layout
with its unit axes dropped: a dense kernel is ``(in, out)``, a depthwise
filter ``(k, D)``, a vector ``(n,)``; the two position tables keep their
``(max_vlen, D)``, at ``max_vlen`` 1 too.  The 18 leaves
of the input front (``word_embs``, ``char_embs``, ``query_conv1d``,
``q_layer_norm``, ``video_conv1d``, ``v_layer_norm``) are left out: they
run before K2, in :func:`encoder_inputs`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from hual_tpu_torch.ops.masking import MASK_VALUE, sequence_mask

# Leaves of the input front, computed before K2 (encoder_inputs).
FRONT_MODULES = ("word_embs", "char_embs", "query_conv1d", "q_layer_norm",
                 "video_conv1d", "v_layer_norm")

_DUAL_DENSES = ("query", "f_key", "f_value", "t_key", "t_value", "s_dense",
                "x_dense", "s_gate", "x_gate", "guided_dense")


def _conv_block_order(path: str) -> list[str]:
    keys = []
    for i in range(4):
        dw = f"{path}/depthwise_conv_layers_{i}"
        keys += [f"{path}/layer_norm_{i}/scale", f"{path}/layer_norm_{i}/bias",
                 f"{dw}/depthwise_filter", f"{dw}/pointwise_filter", f"{dw}/bias"]
    return keys


def _dense_order(path: str, bias: bool = True) -> list[str]:
    return [f"{path}/kernel"] + ([f"{path}/bias"] if bias else [])


def _ln_order(path: str) -> list[str]:
    return [f"{path}/scale", f"{path}/bias"]


def pack_order(attn_layer: int) -> list[str]:
    """K2's leaves (JAX keys without the ``params/`` prefix) in the order of
    the packed buffer; ``csrc/fused_forward.cu`` reads them in this order."""
    keys = ["pos_emb/position_embeddings"] + _conv_block_order("conv_block")
    for li in range(attn_layer):
        d = f"d_attn_{li}"
        m = f"{d}/dual_multihead_attention"
        keys += (_ln_order(f"{d}/layer_norm_1") + _ln_order(f"{d}/layer_norm_t")
                 + _ln_order(f"{d}/layer_norm_2"))
        for name in _DUAL_DENSES:
            keys += _dense_order(f"{m}/{name}")
        for bl in ("bilinear_1", "bilinear_2"):
            keys += [f"{m}/{bl}/dense_1/kernel", f"{m}/{bl}/dense_2/kernel",
                     f"{m}/{bl}/bias"]
        keys += _dense_order(f"{d}/dense_1") + _dense_order(f"{d}/dense_2")
    for name in ("q2v_attn", "v2q_attn"):
        tri = f"{name}/efficient_trilinear"
        keys += [f"{tri}/linear_kernel4arg0", f"{tri}/linear_kernel4arg1",
                 f"{tri}/linear_kernel4mul"] + _dense_order(f"{name}/dense", False)
    keys += ["cq_cat/weighted_pooling/weight"] + _dense_order("cq_cat/dense")
    keys += _dense_order("matching_head/dense") + ["label_emb"]
    fe = "predictor/feature_encoder"
    keys += [f"{fe}/pos_emb/position_embeddings"] + _conv_block_order(f"{fe}/conv_block")
    keys += _ln_order(f"{fe}/layer_norm_1")
    for name in ("query", "key", "value"):
        keys += _dense_order(f"{fe}/top_self_attention/{name}")
    keys += _ln_order(f"{fe}/layer_norm_2") + _dense_order(f"{fe}/dense")
    keys += (_ln_order("predictor/start_layer_norm")
             + _ln_order("predictor/end_layer_norm")
             + _dense_order("predictor/start_hidden")
             + _dense_order("predictor/end_hidden")
             + _dense_order("predictor/start_dense")
             + _dense_order("predictor/end_dense"))
    return keys


# The bf16 companion.  The leaves the JAX kernel's ``mm`` rounds on its
# bf16 path are the kernels of the D-wide dense layers (the pointwise
# filters, the dual attentions', the CQ attentions', cq_cat's, the feature
# encoder's and the predictor's hidden layers: the B operands of the
# kernel's products) and the matching head's kernel and ``label_emb`` (CUDA
# cores).  The (D, 1) denses are elementwise sums there, not rounded.
SLAB_K = 64          # k depth of one slab of a product's weight (kKSlab)
CHUNK_SLABS = 4      # slabs of one chunk of a product (kChunkSlabs)
RING_ROWS = 128      # output columns of a ring slot, a column pass (kRingRows)
_ROW_MAJOR_BF16 = ("matching_head/dense/kernel", "label_emb")
# the CQ attentions' (4D, D) denses run on the bf16 path as two segments of
# K = 2D, as the bilinears' [d1; d2]: each half imaged apart
BF16_HALVES = ("q2v_attn/dense/kernel", "v2q_attn/dense/kernel")
_NOT_ROUNDED = ("predictor/start_dense/kernel", "predictor/end_dense/kernel")


def bf16_leaves(attn_layer: int) -> list[str]:
    """The leaves of the bf16 companion, in pack order."""
    return [k for k in pack_order(attn_layer)
            if (k.endswith("/kernel") or k.endswith("/pointwise_filter")
                or k == "label_emb") and k not in _NOT_ROUNDED]


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _images(key: str, w: torch.Tensor) -> list[torch.Tensor]:
    """The leaf's parts as its products read them: (K, N) once, or its two
    halves along K (:data:`BF16_HALVES`)."""
    if key in BF16_HALVES:
        half = w.shape[0] // 2
        return [w[:half], w[half:]]
    return [w]


def bf16_products(attn_layer: int) -> list[list[tuple[str, int]]]:
    """The kernel's products on the bf16 path in order, each a list of its
    weight parts (leaf key, half): the conv block on each stream, each
    dual-attention layer in both directions (its ten denses, the two
    bilinears of two leaves each, dense_1, dense_2), the two CQ attentions'
    denses (two halves each), cq_cat, the feature encoder twice (its
    pointwise filters, q, k, v, dense), the two hidden layers."""
    def one(*keys):
        return [[(k, 0)] for k in keys]

    conv = one(*(f"conv_block/depthwise_conv_layers_{i}/pointwise_filter"
                 for i in range(4)))
    order = conv + conv
    for li in range(attn_layer):
        m = f"d_attn_{li}/dual_multihead_attention"
        layer = (one(*(f"{m}/{name}/kernel" for name in _DUAL_DENSES))
                 + [[(f"{m}/{bl}/{d}/kernel", 0) for d in ("dense_1", "dense_2")]
                    for bl in ("bilinear_1", "bilinear_2")]
                 + one(f"d_attn_{li}/dense_1/kernel", f"d_attn_{li}/dense_2/kernel"))
        order += layer + layer
    order += [[(k, 0), (k, 1)] for k in BF16_HALVES] + one("cq_cat/dense/kernel")
    fe = "predictor/feature_encoder"
    enc = one(*[f"{fe}/conv_block/depthwise_conv_layers_{i}/pointwise_filter"
                for i in range(4)],
              *[f"{fe}/top_self_attention/{n}/kernel" for n in ("query", "key", "value")],
              f"{fe}/dense/kernel")
    return order + enc + enc + one("predictor/start_hidden/kernel",
                                   "predictor/end_hidden/kernel")


def bf16_schedule(attn_layer: int) -> list[str]:
    """The ring leaves in the order of the kernel's products
    (:func:`bf16_products`), a leaf of two halves once."""
    return [key for product in bf16_products(attn_layer)
            for key, half in product if half == 0]


# The two position tables, (max_vlen, D): they keep both axes, so that
# PackedWeights.max_pos reads max_vlen at max_vlen 1 too.
POS_TABLES = ("pos_emb/position_embeddings",
              "predictor/feature_encoder/pos_emb/position_embeddings")


def _kernel_layout(key: str, jax_shaped: torch.Tensor) -> torch.Tensor:
    """A leaf in the JAX package's shape with its unit axes dropped, but
    for the position tables (:data:`POS_TABLES`)."""
    if key in POS_TABLES:
        return jax_shaped
    shape = [s for s in jax_shaped.shape if s != 1] or [1]
    return jax_shaped.reshape(shape)


@dataclass
class PackedWeights:
    """K2's weights: one contiguous f32 buffer on the model's device and a
    static layout, JAX key (without ``params/``) -> (offset, shape); the
    bf16 path's companion (``bf16``, its ``bf16_layout``, key -> (offset,
    shape) in values) and the ring's ``schedule``: int32 (slabs, 2) of
    (byte offset, bytes) in the order the kernel's products read them."""

    buffer: torch.Tensor
    layout: dict[str, tuple[int, tuple[int, ...]]]
    attn_layer: int
    bf16: torch.Tensor | None = None
    bf16_layout: dict[str, tuple[int, tuple[int, ...]]] | None = None
    schedule: torch.Tensor | None = None

    def __call__(self, key: str) -> torch.Tensor:
        offset, shape = self.layout[key]
        return self.buffer[offset:offset + math.prod(shape)].view(shape)

    @property
    def max_pos(self) -> int:
        return self.layout["pos_emb/position_embeddings"][1][0]


def _bf16_parts(leaves: dict[str, torch.Tensor], attn_layer: int
                ) -> tuple[list[torch.Tensor], dict]:
    """The companion's parts and layout.  A weight leaf w (K, N) becomes the
    bf16 shared-memory image its product reads: w^T (N rows of K) padded
    with zeros to up8(N) rows and up16(K) columns, cut into slabs of
    :data:`SLAB_K` columns (the last one narrower), each slab K-major in
    core matrices of 8 rows x 8 values, core matrix (n/8, k/8) of a slab kw
    wide at ``((n/8) * (kw/8) + k/8) * 64``, row n%8 of it 8 values on; the
    kernel copies each slab whole into a ring slot.  The leaves of
    :data:`BF16_HALVES` are imaged as their two halves along K, one after
    the other.  Images of one shape are made together (the D x D kernels,
    then 2D x D); the matching head's kernel and ``label_emb`` follow
    row-major; each part is 16-byte aligned."""
    keys = [k for k in bf16_leaves(attn_layer) if k not in _ROW_MAJOR_BF16]
    # the images by shape: (key, part) in key order
    shapes: dict[tuple, list[tuple[str, torch.Tensor]]] = {}
    for k in keys:
        for part in _images(k, leaves[k]):
            shapes.setdefault(tuple(part.shape), []).append((k, part))
    parts, layout, offset = [], {}, 0
    for (K, N), group in shapes.items():
        size = _up(N, 8) * _up(K, 16)
        # one image per part, all of the group in one pass
        stacked = torch.stack([part.float() for _, part in group])
        t = torch.zeros((len(group), _up(N, 8), _up(K, 16)), dtype=torch.bfloat16,
                        device=stacked.device)
        t[:, :N, :K] = stacked.transpose(1, 2)
        Np, Kp = t.shape[1:]
        slabs = [t[:, :, k0:k0 + min(SLAB_K, Kp - k0)]
                 .reshape(len(group), Np // 8, 8, -1, 8).permute(0, 1, 3, 2, 4)
                 .reshape(len(group), -1) for k0 in range(0, Kp, SLAB_K)]
        parts.append(torch.cat(slabs, dim=1).reshape(-1))
        for k, _ in group:
            if k not in layout:   # a leaf's offset is its first part's
                layout[k] = (offset, tuple(leaves[k].shape))
            offset += size
    for k in _ROW_MAJOR_BF16:
        t = leaves[k].float().to(torch.bfloat16).reshape(-1)
        pad = _up(t.numel(), 8) - t.numel()
        parts.append(torch.cat([t, t.new_zeros(pad)]) if pad else t)
        layout[k] = (offset, tuple(leaves[k].shape))
        offset += t.numel() + pad
    return parts, layout


def bf16_slabs(layout: dict, attn_layer: int) -> list[tuple[int, int]]:
    """The ring's slabs in the order the kernel consumes them, (value offset
    in the companion, values) each.  A product's parts are cut into slabs of
    :data:`SLAB_K` (each part padded to 16 values of k); the slabs form
    chunks of :data:`CHUNK_SLABS`, and each chunk is read in column passes
    of :data:`RING_ROWS` outputs, a pass's rows of every slab of the chunk
    (contiguous in the slab's image: core matrices of 8 rows follow each
    other along N)."""
    rows = []
    for product in bf16_products(attn_layer):
        slabs = []   # (offset of the slab, padded N, its k width)
        for key, half in product:
            offset, (K, N) = layout[key]
            halves = 2 if key in BF16_HALVES else 1
            Np, Kp = _up(N, 8), _up(K // halves, 16)
            base = offset + half * Np * Kp
            slabs += [(base + Np * k0, Np, min(SLAB_K, Kp - k0))
                      for k0 in range(0, Kp, SLAB_K)]
        for c0 in range(0, len(slabs), CHUNK_SLABS):
            chunk = slabs[c0:c0 + CHUNK_SLABS]
            for n0 in range(0, chunk[0][1], RING_ROWS):
                rows += [(start + n0 * kw, min(RING_ROWS, Np - n0) * kw)
                         for start, Np, kw in chunk]
    return rows


def _bf16_schedule_tensor(layout: dict, attn_layer: int, device) -> torch.Tensor:
    rows = [(2 * offset, 2 * values) for offset, values in bf16_slabs(layout, attn_layer)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def pack_weights(model, out: PackedWeights | None = None) -> PackedWeights:
    """Pack ``model``'s K2 leaves into one buffer, and the leaves the bf16
    path rounds into its companion, once per sweep.

    With ``out`` (an earlier pack of the same model) both buffers are
    written in place and ``out`` is returned: a captured CUDA graph reads
    them at the addresses they had at capture, so a sweep that replays one
    refreshes the pack this way before its replays.
    """
    from hual_tpu_torch.weights import _leaves  # the port's leaf walk

    leaves = {}
    with torch.no_grad():
        for key, param, _, to_jax in _leaves(model):
            key = key[len("params/"):]
            if key.split("/")[0] in FRONT_MODULES:
                continue
            # the layout moves of K2's leaves are indexing and .T only, so
            # weights.py's NumPy moves apply to tensors as they are
            leaves[key] = _kernel_layout(key, to_jax(param.detach()))
        order = pack_order(model.attn_layer)
        if sorted(order) != sorted(leaves):
            raise ValueError("K2's pack order and the model's leaves differ: "
                             f"{sorted(set(order) ^ set(leaves))}")
        layout, offset, parts = {}, 0, []
        for key in order:
            t = leaves[key].float()
            layout[key] = (offset, tuple(t.shape))
            offset += t.numel()
            parts.append(t.reshape(-1))
        bf16_parts, bf16_layout = _bf16_parts(leaves, model.attn_layer)
        if out is None:
            device = parts[0].device
            return PackedWeights(
                torch.cat(parts).contiguous(), layout, model.attn_layer,
                torch.cat(bf16_parts).contiguous(), bf16_layout,
                _bf16_schedule_tensor(bf16_layout, model.attn_layer, device))
        if (out.layout != layout or out.bf16_layout != bf16_layout
                or out.buffer.device != parts[0].device):
            raise ValueError("pack_weights: out was packed for another model")
        torch.cat(parts, out=out.buffer)
        torch.cat(bf16_parts, out=out.bf16)
    return out


# -- the plain version ----------------------------------------------------------
def forward_math(packed: PackedWeights, vf: torch.Tensor, qf: torch.Tensor,
                 v_mask: torch.Tensor, q_mask: torch.Tensor, *, attn_layer: int,
                 num_heads: int, tau: float, use_gumbel: bool,
                 mxu_bf16: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function in plain PyTorch: (start_logits, end_logits,
    match_scores) in the inputs' dtype (f32; f64 for a reference).  Weights
    come from ``packed``; ``mxu_bf16`` rounds the operands of the JAX
    kernel's ``mm``/``mmt`` products to bf16."""
    w = packed
    vm = v_mask.to(vf.dtype)
    qm = q_mask.to(vf.dtype)
    D = vf.shape[-1]
    H = num_heads
    hd = D // H

    def rnd(x):  # round to nearest even bf16, kept in the working dtype
        return x.to(torch.bfloat16).to(x.dtype) if mxu_bf16 else x

    def mm(a, b):  # the JAX kernel's mm / mmt
        return torch.matmul(rnd(a), rnd(b))

    def ln(x, path):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-6) * w(path + "/scale") \
            + w(path + "/bias")

    def dense(x, path, bias=True):
        y = mm(x, w(path + "/kernel"))
        return y + w(path + "/bias") if bias else y

    def conv_block(x, path):
        L = x.shape[1]
        for i in range(4):
            dwp = f"{path}/depthwise_conv_layers_{i}"
            h = ln(x, f"{path}/layer_norm_{i}")
            filt = w(dwp + "/depthwise_filter")                 # (7, D)
            hp = F.pad(h, (0, 0, 3, 3))
            acc = torch.zeros_like(h)
            for k in range(filt.shape[0]):
                acc = acc + hp[:, k:k + L] * filt[k]
            pw = mm(acc, w(dwp + "/pointwise_filter"))
            x = torch.relu(pw + w(dwp + "/bias")) + x
        return x

    def attend(q, k, v, fm, tm):
        # the additive bias of ops/masking.attention_bias: an all-padding
        # `from` row gets -1e30 on every score and attends uniformly
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        qh = q.reshape(B, Tq, H, hd).transpose(1, 2)
        kh = k.reshape(B, Tk, H, hd).transpose(1, 2)
        vh = v.reshape(B, Tk, H, hd).transpose(1, 2)
        bias = (1.0 - fm[:, :, None] * tm[:, None, :]) * MASK_VALUE
        # scaled after the product, as the JAX kernel does
        scores = mm(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        prob = torch.softmax(scores + bias[:, None], dim=-1)
        return mm(prob, vh).transpose(1, 2).reshape(B, Tq, D)

    def dual_attn(frm, to, fm, tm, pre):
        m = f"{pre}/dual_multihead_attention"
        out = ln(frm, pre + "/layer_norm_1")
        ton = ln(to, pre + "/layer_norm_t")
        q = dense(out, m + "/query")
        s_out = attend(q, dense(out, m + "/f_key"), dense(out, m + "/f_value"),
                       fm, fm)
        x_out = attend(q, dense(ton, m + "/t_key"), dense(ton, m + "/t_value"),
                       fm, tm)
        s_val = dense(s_out, m + "/s_dense")
        x_val = dense(x_out, m + "/x_dense")
        s_gate = torch.sigmoid(dense(s_val, m + "/s_gate"))
        x_gate = torch.sigmoid(dense(x_val, m + "/x_gate"))
        outputs = dense(s_gate * x_val + x_gate * s_val, m + "/guided_dense")

        def bilinear(name):
            return (mm(out, w(f"{m}/{name}/dense_1/kernel"))
                    + mm(outputs, w(f"{m}/{name}/dense_2/kernel"))
                    + w(f"{m}/{name}/bias"))

        f = fm[:, :, None]
        gated = torch.sigmoid(bilinear("bilinear_1") * f
                              + MASK_VALUE * (1.0 - f)) * bilinear("bilinear_2")
        res = dense(gated, pre + "/dense_1") + frm
        return dense(ln(res, pre + "/layer_norm_2"), pre + "/dense_2") + res

    def cq_attention(x1, x2, m1, m2, name):
        tri = f"{name}/efficient_trilinear"
        # sub0 and sub1 are elementwise sums in the JAX kernel, full precision
        sub0 = torch.matmul(x1, w(tri + "/linear_kernel4arg0"))[:, :, None]
        sub1 = torch.matmul(x2, w(tri + "/linear_kernel4arg1"))[:, None, :]
        sub2 = mm(x1 * w(tri + "/linear_kernel4mul"), x2.transpose(1, 2))
        score = sub0 + sub1 + sub2                              # (B, T1, T2)
        mk2 = m2[:, None, :]
        mk1 = m1[:, :, None]
        score_ = torch.softmax(score * mk2 + MASK_VALUE * (1.0 - mk2), dim=-1)
        score_t = torch.softmax(score * mk1 + MASK_VALUE * (1.0 - mk1), dim=1)
        c2q = mm(score_, x2)
        # the JAX kernel's association: the inner product's result is
        # rounded again as an operand
        q2c = mm(mm(score_, score_t.transpose(1, 2)), x1)
        att = torch.cat([x1, c2q, x1 * c2q, x1 * q2c], dim=-1)
        return dense(att, name + "/dense", bias=False)

    def feature_encoder(x, fm):
        fe = "predictor/feature_encoder"
        feats = x + w(fe + "/pos_emb/position_embeddings")[None, :x.shape[1]]
        feats = conv_block(feats, fe + "/conv_block")
        o = ln(feats, fe + "/layer_norm_1")
        sa = fe + "/top_self_attention"
        res = attend(dense(o, sa + "/query"), dense(o, sa + "/key"),
                     dense(o, sa + "/value"), fm, fm) + feats
        return dense(ln(res, fe + "/layer_norm_2"), fe + "/dense") + res

    pos = w("pos_emb/position_embeddings")
    vf = conv_block(vf + pos[None, :vf.shape[1]], "conv_block")
    qf = conv_block(qf + pos[None, :qf.shape[1]], "conv_block")
    for li in range(attn_layer):
        vf, qf = (dual_attn(vf, qf, vm, qm, f"d_attn_{li}"),
                  dual_attn(qf, vf, qm, vm, f"d_attn_{li}"))

    q2v = cq_attention(vf, qf, vm, qm, "q2v_attn")                 # (B, T, D)
    v2q = cq_attention(qf, vf, qm, vm, "v2q_attn")                 # (B, W, D)
    # the pooling and the tile are elementwise sums and layout moves
    # (mm_exact) in the JAX kernel: full precision
    x = torch.matmul(v2q, w("cq_cat/weighted_pooling/weight"))[:, :, None]
    qmk = qm[:, :, None]
    alphas = torch.softmax(x * qmk + MASK_VALUE * (1.0 - qmk), dim=1)
    pooled = (v2q * alphas).sum(dim=1)                             # (B, D)
    tiled = pooled[:, None, :].expand(-1, q2v.shape[1], -1)
    fuse = dense(torch.cat([q2v, tiled], dim=-1), "cq_cat/dense")

    mlogits = dense(fuse, "matching_head/dense")
    if use_gumbel:
        mlogits = mlogits / tau          # the deterministic part only
    mscores = torch.softmax(mlogits, dim=-1)                       # (B, T, 4)
    outputs = (fuse + mm(mscores, w("label_emb"))) * vm[:, :, None]

    start_f = feature_encoder(outputs, vm)
    end_f = feature_encoder(start_f, vm)
    p = "predictor"
    start_h = torch.relu(dense(torch.cat(
        [ln(start_f, p + "/start_layer_norm"), outputs], dim=-1), p + "/start_hidden"))
    end_h = torch.relu(dense(torch.cat(
        [ln(end_f, p + "/end_layer_norm"), outputs], dim=-1), p + "/end_hidden"))
    # the (D, 1) kernels are packed as (D,): these products are (B, T),
    # elementwise sums in the JAX kernel, full precision
    start_logits = (torch.matmul(start_h, w(p + "/start_dense/kernel"))
                    + w(p + "/start_dense/bias"))
    end_logits = (torch.matmul(end_h, w(p + "/end_dense/kernel"))
                  + w(p + "/end_dense/bias"))
    return start_logits, end_logits, mscores


# -- the path around K2 ---------------------------------------------------------
def encoder_inputs(model, batch: dict[str, torch.Tensor],
                   word_vectors: torch.Tensor):
    """The input front (embeddings, input projections, LN) through the
    model's own submodules: (vf, qf, v_mask, q_mask)."""
    v_mask = sequence_mask(batch["video_seq_len"], model.max_vlen)
    q_mask = (batch["word_ids"] != 0).to(torch.int32)
    qf = torch.cat([model.word_embs(batch["word_ids"], word_vectors),
                    model.char_embs(batch["char_ids"])], dim=-1)
    qf = model.q_layer_norm(model.query_conv1d(qf))
    vf = model.v_layer_norm(model.video_conv1d(batch["video_features"]))
    return vf.contiguous(), qf.contiguous(), v_mask, q_mask


def seqpan_forward_fused(model, packed: PackedWeights,
                         batch: dict[str, torch.Tensor],
                         word_vectors: torch.Tensor,
                         mxu_bf16: bool = False) -> dict[str, torch.Tensor]:
    """Deterministic SeqPAN forward: the input front, K2 (with bf16
    products under ``mxu_bf16``), then K1's span decode.  Carries the keys
    the eval and infer sweeps read."""
    from hual_tpu_torch.ops.kernels.fused_forward import fused_forward
    from hual_tpu_torch.ops.kernels.span_decode import span_decode

    vf, qf, v_mask, q_mask = encoder_inputs(model, batch, word_vectors)
    start_logits, end_logits, match_scores = fused_forward(
        packed, vf, qf, v_mask, q_mask, attn_layer=model.attn_layer,
        num_heads=model.num_heads, tau=model.tau, use_gumbel=model.use_gumbel,
        mxu_bf16=mxu_bf16)
    start_index, end_index = span_decode(start_logits, end_logits, v_mask)
    return {"v_mask": v_mask, "q_mask": q_mask, "match_scores": match_scores,
            "start_logits": start_logits, "end_logits": end_logits,
            "start_index": start_index, "end_index": end_index}
