"""The bf16 companion of K2's packed weights (``ops/fused_forward.
pack_weights``), which the kernel's bf16 path reads instead of rounding the
f32 pack in its products:

* it holds exactly the leaves that ``hual_tpu``'s ``_forward_math``
  multiplies with ``mm`` (``hual_tpu/ops/pallas/fused_forward.py``: the
  conv blocks' pointwise filters, every ``dense()``, the bilinears' halves,
  the dual attentions' dense_1 and dense_2, the CQ attentions' ``w4``
  denses, cq_cat, the matching head, ``label_emb``, the feature encoder's
  last dense and the hidden layers), each of them unpacked from its
  shared-memory image bit for bit ``f32_pack.to(torch.bfloat16)``, the
  padding zero;
* its schedule lists each weight's slabs in the order of the kernel's
  products, 16-byte aligned: a product's slabs in chunks of at most four,
  each chunk in column passes of at most 128 outputs (a ring slot), as the
  kernel's dense_bf16 reads them (the CQ attentions' (4D, D) denses are
  imaged as their two halves along K, and a bilinear's two leaves are one
  product);
* ``pack_weights(model, out=)`` refills both buffers in place: a captured
  graph reads them at the addresses it captured.
"""

from __future__ import annotations

import pytest
import torch

from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops import fused_forward as ff
from hual_tpu_torch.ops.kernels import fused_forward as k2
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)


def _model(D: int, L: int, seed: int = 1) -> SeqPAN:
    return SeqPAN(vdim=16, dim=D, num_heads=4, attn_layer=L, max_vlen=12,
                  word_dim=300, char_dim=8, num_chars=20,
                  generator=torch.Generator().manual_seed(seed))


def _rounded_by_jax(L: int) -> set[str]:
    """The leaves under ``mm`` in the JAX kernel's ``_forward_math``."""
    keys = {"q2v_attn/dense/kernel", "v2q_attn/dense/kernel", "cq_cat/dense/kernel",
            "matching_head/dense/kernel", "label_emb",
            "predictor/start_hidden/kernel", "predictor/end_hidden/kernel",
            "predictor/feature_encoder/dense/kernel"}
    for cb in ("conv_block", "predictor/feature_encoder/conv_block"):
        keys |= {f"{cb}/depthwise_conv_layers_{i}/pointwise_filter" for i in range(4)}
    keys |= {f"predictor/feature_encoder/top_self_attention/{n}/kernel"
             for n in ("query", "key", "value")}
    for li in range(L):
        m = f"d_attn_{li}/dual_multihead_attention"
        keys |= {f"{m}/{n}/kernel" for n in (
            "query", "f_key", "f_value", "t_key", "t_value", "s_dense", "x_dense",
            "s_gate", "x_gate", "guided_dense")}
        keys |= {f"{m}/bilinear_{b}/dense_{d}/kernel" for b in (1, 2) for d in (1, 2)}
        keys |= {f"d_attn_{li}/dense_{d}/kernel" for d in (1, 2)}
    return keys


def _unimage(flat: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The (K, N) leaf back from its image: slabs of up to 64 columns of
    w^T (rows padded to 8, columns to 16), each in 8x8 core matrices."""
    Np, Kp = -(-N // 8) * 8, -(-K // 16) * 16
    t = torch.empty((Np, Kp), dtype=flat.dtype)
    at = 0
    for k0 in range(0, Kp, 64):
        kw = min(64, Kp - k0)
        for n in range(Np):
            for kc in range(kw // 8):
                start = at + ((n // 8) * (kw // 8) + kc) * 64 + (n % 8) * 8
                t[n, k0 + 8 * kc:k0 + 8 * kc + 8] = flat[start:start + 8]
        at += Np * kw
    assert at == Np * Kp
    return t


@pytest.mark.parametrize("D,L", [(32, 1), (36, 2), (128, 1)])
def test_companion_holds_the_rounded_leaves(D, L):
    packed = ff.pack_weights(_model(D, L))
    assert packed.bf16.dtype == torch.bfloat16 and packed.bf16.is_contiguous()
    assert set(packed.bf16_layout) == _rounded_by_jax(L)
    assert ff.bf16_leaves(L) == [k for k in ff.pack_order(L) if k in _rounded_by_jax(L)]
    bits = packed.bf16.view(torch.int16)
    covered = 0
    for key, (offset, shape) in packed.bf16_layout.items():
        want = packed(key).to(torch.bfloat16).view(torch.int16)
        assert offset % 8 == 0, key            # 16-byte aligned
        if key in ("matching_head/dense/kernel", "label_emb"):
            got = bits[offset:offset + want.numel()].view(shape)
            size = want.numel()
        else:
            K, N = shape
            halves = 2 if key in ff.BF16_HALVES else 1   # imaged apart along K
            Kh = K // halves
            got, size = [], 0
            for h in range(halves):
                n = -(-N // 8) * 8 * (-(-Kh // 16) * 16)
                img = _unimage(bits[offset + size:offset + size + n], Kh, N)
                got.append(img[:N, :Kh].t())
                pad = img.clone()
                pad[:N, :Kh] = 0
                assert not pad.any(), f"{key}: nonzero padding"
                size += n
            got = torch.cat(got)
        assert torch.equal(got, want), key
        covered += size
    assert covered <= packed.bf16.numel() < covered + 16


@pytest.mark.parametrize("D,L", [(32, 2), (36, 1), (136, 1)])
def test_schedule_lists_the_slabs_of_the_products(D, L):
    packed = ff.pack_weights(_model(D, L))
    sched = packed.schedule
    assert sched.dtype == torch.int32 and sched.shape[1] == 2
    rows, counts = [], {}
    for product in ff.bf16_products(L):
        slabs = []   # (byte offset of the slab, padded N, its k width)
        for key, h in product:
            if h == 0:
                counts[key] = counts.get(key, 0) + 1
            offset, (K, N) = packed.bf16_layout[key]
            halves = 2 if key in ff.BF16_HALVES else 1
            Np, Kp = -(-N // 8) * 8, -(-(K // halves) // 16) * 16
            for k0 in range(0, Kp, ff.SLAB_K):
                slabs.append((2 * (offset + Np * (h * Kp + k0)), Np,
                              min(ff.SLAB_K, Kp - k0)))
        for c in range(0, len(slabs), 4):      # chunks of four slabs
            for n0 in range(0, slabs[0][1], 128):   # column passes
                for start, Np, kw in slabs[c:c + 4]:
                    rows.append([start + 2 * n0 * kw, 2 * min(128, Np - n0) * kw])
    assert sched.tolist() == rows
    assert ff.bf16_schedule(L) == [k for p in ff.bf16_products(L) for k, h in p if h == 0]
    assert all(b % 16 == 0 and o % 16 == 0 for o, b in rows)
    assert max(b for _, b in rows) <= 2 * ff.RING_ROWS * ff.SLAB_K
    # the conv blocks, the dual layers and the feature encoder run twice
    twice = {k for k in counts if "conv_block" in k or k.startswith("d_attn_")
             or "feature_encoder" in k}
    assert {k for k, n in counts.items() if n == 2} == twice
    assert set(counts) == _rounded_by_jax(L) - {"matching_head/dense/kernel", "label_emb"}


def test_repack_refills_both_buffers_in_place():
    model = _model(32, 1)
    packed = ff.pack_weights(model)
    ptrs = (packed.buffer.data_ptr(), packed.bf16.data_ptr(), packed.schedule.data_ptr())
    before = packed.bf16.clone()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5).add_(0.01)
    again = ff.pack_weights(model, out=packed)
    assert again is packed
    assert (packed.buffer.data_ptr(), packed.bf16.data_ptr(),
            packed.schedule.data_ptr()) == ptrs
    fresh = ff.pack_weights(model)
    assert torch.equal(packed.buffer, fresh.buffer)
    assert torch.equal(packed.bf16.view(torch.int16), fresh.bf16.view(torch.int16))
    assert not torch.equal(packed.bf16.view(torch.int16), before.view(torch.int16))
    with pytest.raises(ValueError, match="packed for another model"):
        ff.pack_weights(_model(36, 1), out=packed)


def test_bf16_launch_needs_the_companion():
    packed = ff.pack_weights(_model(32, 1))
    bare = ff.PackedWeights(packed.buffer, packed.layout, packed.attn_layer)
    with pytest.raises(ValueError, match="bf16 companion is missing"):
        k2._check_bf16(bare, packed.buffer.device)
    k2._check_bf16(packed, packed.buffer.device)
