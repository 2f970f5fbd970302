"""K2's plain version and its wrapper's CPU route against the JAX package.

The same seeded inputs go through ``hual_tpu``'s fused forward (its Pallas
kernel in interpret mode, as ``tests/test_fused_forward.py`` runs it) and
the port's ``seqpan_forward_fused`` (input front, K2's wrapper on its CPU
route = ``forward_math``, K1's wrapper on its CPU route), from the same
carried-over params; and through the port's eager SeqPAN.  Batches are
ragged (B=5) with padded rows, a length-1 video and a one-word query; the
``max_vlen`` 1 case is B=3 at T=W=1, where both position tables are (1, D).

Tolerances: logits rtol 1e-4 / atol 2e-4, match scores atol 1e-5 (the
bounds of tests/test_fused_forward.py: the frameworks sum in other orders);
decoded indices exact.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.ops.pallas.fused_forward import \
    seqpan_forward_fused as jax_seqpan_forward_fused
from hual_tpu.serve import _flatten_params
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.fused_forward import (FRONT_MODULES, forward_math,
                                              pack_order, pack_weights,
                                              seqpan_forward_fused)
from hual_tpu_torch.ops.kernels import fused_forward as k2
from hual_tpu_torch.weights import load_jax_params, to_jax_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

B, W, C, V = 5, 6, 5, 24
CASES = {
    # name: widths, gumbel, batch, query words
    "d32_h4_l1": (dict(dim=32, num_heads=4, attn_layer=1, max_vlen=16), False, B, W),
    "d32_h4_l1_gumbel": (dict(dim=32, num_heads=4, attn_layer=1, max_vlen=16),
                         True, B, W),
    "d128_h8_l2": (dict(dim=128, num_heads=8, attn_layer=2, max_vlen=16), False, B, W),
    "d32_h4_l1_vlen1": (dict(dim=32, num_heads=4, attn_layer=1, max_vlen=1),
                        False, 3, 1),
    # past the card kernel's old shape limit: T over 100 with D not a
    # multiple of 4, and D over 128
    "d30_h5_l1_vlen120": (dict(dim=30, num_heads=5, attn_layer=1, max_vlen=120),
                          False, B, W),
    "d136_h8_l1": (dict(dim=136, num_heads=8, attn_layer=1, max_vlen=16), False, B, W),
}
TEXT = dict(word_dim=20, char_dim=8, num_chars=30)


def _batch(T: int, seed: int, Bn: int = B, Wn: int = W) -> tuple[dict, np.ndarray]:
    rng = np.random.default_rng(seed)
    # a length-1 video and a one-word query
    v_len = np.minimum(np.array([T, 1, 9, T, 5], np.int32)[:Bn], T)
    q_len = np.minimum(np.array([Wn, 3, 1, 4, Wn])[:Bn], Wn)
    word_ids = np.where(np.arange(Wn)[None] < q_len[:, None],
                        rng.integers(1, 15, (Bn, Wn)), 0).astype(np.int32)
    char_ids = rng.integers(0, 30, (Bn, Wn, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    feats = rng.normal(size=(Bn, T, V)).astype(np.float32)
    batch = {"video_features": feats, "video_seq_len": v_len,
             "word_ids": word_ids, "char_ids": char_ids}
    return batch, rng.normal(size=(13, TEXT["word_dim"])).astype(np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    kw, gumbel, Bn, Wn = CASES[request.param]
    batch, wv = _batch(kw["max_vlen"], len(request.param), Bn, Wn)
    jmodel = JaxSeqPAN(**kw, **TEXT, use_gumbel=gumbel, tau=0.3)
    params = jmodel.init({"params": jax.random.key(0)}, batch, wv, 0.0,
                         deterministic=True)
    ref = jax_seqpan_forward_fused(jmodel, params, batch, wv, block_b=4,
                                   interpret=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    model = load_jax_params(SeqPAN(vdim=V, **kw, **TEXT, use_gumbel=gumbel,
                                   tau=0.3), _flatten_params(params)).eval()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model, tbatch, torch.from_numpy(wv), ref


def _assert_close(out: dict, ref: dict) -> None:
    for key in ("start_logits", "end_logits"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=2e-4,
                                   err_msg=key)
    np.testing.assert_allclose(out["match_scores"], ref["match_scores"],
                               rtol=0, atol=1e-5)
    for key in ("start_index", "end_index"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_fused_forward_matches_jax_kernel(case):
    model, batch, wv, ref = case
    with torch.no_grad():
        out = seqpan_forward_fused(model, pack_weights(model), batch, wv)
    out = {k: v.numpy() for k, v in out.items()}
    Bn = batch["word_ids"].shape[0]
    assert out["match_scores"].shape == (Bn, model.max_vlen, 4)
    for key in ("v_mask", "q_mask", "start_index", "end_index"):
        assert out[key].dtype == np.int32, key
    _assert_close(out, ref)
    np.testing.assert_array_equal(out["v_mask"], ref["v_mask"])
    np.testing.assert_array_equal(out["q_mask"], ref["q_mask"])


def test_fused_forward_matches_eager_model(case):
    model, batch, wv, _ = case
    with torch.no_grad():
        eager = {k: v.numpy() for k, v in model(batch, wv).items()}
        fused = {k: v.numpy() for k, v in seqpan_forward_fused(
            model, pack_weights(model), batch, wv).items()}
    _assert_close(fused, eager)


def test_padding_does_not_leak(case):
    """Each sample's outputs are its own: a sample alone gives what it gives
    inside the ragged batch (the wrapper takes any B, no padding)."""
    model, batch, wv, _ = case
    packed = pack_weights(model)
    with torch.no_grad():
        full = seqpan_forward_fused(model, packed, batch, wv)
        for i in (1, 2):
            one = seqpan_forward_fused(
                model, packed, {k: v[i:i + 1] for k, v in batch.items()}, wv)
            for key in ("start_logits", "end_logits", "match_scores"):
                torch.testing.assert_close(one[key][0], full[key][i],
                                           rtol=1e-5, atol=1e-6)


def test_pack_weights_uses_every_leaf_once(case):
    model = case[0]
    packed = pack_weights(model)
    leaves = {k[len("params/"):] for k in to_jax_params(model)}
    front = {k for k in leaves if k.split("/")[0] in FRONT_MODULES}
    assert len(front) == 18
    assert set(packed.layout) == leaves - front
    assert sorted(packed.layout) == sorted(pack_order(model.attn_layer))
    # contiguous, in pack order, no gap and no overlap
    offset = 0
    for key in pack_order(model.attn_layer):
        start, shape = packed.layout[key]
        assert start == offset, key
        offset += int(np.prod(shape))
    assert offset == packed.buffer.numel()
    assert packed.max_pos == model.max_vlen


def test_pack_weights_leaf_count_at_charades_width():
    model = SeqPAN(vdim=1024, dim=128, num_heads=8, attn_layer=2, max_vlen=64,
                   word_dim=300, char_dim=50, num_chars=60)
    assert len(to_jax_params(model)) == 170
    packed = pack_weights(model)
    assert len(packed.layout) == 152
    # the size fused_forward_weight_floats computes in the CUDA source
    D, L, P = 128, 2, 64
    conv = 4 * (2 * D + 7 * D + D * D + D)
    dual = 6 * D + 10 * (D * D + D) + 2 * (2 * D * D + D) + 2 * (D * D + D)
    fe = P * D + conv + 2 * D + 3 * (D * D + D) + 2 * D + (D * D + D)
    expected = (P * D + conv + L * dual + 2 * (3 * D + 4 * D * D)
                + (2 * D + 2 * D * D) + (4 * D + 4) + 4 * D + fe
                + 4 * D + 2 * (2 * D * D + D) + 2 * (D + 1))
    assert packed.buffer.numel() == expected



def _old_layout(jax_shape) -> tuple[int, ...]:
    """The pack's layout rule for every leaf but the position tables: the
    JAX shape with its unit axes dropped."""
    return tuple(s for s in jax_shape if s != 1) or (1,)


@pytest.mark.parametrize("max_vlen", [1, 2, 16])
def test_pack_layout_keeps_the_position_tables_2d(max_vlen):
    """Both position tables stay (max_vlen, D), so ``max_pos`` is max_vlen
    at 1 too; every other leaf keeps the layout it had, the f32 buffer
    holds each leaf's values in JAX order, and the bf16 companion's layout
    and ring schedule do not depend on the tables' shape.  At max_vlen >= 2
    every shape is what the old rule gave."""
    kw = dict(vdim=8, dim=32, num_heads=4, attn_layer=1, word_dim=8,
              char_dim=4, num_chars=10)
    model = SeqPAN(max_vlen=max_vlen, **kw,
                   generator=torch.Generator().manual_seed(3))
    packed = pack_weights(model)
    assert packed.max_pos == max_vlen
    jax = {k[len("params/"):]: v.shape for k, v in to_jax_params(model).items()}
    for key, (_, shape) in packed.layout.items():
        if key.endswith("pos_emb/position_embeddings"):
            assert shape == (max_vlen, 32), key
        else:
            assert shape == _old_layout(jax[key]), key
        if max_vlen >= 2:
            assert shape == _old_layout(jax[key]), key
        np.testing.assert_array_equal(
            packed(key).numpy().reshape(-1),
            np.asarray(to_jax_params(model)["params/" + key]).reshape(-1))
    # the companion and its ring schedule are those of a wider table
    wide = pack_weights(SeqPAN(max_vlen=16, **kw,
                               generator=torch.Generator().manual_seed(3)))
    assert packed.bf16_layout == wide.bf16_layout
    torch.testing.assert_close(packed.schedule, wide.schedule, rtol=0, atol=0)
    assert packed.bf16.shape == wide.bf16.shape
    # an in-place repack keeps the buffers' addresses
    ptrs = (packed.buffer.data_ptr(), packed.bf16.data_ptr())
    assert pack_weights(model, out=packed) is packed
    assert (packed.buffer.data_ptr(), packed.bf16.data_ptr()) == ptrs


def test_wrapper_refuses_longer_inputs_at_max_vlen_1():
    """At max_vlen 1 the guard passes T = W = 1 and refuses anything longer,
    as the JAX package's (1, D) table would."""
    model = SeqPAN(vdim=8, dim=16, num_heads=2, attn_layer=1, max_vlen=1,
                   word_dim=8, char_dim=4, num_chars=10)
    packed = pack_weights(model)
    kw = dict(attn_layer=1, num_heads=2, tau=0.3, use_gumbel=False)
    vf, qf, vm, qm = _k2_inputs(model)
    out = k2.fused_forward(packed, vf, qf, vm, qm, **kw)
    assert [tuple(o.shape) for o in out] == [(3, 1), (3, 1), (3, 1, 4)]
    two = torch.zeros((3, 2, 16))
    ones = torch.ones((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="positional table"):
        k2.fused_forward(packed, two, qf, ones, qm, **kw)
    with pytest.raises(ValueError, match="positional table"):
        k2.fused_forward(packed, vf, two, vm, ones, **kw)

def _k2_inputs(model, T=12, Wq=4, Bn=3, seed=0):
    D = model.dim
    T, Wq = min(T, model.max_vlen), min(Wq, model.max_vlen)
    rng = np.random.default_rng(seed)
    vf = torch.from_numpy(rng.normal(size=(Bn, T, D)).astype(np.float32))
    qf = torch.from_numpy(rng.normal(size=(Bn, Wq, D)).astype(np.float32))
    v_len = np.minimum(np.array([T, 1, 7]), T)
    vm = torch.from_numpy((np.arange(T)[None] < v_len[:, None]).astype(np.int32))
    qm = torch.ones((Bn, Wq), dtype=torch.int32)
    return vf, qf, vm, qm


def test_wrapper_cpu_route_is_the_plain_version_and_counts_nothing(case):
    model = case[0]
    packed = pack_weights(model)
    args = _k2_inputs(model)
    kw = dict(attn_layer=model.attn_layer, num_heads=model.num_heads,
              tau=0.3, use_gumbel=model.use_gumbel)
    before = k2.fused_forward.launches
    got = k2.fused_forward(packed, *args, **kw)
    plain = forward_math(packed, *args, **kw)
    for g, p in zip(got, plain):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    T = min(12, model.max_vlen)
    assert [tuple(g.shape) for g in got] == [(3, T), (3, T), (3, T, 4)]
    assert k2.fused_forward.launches == before      # no kernel ran


def test_wrapper_takes_an_empty_batch():
    model = SeqPAN(vdim=8, dim=16, num_heads=2, attn_layer=1, max_vlen=12,
                   word_dim=8, char_dim=4, num_chars=10)
    vf, qf, vm, qm = (t[:0] for t in _k2_inputs(model))
    out = k2.fused_forward(pack_weights(model), vf, qf, vm, qm, attn_layer=1,
                           num_heads=2, tau=0.3, use_gumbel=False)
    assert [tuple(o.shape) for o in out] == [(0, 12), (0, 12), (0, 12, 4)]


def test_wrapper_input_checks():
    model = SeqPAN(vdim=8, dim=16, num_heads=2, attn_layer=1, max_vlen=12,
                   word_dim=8, char_dim=4, num_chars=10)
    packed = pack_weights(model)
    vf, qf, vm, qm = _k2_inputs(model)
    kw = dict(attn_layer=1, num_heads=2, tau=0.3, use_gumbel=False)
    with pytest.raises(TypeError, match="vf must be"):
        k2.fused_forward(packed, vf.double(), qf, vm, qm, **kw)
    with pytest.raises(TypeError, match="v_mask must be"):
        k2.fused_forward(packed, vf, qf, vm.float(), qm, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_forward(packed, vf.transpose(0, 1).contiguous().transpose(0, 1),
                         qf, vm, qm, **kw)
    with pytest.raises(ValueError, match="masks"):
        k2.fused_forward(packed, vf, qf, vm[:, :5].contiguous(), qm, **kw)
    with pytest.raises(ValueError, match="qf has shape"):
        k2.fused_forward(packed, vf, qf[:2], vm, qm, **kw)
    with pytest.raises(ValueError, match="positional table"):
        big = torch.zeros((3, 13, 16))
        k2.fused_forward(packed, big, qf, torch.ones((3, 13), dtype=torch.int32),
                         qm, **kw)
    with pytest.raises(ValueError, match="packed for"):
        k2.fused_forward(packed, vf, qf, vm, qm, **dict(kw, attn_layer=2))
    with pytest.raises(ValueError, match="divisible"):
        k2.fused_forward(packed, vf, qf, vm, qm, **dict(kw, num_heads=3))
    meta = [t.to("meta") for t in (vf, qf, vm, qm)]
    with pytest.raises(ValueError, match="packed weights is on"):
        k2.fused_forward(packed, *meta, **kw)
    meta_packed = type(packed)(packed.buffer.to("meta"), packed.layout, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        k2.fused_forward(meta_packed, *meta, **kw)


@pytest.mark.parametrize("T,Wq,D,ok", [
    (64, 13, 128, True),     # Charades: the sweep's query length
    (64, 30, 128, True),     # Charades: the serve path's word bound
    (100, 30, 128, True),    # ActivityNet width
    (17, 5, 128, True),      # ragged in every tile dimension
    (1, 1, 16, True),
    (100, 100, 128, True),   # the old limit itself
    (101, 13, 128, True),    # past the old limit: T
    (64, 101, 128, True),    # W
    (0, 13, 128, False),
    (64, 0, 128, False),
    (64, 13, 256, True),     # D past 128
    (64, 13, 30, True),      # D not a multiple of 4 (6 heads of 5)
    (64, 13, 36, False),     # D not divisible by the 8 heads
])
def test_kernel_shape_limit(T, Wq, D, ok):
    """What the kernel refuses, as the Pallas kernel does: T or W below 1,
    D not divisible by the heads (8, or 6 at D=30).  Every other shape is
    taken, those past the limit it had until its stages tiled (T and W over
    100, D over 128 or not a multiple of 4) too; the wrapper has no limit
    constants left."""
    assert not hasattr(k2, "MAX_LEN") and not hasattr(k2, "MAX_DIM")
    H = 6 if D == 30 else 8
    if ok:
        k2.check_kernel_shape(T, Wq, D, H)
    else:
        with pytest.raises(ValueError, match=r"the kernel takes T|not divisible"):
            k2.check_kernel_shape(T, Wq, D, H)
