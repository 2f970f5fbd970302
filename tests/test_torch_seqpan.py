"""The port's SeqPAN deterministic forward vs the JAX package's, on bridged
weights, output key by output key, for ``span_decode`` xla and pallas (the
JAX Pallas kernel in interpret mode, the port's kernel wrapper on its CPU
path).

Tolerances: logits rtol 1e-4 / atol 2e-4 (the bound of
tests/test_fused_forward.py); q2v/v2q features, match scores and the match
loss absolute only: 1e-4, 1e-5 and 1e-5.  The two frameworks sum in
different orders, which is all these bounds absorb; indices are exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.serve import _flatten_params
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.decode import span_decode
from hual_tpu_torch.weights import load_jax_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

CASES = {
    # name: model widths, (B, W, C) of the batch
    "small_t16": (dict(vdim=32, dim=16, num_heads=2, attn_layer=2,
                       max_vlen=16, word_dim=24, char_dim=8, num_chars=30),
                  (5, 7, 6)),
    "small_t20": (dict(vdim=24, dim=16, num_heads=2, attn_layer=2,
                       max_vlen=20, word_dim=24, char_dim=12, num_chars=25),
                  (6, 9, 5)),
    "charades": (dict(vdim=1024, dim=128, num_heads=8, attn_layer=2,
                      max_vlen=64, word_dim=300, char_dim=50, num_chars=60),
                 (4, 12, 8)),
}


def _batch(kw: dict, bwc: tuple, seed: int) -> tuple[dict, np.ndarray]:
    B, W, C = bwc
    T = kw["max_vlen"]
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, T + 1, size=B).astype(np.int32)
    lens[0], lens[1] = T, 1                       # full and length-1 videos
    qlen = rng.integers(1, W + 1, size=(B, 1))
    qlen[0] = W
    word_ids = np.where(np.arange(W)[None] < qlen,
                        rng.integers(1, 40, (B, W)), 0).astype(np.int32)
    char_ids = rng.integers(0, kw["num_chars"], (B, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    feats = rng.normal(size=(B, T, kw["vdim"])).astype(np.float32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    batch = {"video_features": feats, "video_seq_len": lens,
             "word_ids": word_ids, "char_ids": char_ids}
    wv = rng.normal(size=(38, kw["word_dim"])).astype(np.float32)
    return batch, wv


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    kw, bwc = CASES[request.param]
    batch, wv = _batch(kw, bwc, seed=len(request.param))
    jkw = {k: v for k, v in kw.items() if k != "vdim"}
    outs, flat = {}, None
    for decode in ("xla", "pallas"):
        model = JaxSeqPAN(**jkw, span_decode=decode)
        if flat is None:
            params = jax.jit(lambda key, m=model: m.init(
                {"params": key}, batch, wv, 0.0, deterministic=True))(
                    jax.random.key(7))
            flat = _flatten_params(params)
        apply = jax.jit(lambda p, b, w, m=model: m.apply(
            p, b, w, 0.0, deterministic=True))
        outs[decode] = {k: np.array(v) for k, v in
                        apply(params, batch, wv).items()}
    return kw, batch, wv, flat, outs


@pytest.mark.parametrize("decode", ["xla", "pallas"])
def test_forward_matches_jax(case, decode):
    kw, batch, wv, flat, outs = case
    ref = outs[decode]
    model = load_jax_params(SeqPAN(**kw, span_decode=decode), flat).eval()
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    torch.from_numpy(wv))
    out = {k: v.numpy() for k, v in out.items()}
    assert set(out) == set(ref)
    for key in ("v_mask", "q_mask", "start_index", "end_index"):
        assert out[key].dtype == np.int32, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    for key in ("start_logits", "end_logits"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=2e-4,
                                   err_msg=key)
    for key in ("q2v_feats", "v2q_feats"):
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(out["match_scores"], ref["match_scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["match_loss"], ref["match_loss"],
                               rtol=0, atol=1e-5)
    for key in ref:
        assert out[key].shape == ref[key].shape, key


def test_port_decode_on_jax_logits_is_exact(case):
    """Decode parity not hidden behind logit noise: the port's decode on
    JAX's own logits gives JAX's indices."""
    _, batch, _, _, outs = case
    mask = torch.from_numpy(outs["xla"]["v_mask"])
    for decode in ("xla", "pallas"):
        ref = outs[decode]
        s, e = span_decode(torch.from_numpy(ref["start_logits"]),
                           torch.from_numpy(ref["end_logits"]), mask)
        np.testing.assert_array_equal(s.numpy(), ref["start_index"])
        np.testing.assert_array_equal(e.numpy(), ref["end_index"])


def test_padded_rows_are_finite_and_shared_weights_are_single(case):
    kw, batch, wv, flat, _ = case
    model = load_jax_params(SeqPAN(**kw), flat)
    # one instance per shared module: the leaf count equals JAX's
    assert len(list(model.parameters())) == len(flat)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    torch.from_numpy(wv))
    # the length-1 video and the padded query words stay finite
    for key in ("q2v_feats", "v2q_feats", "start_logits", "end_logits",
                "match_scores"):
        assert torch.isfinite(out[key]).all(), key
