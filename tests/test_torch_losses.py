"""The port's losses, device labels and dropout against ``hual_tpu``.

* ``localizing_loss`` and ``alignment_loss`` (both reference quirks kept)
  on the same arrays as ``hual_tpu.models.layers``: rtol 1e-5.
* The match loss with the label-embedding orthogonality penalty, and
  ``seqpan_loss``'s components, from the deterministic forward of both
  packages on the same weights and batch: rtol 1e-5.
* Device labels against ``labels_jax.make_span_labels_jax`` and the host
  ``make_span_labels``: match/inner exact, y1/y2 within 1e-7 (bit-equal to
  the JAX package's f32 path).
* Dropout: rate-0 rows bit-equal to the deterministic pass, the keep share
  within 4 sigma of 1-p, per-sample rate vectors, the 1/(1-p) scale, and
  no draw without a generator.
* ``runtime/debug.plot_se_label`` plots labels straight from tensors.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hual_tpu.data.labels import make_span_labels
from hual_tpu.data.labels_jax import make_span_labels_jax
from hual_tpu.models import layers as jlayers
from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.models.seqpan import seqpan_loss as jax_seqpan_loss
from hual_tpu.serve import _flatten_params
from hual_tpu_torch.data.labels_device import make_span_labels_device
from hual_tpu_torch.models import layers
from hual_tpu_torch.models.seqpan import SeqPAN, seqpan_loss
from hual_tpu_torch.weights import load_jax_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

B, T, W, C, V = 6, 12, 5, 4, 16
WIDTHS = dict(dim=16, num_heads=2, attn_layer=1, max_vlen=T, word_dim=10,
              char_dim=4, num_chars=20)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _spans(rng, n, max_len):
    v_len = rng.integers(1, max_len + 1, n).astype(np.int32)
    v_len[:3] = (1, min(2, max_len), max_len)
    s = rng.integers(0, v_len).astype(np.int32)
    e = np.minimum(s + rng.integers(0, 7, n), v_len - 1).astype(np.int32)
    s[2], e[2] = 0, max_len - 1                     # the whole video
    return s, e, v_len


def test_localizing_and_alignment_losses_match():
    rng = np.random.default_rng(0)
    s, e, v_len = _spans(rng, B, T)
    y1, y2, _, inner = make_span_labels(s, e, v_len, T)
    mask = (np.arange(T)[None] < v_len[:, None]).astype(np.int32)
    sl, el = (rng.normal(size=(B, T)).astype(np.float32) for _ in range(2))
    want = float(jlayers.localizing_loss(sl, el, y1, y2, mask))
    got = layers.localizing_loss(_t(sl), _t(el), _t(y1), _t(y2), _t(mask)).item()
    assert got == pytest.approx(want, rel=1e-5)

    tmask = (np.arange(W)[None] < rng.integers(1, W + 1, (B, 1))).astype(np.int32)
    tfeat = rng.normal(size=(B, W, 8)).astype(np.float32)   # padded rows too
    vfeat = rng.normal(size=(B, T, 8)).astype(np.float32)
    inner = inner.astype(np.float32)
    want = float(jlayers.alignment_loss(tfeat, vfeat, tmask, mask, inner))
    got = layers.alignment_loss(_t(tfeat), _t(vfeat), _t(tmask), _t(mask),
                                _t(inner)).item()
    assert got == pytest.approx(want, rel=1e-5)
    # the quirks: padded query rows count in the sum; the KL takes
    # probabilities as log-probabilities
    t2 = tfeat.copy()
    t2[tmask == 0] += 1.0
    assert layers.alignment_loss(_t(t2), _t(vfeat), _t(tmask), _t(mask),
                                 _t(inner)).item() != pytest.approx(got)
    p = torch.softmax(torch.randn(3, 4), -1)
    kl = layers._kl_for_log_probs(torch.log(p), p)
    np.testing.assert_allclose(kl.numpy(), np.asarray(jlayers._kl_for_log_probs(
        jnp.log(jnp.asarray(p.numpy())), jnp.asarray(p.numpy()))), rtol=1e-6)


def test_match_loss_and_seqpan_loss_match():
    rng = np.random.default_rng(1)
    s, e, v_len = _spans(rng, B, T)
    q_len = rng.integers(1, W + 1, B)
    word_ids = np.where(np.arange(W)[None] < q_len[:, None],
                        rng.integers(1, 9, (B, W)), 0).astype(np.int32)
    char_ids = rng.integers(0, 20, (B, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    batch = {"video_features": rng.normal(size=(B, T, V)).astype(np.float32),
             "video_seq_len": v_len, "word_ids": word_ids, "char_ids": char_ids}
    y1, y2, match, inner = make_span_labels(s, e, v_len, T)
    batch.update(y1=y1, y2=y2, match_labels=match, inner_labels=inner.astype(np.float32))
    wv = rng.normal(size=(7, 10)).astype(np.float32)

    jmodel = JaxSeqPAN(**WIDTHS)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init({"params": jax.random.key(2)}, jbatch, wv, 0.0,
                         deterministic=True)
    jout = jmodel.apply(params, jbatch, wv, 0.0, jbatch["match_labels"],
                        deterministic=True)
    _, jaux = jax_seqpan_loss(jout, jbatch)

    model = load_jax_params(SeqPAN(vdim=V, **WIDTHS), _flatten_params(params))
    pbatch = {k: _t(v) for k, v in batch.items()}
    out = model(pbatch, _t(wv), pbatch["match_labels"])
    _, aux = seqpan_loss(out, pbatch)
    assert set(aux) == set(jaux)
    for k in jaux:
        assert aux[k].item() == pytest.approx(float(jaux[k]), rel=1e-5), k
    # the match loss is the head's masked CE plus the orthogonality penalty
    eye = torch.eye(4)
    ortho = (model.label_emb @ model.label_emb.T * (1 - eye)).square().sum().sqrt()
    head = model.matching_head
    ce, _ = head(_fuse(model, pbatch, wv), pbatch["match_labels"], out["v_mask"])
    assert (ce + ortho).item() == pytest.approx(aux["match_loss"].item(), rel=1e-6)


def _fuse(model, batch, wv):
    feats = {}
    hook = model.cq_cat.register_forward_hook(lambda m, i, o: feats.setdefault("x", o))
    try:
        model(batch, _t(wv))
    finally:
        hook.remove()
    return feats["x"]


def test_device_labels_match():
    rng = np.random.default_rng(2)
    for max_len in (1, 8, 64, 100):
        s, e, v_len = _spans(rng, 40, max_len)
        want = make_span_labels_jax(jnp.asarray(s), jnp.asarray(e),
                                    jnp.asarray(v_len), max_len)
        host = make_span_labels(s, e, v_len, max_len)
        got = make_span_labels_device(_t(s), _t(e), _t(v_len), max_len)
        assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                          torch.int32, torch.float32]
        for i in (0, 1):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
            np.testing.assert_allclose(got[i].numpy(), host[i], rtol=0, atol=1e-7)
        for i in (2, 3):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
            np.testing.assert_array_equal(got[i].numpy(), host[i])


def test_dropout_rates_and_streams():
    x = torch.randn(8, 50, 40)
    assert layers.dropout(x, 0.5, None) is x                 # deterministic
    g = torch.Generator().manual_seed(0)
    assert layers.dropout(x, 0.0, g) is x                    # rate 0: no draw
    state = g.get_state()
    p = 0.3
    y = layers.dropout(x, p, g)
    assert not torch.equal(g.get_state(), state)
    kept = y != 0
    n = x.numel()
    share = kept.double().mean().item()
    assert abs(share - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(y[kept], x[kept] * (1 / (1 - p)), rtol=0, atol=0)
    # same generator state, same mask
    g.set_state(state)
    torch.testing.assert_close(layers.dropout(x, p, g), y, rtol=0, atol=0)

    # per-sample rates: rate-0 rows are the deterministic pass bit for bit
    rates = torch.tensor([0.0, 0.5, 0.0, 0.9, 0.2, 0.0, 0.5, 0.0])
    y = layers.dropout(x, rates, torch.Generator().manual_seed(1))
    for i, r in enumerate(rates.tolist()):
        if r == 0.0:
            assert torch.equal(y[i], x[i])
        else:
            share = (y[i] != 0).double().mean().item()
            m = x[i].numel()
            assert abs(share - (1 - r)) < 4 * np.sqrt(r * (1 - r) / m), (i, share)
            torch.testing.assert_close(y[i][y[i] != 0], x[i][y[i] != 0] / (1 - r))
    # gradients flow through kept elements only, scaled
    xr = x.clone().requires_grad_(True)
    out = layers.dropout(xr, 0.5, torch.Generator().manual_seed(2))
    out.sum().backward()
    torch.testing.assert_close(xr.grad, (out != 0).float() * 2.0)


def test_module_mode_changes_nothing():
    rng = np.random.default_rng(3)
    model = SeqPAN(vdim=V, **WIDTHS, generator=torch.Generator().manual_seed(0))
    s, e, v_len = _spans(rng, B, T)
    batch = {"video_features": _t(rng.normal(size=(B, T, V)).astype(np.float32)),
             "video_seq_len": _t(v_len),
             "word_ids": _t(rng.integers(1, 9, (B, W)).astype(np.int32)),
             "char_ids": _t(rng.integers(1, 20, (B, W, C)).astype(np.int32))}
    wv = torch.randn(7, 10)
    with torch.no_grad():
        a = model.train()(batch, wv)["start_logits"]
        b = model.eval()(batch, wv)["start_logits"]
        c = model(batch, wv, drop_rate=0.0, generator=torch.Generator())["start_logits"]
        d = model(batch, wv, drop_rate=0.4,
                  generator=torch.Generator().manual_seed(5))["start_logits"]
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, d)


def test_plot_se_label_takes_device_labels(tmp_path):
    from hual_tpu.runtime.debug import plot_se_label as jax_plot
    from hual_tpu_torch.runtime.debug import plot_se_label

    s, e, v_len = _spans(np.random.default_rng(4), 3, T)
    y1, y2, match, _ = make_span_labels_device(_t(s), _t(e), _t(v_len), T)
    paths = plot_se_label(y1, y2, match, out_dir=str(tmp_path / "port"))
    want = jax_plot(y1.numpy(), y2.numpy(), match.numpy(),
                    out_dir=str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in want]
    assert all(os.path.getsize(p) > 0 for p in paths)
