"""The port's BERT-AdamW and gumbel ops against ``hual_tpu.ops``.

* The decay mask equals ``hual_tpu.ops.optim._decay_mask`` leaf by leaf over
  all 170 leaves of SeqPAN at Charades width (JAX's tree from
  ``jax.eval_shape``, so nothing is computed).
* ``BertAdamW`` against ``make_optimizer`` on identical grads over three
  steps with the lr changing and the clip both on and off: deltas within
  1e-7 abs.
* The clip against ``optax.clip_by_global_norm``: bit-equal below the
  threshold, within 1e-6 rel above it.
* The gumbel ops: shapes, and the moments of their noise against the
  Gumbel and logistic laws (within 5 standard errors); label smoothing
  against ``hual_tpu`` within 1e-7.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.ops import gumbel as jgumbel
from hual_tpu.ops.optim import _decay_mask
from hual_tpu.ops.optim import make_optimizer as jax_make_optimizer
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops import gumbel
from hual_tpu_torch.ops.optim import (clip_by_global_norm, count_params,
                                      decay_mask, make_optimizer)
from hual_tpu_torch.weights import _leaves, to_jax_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

CHARADES = dict(dim=128, num_heads=8, attn_layer=2, max_vlen=64, word_dim=300,
                char_dim=50, num_chars=60)
SMALL = dict(dim=16, num_heads=2, attn_layer=1, max_vlen=8, word_dim=12,
             char_dim=4, num_chars=20)


def _keyed(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def test_decay_mask_matches_jax_at_charades_width():
    rng = np.random.default_rng(0)
    batch = {"video_features": np.zeros((2, 64, 1024), np.float32),
             "video_seq_len": np.array([64, 9], np.int32),
             "word_ids": rng.integers(1, 10, (2, 5)).astype(np.int32),
             "char_ids": rng.integers(1, 60, (2, 5, 4)).astype(np.int32)}
    wv = np.zeros((10, 300), np.float32)
    shapes = jax.eval_shape(
        lambda: JaxSeqPAN(**CHARADES).init({"params": jax.random.key(0)}, batch,
                                           wv, 0.0, deterministic=True))
    want = _keyed(_decay_mask(shapes))
    model = SeqPAN(vdim=1024, **CHARADES)
    got = decay_mask(model)
    assert len(got) == len(want) == 170
    assert got == want
    assert 0 < sum(got.values()) < len(got)
    assert count_params(model) == sum(math.prod(s.shape)
                                      for s in _keyed(shapes).values())


def test_bert_adamw_matches_optax_on_identical_grads():
    model = SeqPAN(vdim=8, **SMALL, generator=torch.Generator().manual_seed(1))
    to_port = {key: move for key, _, move, _ in _leaves(model)}
    opt = make_optimizer(model, clip_norm=1.0, weight_decay=0.01)
    flat = to_jax_params(model)
    params = _nest(flat)
    tx = jax_make_optimizer(1.0, 0.01)
    state = tx.init(params)
    rng = np.random.default_rng(2)
    # global norms 5 (clipped), 0.3 (not) and 40 (clipped); one leaf near
    # zero, where the first step's 1/(sqrt(v)+eps) amplifies
    for lr, norm in ((1e-3, 5.0), (7e-4, 0.3), (2e-4, 40.0)):
        grads = {k: rng.normal(size=v.shape) for k, v in flat.items()}
        grads["params/label_emb"] *= 1e-7
        total = math.sqrt(sum(float(np.sum(g ** 2)) for g in grads.values()))
        grads = {k: (g * norm / total).astype(np.float32) for k, g in grads.items()}
        state.hyperparams["learning_rate"] = jnp.float32(lr)
        updates, state = tx.update(_nest(grads), state, params)
        want = _keyed(updates)
        before = to_jax_params(model)
        opt.step([torch.from_numpy(np.array(to_port[k](grads[k]))) for k in opt.keys],
                 lr)
        after = to_jax_params(model)
        params = optax.apply_updates(params, updates)
        for k in flat:
            np.testing.assert_allclose(after[k] - before[k], np.asarray(want[k]),
                                       rtol=0, atol=1e-7, err_msg=k)
        assert max(float(np.abs(v).max()) for v in want.values()) > 1e-5
    for k, v in _keyed(params).items():
        np.testing.assert_allclose(to_jax_params(model)[k], np.asarray(v),
                                   rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("norm", [0.25, 1.0, 7.5])
def test_clip_matches_optax(norm):
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    total = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    grads = [(g * norm / total).astype(np.float32) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got, g_norm = clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    assert abs(float(g_norm) - norm) < 1e-5 * norm
    for g, w, orig in zip(got, want, grads):
        if norm < 1.0:
            np.testing.assert_array_equal(g.numpy(), orig)      # untouched
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    clipped = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in got))
    assert abs(clipped - min(norm, 1.0)) < 1e-5


def test_gumbel_ops_shapes_and_noise_moments():
    n = 200_000
    g = torch.Generator().manual_seed(4)
    like = torch.zeros(())
    noise = gumbel.gumbel_sample(g, (n,), like).double()
    euler = 0.5772156649015329
    var = math.pi ** 2 / 6
    assert abs(noise.mean().item() - euler) < 5 * math.sqrt(var / n)
    # the sample variance's standard error: var * sqrt((kurtosis - 1) / n)
    assert abs(noise.var().item() - var) < 5 * var * math.sqrt(4.4 / n)

    # gumbel_sigmoid at logits 0, tau 1: sigmoid of logistic noise
    y = gumbel.gumbel_sigmoid(g, torch.zeros(n), tau=1.0).double()
    logistic = torch.log(y) - torch.log1p(-y)
    assert abs(logistic.mean().item()) < 5 * math.sqrt(math.pi ** 2 / 3 / n)
    assert abs(logistic.var().item() - math.pi ** 2 / 3) < (
        5 * math.pi ** 2 / 3 * math.sqrt(3.2 / n))

    logits = torch.randn(6, 4, generator=g)
    soft = gumbel.gumbel_softmax(g, logits, tau=0.5)
    assert soft.shape == logits.shape
    torch.testing.assert_close(soft.sum(-1), torch.ones(6))
    hard = gumbel.gumbel_softmax(g, logits.T.contiguous(), tau=0.5, hard=True)
    jhard = jgumbel.gumbel_softmax(jax.random.key(0), jnp.asarray(logits.T.numpy()),
                                   0.5, hard=True)
    assert hard.shape == jhard.shape
    assert set(hard.unique().tolist()) <= {0.0, 1.0}
    # the straight-through estimator, as the reference takes it: one max per
    # column of axis 1
    assert (hard.amax(dim=1) == 1.0).all()
    sig = gumbel.gumbel_sigmoid(g, logits, tau=0.3, hard=True)
    assert sig.shape == logits.shape

    labels = (np.random.default_rng(5).random((3, 7)) > 0.5).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([[7], [3], [5]])).astype(np.int32)
    want = np.asarray(jgumbel.label_smoothing(jnp.asarray(labels), jnp.asarray(mask)))
    got = gumbel.label_smoothing(torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
