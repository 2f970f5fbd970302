"""One train step of the port against ``hual_tpu``'s ``make_train_step``.

Same weights (through ``weights.py``), same batch gathered from the same
device-resident split, drop rate 0, at a Charades-like and an
ActivityNet-like small shape (longer videos, wider char embedding):

* loss components within rtol 1e-5;
* the clipped grads per leaf (read from the optimizers' first moments,
  ``mu / (1 - b1)``, both packages) within rtol 1e-3 and atol
  1e-6 * max(1, max|g|);
* parameter deltas within the golden harness's mixed bound, rtol 2e-2 /
  atol 1e-5 (``tests/test_golden_model.py``): BERT-AdamW's first step is
  ~lr*3.16*sign(g), so a grad that differs by 1e-9 near zero can move its
  delta by the whole step;
* IoUs and the decoded indices equal.  The port decodes under
  ``span_decode: pallas`` (K1's wrapper, its plain version on the CPU);
  the JAX step under ``xla``, since JAX cannot differentiate through the
  Pallas decode in interpret mode (the two decodes are bit-equal,
  ``tests/test_pallas.py``).

``label_emb`` is perturbed off its orthogonal init first: there the
penalty ``sqrt(sum((E E^T * (1-I))^2))`` is the norm of rounding noise, and
its gradient's direction is that noise, different in every framework.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hual_tpu.ops.optim import make_optimizer as jax_make_optimizer
from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.runtime import steps as jsteps
from hual_tpu.serve import _flatten_params
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.optim import make_optimizer
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.weights import _leaves, load_jax_params, to_jax_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

SHAPES = {
    "charades": dict(T=16, W=6, C=4, V=32, char_dim=4),
    "anet": dict(T=24, W=7, C=5, V=32, char_dim=8),
}
B, N, LR = 8, 11, 1e-3


def _split(rng, T, W, C, V):
    v_len = rng.integers(2, T + 1, N).astype(np.int32)
    v_len[:2] = (1, T)
    s = rng.integers(0, v_len).astype(np.int32)
    e = np.minimum(s + rng.integers(0, 6, N), v_len - 1).astype(np.int32)
    q_len = rng.integers(1, W + 1, N)
    word_ids = np.where(np.arange(W)[None] < q_len[:, None],
                        rng.integers(1, 10, (N, W)), 0).astype(np.int32)
    char_ids = rng.integers(0, 20, (N, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    return {"features": rng.normal(size=(5, T, V)).astype(np.float32),
            "feat_rows": rng.integers(0, 5, N).astype(np.int32),
            "v_len": v_len, "word_ids": word_ids, "char_ids": char_ids,
            "s_ind": s, "e_ind": e,
            "duration": rng.uniform(5, 30, N).astype(np.float32)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_train_step_matches_jax(shape):
    cfg = SHAPES[shape]
    rng = np.random.default_rng(7)
    data = _split(rng, cfg["T"], cfg["W"], cfg["C"], cfg["V"])
    wv = rng.normal(size=(9, 12)).astype(np.float32)
    widths = dict(dim=32, num_heads=2, attn_layer=1, max_vlen=cfg["T"],
                  word_dim=12, char_dim=cfg["char_dim"], num_chars=20)
    sel = np.array([3, 0, 1, 10, 7, 7, 5, 2], np.int32)

    jmodel = JaxSeqPAN(**widths, span_decode="xla")
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jbatch = jsteps.gather_batch(jdata, jnp.asarray(sel), with_labels=True)
    params = jmodel.init({"params": jax.random.key(1)}, jbatch, wv, 0.0,
                         deterministic=True)
    flat = _flatten_params(params)
    flat["params/label_emb"] = (flat["params/label_emb"] + 0.1 * rng.normal(
        size=flat["params/label_emb"].shape)).astype(np.float32)
    params = {"params": jax.tree.map(jnp.asarray, _unflatten(flat))}
    tx = jax_make_optimizer(1.0, 0.01)
    step = jax.jit(jsteps.make_train_step(jmodel, tx, 1.0, 0.0))
    jparams, jopt, jmetrics = step(params, tx.init(params), jbatch, wv,
                                   jnp.float32(LR), jax.random.key(5))
    jout = jmodel.apply(params, jbatch, wv, 0.0, deterministic=True)

    model = load_jax_params(SeqPAN(vdim=cfg["V"], **widths, span_decode="pallas"),
                            flat)
    opt = make_optimizer(model, clip_norm=1.0, weight_decay=0.01)
    batch = steps.gather_batch({k: torch.from_numpy(v) for k, v in data.items()},
                               torch.from_numpy(sel), with_labels=True)
    before = to_jax_params(model)
    with torch.no_grad():
        out = model(batch, torch.from_numpy(wv))
    metrics = steps.train_step(model, opt, batch, torch.from_numpy(wv), LR,
                               torch.Generator().manual_seed(0), drop_rate=0.0)

    for k in ("loc_loss", "match_loss", "align_loss", "loss"):
        assert metrics[k].item() == pytest.approx(float(jmetrics[k]), rel=1e-5), k
    np.testing.assert_array_equal(metrics["ious"].numpy(), np.asarray(jmetrics["ious"]))
    for k in ("start_index", "end_index"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))

    jmu = _flatten_params(jopt.inner_state[1].mu)
    to_jax = {key: move for key, _, _, move in _leaves(model)}
    for key, mu in zip(opt.keys, opt.mu):
        g, want = to_jax[key](mu.numpy()) / 0.1, np.asarray(jmu[key]) / 0.1
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-6 * scale,
                                   err_msg=key)
    after, jafter = to_jax_params(model), _flatten_params(jparams)
    for key in flat:
        np.testing.assert_allclose(after[key] - before[key],
                                   np.asarray(jafter[key]) - flat[key],
                                   rtol=2e-2, atol=1e-5, err_msg=key)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")[1:]
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree
