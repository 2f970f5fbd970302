"""The port's steps and sweeps against ``hual_tpu/runtime/steps.py``.

``device_ious`` and ``gather_batch`` (f32, bf16 and int8 tables) on the same
seeded data; then the eval and infer sweeps of both backends on one
device-resident split, against ``make_{eval,infer}_sweep_indexed`` and
``make_fused_{eval,infer}_sweep_indexed`` (the JAX package's Pallas kernels
in interpret mode).  The split has padded rows, a length-1 video, a one-word
query and a ragged final batch padded by repetition, as the trainer builds it.

Tolerances: IoUs atol 1e-6, logits rtol 1e-4 / atol 2e-4, match scores atol
1e-5, indices exact; gathers are exact.  The live MC passes (dropout at
mc 0.5, gumbel noise) are checked for what they must do here; their
distribution against the JAX package's is ``tests/test_torch_train.py``'s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hual_tpu.data.features import quantize_features
from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.runtime import steps as jsteps
from hual_tpu.serve import _flatten_params
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.masking import sequence_mask
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.weights import load_jax_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

N, T, W, C, V, BS = 10, 8, 5, 4, 16, 4
WIDTHS = dict(dim=32, num_heads=4, attn_layer=1, max_vlen=T, word_dim=12,
              char_dim=4, num_chars=20)


def _split(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n_videos = 7
    v_len = rng.integers(2, T + 1, N).astype(np.int32)
    v_len[1] = 1
    s = rng.integers(0, v_len).astype(np.int32)
    q_len = rng.integers(2, W + 1, N)
    q_len[2] = 1
    word_ids = np.where(np.arange(W)[None] < q_len[:, None],
                        rng.integers(1, 10, (N, W)), 0).astype(np.int32)
    char_ids = rng.integers(0, 20, (N, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    features = rng.normal(size=(n_videos, T, V)).astype(np.float32)
    return {"features": features,
            "feat_rows": rng.integers(0, n_videos, N).astype(np.int32),
            "v_len": v_len, "word_ids": word_ids, "char_ids": char_ids,
            "s_ind": s, "e_ind": np.minimum(s + 2, v_len - 1).astype(np.int32),
            "duration": rng.uniform(5, 30, N).astype(np.float32)}


def _sels() -> np.ndarray:
    # EvalLoader(pad_to_batch=True) order: the last batch repeats row N-1
    idx = np.arange(3 * BS)
    return np.minimum(idx, N - 1).astype(np.int32).reshape(3, BS)


def _to_torch(data: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in data.items()}


def test_device_ious_match():
    rng = np.random.default_rng(1)
    n = 64
    v_len = rng.integers(1, 65, n).astype(np.int32)
    idx = [rng.integers(0, v_len).astype(np.int32) for _ in range(4)]
    dur = rng.uniform(0, 40, n).astype(np.float32)
    dur[:2] = 0.0                                         # zero union
    ref = np.asarray(jsteps.device_ious(*(jnp.asarray(a) for a in (*idx, v_len, dur))))
    got = steps.device_ious(*(torch.from_numpy(a) for a in (*idx, v_len, dur)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert (got[:2] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gather_batch_matches(dtype):
    data = _split(2)
    jdata = dict(data)
    pdata = _to_torch(data)
    if dtype == "bfloat16":
        jdata["features"] = data["features"].astype(ml_dtypes.bfloat16)
        pdata["features"] = pdata["features"].to(torch.bfloat16)
    elif dtype == "int8":
        q, scales = quantize_features(data["features"])
        jdata["features"], jdata["feature_scales"] = q, scales
        pdata["features"] = torch.from_numpy(q)
        pdata["feature_scales"] = torch.from_numpy(scales)
    sel = np.array([4, 0, 9, 9], np.int32)
    ref = jsteps.gather_batch({k: jnp.asarray(v) for k, v in jdata.items()},
                              jnp.asarray(sel), with_labels=False)
    got = steps.gather_batch(pdata, torch.from_numpy(sel))
    assert set(got) == set(ref)
    assert got["video_features"].dtype == torch.float32
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.fixture(scope="module")
def sweeps():
    data = _split(0)
    wv = np.random.default_rng(3).normal(size=(9, 12)).astype(np.float32)
    jmodel = JaxSeqPAN(**WIDTHS)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    sels = _sels()
    batch0 = jsteps.gather_batch(jdata, jnp.asarray(sels[0]), False)
    params = jmodel.init({"params": jax.random.key(4)}, batch0, wv, 0.0,
                         deterministic=True)
    key = jax.random.key(0)
    jsels = jnp.asarray(sels)
    ref = {
        "flax": (jsteps.make_eval_sweep_indexed(jmodel)(params, jdata, jsels, wv),
                 jsteps.make_infer_sweep_indexed(jmodel)(params, jdata, jsels,
                                                         wv, key)),
        "fused": (jsteps.make_fused_eval_sweep_indexed(jmodel, block_b=4)(
                      params, jdata, jsels, wv),
                  jsteps.make_fused_infer_sweep_indexed(jmodel, block_b=4)(
                      params, jdata, jsels, wv, key)),
    }
    ref = {b: (np.asarray(e), {k: np.asarray(v) for k, v in i.items()})
           for b, (e, i) in ref.items()}
    model = load_jax_params(SeqPAN(vdim=V, **WIDTHS),
                            _flatten_params(params)).eval()
    return model, _to_torch(data), torch.from_numpy(sels), torch.from_numpy(wv), ref


@pytest.mark.parametrize("backend", ["flax", "fused"])
def test_eval_sweep_matches(sweeps, backend):
    model, data, sels, wv, ref = sweeps
    sweep = steps.eval_sweep if backend == "flax" else steps.fused_eval_sweep
    ious = sweep(model, steps.resident_batches(data, sels), wv)
    assert ious.shape == (sels.numel(),) and ious.dtype == torch.float32
    np.testing.assert_allclose(ious.numpy(), ref[backend][0].reshape(-1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["flax", "fused"])
def test_infer_sweep_matches(sweeps, backend):
    model, data, sels, wv, ref = sweeps
    sweep = steps.infer_sweep if backend == "flax" else steps.fused_infer_sweep
    out = {k: v.numpy() for k, v in
           sweep(model, steps.resident_batches(data, sels), wv).items()}
    # the sweep keeps (n_batches * B, ...) rows; JAX stacks (n_batches, B, ...)
    want = {k: v.reshape(-1, *v.shape[2:]) for k, v in ref[backend][1].items()}
    assert set(out) == set(want)
    for k in want:
        assert out[k].shape == want[k].shape, k
    for k in ("start_logits", "end_logits", "start_logits1", "end_logits1",
              "start_logits2", "end_logits2"):
        np.testing.assert_allclose(out[k], want[k], rtol=1e-4, atol=2e-4, err_msg=k)
    np.testing.assert_allclose(out["match_scores"], want["match_scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["ious"], want["ious"], rtol=0, atol=1e-6)
    for k in ("start_index", "end_index"):
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    # the MC reuse rule: both "stochastic" passes are the clean pass
    np.testing.assert_array_equal(out["start_logits1"], out["start_logits"])
    np.testing.assert_array_equal(out["end_logits2"], out["end_logits"])


def test_backends_agree(sweeps):
    model, data, sels, wv, _ = sweeps
    eager = steps.infer_sweep(model, steps.resident_batches(data, sels), wv)
    fused = steps.fused_infer_sweep(model, steps.resident_batches(data, sels), wv)
    for k in ("start_index", "end_index"):
        torch.testing.assert_close(fused[k], eager[k], rtol=0, atol=0)
    torch.testing.assert_close(fused["start_logits"], eager["start_logits"],
                               rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("sweep", ["infer_sweep", "fused_infer_sweep"])
def test_stochastic_passes_run(sweeps, sweep):
    """At mc_droprate 0.5 the two stochastic passes run live: they differ
    from the clean pass and from each other, replay from the same seed, and
    leave the clean pass as it was.  With the gumbel head on they run live
    at mc 0 too."""
    model, data, sels, wv, _ = sweeps
    sweep_fn = getattr(steps, sweep)

    def fn(model, data, sels, wv, **kw):
        return sweep_fn(model, steps.resident_batches(data, sels), wv, **kw)

    clean = fn(model, data, sels, wv)
    out = fn(model, data, sels, wv, mc_droprate=0.5, seed=3)
    for k in ("start_logits", "end_logits", "match_scores", "start_index",
              "end_index", "ious"):
        torch.testing.assert_close(out[k], clean[k], rtol=0, atol=0)
    valid = sequence_mask(data["v_len"][sels.reshape(-1)], T).bool()
    s0, s1, s2 = (out[k][valid] for k in ("start_logits", "start_logits1",
                                           "start_logits2"))
    assert (s1 != s0).float().mean() > 0.9 and (s1 != s2).float().mean() > 0.9
    assert torch.isfinite(s1).all() and torch.isfinite(out["end_logits2"]).all()
    again = fn(model, data, sels, wv, mc_droprate=0.5, seed=3)
    torch.testing.assert_close(again["end_logits2"], out["end_logits2"],
                               rtol=0, atol=0)
    other = fn(model, data, sels, wv, mc_droprate=0.5, seed=4)
    assert not torch.equal(other["start_logits1"], out["start_logits1"])

    gumbel = SeqPAN(vdim=V, **WIDTHS, use_gumbel=True)
    gumbel.load_state_dict(model.state_dict())
    g = fn(gumbel, data, sels, wv)
    assert not torch.equal(g["start_logits1"], g["start_logits"])
    assert not torch.equal(g["start_logits1"], g["start_logits2"])
