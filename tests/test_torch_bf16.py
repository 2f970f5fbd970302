"""The bf16 path of the port against the JAX package's, on the CPU.

Three bf16 options share their numerics: K2's ``mxu_bf16`` products
(``train.fused_mxu_bf16``), the eager model at ``model.compute_dtype:
bfloat16`` and the stochastic MC passes at ``train.mc_dtype: bfloat16``.
The same seeded inputs and params go through ``hual_tpu`` (its fused
forward in interpret mode, its eager model, its train step) and the port.

bf16 rounding makes these outputs chaotic at the f32 level: on
``hual_tpu``'s own fused forward at D=128, 8 heads, 2 layers (T=16, B=5,
ragged), bf16 is 0.13 / 0.080 / 0.024 from f32 (start logits / end logits /
match scores, max|logit| 6.5-7.2), and a 1e-6 relative change of the video
features moves the bf16 output by 0.055 / 0.043 / 0.019 (f32: 2.1e-5 /
1.9e-5 / 3.2e-6).  Two right bf16 implementations that sum in other orders
differ by about half the bf16-vs-f32 gap, so no tight elementwise bound
holds and decoded indices may differ.  The bounds, for an output x of the
port's bf16 path:

* (B) band: |x - JAX f32| <= 0.05 + 0.03 * max|JAX f32| for logits (the
  bound of ``tests/test_true_mc.py:219-220``); for match scores <= 0.05
  through K2 (whose bf16 rounds product operands only) and <= 0.15 for the
  eager model at ``compute_dtype: bfloat16``, which rounds every activation:
  there the JAX package's own bf16 is up to 0.062 (D=128) and 0.092 (the
  gumbel head, whose 1/tau = 3.3 sharpens the logits) from its f32;
* (S) statistic: rms(x - JAX f32) / rms(JAX bf16 - JAX f32) in [0.5, 2]:
  the port rounds as much as the JAX package does, no more, no less;
* (R) really rounds: rms(x - port f32) > 100 * rms(port f32 - JAX f32).

Decoded indices are compared only as a printed share.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402

from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN  # noqa: E402
from hual_tpu.models.seqpan import seqpan_loss as jax_seqpan_loss  # noqa: E402
from hual_tpu.ops.pallas.fused_forward import (  # noqa: E402
    encoder_inputs as jax_encoder_inputs, fused_forward as jax_fused_forward)
from hual_tpu.runtime import steps as jsteps  # noqa: E402
from hual_tpu.serve import _flatten_params  # noqa: E402
import hual_tpu_torch.cli as cli  # noqa: E402
import hual_tpu_torch.orchestrate as orchestrate  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.models.seqpan import SeqPAN  # noqa: E402
from hual_tpu_torch.ops.fused_forward import (encoder_inputs,  # noqa: E402
                                              forward_math, pack_weights,
                                              seqpan_forward_fused)
from hual_tpu_torch.ops.kernels import fused_forward as k2  # noqa: E402
from hual_tpu_torch.ops.optim import make_optimizer  # noqa: E402
from hual_tpu_torch.runtime import debug, steps  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from hual_tpu_torch.serve import Predictor, export_model_bundle  # noqa: E402
from hual_tpu_torch.utils.io import load_pickle  # noqa: E402
from hual_tpu_torch.weights import _leaves, load_jax_params, to_jax_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

LOGGER = logging.getLogger("test_torch_bf16")
B, W, C, V = 5, 6, 5, 24
# the widths and batch of tests/test_torch_fused_forward.py
CASES = {
    "d32_h4_l1": (dict(dim=32, num_heads=4, attn_layer=1, max_vlen=16), False),
    "d32_h4_l1_gumbel": (dict(dim=32, num_heads=4, attn_layer=1, max_vlen=16), True),
    "d128_h8_l2": (dict(dim=128, num_heads=8, attn_layer=2, max_vlen=16), False),
}
TEXT = dict(word_dim=20, char_dim=8, num_chars=30)
OUTS = ("start_logits", "end_logits", "match_scores")


def _batch(T: int, seed: int) -> tuple[dict, np.ndarray]:
    rng = np.random.default_rng(seed)
    v_len = np.array([T, 1, 9, T, 5], np.int32)          # a length-1 video
    q_len = np.array([W, 3, 1, 4, W])                    # a one-word query
    word_ids = np.where(np.arange(W)[None] < q_len[:, None],
                        rng.integers(1, 15, (B, W)), 0).astype(np.int32)
    char_ids = rng.integers(0, 30, (B, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    feats = rng.normal(size=(B, T, V)).astype(np.float32)
    batch = {"video_features": feats, "video_seq_len": v_len,
             "word_ids": word_ids, "char_ids": char_ids}
    return batch, rng.normal(size=(13, TEXT["word_dim"])).astype(np.float32)


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def check_bf16(x: dict, jax32: dict, jax16: dict, port32: dict,
               ms_band: float = 0.05) -> dict:
    """(B), (S) and (R) of the docstring for each output; returns the
    measured statistics."""
    stats = {}
    for key in OUTS:
        xv, j32 = np.asarray(x[key]), np.asarray(jax32[key])
        assert xv.dtype == np.float32 and np.isfinite(xv).all(), key
        band = (ms_band if key == "match_scores"
                else 0.05 + 0.03 * float(np.abs(j32).max()))
        err = float(np.abs(xv - j32).max())
        ratio = _rms(xv - j32) / _rms(np.asarray(jax16[key]) - j32)
        floor = _rms(np.asarray(port32[key]) - j32)
        stats[key] = {"max_err": err, "band": band, "S": ratio,
                      "R": _rms(xv - np.asarray(port32[key])) / max(floor, 1e-30)}
        assert err <= band, (key, stats[key])                           # (B)
        assert 0.5 <= ratio <= 2.0, (key, stats[key])                   # (S)
        assert stats[key]["R"] > 100.0, (key, stats[key])               # (R)
    return stats


def _spans_share(a: dict, b: dict) -> float:
    return float(np.mean((np.asarray(a["start_index"]) == np.asarray(b["start_index"]))
                         & (np.asarray(a["end_index"]) == np.asarray(b["end_index"]))))


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")[1:]
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _jax_params(flat: dict) -> dict:
    """The JAX package's param tree from a flat params dict."""
    return {"params": jax.tree.map(jnp.asarray, _unflatten(flat))}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One case: hual_tpu's fused forward (interpret mode) and eager model
    in f32 and bf16, and the port's model, from the same params."""
    kw, gumbel = CASES[request.param]
    batch, wv = _batch(kw["max_vlen"], seed=len(request.param))
    jmodel = JaxSeqPAN(**kw, **TEXT, use_gumbel=gumbel, tau=0.3)
    # jitted: the same params as the eager init of the fused-forward tests
    params = jax.jit(lambda key: jmodel.init({"params": key}, batch, wv, 0.0,
                                             deterministic=True))(jax.random.key(0))
    model = load_jax_params(SeqPAN(vdim=V, **kw, **TEXT, use_gumbel=gumbel, tau=0.3),
                            _flatten_params(params)).eval()
    vf, qf, vm, qm = jax_encoder_inputs(jmodel, params, batch, wv)
    fused = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        out = jax_fused_forward(params, vf, qf, vm, qm, attn_layer=kw["attn_layer"],
                                num_heads=kw["num_heads"], tau=0.3,
                                use_gumbel=gumbel, block_b=4, mxu_bf16=bf16,
                                interpret=True)
        fused[name] = dict(zip(OUTS, (np.asarray(o) for o in out)))
    eager = {name: {k: np.asarray(v) for k, v in jax.jit(
                        lambda p, m=m: m.apply(p, batch, wv, 0.0, deterministic=True)
                    )(params).items()}
             for name, m in (("f32", jmodel),
                             ("bf16", jmodel.clone(compute_dtype="bfloat16")))}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return request.param, model, tbatch, torch.from_numpy(wv), fused, eager


def _numpy(out: dict) -> dict:
    return {k: v.numpy() for k, v in out.items()}


def test_k2_plain_bf16_matches_jax_kernel_bf16(case):
    """K2's plain version with ``mxu_bf16`` and the port's fused forward on
    its CPU route, against hual_tpu's K2 with ``mxu_bf16`` (interpret)."""
    name, model, batch, wv, fused, _ = case
    packed = pack_weights(model)
    with torch.no_grad():
        port32 = _numpy(seqpan_forward_fused(model, packed, batch, wv))
        port16 = _numpy(seqpan_forward_fused(model, packed, batch, wv, mxu_bf16=True))
        vf, qf, vm, qm = encoder_inputs(model, batch, wv)
        plain = dict(zip(OUTS, (o.numpy() for o in forward_math(
            packed, vf, qf, vm, qm, attn_layer=model.attn_layer,
            num_heads=model.num_heads, tau=model.tau, use_gumbel=model.use_gumbel,
            mxu_bf16=True))))
    for key in OUTS:
        np.testing.assert_array_equal(port16[key], plain[key], err_msg=key)
    stats = check_bf16(port16, fused["f32"], fused["bf16"], port32)
    print(name, stats, "equal spans with JAX bf16:",
          _spans_share(port16, _decode(fused["bf16"], port16["v_mask"])))


def _decode(out: dict, v_mask: np.ndarray) -> dict:
    """The plain span decode of JAX's logits under the port's mask."""
    from hual_tpu_torch.ops.decode import span_decode

    s, e = span_decode(*(torch.tensor(np.asarray(a)) for a in
                         (out["start_logits"], out["end_logits"], v_mask)))
    return {"start_index": s.numpy(), "end_index": e.numpy()}


def test_eager_model_bf16_matches_jax_clone(case):
    """The eager model at ``compute_dtype: bfloat16`` against
    ``JaxSeqPAN.clone(compute_dtype="bfloat16").apply``, deterministic."""
    name, model, batch, wv, _, eager = case
    with torch.no_grad():
        port32 = _numpy(model(batch, wv))
        port16 = _numpy(model.with_compute_dtype("bfloat16")(batch, wv))
    for key in ("q2v_feats", "v2q_feats"):
        assert port16[key].dtype == np.float32
    stats = check_bf16(port16, eager["f32"], eager["bf16"], port32, ms_band=0.15)
    print(name, stats, "equal spans with JAX bf16:", _spans_share(port16, eager["bf16"]))


def test_bf16_view_shares_the_parameters(case):
    model = case[1]
    view = model.with_compute_dtype("bfloat16")
    assert (model.compute_dtype, view.compute_dtype) == ("float32", "bfloat16")
    assert all(a is b for a, b in zip(model.parameters(), view.parameters()))
    assert list(model.state_dict()) == list(view.state_dict())
    with pytest.raises(ValueError, match="compute_dtype"):
        model.with_compute_dtype("float16")


def test_k2_wrapper_bf16_cpu_route_counts_nothing(case):
    model = case[1]
    packed = pack_weights(model)
    vf, qf, vm, qm = encoder_inputs(model, case[2], case[3])
    kw = dict(attn_layer=model.attn_layer, num_heads=model.num_heads, tau=0.3,
              use_gumbel=model.use_gumbel)
    before = (k2.fused_forward.launches, k2.fused_forward.launches_bf16)
    with torch.no_grad():
        got = k2.fused_forward(packed, vf, qf, vm, qm, **kw, mxu_bf16=True)
        plain = forward_math(packed, vf, qf, vm, qm, **kw, mxu_bf16=True)
        f32 = forward_math(packed, vf, qf, vm, qm, **kw)
    for g, p, f in zip(got, plain, f32):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, p, rtol=0, atol=0)
        assert not torch.equal(g, f)
    assert (k2.fused_forward.launches, k2.fused_forward.launches_bf16) == before


# -- a train step at compute_dtype bfloat16 -------------------------------------
T_STEP, W_STEP, C_STEP, V_STEP, N_STEP, LR = 16, 6, 4, 32, 11, 1e-3
# the JAX and port bf16 gradients' cosine, measured 0.9956 on this batch
# (JAX bf16 against JAX f32: 0.9989), less a margin of 0.0056 for other
# summation orders
GRAD_COSINE = 0.99


def _split(rng) -> dict:
    """The Charades-like split of tests/test_torch_train_step.py."""
    T, W_, C_, V_ = T_STEP, W_STEP, C_STEP, V_STEP
    v_len = rng.integers(2, T + 1, N_STEP).astype(np.int32)
    v_len[:2] = (1, T)
    s = rng.integers(0, v_len).astype(np.int32)
    e = np.minimum(s + rng.integers(0, 6, N_STEP), v_len - 1).astype(np.int32)
    q_len = rng.integers(1, W_ + 1, N_STEP)
    word_ids = np.where(np.arange(W_)[None] < q_len[:, None],
                        rng.integers(1, 10, (N_STEP, W_)), 0).astype(np.int32)
    char_ids = rng.integers(0, 20, (N_STEP, W_, C_)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    return {"features": rng.normal(size=(5, T, V_)).astype(np.float32),
            "feat_rows": rng.integers(0, 5, N_STEP).astype(np.int32),
            "v_len": v_len, "word_ids": word_ids, "char_ids": char_ids,
            "s_ind": s, "e_ind": e,
            "duration": rng.uniform(5, 30, N_STEP).astype(np.float32)}


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_train_step_bf16_matches_jax():
    """One train step at ``compute_dtype: bfloat16``, drop 0, against the
    JAX package's bf16 step (``span_decode: xla``, ``label_emb`` moved off
    its orthogonal init, as in tests/test_torch_train_step.py): the loss in
    the band (B), finite grads, and the flat gradient's cosine with JAX's at
    least GRAD_COSINE; the f32 port's cosine with JAX f32's is the control."""
    rng = np.random.default_rng(7)
    data = _split(rng)
    wv = rng.normal(size=(9, 12)).astype(np.float32)
    widths = dict(dim=32, num_heads=2, attn_layer=1, max_vlen=T_STEP,
                  word_dim=12, char_dim=4, num_chars=20)
    sel = np.array([3, 0, 1, 10, 7, 7, 5, 2], np.int32)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jbatch = jsteps.gather_batch(jdata, jnp.asarray(sel), with_labels=True)
    jmodel = JaxSeqPAN(**widths, span_decode="xla")
    flat = to_jax_params(SeqPAN(vdim=V_STEP, **widths,
                                generator=torch.Generator().manual_seed(1)))
    flat["params/label_emb"] = (flat["params/label_emb"] + 0.1 * rng.normal(
        size=flat["params/label_emb"].shape)).astype(np.float32)
    params = _jax_params(flat)
    batch = steps.gather_batch({k: torch.from_numpy(v) for k, v in data.items()},
                               torch.from_numpy(sel), with_labels=True)

    def jax_grads(model) -> tuple[dict, dict]:
        def loss_fn(p):
            out = model.apply(p, jbatch, wv, 0.0, jbatch["match_labels"],
                              deterministic=True)
            return jax_seqpan_loss(out, jbatch, 1.0)

        (_, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        return {k: float(v) for k, v in aux.items()}, _flatten_params(g)

    def port_grads(dtype: str) -> tuple[dict, dict]:
        model = load_jax_params(SeqPAN(vdim=V_STEP, **widths, span_decode="pallas",
                                       compute_dtype=dtype), flat)
        opt = make_optimizer(model, clip_norm=1.0, weight_decay=0.01)
        metrics = steps.train_step(model, opt, batch, torch.from_numpy(wv), LR,
                                   torch.Generator().manual_seed(0), drop_rate=0.0)
        to_jax = {key: move for key, _, _, move in _leaves(model)}
        # the clipped grads from the first moments (mu = 0.1 g); clipping
        # scales every leaf alike, so the cosine is that of the raw grads
        grads = {k: to_jax[k](mu.numpy()) / 0.1 for k, mu in zip(opt.keys, opt.mu)}
        return {k: float(v) for k, v in metrics.items() if k != "ious"}, grads

    def flat_vector(grads: dict) -> np.ndarray:
        return np.concatenate([np.asarray(grads[k], np.float64).ravel()
                               for k in sorted(flat)])

    jm32, jg32 = jax_grads(jmodel)
    jm16, jg16 = jax_grads(jmodel.clone(compute_dtype="bfloat16"))
    pm32, pg32 = port_grads("float32")
    pm16, pg16 = port_grads("bfloat16")
    for k in ("loc_loss", "match_loss", "align_loss", "loss"):
        band = 0.05 + 0.03 * abs(jm32[k])
        assert abs(pm16[k] - jm32[k]) <= band, (k, pm16[k], jm32[k], band)
    assert pm16["loss"] != pm32["loss"]                  # the step really rounds
    assert all(np.isfinite(g).all() for g in pg16.values())
    cos16 = _cosine(flat_vector(pg16), flat_vector(jg16))
    cos32 = _cosine(flat_vector(pg32), flat_vector(jg32))
    print(f"grad cosine bf16 port vs JAX {cos16:.6f}, f32 control {cos32:.8f}; "
          f"JAX bf16 vs JAX f32 {_cosine(flat_vector(jg16), flat_vector(jg32)):.6f}; "
          f"loss port bf16 {pm16['loss']:.5f}, JAX bf16 {jm16['loss']:.5f}, "
          f"JAX f32 {jm32['loss']:.5f}")
    assert cos16 >= GRAD_COSINE, cos16
    assert cos32 > 0.99999, cos32


# -- the Trainer and the server ---------------------------------------------------
def _config(root: str, **train) -> dict:
    return {
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "train": dict({"batch_size": 6, "eval_batch_size": 5,
                       "infer_batch_size": 7}, **train),
        "model": {"max_vlen": 8, "max_tlen": 8, "vdim": 16, "dim": 16,
                  "num_heads": 2, "word_dim": 300, "char_dim": 4,
                  "attn_layer": 1, "span_decode": "pallas"},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_bf16"))
    make_dataset(root, task="charades", n_train=23, n_test=12, vdim=16,
                 max_raw_len=12, seed=3)
    cfg = Config.from_dict(_config(root))
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    return root, dataset, store


def _trainer(world, **train) -> Trainer:
    root, dataset, store = world
    tr = Trainer(Config.from_dict(_config(root, **train)), dataset, store,
                 logger=LOGGER, device="cpu")
    tr.init_state(seed=5)
    return tr


@pytest.mark.parametrize("backend", ["flax", "fused"])
def test_mc_dtype_bf16_runs_the_stochastic_passes_only(world, backend, tmp_path):
    """``train.mc_dtype: bfloat16`` at ``mc_droprate`` 0.5, as
    tests/test_true_mc.py:166-212 checks it in the JAX package: the clean
    outputs are bit-identical to an all-f32 trainer's; the MC logits are
    f32, finite and differ between the two passes."""
    rows = {}
    for dtype in ("float32", "bfloat16"):
        tr = _trainer(world, sweep_backend=backend, mc_droprate=0.5, mc_dtype=dtype)
        assert (tr.mc_model is None) == (dtype == "float32")
        if tr.mc_model is not None:
            assert tr.mc_model.compute_dtype == "bfloat16"
            assert all(a is b for a, b in zip(tr.model.parameters(),
                                              tr.mc_model.parameters()))
        path = str(tmp_path / f"{dtype}.pkl")
        tr.infer_trainset(save_path=path)
        rows[dtype] = load_pickle(path)
    for f32, b16 in zip(rows["float32"], rows["bfloat16"]):
        assert f32["prop_idx"] == b16["prop_idx"]
        for a, b in zip(f32["prop_logits"], b16["prop_logits"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(f32["m_score"], b16["m_score"])
        for k in ("prop_logits1", "prop_logits2"):
            assert all(a.dtype == np.float32 and np.isfinite(a).all() for a in b16[k])
    b16 = rows["bfloat16"]
    assert any(not np.array_equal(r["prop_logits1"][0], r["prop_logits2"][0]) for r in b16)
    # the same generators at another dtype: other MC logits than f32's
    assert any(not np.array_equal(a["prop_logits1"][0], b["prop_logits1"][0])
               for a, b in zip(rows["float32"], b16))


def test_trainer_with_fused_mxu_bf16(world, tmp_path):
    """``train.fused_mxu_bf16: true`` on the CPU: K2's plain version with
    bf16 products in both fused sweeps; finite metrics and the f32 pickle's
    schema."""
    f32 = _trainer(world, sweep_backend="fused")
    b16 = _trainer(world, sweep_backend="fused", fused_mxu_bf16=True)
    metrics = b16.test()
    assert set(metrics) == set(f32.test())
    assert all(np.isfinite(v) for v in metrics.values())
    paths = {name: str(tmp_path / f"{name}.pkl") for name in ("f32", "bf16")}
    for name, tr in (("f32", f32), ("bf16", b16)):
        assert all(np.isfinite(v) for v in tr.infer_trainset(save_path=paths[name]).values())
    want, got = load_pickle(paths["f32"]), load_pickle(paths["bf16"])
    assert len(got) == len(want) == 23
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert type(g[key]) is type(w[key]), key
        for key in ("prop_logits", "prop_logits1", "prop_logits2"):
            assert all(a.dtype == b.dtype == np.float32 and a.shape == b.shape
                       for a, b in zip(g[key], w[key]))
    assert any(not np.array_equal(g["prop_logits"][0], w["prop_logits"][0])
               for g, w in zip(got, want))


def test_bf16_bundle_serves(world, tmp_path):
    """A bundle whose ``meta.json`` says ``compute_dtype: bfloat16`` loads
    and serves on the CPU; its logits are f32 and not the f32 bundle's."""
    tr = _trainer(world)
    root, dataset, store = world
    vocab = {"word_dict": dataset["word_dict"], "char_dict": dataset["char_dict"]}
    requests = [(np.abs(np.random.default_rng(i).normal(size=(5 + 3 * i, 16)))
                 .astype(np.float32), 20.0, "a person opens the door")
                for i in range(5)]
    served = {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config.from_dict(_config(root))
        cfg.model.compute_dtype = dtype
        cfg.model.num_chars, cfg.model.num_words = dataset["n_chars"], dataset["n_words"]
        path = export_model_bundle(tr.model, str(tmp_path / dtype), config=cfg,
                                   word_vectors=dataset["word_vector"],
                                   max_wlen=dataset["max_wlen"],
                                   max_clen=dataset["max_clen"], **vocab)
        pred = Predictor.from_bundle(path, batch_size=4, device="cpu")
        assert pred.model.compute_dtype == dtype
        results = pred.predict_batch(requests)
        for r in results:
            assert 0 <= r["start_index"] <= r["end_index"] < r["v_len"]
            assert 0.0 < r["score"] <= 1.0
        with torch.inference_mode():
            out = pred.model({k: torch.from_numpy(v) for k, v in
                              pred.encode_batch(requests[:4]).items()},
                             pred.word_vectors)
        assert out["start_logits"].dtype == torch.float32
        served[dtype] = out["start_logits"]
    assert not torch.equal(served["float32"], served["bfloat16"])


# -- deterministic mode ----------------------------------------------------------
def test_enable_deterministic_sets_both_switches():
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    code = ("import os, torch\n"
            "from hual_tpu_torch.runtime.debug import enable_deterministic\n"
            "assert not torch.are_deterministic_algorithms_enabled()\n"
            "enable_deterministic()\n"
            "print(os.environ['CUBLAS_WORKSPACE_CONFIG'],"
            " torch.are_deterministic_algorithms_enabled())\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True,
                         cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.stdout.split() == [":4096:8", "True"]


def test_enable_deterministic_refuses_after_cuda_started(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        debug.enable_deterministic()
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    # set before CUDA started: accepted, and kept as the caller set it
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    try:
        debug.enable_deterministic()
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    finally:
        torch.use_deterministic_algorithms(False)


class _Called(Exception):
    pass


def test_entry_points_take_the_deterministic_flag(monkeypatch):
    calls = []
    monkeypatch.setattr(cli, "enable_deterministic", lambda: calls.append("cli"))
    monkeypatch.setattr(orchestrate, "enable_deterministic",
                        lambda: calls.append("orchestrate"))

    def build(*a, **kw):
        raise _Called

    monkeypatch.setattr(cli, "build_trainer", build)
    monkeypatch.setattr(cli.Config, "load", classmethod(lambda cls, p: Config()))
    monkeypatch.setattr(orchestrate, "run_rounds", lambda *a, **kw: [])
    with pytest.raises(_Called):
        cli.main(["--config", "x.yaml", "--deterministic"])
    assert orchestrate.main(["charades", "--deterministic"]) == 0
    assert calls == ["cli", "orchestrate"]
    with pytest.raises(_Called):
        cli.main(["--config", "x.yaml"])
    assert orchestrate.main(["charades"]) == 0
    assert calls == ["cli", "orchestrate"]      # the default changes nothing
