"""The port's graphed loops (``runtime/graphs.py``) on the CPU, where they
run their capture-safe programs eagerly (``Graphs(capture=False)``).

* The capture-safe train epoch (static ``sel``, ``opt.lr``, a reseeded
  generator) equals ``steps.train_epoch`` bit for bit over 5 replayed
  steps and a ragged eager one: params, moments, losses, IoUs.
* At drop 0 it equals ``hual_tpu``'s scanned epoch
  (``jax.jit(make_train_epoch_indexed(...))``, built as
  ``tests/test_epoch_scan.py`` builds it) within
  ``tests/test_torch_train_step.py``'s bounds: losses rtol 1e-5, parameter
  deltas rtol 2e-2 / atol 1e-5.  The JAX epoch decodes with ``xla`` (JAX
  cannot differentiate through the Pallas decode in interpret mode) and
  ``label_emb`` is moved off its orthogonal init, as there.
* The capture-safe sweeps equal ``make_eval_sweep_indexed``,
  ``make_infer_sweep_indexed`` (mc 0) and ``make_fused_eval_sweep_indexed``
  (the Pallas kernels in interpret mode) within ``tests/test_torch_steps.py``'s
  bounds: IoUs atol 1e-6, logits rtol 1e-4 / atol 2e-4, match scores atol
  1e-5, indices exact; and the eager sweeps of ``runtime/steps.py`` bit for
  bit at mc 0.5 (sequential, folded, through a bf16 ``mc_model``, fused).
* A reseeded generator draws what a fresh ``make_generator`` draws;
  ``pack_weights(out=)`` refreshes a pack in place; a new optimizer gets a
  new train program; ``StepGraph`` raises off the card; the CPU Trainer
  runs the eager loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.ops.optim import make_optimizer as jax_make_optimizer
from hual_tpu.runtime import steps as jsteps
from hual_tpu.serve import _flatten_params
from hual_tpu_torch.data.datasets import gen_or_load_dataset
from hual_tpu_torch.data.features import FeatureStore
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.fused_forward import pack_weights
from hual_tpu_torch.ops.optim import make_optimizer
from hual_tpu_torch.runtime import graphs, steps
from hual_tpu_torch.weights import load_jax_params, to_jax_params
from torch_train_helpers import (make_dataset, make_trainer,  # noqa: F401
                                 one_torch_thread, train_config)

N, T, W, C, V, B = 26, 8, 5, 4, 16, 4
WIDTHS = dict(dim=32, num_heads=4, attn_layer=1, max_vlen=T, word_dim=12,
              char_dim=4, num_chars=20)
LR = 1e-3


def _split(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n_videos = 9
    v_len = rng.integers(2, T + 1, N).astype(np.int32)
    v_len[1] = 1
    s = rng.integers(0, v_len).astype(np.int32)
    q_len = rng.integers(2, W + 1, N)
    q_len[2] = 1
    word_ids = np.where(np.arange(W)[None] < q_len[:, None],
                        rng.integers(1, 10, (N, W)), 0).astype(np.int32)
    char_ids = rng.integers(0, 20, (N, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    return {"features": rng.normal(size=(n_videos, T, V)).astype(np.float32),
            "feat_rows": rng.integers(0, n_videos, N).astype(np.int32),
            "v_len": v_len, "word_ids": word_ids, "char_ids": char_ids,
            "s_ind": s, "e_ind": np.minimum(s + 2, v_len - 1).astype(np.int32),
            "duration": rng.uniform(5, 30, N).astype(np.float32)}


def _to_torch(data: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in data.items()}


@pytest.fixture(scope="module")
def world():
    """The split, word vectors and ``hual_tpu``'s initial params (with
    ``label_emb`` moved off its orthogonal init), flat and as a tree."""
    data = _split(0)
    rng = np.random.default_rng(3)
    wv = rng.normal(size=(9, 12)).astype(np.float32)
    jmodel = JaxSeqPAN(**WIDTHS, span_decode="xla")
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    batch0 = jsteps.gather_batch(jdata, jnp.arange(B, dtype=jnp.int32), True)
    # one compiled init: op by op, the init takes most of this file's time
    init = jax.jit(lambda key: jmodel.init({"params": key}, batch0, wv, 0.0,
                                           batch0["match_labels"],
                                           deterministic=True))
    flat = _flatten_params(init(jax.random.key(4)))
    flat["params/label_emb"] = (flat["params/label_emb"] + 0.1 * rng.normal(
        size=flat["params/label_emb"].shape)).astype(np.float32)
    return data, wv, flat


def _model(flat: dict, **kw) -> SeqPAN:
    return load_jax_params(SeqPAN(vdim=V, **WIDTHS, span_decode="pallas", **kw),
                           flat)


def _order(n_steps: int, rest: int = 0, seed: int = 5) -> torch.Tensor:
    perm = np.random.default_rng(seed).permutation(N)[:n_steps * B + rest]
    return torch.from_numpy(perm.astype(np.int64))


def test_capture_safe_epoch_equals_eager_steps(world):
    data, wv, flat = world
    tdata, twv = _to_torch(data), torch.from_numpy(wv)
    order = _order(5, rest=3)
    runs = {}
    for name in ("eager", "graphs"):
        model = _model(flat)
        opt = make_optimizer(model, clip_norm=1.0, weight_decay=0.01)
        if name == "eager":
            losses, ious = steps.train_epoch(model, opt, tdata, order, B, twv, LR,
                                             29, 7, drop_rate=0.2)
        else:
            losses, ious = graphs.Graphs("cpu", capture=False).train_epoch(
                model, opt, tdata, order, B, twv, LR, 29, 7, drop_rate=0.2)
        runs[name] = (model.state_dict(), opt.mu, opt.nu, losses, ious)
    (pe, mue, nue, le, ie), (pg, mug, nug, lg, ig) = runs["eager"], runs["graphs"]
    assert le.shape == (6,) and ie.shape == (order.numel(),)
    assert torch.equal(le, lg) and torch.equal(ie, ig)
    assert all(torch.equal(pe[k], pg[k]) for k in pe)
    assert all(torch.equal(a, b) for a, b in zip(mue + nue, mug + nug))
    # the step moved the params: the comparison is not of two untouched models
    assert not torch.equal(pe["label_emb"], _model(flat).label_emb)


def test_capture_safe_epoch_matches_jax_scan(world):
    data, wv, flat = world
    n_steps = 3
    sels = _order(n_steps).numpy().astype(np.int32).reshape(n_steps, B)
    jmodel = JaxSeqPAN(**WIDTHS, span_decode="xla")
    tx = jax_make_optimizer(1.0, 0.01)
    params = {"params": jax.tree.map(jnp.asarray, _unflatten(flat))}
    epoch = jax.jit(jsteps.make_train_epoch_indexed(jmodel, tx, 1.0, 0.0))
    jparams, _, jlosses, _ = epoch(params, tx.init(params),
                                   {k: jnp.asarray(v) for k, v in data.items()},
                                   jnp.asarray(sels), wv, jnp.float32(LR),
                                   jax.random.key(7), jnp.int32(0))

    model = _model(flat)
    opt = make_optimizer(model, clip_norm=1.0, weight_decay=0.01)
    losses, _ = graphs.Graphs("cpu", capture=False).train_epoch(
        model, opt, _to_torch(data), torch.from_numpy(sels.reshape(-1)), B,
        torch.from_numpy(wv), LR, 7, 0, drop_rate=0.0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    after, jafter = to_jax_params(model), _flatten_params(jparams)
    for key in flat:
        np.testing.assert_allclose(after[key] - flat[key],
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


def _sweep_sels() -> tuple[np.ndarray, list[int]]:
    # EvalLoader(pad_to_batch=True) order: the last batch repeats row N-1
    n_batches = -(-N // B)
    sels = np.minimum(np.arange(n_batches * B), N - 1).astype(np.int32)
    n_valid = [B] * (n_batches - 1) + [N - (n_batches - 1) * B]
    return sels.reshape(n_batches, B), n_valid


@pytest.mark.parametrize("sweep", ["eval", "infer", "fused_eval"])
def test_capture_safe_sweeps_match_jax(world, sweep):
    data, wv, flat = world
    jmodel = JaxSeqPAN(**WIDTHS)
    params = {"params": jax.tree.map(jnp.asarray, _unflatten(flat))}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    sels, n_valid = _sweep_sels()
    g = graphs.Graphs("cpu", capture=False)
    model = _model(flat).eval()
    args = (model, _to_torch(data), torch.from_numpy(sels), n_valid,
            torch.from_numpy(wv))
    if sweep == "eval":
        ref = {"ious": jsteps.make_eval_sweep_indexed(jmodel)(params, jdata, sels, wv)}
        out = {"ious": g.eval_sweep(*args)}
    elif sweep == "fused_eval":
        ref = {"ious": jsteps.make_fused_eval_sweep_indexed(jmodel, block_b=4)(
            params, jdata, sels, wv)}
        out = {"ious": g.fused_eval_sweep(*args)}
    else:
        ref = jsteps.make_infer_sweep_indexed(jmodel)(params, jdata, sels, wv,
                                                      jax.random.key(0))
        out = g.infer_sweep(*args)
    # the sweep keeps the valid rows; JAX stacks (n_batches, B, ...)
    want = {k: np.asarray(v).reshape(-1, *np.asarray(v).shape[2:])[:N]
            for k, v in ref.items()}
    assert set(out) == set(want)
    for k, v in out.items():
        assert v.shape == want[k].shape, k
        if k == "ious":
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6)
        elif k == "match_scores":
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5)
        elif k.endswith("_index"):
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=2e-4,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["sequential", "fold_mc", "mc_bf16", "fused"])
def test_capture_safe_mc_sweeps_equal_eager(world, mode):
    data, wv, flat = world
    model = _model(flat).eval()
    mc_model = model.with_compute_dtype("bfloat16") if mode == "mc_bf16" else None
    sels, n_valid = _sweep_sels()
    tdata, tsels, twv = _to_torch(data), torch.from_numpy(sels), torch.from_numpy(wv)
    kw = dict(mc_droprate=0.5, seed=11, mc_model=mc_model)
    batches = steps.resident_batches(tdata, tsels, n_valid)
    g = graphs.Graphs("cpu", capture=False)
    if mode == "fused":
        want = steps.fused_infer_sweep(model, batches, twv, **kw)
        got = g.fused_infer_sweep(model, tdata, tsels, n_valid, twv, **kw)
    else:
        fold = mode == "fold_mc"
        want = steps.infer_sweep(model, batches, twv, fold_mc=fold, **kw)
        got = g.infer_sweep(model, tdata, tsels, n_valid, twv, fold_mc=fold, **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["start_logits1"], got["start_logits2"])   # live


def test_reseeded_generator_draws_as_fresh():
    g = torch.Generator()
    torch.rand(17, generator=g)                          # a used generator
    for words in ((29, 0), (29, 41), (3, 7, 1)):
        g.manual_seed(steps.stream_seed(*words))
        fresh = steps.make_generator(torch.device("cpu"), *words)
        assert torch.equal(torch.rand(64, generator=g),
                           torch.rand(64, generator=fresh))


def test_pack_weights_out_refreshes_in_place(world):
    model = _model(world[2])
    packed = pack_weights(model)
    address, before = packed.buffer.data_ptr(), packed.buffer.clone()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    assert pack_weights(model, out=packed) is packed
    assert packed.buffer.data_ptr() == address
    assert not torch.equal(packed.buffer, before)
    assert torch.equal(packed.buffer, pack_weights(model).buffer)
    other = SeqPAN(vdim=V, **dict(WIDTHS, attn_layer=2))
    with pytest.raises(ValueError, match="another model"):
        pack_weights(other, out=packed)


def test_new_optimizer_and_weights_reach_the_programs(world):
    """A new optimizer (``Trainer.init_state`` / ``load_params``) gets a new
    train program; a fused sweep after training packs the new weights."""
    data, wv, flat = world
    tdata, twv = _to_torch(data), torch.from_numpy(wv)
    model = _model(flat)
    g = graphs.Graphs("cpu", capture=False)
    sels, n_valid = _sweep_sels()
    tsels = torch.from_numpy(sels)
    g.fused_eval_sweep(model, tdata, tsels, n_valid, twv)
    first = make_optimizer(model)
    g.train_epoch(model, first, tdata, _order(2), B, twv, LR, 1, 0, drop_rate=0.1)
    kept = [m.clone() for m in first.mu]
    second = make_optimizer(model)
    g.train_epoch(model, second, tdata, _order(2), B, twv, LR, 1, 2, drop_rate=0.1)
    assert all(torch.equal(a, b) for a, b in zip(first.mu, kept))
    assert any(m.abs().sum() > 0 for m in second.mu)
    assert len([k for k in g._programs if k[0] == "train_step"]) == 1
    want = steps.fused_eval_sweep(model, steps.resident_batches(tdata, tsels, n_valid),
                                  twv)
    assert torch.equal(g.fused_eval_sweep(model, tdata, tsels, n_valid, twv), want)


def test_step_graph_needs_the_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepGraph(lambda: {}, "cpu")


def test_cpu_trainer_runs_the_eager_loops(tmp_path, monkeypatch):
    calls = []
    for name in ("train_epoch", "fused_eval_sweep", "fused_infer_sweep"):
        def counted(*args, _real=getattr(steps, name), _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(steps, name, counted)
    root = str(tmp_path)
    make_dataset(root, task="charades", n_train=20, n_test=8, vdim=32,
                 max_raw_len=24, seed=7)
    cfg = train_config(root, str(tmp_path / "ckpt"))
    world = (root, gen_or_load_dataset(cfg),
             FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen))
    tr = make_trainer(world, str(tmp_path / "ckpt"), epochs=1)
    assert tr._graphs is None
    monkeypatch.chdir(tmp_path)
    tr.train()
    tr.infer_trainset(save_path=str(tmp_path / "infer.pkl"))
    assert tr.state.step == 3
    assert calls == ["train_epoch", "fused_eval_sweep", "fused_infer_sweep"]
