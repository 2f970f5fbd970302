"""Data parallelism in the port (``hual_tpu_torch/parallel``), the cases of
``tests/test_sharding.py``, on the CPU with gloo at world size 2.

One spawn of two ranks per layout, each in a module-scoped fixture that
returns every result: ``(data=2, model=1)`` for the batch-sharded cases and
``(data=1, model=2)`` for the model axis.  The world-1 references run in
this process without a process group (the unsharded path), and once on a
one-rank gloo group (the sharded path at world 1, which must give the same
bits).  The step against ``hual_tpu``'s 8-device step is in
``test_torch_parallel_jax.py``, the Trainer's cases in
``test_torch_parallel_trainer.py`` and the launched entry points in
``test_torch_parallel_cli.py``; they share this file's helpers.  Bounds are ``tests/test_sharding.py``'s: loss rtol 1e-5, params
rtol 2e-4 / atol 2e-6; IoUs and decoded spans equal.

The step's split and widths are ``test_sharding.py``'s (B=16, T=8, D=16,
one dual-attention layer); ``label_emb`` is moved off its orthogonal init,
where the penalty's gradient is rounding noise
(``tests/test_torch_train_step.py``).  The ranks run one intra-op thread
each: six xdist workers share the cores.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hual_tpu_torch.data.features import quantize_features
from hual_tpu_torch.models import layers
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.optim import make_optimizer
from hual_tpu_torch.parallel import Mesh, RowShard, make_mesh, sum_over
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.weights import load_jax_params, to_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (a fixture, re-exported)

B, T, W, C, V, N, ROWS = 16, 8, 6, 4, 16, 20, 13
WIDTHS = dict(vdim=V, dim=16, num_heads=2, attn_layer=1, max_vlen=T, word_dim=32,
              char_dim=4, num_chars=10)
LR = 1e-3
SEL = np.random.default_rng(9).permutation(N)[:B].astype(np.int32)
RAGGED = np.concatenate([SEL, [3, 17, 11]]).astype(np.int32)   # 16 + 3 rows


# -- the split, the model, the step --------------------------------------------
def split() -> dict:
    """A device-resident split of N samples over a table of ROWS videos (an
    odd count, so the sharded table is padded)."""
    rng = np.random.default_rng(0)
    v_len = rng.integers(2, T + 1, N).astype(np.int32)
    s = (rng.uniform(0, 0.5, N) * v_len).astype(np.int32)
    e = np.minimum(s + rng.integers(0, 4, N), v_len - 1).astype(np.int32)
    word_ids = np.concatenate([rng.integers(1, 20, (N, 4)), np.zeros((N, W - 4))],
                              axis=1).astype(np.int32)
    return {"features": rng.normal(size=(ROWS, T, V)).astype(np.float32),
            "feat_rows": rng.integers(0, ROWS, N).astype(np.int32),
            "v_len": v_len, "word_ids": word_ids,
            "char_ids": rng.integers(0, 10, (N, W, C)).astype(np.int32),
            "s_ind": s, "e_ind": np.maximum(e, s),
            "duration": rng.uniform(10, 30, N).astype(np.float32)}


def word_vectors() -> np.ndarray:
    return np.random.default_rng(1).normal(size=(25, 32)).astype(np.float32)


def device_split(mesh, table: str = "sharded") -> dict:
    """The split as tensors: the table whole (``"replicated"``) or this
    rank's RowShard (``"sharded"``), in f32, bf16 or int8 (``"bf16"``,
    ``"int8"``, both sharded)."""
    data = split()
    feats = data.pop("features")
    out = {k: torch.from_numpy(v) for k, v in data.items()}

    def put(arr):
        if mesh is None or table == "replicated":
            return torch.from_numpy(arr)
        return mesh.shard_rows(arr)

    if table == "int8":
        q, scales = quantize_features(feats)
        out["features"], out["feature_scales"] = put(q), put(scales)
    elif table == "bf16":
        t = put(feats)
        out["features"] = (t.to(torch.bfloat16) if isinstance(t, torch.Tensor)
                           else RowShard(t.local.to(torch.bfloat16), t.lo, t.total,
                                         t.group))
    else:
        out["features"] = put(feats)
    return out


def model_of(flat=None, gumbel: bool = False) -> SeqPAN:
    model = SeqPAN(**WIDTHS, use_gumbel=gumbel, span_decode="pallas")
    if flat is not None:
        return load_jax_params(model, flat)
    model.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.label_emb.add_(0.1 * torch.randn(model.label_emb.shape,
                                               generator=torch.Generator().manual_seed(4)))
    return model


def vocab(mesh):
    wv = word_vectors()
    return torch.from_numpy(wv) if mesh is None else mesh.shard_vocab(wv)


def step(mesh, drop: float = 0.2, gumbel: bool = True, table: str = "sharded",
         flat=None) -> dict:
    """One train step on the global batch SEL: loss components, IoUs and
    the params after, as numpy."""
    model = model_of(flat, gumbel)
    opt = make_optimizer(model, clip_norm=1.0, weight_decay=0.01)
    rows = steps.batch_rows(mesh, B)
    batch = steps.gather_batch(device_split(mesh, table), torch.from_numpy(SEL),
                               with_labels=True, rows=rows)
    m = steps.train_step(model, opt, batch, vocab(mesh), LR,
                         steps.make_generator(torch.device("cpu"), 5),
                         drop_rate=drop, rows=rows)
    return {"losses": {k: m[k].item() for k in ("loc_loss", "match_loss",
                                                 "align_loss", "loss")},
            "ious": m["ious"].numpy(), "params": to_jax_params(model)}


def epoch(mesh) -> dict:
    """steps.train_epoch over RAGGED (a full batch and a ragged one of 3)."""
    model = model_of(gumbel=True)
    opt = make_optimizer(model, clip_norm=1.0, weight_decay=0.01)
    losses, ious = steps.train_epoch(model, opt, device_split(mesh),
                                     torch.from_numpy(RAGGED), B, vocab(mesh), LR,
                                     11, 0, drop_rate=0.2, mesh=mesh)
    return {"losses": losses.numpy(), "ious": ious.numpy(),
            "params": to_jax_params(model)}


def sweeps(mesh) -> dict:
    """The infer sweeps at mc 0.5 over two batches of SEL's samples
    (sequential, folded, fused) and the eval sweep."""
    model = model_of(gumbel=False)
    data = device_split(mesh)
    sels = torch.from_numpy(np.stack([SEL, SEL[::-1].copy()]))
    rows = steps.batch_rows(mesh, B)
    wv = vocab(mesh)

    def batches():
        return steps.resident_batches(data, sels, [B, 11], rows)

    out = {"eval": steps.eval_sweep(model, batches(), wv, rows).numpy()}
    for name, fn, kw in (("mc", steps.infer_sweep, {}),
                         ("fold_mc", steps.infer_sweep, {"fold_mc": True}),
                         ("fused_mc", steps.fused_infer_sweep, {})):
        out[name] = {k: v.numpy() for k, v in
                     fn(model, batches(), wv, 0.5, 7, rows=rows, **kw).items()}
    return out


def losses_by_rank(mesh) -> dict:
    """This rank's shares of the three losses on its rows of the forward of
    the global batch, summed over the data group; and the same losses
    computed on its rows as if they were a whole batch, summed."""
    model = model_of()
    rows = steps.batch_rows(mesh, B)
    batch = steps.gather_batch(device_split(mesh), torch.from_numpy(SEL),
                               with_labels=True, rows=rows)
    with torch.no_grad():
        out = model(batch, vocab(mesh), batch["match_labels"], rows=rows)
        local = model(batch, vocab(mesh), batch["match_labels"])
        args = (out["v2q_feats"], out["q2v_feats"], out["q_mask"], out["v_mask"],
                batch["inner_labels"])
        per_rank = {"align": layers.alignment_loss(*args).reshape(1),
                    "match": local["match_loss"].reshape(1)}
        shares = {"align": layers.alignment_loss(*args, rows).reshape(1),
                  "match": out["match_loss"].reshape(1),
                  "loc": layers.localizing_loss(out["start_logits"], out["end_logits"],
                                                batch["y1"], batch["y2"],
                                                out["v_mask"], rows).reshape(1)}
    return {"global": {k: sum_over(v, rows).item() for k, v in shares.items()},
            "per_rank": {k: sum_over(v, rows).item() for k, v in per_rank.items()}}


# -- the ranks ----------------------------------------------------------------------
def _entry(rank: int, fn, world: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        torch.save(fn(rank, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp: str, *args) -> list:
    """``fn(rank, *args)`` on ``world`` spawned ranks joined by gloo through
    a file under ``tmp`` (one intra-op thread each); every rank's result.
    ``fn`` lives in a test module, which the ranks import."""
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def layout(mesh: Mesh) -> dict:
    return {"shape": dict(mesh.shape), "size": mesh.size, "rank": mesh.rank,
            "data_index": mesh.data_index, "model_index": mesh.model_index,
            "data_group": dist.get_process_group_ranks(mesh.data_group),
            "model_group": dist.get_process_group_ranks(mesh.model_group)}


def data_axis_ranks(rank: int) -> dict:
    """Every case of the (data=2, model=1) layout on one rank."""
    mesh = make_mesh()
    errors = []
    for kw in ({"model_parallel": 3}, {"n_devices": 3}):
        try:
            make_mesh(**kw)
        except ValueError as e:
            errors.append(str(e))
    out = {"layout": layout(mesh), "errors": errors,
           "step": step(mesh),
           "replicated_table": step(mesh, table="replicated"),
           "bf16": step(mesh, table="bf16"), "int8": step(mesh, table="int8"),
           "epoch": epoch(mesh), "ragged_rows": mesh.batch_rows(3),
           "sweeps": sweeps(mesh), "losses": losses_by_rank(mesh),
           "table_rows": mesh.shard_rows(split()["features"]).local.shape[0],
           "vocab": type(vocab(mesh)).__name__, "vocab_rows": vocab(mesh).shape[0]}
    out["ragged_rows"] = (out["ragged_rows"].n, out["ragged_rows"].total,
                          out["ragged_rows"].group is None)
    return out


def model_axis_ranks(rank: int) -> dict:
    """The (data=1, model=2) layout: the table over both ranks, the vocab
    over the model group, the batch whole on each rank."""
    mesh = make_mesh(model_parallel=2)
    v = vocab(mesh)
    return {"layout": layout(mesh), "step": step(mesh),
            "table_rows": mesh.shard_rows(split()["features"]).local.shape[0],
            "vocab_rows": v.local.shape[0], "vocab_total": v.shape[0]}


# -- fixtures -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both ranks' results on the (data=2, model=1) layout."""
    return run_ranks(data_axis_ranks, 2, str(tmp_path_factory.mktemp("data_axis")))


@pytest.fixture(scope="module")
def world2_model(tmp_path_factory):
    """Both ranks' results on the (data=1, model=2) layout."""
    return run_ranks(model_axis_ranks, 2, str(tmp_path_factory.mktemp("model_axis")))


@pytest.fixture(scope="module")
def world1():
    """The unsharded references in this process."""
    return {"step": step(None), "losses": losses_by_rank(None),
            "bf16": step(None, table="bf16"), "int8": step(None, table="int8"),
            "epoch": epoch(None), "sweeps": sweeps(None)}


@pytest.fixture(scope="module")
def world1_group(tmp_path_factory):
    """The sharded path on a one-rank gloo group in this process."""
    init = tmp_path_factory.mktemp("world1_group") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh()
        return {"mesh": layout(mesh), "step": step(mesh), "epoch": epoch(mesh),
                "sweeps": sweeps(mesh)}
    finally:
        dist.destroy_process_group()


# -- checks ---------------------------------------------------------------------------
def assert_step_close(got: dict, want: dict) -> None:
    for k, v in want["losses"].items():
        assert got["losses"][k] == pytest.approx(v, rel=1e-5), k
    np.testing.assert_array_equal(got["ious"], want["ious"])
    assert_params_close(got["params"], want["params"])


def assert_params_close(got: dict, want: dict, atol: float = 2e-6) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=atol, err_msg=k)


def assert_same(a, b) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


# 1. make_mesh's layouts and its ValueError
def test_local_mesh_without_a_group():
    mesh = make_mesh()
    assert (mesh.shape, mesh.size, mesh.distributed) == ({"data": 1, "model": 1}, 1, False)
    assert mesh.batch_rows(16).group is None
    with pytest.raises(ValueError):
        make_mesh(model_parallel=2)
    with pytest.raises(ValueError):
        make_mesh(n_devices=2)


def test_mesh_layouts(world2, world2_model):
    for rank, r in enumerate(world2):
        assert r["layout"] == {"shape": {"data": 2, "model": 1}, "size": 2,
                               "rank": rank, "data_index": rank, "model_index": 0,
                               "data_group": [0, 1], "model_group": [rank]}
        assert len(r["errors"]) == 2 and "not divisible" in r["errors"][0]
    for rank, r in enumerate(world2_model):
        assert r["layout"] == {"shape": {"data": 1, "model": 2}, "size": 2,
                               "rank": rank, "data_index": 0, "model_index": rank,
                               "data_group": [rank], "model_group": [0, 1]}


# 2. a world-2 step at drop 0.2 with gumbel on equals the world-1 step
def test_world2_step_equals_world1(world2, world1):
    for r in world2:
        assert_step_close(r["step"], world1["step"])
    # every rank holds the same weights after the step
    assert_same(world2[0]["step"]["params"], world2[1]["step"]["params"])


def test_world1_group_is_bit_equal_to_unsharded(world1_group, world1):
    assert world1_group["mesh"]["shape"] == {"data": 1, "model": 1}
    for case in ("step", "epoch", "sweeps"):
        assert_same(world1_group[case], world1[case])


def test_losses_are_global(world2, world1):
    """The shares summed over the ranks are the global losses; the same
    losses computed per rank (a (b x b) alignment softmax, a per-rank
    match mean) are not."""
    want = world1["losses"]["global"]
    for r in world2:
        got = r["losses"]
        for k in ("loc", "match", "align"):
            assert got["global"][k] == pytest.approx(want[k], rel=1e-5), k
        for k in ("align", "match"):
            assert got["per_rank"][k] != pytest.approx(want[k], rel=1e-3), k


# 4. the indexed step with the table sharded equals the replicated table's
def test_sharded_table_equals_replicated(world2):
    for r in world2:
        assert_same(r["step"], r["replicated_table"])


# 5. the sharded infer step: shapes, live MC passes, outputs equal world 1's
def test_sharded_sweeps(world2, world1):
    want = world1["sweeps"]
    for r in world2:
        got = r["sweeps"]
        np.testing.assert_array_equal(got["eval"], want["eval"])
        for name in ("mc", "fold_mc", "fused_mc"):
            g, w = got[name], want[name]
            assert g["start_logits"].shape == (B + 11, T)
            assert not np.allclose(g["start_logits1"], g["start_logits2"])
            for k in ("start_index", "end_index", "ious"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=(name, k))
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=2e-6,
                                           err_msg=(name, k))


# 6. the model axis: table and vocab sharded, the step equal to the replicated one
def test_model_axis_step(world2_model, world1):
    for r in world2_model:
        assert_step_close(r["step"], world1["step"])


# 7. each rank holds rows/shards of the table and vocab
def test_rows_per_rank(world2, world2_model):
    padded = ROWS + 1
    for r in world2:
        assert r["table_rows"] == padded // 2
        assert (r["vocab"], r["vocab_rows"]) == ("Tensor", 25)   # model axis 1
    for r in world2_model:
        assert r["table_rows"] == padded // 2
        assert (r["vocab_rows"], r["vocab_total"]) == (13, 26)


# 8. bf16 and int8 tables step finitely and equal world 1
@pytest.mark.parametrize("table", ["bf16", "int8"])
def test_compressed_tables(world2, world1, table):
    for r in world2:
        assert np.isfinite(r[table]["losses"]["loss"])
        assert_step_close(r[table], world1[table])


# 10. a ragged last batch is whole on every rank
def test_ragged_batch_replicated(world2, world1):
    want = world1["epoch"]
    for r in world2:
        assert r["ragged_rows"] == (3, 3, True)
        for k in ("losses",):
            np.testing.assert_allclose(r["epoch"][k], want[k], rtol=1e-5)
        np.testing.assert_array_equal(r["epoch"]["ious"], want["ious"])
        assert_params_close(r["epoch"]["params"], want["params"])
