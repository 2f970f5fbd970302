"""TF1-checkpoint migration of the port (hual_tpu_torch/utils/tf1_port.py)
against ``hual_tpu.utils.tf1_port`` and against TensorFlow's own reader.

* The name map and ``params_from_tf_values`` equal the JAX package's, leaf
  for leaf and bit for bit: on the cases of tests/test_tf1_port.py and on
  every name of a reference naming of ``hual_tpu``'s init tree, at a tiny
  width and at Charades width.
* TF's ``tf.compat.v1.train.Saver`` writes those variables with their Adam
  slots, ``global_step`` (int64) and the GloVe table, twice
  (``max_to_keep=3``); the port's TF-free reader returns what
  ``tf.train.load_checkpoint`` returns (names, dtypes, shapes, bytes), for
  the prefix and for the directory (the latest wins).
* ``port_checkpoint`` then ``Trainer.restore`` on the CPU gives the JAX
  tree's params bit for bit, and logits within tests/test_torch_seqpan.py's
  bounds of ``hual_tpu``'s ``SeqPAN.apply`` on the same params (rtol 1e-4 /
  atol 2e-4; indices exact).
* The reader's refusals, and tests/torch_tf1_bundle.py's writer (what
  chip_smoke.py writes on the card, which has no TensorFlow) read by TF
  bit for bit.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402
from torch_tf1_bundle import (reference_names, saver_values,  # noqa: E402
                              write_bundle, write_pointer)

from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN  # noqa: E402
from hual_tpu.serve import _flatten_params  # noqa: E402
from hual_tpu.utils import tf1_port as jax_port  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.models.seqpan import SeqPAN  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from hual_tpu_torch.utils import tf1_port as port  # noqa: E402
from hual_tpu_torch.weights import load_jax_params, to_jax_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

TINY = dict(vdim=16, dim=16, num_heads=2, attn_layer=1, max_vlen=16,
            word_dim=300, char_dim=8)
CHARADES = dict(vdim=1024, dim=128, num_heads=8, attn_layer=2, max_vlen=64,
                word_dim=300, char_dim=50)
WIDTHS = {"tiny": TINY, "charades": CHARADES}

# tests/test_tf1_port.py:32-57, one case each; the last two raise in both
PARAM_CASES = {
    "filters_and_nests": {
        "pos/emb:0": np.ones((3, 2), np.float32),
        "pos/emb/adam_m": np.zeros((3, 2), np.float32),
        "pos/emb/adam_v": np.zeros((3, 2), np.float32),
        "global_step": np.int64(7),
        "word_embs/word_table": np.ones((5, 2), np.float32),
        "word_embs/unk:0": np.arange(2, dtype=np.float32)[None],
        "matching_loss/dense/kernel": np.full((2, 4), 0.5, np.float32),
        "feature_encoder/multihead_attention_block/layer_norm_scale":
            np.linspace(0, 1, 2, dtype=np.float32)},
    "layer_norm_leaves": {
        "q_layer_norm/layer_norm_scale": np.ones(3, np.float32),
        "q_layer_norm/layer_norm_bias": np.full(3, -1.0, np.float64)},
    "both_map_to_one_path": {"matching_loss/w:0": np.zeros(1, np.float32),
                             "matching_head/w:0": np.zeros(1, np.float32)},
    "no_model_variables": {"global_step": np.int64(1),
                           "a/adam_m": np.zeros(1, np.float32)},
}
NAMES = ("a/adam_m", "a/adam_v", "global_step", "global_step:0",
         "word_embs/word_table", "word_embs/unk:0", "matching_loss/dense/kernel",
         "x/adam_m_like")


def _leaves(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): v})
    return out


def _jax_model(kw: dict, num_chars: int) -> tuple:
    kw = dict(kw)
    vdim = kw.pop("vdim")
    model = JaxSeqPAN(**kw, num_chars=num_chars)
    batch = {"video_features": jnp.zeros((2, kw["max_vlen"], vdim)),
             "video_seq_len": jnp.ones((2,), jnp.int32),
             "word_ids": jnp.ones((2, 5), jnp.int32),
             "char_ids": jnp.ones((2, 5, 4), jnp.int32)}
    init = lambda key: model.init({"params": key}, batch,  # noqa: E731
                                  jnp.zeros((3, kw["word_dim"])), 0.0,
                                  deterministic=True)
    return model, init


def _random_params(kw: dict, seed: int) -> dict[str, np.ndarray]:
    """hual_tpu's init tree at ``kw`` (shapes by eval_shape), flattened,
    with seeded random values."""
    _, init = _jax_model(kw, num_chars=40)
    shapes = _flatten_params(jax.eval_shape(init, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in shapes.items()}


def _tf():
    tf = pytest.importorskip("tensorflow")
    return tf


def _saver_write(tf, directory: str, runs: list[dict]) -> list[str]:
    """One ``tf.compat.v1.train.Saver(max_to_keep=3)`` saving ``runs[i]``
    as step ``i + 1`` in turn; returns the prefixes."""
    graph = tf.Graph()
    names = sorted(runs[0])
    with graph.as_default():
        feeds, assigns = {}, []
        for name in names:
            value = runs[0][name]
            var = tf.compat.v1.get_variable(
                name, shape=value.shape, dtype=tf.as_dtype(value.dtype),
                initializer=tf.compat.v1.zeros_initializer())
            ph = tf.compat.v1.placeholder(var.dtype, value.shape)
            feeds[name] = ph
            assigns.append(var.assign(ph))
        saver = tf.compat.v1.train.Saver(max_to_keep=3)
    prefixes = []
    with tf.compat.v1.Session(graph=graph) as sess:
        for step, values in enumerate(runs, start=1):
            sess.run(assigns, {feeds[n]: values[n] for n in names})
            prefixes.append(saver.save(sess, os.path.join(directory, "best_SeqPAN.ckpt"),
                                       global_step=step))
    return prefixes


def _tf_read(tf, prefix: str) -> dict:
    reader = tf.train.load_checkpoint(prefix)
    return {n: reader.get_tensor(n) for n in reader.get_variable_to_shape_map()}


def _assert_same_values(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w), name
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        assert np.shape(g) == np.shape(w), name
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), name


# -- the name map ---------------------------------------------------------------
@pytest.mark.parametrize("case", list(PARAM_CASES))
def test_params_from_tf_values_matches_jax(case):
    values = PARAM_CASES[case]
    try:
        want = jax_port.params_from_tf_values(values)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port.params_from_tf_values(values)
        assert str(got.value) == str(e)
        return
    got = port.params_from_tf_values(values)
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert set(port.flat_params(got)) == {"/".join(k) for k in a}


@pytest.mark.parametrize("name", NAMES)
def test_is_model_variable_matches_jax(name):
    assert port.is_model_variable(name) == jax_port.is_model_variable(name)
    assert port.tf_name_to_flax_path(name) == jax_port.tf_name_to_flax_path(name)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_name_map_matches_jax_on_the_init_tree(width):
    flat = _random_params(WIDTHS[width], seed=1)
    names = reference_names(flat)
    assert len(names) == len(flat)
    for name in names:
        path = port.tf_name_to_flax_path(name)
        assert path == jax_port.tf_name_to_flax_path(name)
        assert port.is_model_variable(name) and jax_port.is_model_variable(name)
    assert any("multihead_attention_block" in n for n in names)
    assert any(n.startswith("matching_loss/") for n in names)
    tree = port.params_from_tf_values(names)
    want = _leaves(jax_port.params_from_tf_values(names))
    assert _leaves(tree).keys() == want.keys()
    back = port.flat_params(tree)
    assert back.keys() == flat.keys()
    for k, v in back.items():
        assert v.tobytes() == flat[k].tobytes(), k


# -- the reader against TensorFlow's ------------------------------------------------
@pytest.fixture(scope="module", params=list(WIDTHS))
def tf_saved(request, tmp_path_factory):
    """TF's Saver wrote a reference-named checkpoint twice: (directory,
    prefixes, the values of each save)."""
    tf = _tf()
    flat = _random_params(WIDTHS[request.param], seed=2)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 300)).astype(np.float32)
    runs = [saver_values(flat, table, 100, rng),
            saver_values({k: v + 1 for k, v in flat.items()}, table, 200, rng)]
    directory = str(tmp_path_factory.mktemp(f"saver_{request.param}"))
    return tf, directory, _saver_write(tf, directory, runs), runs


def test_reader_matches_tf_prefix_and_directory(tf_saved):
    tf, directory, prefixes, runs = tf_saved
    first = port.load_tf1_checkpoint(prefixes[0])
    _assert_same_values(first, _tf_read(tf, prefixes[0]))
    latest = port.load_tf1_checkpoint(directory)
    _assert_same_values(latest, _tf_read(tf, tf.train.latest_checkpoint(directory)))
    assert port.latest_checkpoint(directory) == prefixes[1]
    assert latest["global_step"] == 200 and latest["global_step"].dtype == np.int64
    assert latest.keys() == runs[1].keys()
    for k, v in runs[1].items():
        assert np.asarray(latest[k]).tobytes() == v.tobytes(), k


def test_reader_resolves_a_relative_pointer(tf_saved, tmp_path):
    tf, _, prefixes, _ = tf_saved
    for f in os.listdir(os.path.dirname(prefixes[0])):
        if f.startswith(os.path.basename(prefixes[0]) + "."):
            os.symlink(os.path.join(os.path.dirname(prefixes[0]), f), tmp_path / f)
    write_pointer(str(tmp_path), os.path.basename(prefixes[0]))
    assert port.latest_checkpoint(str(tmp_path)) == str(tmp_path / os.path.basename(prefixes[0]))
    _assert_same_values(port.load_tf1_checkpoint(str(tmp_path)),
                        _tf_read(tf, prefixes[0]))


def test_helper_writer_is_read_by_tf(tmp_path):
    """tests/torch_tf1_bundle.py's bundle, several blocks and restarts:
    TF's reader gives back every value bit for bit, and so does the port's."""
    tf = _tf()
    rng = np.random.default_rng(4)
    values = saver_values(_random_params(TINY, seed=5),
                          rng.normal(size=(20, 300)).astype(np.float32), 7, rng)
    values.update({"flags": np.array([True, False, True]),
                   "counts": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "scale64": rng.normal(size=(3,))})
    prefix = write_bundle(str(tmp_path / "ck" / "best_SeqPAN.ckpt-7"), values,
                          block_bytes=300)
    want = _tf_read(tf, prefix)
    assert want.keys() == values.keys()
    for k, v in values.items():
        assert np.asarray(want[k]).dtype == v.dtype and np.shape(want[k]) == v.shape, k
        assert np.asarray(want[k]).tobytes() == v.tobytes(), k
    _assert_same_values(port.load_tf1_checkpoint(prefix), want)


# -- port_checkpoint -> Trainer.restore ---------------------------------------------
@pytest.fixture(scope="module")
def cpu_trainer(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tf1_trainer"))
    make_dataset(root, task="charades", n_train=16, n_test=8, vdim=TINY["vdim"],
                 max_raw_len=24, seed=13)
    cfg = Config.from_dict({
        "task": "charades", "suffix": "ported",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "model": dict(TINY, max_tlen=10)})
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    tr = Trainer(cfg, dataset, store, device="cpu")
    yield tr
    tr.close()


def test_port_checkpoint_restores_the_jax_params(cpu_trainer, tmp_path):
    tf = _tf()
    tr = cpu_trainer
    model, init = _jax_model(TINY, num_chars=tr.config.model.num_chars)
    params = jax.jit(init)(jax.random.key(11))
    flat = _flatten_params(params)
    rng = np.random.default_rng(6)
    table = np.asarray(tr.dataset["word_vector"], np.float32)
    _saver_write(tf, str(tmp_path / "ck"), [saver_values(flat, table, 42, rng)])

    out = str(tmp_path / "ported" / "best.npz")
    ported, wv = port.port_checkpoint(str(tmp_path / "ck"), out)
    np.testing.assert_array_equal(wv, table)
    np.testing.assert_array_equal(np.load(port.word_vectors_path(out)), table)
    assert ported.keys() == flat.keys()
    tr.restore(out)
    direct = load_jax_params(SeqPAN.from_config(tr.config), flat)
    restored, want = to_jax_params(tr.model), to_jax_params(direct)
    for k, v in want.items():
        assert restored[k].tobytes() == v.tobytes() == flat[k].tobytes(), k

    # the restored model's forward against hual_tpu's apply on the same params
    B, W, C, T = 5, 7, 6, TINY["max_vlen"]
    rng = np.random.default_rng(8)
    lens = rng.integers(2, T + 1, size=B).astype(np.int32)
    lens[:2] = (T, 1)
    word_ids = np.where(np.arange(W)[None] < rng.integers(1, W + 1, (B, 1)),
                        rng.integers(1, len(table), (B, W)), 0).astype(np.int32)
    char_ids = rng.integers(0, tr.config.model.num_chars, (B, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    feats = rng.normal(size=(B, T, TINY["vdim"])).astype(np.float32)
    feats[np.arange(T)[None] >= lens[:, None]] = 0.0
    batch = {"video_features": feats, "video_seq_len": lens,
             "word_ids": word_ids, "char_ids": char_ids}
    ref = jax.jit(lambda p, b, w: model.apply(p, b, w, 0.0, deterministic=True))(
        params, batch, table)
    with torch.no_grad():
        out_t = tr.model({k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.from_numpy(table))
    for key in ("start_logits", "end_logits"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=2e-4, err_msg=key)
    for key in ("start_index", "end_index"):
        np.testing.assert_array_equal(out_t[key].numpy(), np.asarray(ref[key]))


def test_port_tool_prints_the_summary(tmp_path, capsys):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import torch_port_tf1_checkpoint as tool

    flat = _random_params(TINY, seed=9)
    rng = np.random.default_rng(10)
    prefix = write_bundle(str(tmp_path / "ck" / "best_SeqPAN.ckpt-3"),
                          saver_values(flat, np.ones((4, 300), np.float32), 3, rng))
    write_pointer(str(tmp_path / "ck"), prefix)
    assert tool.main([str(tmp_path / "ck"), str(tmp_path / "best.npz")]) == 0
    lines = capsys.readouterr().out.splitlines()
    n = sum(v.size for v in flat.values())
    assert lines[0] == (f"ported {len(flat)} tensors / {n:,} parameters -> "
                        f"{tmp_path / 'best.npz'}")
    assert lines[1].startswith("word vectors (4, 300) -> ")
    with np.load(tmp_path / "best.npz") as saved:
        assert saved.keys() == flat.keys()


# -- what the reader refuses --------------------------------------------------------
def _bundle(tmp_path, **kw) -> str:
    values = {"a/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
              "global_step": np.asarray(1, np.int64)}
    values.update(kw.pop("extra", {}))
    return write_bundle(str(tmp_path / "ck-1"), values, **kw)


def _flip_data_byte(prefix: str) -> str:
    path = prefix + ".data-00000-of-00001"
    raw = bytearray(open(path, "rb").read())
    raw[3] ^= 0x10
    open(path, "wb").write(bytes(raw))
    return prefix


ERRORS = {
    "compressed_block": (lambda p: _bundle(p, block_type=1),
                         ValueError, "compression type 1 \\(snappy\\)"),
    "unknown_dtype": (lambda p: _bundle(p, extra={"h": np.ones(2, np.float16)}),
                      ValueError, "'h' has dtype enum 19"),
    "sliced_entry": (lambda p: _bundle(p, sliced=("a/kernel",)),
                     ValueError, "'a/kernel' is saved in slices"),
    "crc_mismatch": (lambda p: _flip_data_byte(_bundle(p)),
                     ValueError, "'a/kernel': crc32c mismatch"),
    "missing_pointer_target": (lambda p: (write_pointer(str(p), "gone-3"), str(p))[1],
                               FileNotFoundError, "has no .index"),
    "no_pointer": (lambda p: str(p), FileNotFoundError, "no TF checkpoint pointer"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_reader_refuses(case, tmp_path):
    make, error, match = ERRORS[case]
    with pytest.raises(error, match=match):
        port.load_tf1_checkpoint(make(tmp_path))


def test_two_names_on_one_path_refused(tmp_path):
    values = {"matching_loss/w": np.zeros(2, np.float32),
              "matching_head/w": np.ones(2, np.float32)}
    with pytest.raises(ValueError, match="both map to flax path"):
        port.port_checkpoint(write_bundle(str(tmp_path / "ck-1"), values),
                             str(tmp_path / "best.npz"))


def test_crc32c_known_values():
    assert port.crc32c(b"123456789") == 0xE3069283
    assert port.crc32c(b"") == 0
    rng = np.random.default_rng(12)
    for n in (1, 255, 256, 1000, 4097, 70001):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        reg = 0xFFFFFFFF
        for b in data:
            reg ^= b
            for _ in range(8):
                reg = (reg >> 1) ^ (0x82F63B78 if reg & 1 else 0)
        assert port.crc32c(data) == reg ^ 0xFFFFFFFF, n
