"""The port's API-parity functions against ``hual_tpu``'s, on the same
seeded inputs, exactly: the Gaussian soft labels (``data/labels.py``),
``dataset_gen_active`` and ``Processor`` with ``scope`` and
``reset_idx_counter`` (``data/datasets.py``), ``register_model``
(``models/registry.py``) and the ``io`` round trips (``utils/io.py``).
None of them is on a path of the pipeline; the reference kept them as
public API.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from hual_tpu.data import datasets as jax_datasets
from hual_tpu.data import labels as jax_labels
from hual_tpu.models import registry as jax_registry
from hual_tpu.utils import io as jax_io
from hual_tpu_torch.data import datasets, labels
from hual_tpu_torch.models import registry
from hual_tpu_torch.utils import io

# (s, e, vlen, L, alpha): the span at both ends, a one-frame span, vlen < L
SOFT_LABEL_CASES = [(0, 5, 16, 16, 0.25), (3, 9, 12, 16, 0.25),
                    (10, 10, 20, 32, 1.0), (0, 63, 64, 64, 0.1),
                    (2, 40, 41, 100, 0.5), (7, 8, 9, 9, 2.0)]


@pytest.mark.parametrize("s,e,vlen,L,alpha", SOFT_LABEL_CASES)
def test_gene_soft_label_matches_jax(s, e, vlen, L, alpha):
    got = labels.gene_soft_label(s, e, vlen, L, alpha)
    want = jax_labels.gene_soft_label(s, e, vlen, L, alpha)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    g = labels.get_gaussian_weight(s + 0.5, vlen, L, alpha)
    np.testing.assert_array_equal(g, jax_labels.get_gaussian_weight(s + 0.5, vlen, L, alpha))


def _records(rng, n: int, active: bool) -> tuple[list, dict, dict, dict]:
    words = ["person", "opens", "the", "door", "zzunseen", "a", "cup"]
    word_dict = {"<PAD>": 0, "<UNK>": 1, **{w: i + 2 for i, w in enumerate(words[:-2])}}
    char_dict = {"<PAD>": 0, "<UNK>": 1,
                 **{c: i + 2 for i, c in enumerate("personthd")}}
    vfeat_lens = {f"v{i}": int(rng.integers(4, 40)) for i in range(n - 1)}
    recs = []
    for i in range(n):
        duration = float(rng.uniform(10, 40))
        s = float(rng.uniform(0, duration / 2))
        rec = {"sample_id": i, "vid": f"v{i}", "s_time": s,
               "e_time": min(duration, s + float(rng.uniform(1, 10))),
               "duration": duration,
               "words": list(rng.choice(words, size=int(rng.integers(1, 9))))}
        if active:
            w = rng.uniform(0, 0.4, int(rng.integers(5, 50)))
            lo = int(rng.integers(0, len(w)))
            w[lo:lo + int(rng.integers(1, 6))] = rng.uniform(0.5, 1.0)
            rec["active_weight"] = w.tolist()
        recs.append(rec)
    return recs, vfeat_lens, word_dict, char_dict


@pytest.mark.parametrize("seed,max_pos_len", [(0, 64), (1, 3), (2, 100)])
def test_dataset_gen_active_matches_jax(seed, max_pos_len):
    recs, lens, wd, cd = _records(np.random.default_rng(seed), 12, active=True)
    got = datasets.dataset_gen_active(recs, lens, wd, cd, max_pos_len, "train")
    want = jax_datasets.dataset_gen_active(recs, lens, wd, cd, max_pos_len, "train")
    assert got == want and len(got) == len(lens)     # v11 has no features
    plain = datasets.dataset_gen(recs, lens, wd, cd, max_pos_len, "train")
    assert plain == jax_datasets.dataset_gen(recs, lens, wd, cd, max_pos_len, "train")


def test_dataset_gen_active_without_active_frames_raises():
    recs, lens, wd, cd = _records(np.random.default_rng(3), 4, active=True)
    recs[1]["active_weight"] = [0.1, 0.49, 0.0]
    for fn in (datasets.dataset_gen_active, jax_datasets.dataset_gen_active):
        with pytest.raises(ValueError, match="no active frames for v1"):
            fn(recs, lens, wd, cd, 64, "train")


@pytest.mark.parametrize("scope", ["train", "test", None])
def test_processor_scope_and_counter_match_jax(scope):
    raw = [["vid0", 30.5, [1.0, 4.5], "A person opens the door.", "extra"],
           ["vid1", 12.0, [0.0, 3.0], "someone drinks from a cup"],
           [7, 20.0, [2.5, 9.0], "Person is laughing"]]
    port, ref = datasets.Processor(), jax_datasets.Processor()
    for _ in range(2):            # the counter runs on across calls
        args = (raw,) if scope is None else (raw, scope)
        got = port.process_data(*args)
        assert got == ref.process_data(raw, scope or "train")
    assert port.idx_counter == ref.idx_counter == 2 * len(raw)
    port.reset_idx_counter()
    ref.reset_idx_counter()
    assert port.process_data(raw, scope=scope) == ref.process_data(raw, scope=scope)
    assert port.idx_counter == len(raw)


def test_register_model_matches_jax():
    for mod in (registry, jax_registry):
        @mod.register_model("ParityProbe")
        class Probe:
            pass

        assert mod.get_model_class("ParityProbe") is Probe
        assert mod.get_model_class("SeqPAN").__name__ == "SeqPAN"
        with pytest.raises(KeyError, match="unknown model 'nope'"):
            mod.get_model_class("nope")
        del mod._REGISTRY["ParityProbe"]


@pytest.mark.parametrize("lines", [["a", "b c", ""], ["only"], [], ["ü ñ", "x\ty"]])
def test_lines_round_trip_matches_jax(tmp_path, lines):
    io.save_lines(lines, str(tmp_path / "port" / "l.txt"))
    jax_io.save_lines(lines, str(tmp_path / "jax" / "l.txt"))
    assert (tmp_path / "port" / "l.txt").read_bytes() == (tmp_path / "jax" / "l.txt").read_bytes()
    got = io.load_lines(str(tmp_path / "port" / "l.txt"))
    assert got == jax_io.load_lines(str(tmp_path / "port" / "l.txt"))


def test_load_yaml_matches_jax(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("task: charades\nmodel:\n  dim: 128\n  names: [a, b]\n"
                    "train: {lr: 1.0e-4, fold_mc: false}\n")
    assert io.load_yaml(str(path)) == jax_io.load_yaml(str(path))
    shipped = os.path.join(os.path.dirname(__file__), "..", "configs", "charades",
                           "SeqPAN.yaml")
    assert io.load_yaml(shipped) == jax_io.load_yaml(shipped)
