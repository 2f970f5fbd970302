"""The repairs of four API differences from ``hual_tpu``, each against
``hual_tpu`` on the same inputs, and the parameter names of every public
function and class of the port against its ``hual_tpu`` counterpart:

* ``runtime/observability.trace(name, profile_dir=None)`` records a
  torch.profiler trace into the directory it is given, or into
  ``$HUAL_PROFILE_DIR``, as ``hual_tpu``'s records a jax.profiler one;
* ``data/datasets.dataset_gen`` takes ``scope`` as its sixth argument;
* ``utils/io.save_json(data, path, pretty=False)`` writes ``indent=4`` with
  ``pretty``, byte-equal to ``hual_tpu``'s;
* ``runtime/trainer.Trainer``'s fourth parameter is ``mesh``;
* :data:`RECORDED` lists every pair whose parameters differ, with the
  reason: a new difference, or one that goes away, fails a case.
"""

from __future__ import annotations

import glob
import importlib
import inspect
import json
import logging
import os
import pkgutil
import sys

import numpy as np
import pytest

import hual_tpu_torch
from hual_tpu.data import datasets as jax_datasets
from hual_tpu.utils import io as jax_io
from hual_tpu_torch.data import datasets
from hual_tpu_torch.runtime import observability
from hual_tpu_torch.utils import io
from test_torch_api_parity import _records

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_synthetic_data import make_dataset  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

# the port's modules with a hual_tpu counterpart that share public names
MODULES = [
    'active.coefficients', 'active.engine', 'active.renew',
    'active.uncertainty', 'cli', 'config', 'data.datasets', 'data.features',
    'data.labels', 'data.loader', 'data.tokenize', 'data.vocab',
    'models.initializers', 'models.layers', 'models.modules', 'models.registry',
    'models.seqpan', 'native', 'ops.decode', 'ops.gumbel', 'ops.masking',
    'ops.optim', 'orchestrate', 'parallel.mesh', 'runtime.debug',
    'runtime.logger', 'runtime.observability', 'runtime.steps',
    'runtime.trainer', 'serve', 'utils.io', 'utils.metrics', 'utils.tf1_port']

# "module.name": (the port's parameters, hual_tpu's), for each pair that
# differs on purpose
RECORDED = {
    # the port's entry points take the device (and the process group's
    # rendezvous or mesh) the JAX package finds for itself
    "cli.build_trainer": (
        ('config', 'features', 'device_features', 'base_dataset', 'device', 'mesh'),
        ('config', 'features', 'device_features', 'base_dataset')),
    "cli.main": (
        ('argv', 'device', 'init_method'),
        ('argv',)),
    "orchestrate.run_rounds": (
        ('task', 'rounds', 'base_config_path', 'start_round', 'data_root',
        'results_root', 'max_retries', 'warm_start', 'point_strategy', 'selection',
        'strategy_seed', 'device', 'mesh'),
        ('task', 'rounds', 'base_config_path', 'start_round', 'data_root',
        'results_root', 'max_retries', 'warm_start', 'point_strategy', 'selection',
        'strategy_seed')),
    "orchestrate.main": (
        ('argv', 'device', 'init_method'),
        ('argv',)),
    "parallel.mesh.make_mesh": (
        ('n_devices', 'model_parallel', 'device'),
        ('n_devices', 'model_parallel')),
    "serve.Predictor": (
        ('config', 'params', 'word_dict', 'char_dict', 'word_vectors', 'max_wlen',
        'max_clen', 'batch_size', 'device'),
        ('config', 'params', 'word_dict', 'char_dict', 'word_vectors', 'max_wlen',
        'max_clen', 'batch_size')),
    "runtime.trainer.Trainer": (
        ('config', 'dataset', 'feature_store', 'mesh', 'logger', 'device_features',
        'device'),
        ('config', 'dataset', 'feature_store', 'mesh', 'logger',
        'device_features')),
    # a torch.Generator where JAX takes a key; dropout as a function of it
    "models.initializers.glorot_uniform_tf": (
        ('shape', 'generator'),
        ('key', 'shape', 'dtype')),
    "models.layers.dropout": (
        ('x', 'rate', 'generator'),
        ('module', 'x', 'rate', 'deterministic')),
    "ops.gumbel.gumbel_sample": (
        ('generator', 'shape', 'like'),
        ('rng', 'shape')),
    "ops.gumbel.gumbel_softmax": (
        ('generator', 'logits', 'tau', 'hard'),
        ('rng', 'logits', 'tau', 'hard')),
    "ops.gumbel.gumbel_sigmoid": (
        ('generator', 'logits', 'tau', 'hard'),
        ('rng', 'logits', 'tau', 'hard')),
    # nn.Module constructors take their input widths (and the seeded
    # generator); flax modules take parent and name and infer widths
    "models.layers.LayerNorm": (
        ('dim',),
        ('parent', 'name')),
    "models.layers.Conv1D": (
        ('in_dim', 'dim', 'use_bias', 'activation'),
        ('dim', 'use_bias', 'activation', 'parent', 'name')),
    "models.layers.DepthwiseSeparableConv": (
        ('dim', 'kernel_size'),
        ('dim', 'kernel_size', 'use_bias', 'activation', 'parent', 'name')),
    "models.layers.Bilinear": (
        ('dim',),
        ('dim', 'use_bias', 'parent', 'name')),
    "models.layers.DualMultiheadAttention": (
        ('dim', 'num_heads'),
        ('dim', 'num_heads', 'parent', 'name')),
    "models.layers.TrilinearAttention": (
        ('dim',),
        ('parent', 'name')),
    "models.layers.CQAttention": (
        ('dim',),
        ('dim', 'parent', 'name')),
    "models.layers.WeightedPooling": (
        ('dim',),
        ('parent', 'name')),
    "models.layers.CQConcat": (
        ('dim',),
        ('dim', 'parent', 'name')),
    "models.layers.MatchingHead": (
        ('dim', 'label_size', 'tau', 'gumbel'),
        ('label_size', 'tau', 'gumbel', 'parent', 'name')),
    "models.modules.WordEmbedding": (
        ('word_dim',),
        ('word_dim', 'parent', 'name')),
    "models.modules.CharEmbedding": (
        ('char_size', 'dim', 'kernels', 'filters'),
        ('char_size', 'dim', 'kernels', 'filters', 'parent', 'name')),
    "models.modules.PositionalEmbedding": (
        ('max_pos_len', 'dim'),
        ('max_pos_len', 'dim', 'parent', 'name')),
    "models.modules.ConvBlock": (
        ('dim', 'kernel_size', 'num_layers'),
        ('dim', 'kernel_size', 'num_layers', 'parent', 'name')),
    "models.modules.DualAttnBlock": (
        ('dim', 'num_heads'),
        ('dim', 'num_heads', 'parent', 'name')),
    "models.modules.TopSelfAttention": (
        ('dim', 'num_heads'),
        ('dim', 'num_heads', 'parent', 'name')),
    "models.modules.FeatureEncoder": (
        ('dim', 'num_heads', 'max_pos_len'),
        ('dim', 'num_heads', 'max_pos_len', 'parent', 'name')),
    "models.modules.ConditionedPredictor": (
        ('dim', 'num_heads', 'max_pos_len'),
        ('dim', 'num_heads', 'max_pos_len', 'parent', 'name')),
    "models.seqpan.SeqPAN": (
        ('vdim', 'dim', 'num_heads', 'attn_layer', 'max_vlen', 'word_dim',
        'char_dim', 'num_chars', 'tau', 'use_gumbel', 'span_decode',
        'compute_dtype', 'generator'),
        ('dim', 'num_heads', 'attn_layer', 'max_vlen', 'word_dim', 'char_dim',
        'num_chars', 'tau', 'use_gumbel', 'compute_dtype', 'span_decode', 'parent',
        'name')),
    # the losses and the gather take this rank's rows of a global batch (data
    # parallelism)
    "models.layers.localizing_loss": (
        ('start_logits', 'end_logits', 'y1', 'y2', 'mask', 'rows'),
        ('start_logits', 'end_logits', 'y1', 'y2', 'mask')),
    "models.layers.alignment_loss": (
        ('tfeat', 'vfeat', 'tmask', 'vmask', 'inner_label', 'rows'),
        ('tfeat', 'vfeat', 'tmask', 'vmask', 'inner_label')),
    "models.seqpan.seqpan_loss": (
        ('outputs', 'batch', 'match_lambda', 'rows'),
        ('outputs', 'batch', 'match_lambda')),
    "runtime.steps.gather_batch": (
        ('data', 'sel', 'with_labels', 'rows'),
        ('data', 'sel', 'with_labels')),
    # the torch model holds its parameters and the optimizer its state
    "ops.optim.count_params": (
        ('model',),
        ('params',)),
    "ops.optim.make_optimizer": (
        ('model', 'clip_norm', 'weight_decay'),
        ('clip_norm', 'weight_decay')),
    "runtime.trainer.TrainState": (
        ('opt', 'step', 'best_r1i7', 'epoch'),
        ('params', 'opt_state', 'step', 'best_r1i7', 'epoch')),
    # only rank 0 writes the log file
    "runtime.logger.get_logger": (
        ('log_dir', 'tag', 'to_file'),
        ('log_dir', 'tag')),
    # the port writes a best.npz file, the JAX package an Orbax directory
    "utils.tf1_port.port_checkpoint": (
        ('ckpt_prefix', 'out'),
        ('ckpt_prefix', 'out_dir')),
}


def _pairs(module: str) -> dict[str, tuple[tuple, tuple]]:
    """Public functions and classes defined in both ``hual_tpu_torch.
    <module>`` and ``hual_tpu.<module>``: name -> their parameter names."""
    port = importlib.import_module(f"hual_tpu_torch.{module}")
    ref = importlib.import_module(f"hual_tpu.{module}")
    out = {}
    for name, obj in vars(port).items():
        other = getattr(ref, name, None)
        if (name.startswith("_") or other is None
                or not all(inspect.isfunction(o) or inspect.isclass(o)
                           for o in (obj, other))
                or obj.__module__ != port.__name__
                or other.__module__ != ref.__name__):
            continue
        try:
            sigs = [tuple(inspect.signature(o).parameters) for o in (obj, other)]
        except (TypeError, ValueError):  # a class without a signature
            continue
        out[name] = tuple(sigs)
    return out


@pytest.mark.parametrize("module", MODULES)
def test_signatures_match_jax(module):
    pairs = _pairs(module)
    assert pairs, f"{module}: no public pair left"
    for name, (port, ref) in pairs.items():
        key = f"{module}.{name}"
        if key in RECORDED:
            assert (port, ref) == RECORDED[key], f"{key}: the recorded difference changed"
        else:
            assert port == ref, f"{key}: port {port} vs hual_tpu {ref}"
    stale = [k for k in RECORDED if k.rsplit(".", 1)[0] == module
             and k.rsplit(".", 1)[1] not in pairs]
    assert not stale, f"recorded but gone: {stale}"


def test_signature_modules_cover_the_port():
    """Every module of the port whose counterpart shares a public name is
    in MODULES, and every recorded pair's module is."""
    found = []
    for info in pkgutil.walk_packages(hual_tpu_torch.__path__, "hual_tpu_torch."):
        module = info.name[len("hual_tpu_torch."):]
        try:
            importlib.import_module(f"hual_tpu.{module}")
        except ModuleNotFoundError:
            continue
        if _pairs(module):
            found.append(module)
    assert found == MODULES
    assert {k.rsplit(".", 1)[0] for k in RECORDED} <= set(MODULES)


@pytest.mark.parametrize("via", ["argument", "environment"])
def test_trace_writes_a_profile(tmp_path, monkeypatch, via):
    """On the parent ``trace`` took no directory and never read the
    variable: no file was written."""
    monkeypatch.delenv("HUAL_PROFILE_DIR", raising=False)
    out = tmp_path / "prof"
    if via == "argument":
        scope = observability.trace("probe_scope", str(out))
    else:
        monkeypatch.setenv("HUAL_PROFILE_DIR", str(out))
        scope = observability.trace("probe_scope")
    with scope:
        x = np.arange(16.0)
        (x * 2).sum()
    files = glob.glob(str(out / "probe_scope-*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "probe_scope" for e in events)


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("HUAL_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with observability.trace("quiet_scope"):
        pass
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("seed,max_pos_len,scope", [(0, 64, "train"), (1, 3, "test")])
def test_dataset_gen_takes_scope_positionally(seed, max_pos_len, scope):
    recs, lens, wd, cd = _records(np.random.default_rng(seed), 12, active=False)
    got = datasets.dataset_gen(recs, lens, wd, cd, max_pos_len, scope)
    assert got == jax_datasets.dataset_gen(recs, lens, wd, cd, max_pos_len, scope)


@pytest.mark.parametrize("pretty", [True, False])
def test_save_json_pretty_matches_jax(tmp_path, pretty):
    data = {"b": [1, 2.5, {"c": None}], "a": "ü", "n": [[0.1, 3], []]}
    io.save_json(data, str(tmp_path / "port.json"), pretty=pretty)
    jax_io.save_json(data, str(tmp_path / "jax.json"), pretty=pretty)
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert (b"\n    " in got) == pretty
    io.save_json(data, str(tmp_path / "positional.json"), pretty)
    assert (tmp_path / "positional.json").read_bytes() == got


def test_trainer_takes_mesh_fourth(tmp_path, monkeypatch):
    """``Trainer(c, d, f, mesh)`` binds ``mesh``, as ``hual_tpu``'s does;
    on the parent the mesh went to ``logger``."""
    from hual_tpu_torch.config import Config
    from hual_tpu_torch.data.datasets import gen_or_load_dataset
    from hual_tpu_torch.data.features import FeatureStore
    from hual_tpu_torch.parallel import make_mesh
    from hual_tpu_torch.runtime.trainer import Trainer

    root = str(tmp_path)
    make_dataset(root, task="charades", n_train=8, n_test=4, vdim=16,
                 max_raw_len=12, min_raw_len=6, seed=3)
    cfg = Config.from_dict({
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "train": {"epochs": 1, "batch_size": 4},
        "model": {"max_vlen": 8, "max_tlen": 6, "vdim": 16, "dim": 16,
                  "num_heads": 2, "word_dim": 300, "char_dim": 8,
                  "attn_layer": 1},
    })
    dataset = gen_or_load_dataset(cfg)
    store = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    mesh = make_mesh(device="cpu")
    bound = inspect.signature(Trainer).bind(cfg, dataset, store, mesh)
    assert bound.arguments["mesh"] is mesh and "logger" not in bound.arguments
    monkeypatch.chdir(root)             # the Trainer logs under ./logs
    tr = Trainer(cfg, dataset, store, mesh, device="cpu")
    assert isinstance(tr.logger, logging.Logger)
    assert tr.mesh is None        # the local mesh runs the unsharded path
    assert tr.device.type == "cpu"
