"""The port's config schema loads what the JAX package's loads, and its
dict form round-trips through both packages."""

from __future__ import annotations

import os

import pytest

from hual_tpu.config import Config as JaxConfig
from hual_tpu_torch.config import (TORCH_MATMUL_PRECISION, Config,
                                   ModelConfig)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("task", ["charades", "anet"])
def test_yaml_loads_as_in_jax(task):
    path = os.path.join(ROOT, "configs", task, "SeqPAN.yaml")
    port, ref = Config.load(path), JaxConfig.load(path)
    assert port.to_dict() == ref.to_dict()
    assert JaxConfig.from_dict(port.to_dict()).to_dict() == ref.to_dict()
    assert port.eval_batch_size == ref.eval_batch_size
    assert port.model_dir() == ref.model_dir()
    assert (port.derive_round(2, "/data").to_dict()
            == ref.derive_round(2, "/data").to_dict())


def test_validation_matches_jax():
    for bad in ({"span_decode": "cuda"}, {"matmul_precision": "tf32"},
                {"feature_dtype": "bf32"}):
        with pytest.raises(ValueError):
            JaxConfig.from_dict({"model": bad})
        with pytest.raises(ValueError):
            Config.from_dict({"model": bad})
    assert ModelConfig(feature_dtype="i8").feature_dtype == "int8"
    assert set(TORCH_MATMUL_PRECISION.values()) == {"highest"}


@pytest.mark.parametrize("task", ["charades", "anet"])
def test_chip_smoke_widths_are_the_configs(task):
    """chip_smoke.py copies the model sections (the machine with the card
    may have no pyyaml); they must not drift from the YAML files."""
    import chip_smoke

    widths = chip_smoke.CHARADES if task == "charades" else chip_smoke.ANET
    path = os.path.join(ROOT, "configs", task, "SeqPAN.yaml")
    assert Config.from_dict({"model": widths}).model == Config.load(path).model


def test_bf16_compute_alias_is_accepted():
    assert ModelConfig(compute_dtype="bf16").compute_dtype == "bfloat16"
    assert (JaxConfig.from_dict({"model": {"compute_dtype": "bf16"}}).model
            .compute_dtype == Config.from_dict(
                {"model": {"compute_dtype": "bf16"}}).model.compute_dtype)
