"""What the benchmark takes from the port: its ``Trainer`` on the run's
inputs, and the K1/K2 launch counters."""

from __future__ import annotations

import copy
import logging
import os
import sys

import torch

from benchmark.data import Inputs
from hual_tpu_torch.config import Config
from hual_tpu_torch.ops.kernels import fused_forward as k2
from hual_tpu_torch.ops.kernels import span_decode as k1
from hual_tpu_torch.runtime.trainer import Trainer


def quiet_logger() -> logging.Logger:
    """The port's log lines at WARNING and above, on standard error."""
    log = logging.getLogger("benchmark.port")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("port %(levelname)s: %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.WARNING)
        log.propagate = False
    return log


def config(spec: dict, seed: int, workdir: str) -> Config:
    """The configuration's ``Config``, its random streams seeded with the
    run's seed and its checkpoints under the run's work directory."""
    d = copy.deepcopy(spec["config"])
    d.setdefault("train", {})["seed"] = seed
    d.setdefault("paths", {})["ckpt_dir"] = os.path.join(workdir, "ckpt")
    return Config.from_dict(d)


def trainer(spec: dict, seed: int, inputs: Inputs, flat: dict, workdir: str,
            device: torch.device) -> Trainer:
    """A resident ``Trainer`` on the run's inputs (the table handed in on
    the device), loaded with the run's weights."""
    tr = Trainer(config(spec, seed, workdir), inputs.dataset, inputs.store,
                 logger=quiet_logger(), device_features=(inputs.table, None), device=device)
    tr.load_params(flat)
    return tr


def launches() -> dict:
    """K1's and K2's launches so far (graph replays included)."""
    return {"span_decode": k1.span_decode.launches,
            "fused_forward": k2.fused_forward.launches,
            "fused_forward_bf16": k2.fused_forward.launches_bf16}
