"""What the port's tools (``tools/torch_*.py``) share: the ``--device`` and
``--out`` flags, the card's name and power limit, the K1/K2 launch
counters, timing that ends on the device, a SeqPAN at Charades width with
seeded weights, a synthetic split on the device, and the JSON result.

The tools run on the card (``--device cuda``, the default) and raise
without one; ``--device cpu`` runs them on the CPU (the tests do), where
the kernel wrappers take their plain versions and launch nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hual_tpu_torch.config import apply_matmul_precision, resolve_device  # noqa: E402
from hual_tpu_torch.models.seqpan import SeqPAN  # noqa: E402
from hual_tpu_torch.ops.kernels import fused_forward as k2  # noqa: E402
from hual_tpu_torch.ops.kernels import span_decode as k1  # noqa: E402

# the model section of configs/charades/SeqPAN.yaml
CHARADES = dict(vdim=1024, dim=128, num_heads=8, attn_layer=2, max_vlen=64,
                word_dim=300, char_dim=50)


def add_common_flags(parser: argparse.ArgumentParser, tool: str) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("--out", default=os.path.join(REPO, "results", f"torch_{tool}.json"),
                        help="the result's JSON file")


def device_of(name: str) -> torch.device:
    """The tool's device; on the card the port's full-fp32 matmuls."""
    device = resolve_device(name)
    if device.type == "cuda":
        apply_matmul_precision("default")
    return device


def device_info(device: torch.device) -> dict:
    """The device, and on the card its name and power limit as
    ``nvidia-smi`` prints them."""
    if device.type != "cuda":
        return {"device": str(device), "card": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return {"device": torch.cuda.get_device_name(device), "card": smi.splitlines()[0]}


def launches() -> dict:
    """K1's and K2's (f64 and bf16 products) launches since the reset."""
    return {"span_decode": k1.span_decode.launches,
            "fused_forward": k2.fused_forward.launches,
            "fused_forward_bf16": k2.fused_forward.launches_bf16}


def reset_launches() -> None:
    k1.span_decode.launches = k2.fused_forward.launches = 0
    k2.fused_forward.launches_bf16 = 0


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ms_per_call(fn: Callable[[], object], device: torch.device, iters: int,
                warmup: int = 3) -> float:
    """Mean ms of one call of ``fn`` over ``iters`` calls, after ``warmup``.

    On the card: CUDA events around the calls, queued behind a device sleep
    three times as long as the host takes to issue them, so the card runs
    them back to back and the events time the device, not the host's
    launch rate.  On the CPU: the host clock after a synchronisation."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    if device.type != "cuda":
        return host_ms / iters
    synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    probe = 10_000_000
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    torch.cuda._sleep(int(probe * (3.0 * host_ms + 5.0) / start.elapsed_time(end)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def seconds_per_call(fn: Callable[[], torch.Tensor], device: torch.device,
                     iters: int, warmup: int = 2) -> float:
    """Mean host seconds of one call of ``fn`` over ``iters`` calls; the
    clock stops at a synchronisation and a host fetch of the last output."""
    for _ in range(warmup):
        out = fn()
    out.cpu()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    value = out.reshape(-1)[:1].cpu()
    synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    if not bool(torch.isfinite(value.float()).all()):
        raise RuntimeError(f"a non-finite output: {value}")
    return dt


def seeded_model(device: torch.device, seed: int = 0, num_chars: int = 100,
                 span_decode: str = "pallas", **widths) -> SeqPAN:
    """SeqPAN at Charades width (``widths`` override it), weights from a
    seeded generator, on ``device`` in eval mode."""
    model = SeqPAN(**{**CHARADES, **widths}, num_chars=num_chars,
                   span_decode=span_decode)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def synthetic_split(device: torch.device, n: int, T: int, vdim: int,
                    W: int = 14, C: int = 12, vocab: int = 2000,
                    chars: int = 100, seed: int = 0) -> tuple[dict, torch.Tensor]:
    """A device-resident split of ``n`` samples (one video each, every clip
    valid) in the layout ``runtime.steps.gather_batch`` reads, and GloVe
    rows (vocab, 300): the JAX package's ``bench.build`` data."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, T // 2, n).astype(np.int32)
    data = {
        "features": rng.normal(size=(n, T, vdim)).astype(np.float32),
        "feat_rows": np.arange(n, dtype=np.int32),
        "v_len": np.full(n, T, np.int32),
        "word_ids": rng.integers(1, vocab, size=(n, W)).astype(np.int32),
        "char_ids": rng.integers(0, chars, size=(n, W, C)).astype(np.int32),
        "duration": rng.uniform(15, 40, size=n).astype(np.float32),
        "s_ind": s,
        "e_ind": np.minimum(s + rng.integers(1, T // 2, n), T - 1).astype(np.int32),
    }
    word_vectors = rng.normal(size=(vocab, 300)).astype(np.float32)
    return ({k: torch.from_numpy(v).to(device) for k, v in data.items()},
            torch.from_numpy(word_vectors).to(device))


def write_result(path: str, result: dict) -> None:
    """Print the result (and the launches the tool caused) and write it."""
    result = {**result, "launches": launches()}
    print(json.dumps({"launches": result["launches"]}), flush=True)
    print(json.dumps(result, indent=1, default=float), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=float)
    print(f"wrote {path}", flush=True)
