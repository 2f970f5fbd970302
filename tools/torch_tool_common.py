"""What the port's tools (``tools/torch_*.py``) share: the ``--device`` and
``--out`` flags, the card's name and power limit, the K1/K2 launch
counters, timing that ends on the device, a SeqPAN at Charades width with
seeded weights, a synthetic split on the device, the FLOPs of a call, the
card's peak rates and the guard on a share of them, and the JSON result.

The tools run on the card (``--device cuda``, the default) and raise
without one; ``--device cpu`` runs them on the CPU (the tests do), where
the kernel wrappers take their plain versions and launch nothing.
"""

from __future__ import annotations

import argparse
import json
import math
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
from hual_tpu_torch.ops.optim import make_optimizer  # noqa: E402
from hual_tpu_torch.runtime import graphs, steps  # noqa: E402

# the model section of configs/charades/SeqPAN.yaml
CHARADES = dict(vdim=1024, dim=128, num_heads=8, attn_layer=2, max_vlen=64,
                word_dim=300, char_dim=50)
# One H100 SXM's published dense peaks at 700 W: float32 outside the tensor
# cores (the port's f32 products run with TF32 off; K2's f64 sums run on
# the FP64 tensor cores, 67 TFLOP/s too) and bf16 on the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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
    """Mean ms of one call of ``fn`` over ``iters`` calls, after ``warmup``
    (at least 2).

    On the card: CUDA events around the calls, queued behind a device sleep
    three times as long as the host took to issue as many calls in the
    warm-up (the first call aside), so the card runs them back to back and
    the events time the device, not the host's launch rate.  The sleep
    lasts at most 1 s: the queue of pending launches is bounded and the
    host waits once it is full, so calls of thousands of eager kernels are
    timed at the host's issue rate however long the sleep.  On the CPU: the
    host clock after a synchronisation."""
    fn()                                  # the first call may build or allocate
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(warmup - 1):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3 / (warmup - 1)
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    probe = 10_000_000
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    sleep_ms = min(3.0 * issue_ms * iters + 5.0, 1000.0)
    torch.cuda._sleep(int(probe * sleep_ms / start.elapsed_time(end)))
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


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one call of ``fn``, counted by ``torch.utils.flop_counter.
    FlopCounterMode`` over the operators it runs (products and
    convolutions, forward and backward): the work, not the implementation.
    Give it an eager call: a graph replay and the ctypes kernels (K1, K2)
    are invisible to the counter, so a path that runs K2 is counted
    through the eager model's forward, which computes the same function."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def peak_share(name: str, flops: float, seconds: float, dtype: str) -> float:
    """The share of the card's peak (:data:`PEAK_FLOPS` of ``dtype``, the
    path's product precision) that ``flops`` done in ``seconds`` imply.
    Above 1 the measurement cannot be true (it did not wait for the
    device): raises ``SystemExit``, as ``bench.check_mfu`` does."""
    share = flops / seconds / PEAK_FLOPS[dtype] if seconds > 0 else math.inf
    if not math.isfinite(share) or share > 1.0:
        raise SystemExit(f"{name}: {flops:.4g} FLOPs in {seconds:.4g} s is a "
                         f"share {share:.3g} of the {dtype} peak, over 1: the "
                         "timing did not wait for the device")
    return share


def k2_flops(B: int, T: int, W: int, D: int = 128, attn_layer: int = 2) -> int:
    """FLOPs of K2's products (2 per multiply-add) at these shapes; the
    elementwise work (softmax, LN, gates) is left out, so the bound it
    gives is a lower bound."""
    def mm(rows, k, n):
        return 2 * rows * k * n

    def conv(rows):                     # 4 x (depthwise k=7 + pointwise)
        return 4 * (mm(rows, D, D) + 2 * 7 * rows * D)

    def attn(tq, tk):                   # q k^T and p v over all heads
        return 2 * mm(tq, D, tk)

    def dual(tq, tk):                   # 14 D x D products on `from` rows, 2 on `to`
        return 14 * mm(tq, D, D) + 2 * mm(tk, D, D) + attn(tq, tq) + attn(tq, tk)

    def cq(t1, t2):                     # trilinear, c2q, score_ @ score_t^T, q2c, dense
        return 2 * mm(t1, D, t2) + mm(t1, t2, t1) + mm(t1, t1, D) + mm(t1, 4 * D, D)

    fe = conv(T) + 3 * mm(T, D, D) + attn(T, T) + mm(T, D, D)
    per_sample = (conv(T) + conv(W) + attn_layer * (dual(T, W) + dual(W, T))
                  + cq(T, W) + cq(W, T) + mm(T, 2 * D, D) + mm(T, D, 4)
                  + mm(T, 4, D) + 2 * fe + 2 * mm(T, 2 * D, D) + 2 * mm(T, D, 1))
    return B * per_sample


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
    rows (vocab, 300): the JAX package's ``bench.build`` data.  The feature
    table (0.52 GB at 2,000 x 64 x 1,024) is drawn on ``device`` from a
    seeded generator; the small columns on the host."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, T // 2, n).astype(np.int32)
    features = torch.randn((n, T, vdim), device=device,
                           generator=torch.Generator(device=device).manual_seed(seed))
    data = {
        "feat_rows": np.arange(n, dtype=np.int32),
        "v_len": np.full(n, T, np.int32),
        "word_ids": rng.integers(1, vocab, size=(n, W)).astype(np.int32),
        "char_ids": rng.integers(0, chars, size=(n, W, C)).astype(np.int32),
        "duration": rng.uniform(15, 40, size=n).astype(np.float32),
        "s_ind": s,
        "e_ind": np.minimum(s + rng.integers(1, T // 2, n), T - 1).astype(np.int32),
    }
    word_vectors = rng.normal(size=(vocab, 300)).astype(np.float32)
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    return {"features": features, **data}, torch.from_numpy(word_vectors).to(device)


def train_step_call(model, data: dict, word_vectors: torch.Tensor,
                    batch_size: int) -> Callable[[], dict]:
    """A call of one eager train step (``runtime.steps.train_step`` at drop
    0.2, lr 1e-4, with its own BERT-AdamW) on the split's first
    ``batch_size`` samples: the step a tool times eagerly and the work
    ``count_flops`` counts for a train step."""
    device = word_vectors.device
    opt = make_optimizer(model, 1.0, 0.01)
    batch = steps.gather_batch(data, torch.arange(batch_size, device=device),
                               with_labels=True)
    gen = torch.Generator(device=device).manual_seed(0)
    return lambda: steps.train_step(model, opt, batch, word_vectors, 1e-4, gen,
                                    drop_rate=0.2)


class Loops:
    """The device-resident loops a tool times, as the Trainer runs them: on
    the card ``runtime/graphs.py``'s captured programs, replayed per batch;
    on the CPU ``runtime/steps.py``'s eager loops."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs = graphs.Graphs(device) if device.type == "cuda" else None

    def sweep(self, name: str, model, data: dict, sels: torch.Tensor,
              word_vectors: torch.Tensor, **kw):
        """The sweep ``name`` (``eval_sweep``, ``fused_infer_sweep``, ...)
        over the rows of ``sels`` (n_batches, B), every row valid."""
        if self.graphs is not None:
            return getattr(self.graphs, name)(model, data, sels, None,
                                              word_vectors, **kw)
        return getattr(steps, name)(model, steps.resident_batches(data, sels),
                                    word_vectors, **kw)

    def epoch(self, model, data: dict, word_vectors: torch.Tensor,
              batch_size: int, n_steps: int, seed: int = 7
              ) -> Callable[[], torch.Tensor]:
        """A call that runs one train epoch of ``n_steps`` full batches of a
        fixed shuffled order (the JAX tools' scanned epoch) at drop 0.2, lr
        1e-4, with a new BERT-AdamW over ``model``, and returns its losses on
        the device; each call draws new dropout masks."""
        opt = make_optimizer(model, 1.0, 0.01)
        n = int(data["feat_rows"].shape[0])
        order = torch.from_numpy(np.random.default_rng(seed).permutation(n)[
            :n_steps * batch_size]).to(self.device)
        calls = [0]

        def run() -> torch.Tensor:
            step0 = calls[0] * n_steps
            calls[0] += 1
            loop = steps if self.graphs is None else self.graphs
            return loop.train_epoch(model, opt, data, order, batch_size,
                                    word_vectors, 1e-4, seed, step0,
                                    drop_rate=0.2)[0]
        return run

    def close(self) -> None:
        if self.graphs is not None:
            self.graphs.close()


def write_result(path: str, result: dict) -> None:
    """Print the result (and the launches the tool caused) and write it."""
    result = {**result, "launches": launches()}
    print(json.dumps({"launches": result["launches"]}), flush=True)
    print(json.dumps(result, indent=1, default=float), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=float)
    print(f"wrote {path}", flush=True)
