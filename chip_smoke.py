#!/usr/bin/env python3
"""Drive the PyTorch port (``hual_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports neither JAX nor ``hual_tpu``.  Phases, each printing one JSON
line; any failure exits non-zero before the last line:

1. environment: ``nvidia-smi`` name and power limit, torch / CUDA versions,
   the TF32 flags after the port pins full fp32;
2. build: every kernel of ``hual_tpu_torch/csrc`` compiled for sm_90a, one
   nvcc per source, all started together; ptxas's registers and spills per
   kernel (any spill fails), and the counts of DMMA (f64 tensor-core) and
   HMMA (bf16 tensor-core, K2's ``mxu_bf16`` path) instructions in K2's
   SASS by ``cuobjdump -sass`` (0 of either fails);
3. span_decode: the kernel against its plain PyTorch version on the card,
   at the main path's shapes and larger (up to T=128), with crafted rows
   (all-equal probabilities, ties, a suffix maximum in a later 32-position
   chunk than the start), indices exactly equal; CUDA-event
   times of both, their time inside kernels (torch.profiler) and the byte
   bound;
4. serve: a bundle of seeded random weights at Charades width
   (configs/charades/SeqPAN.yaml, span_decode: pallas) served by
   ``Predictor.from_bundle`` at batch 8, 32 and 96 over raw requests of
   24-120 clips; launch counts, indices against the plain decode on the card,
   logits against the CPU forward, requests/s and forward times; a
   torch.profiler breakdown of the batch-96 path by kernel, with the
   device's idle share; then one batch at ActivityNet width (T=100,
   char_dim 100);
5. sweep dataset: a synthetic dataset of Charades-STA's split sizes (3,720
   test queries over 1,334 videos, 12,408 train queries over 5,338 videos,
   raw lengths 24-120 clips, queries of 4-12 words from a 1,000-word
   vocabulary) written in the reference's file formats, its features built
   in memory into the port's FeatureStore (a 1.7 GB table on the card);
6. fused_forward: K2 against its plain version (in f64) on the card at
   (96,64), (8,64), (5,64) and (1,64) with the sweep's query length, at
   (32,100) and at (3,17,5), ragged in every tile dimension, with padded
   rows, a length-1 video and a one-word query:
   logits within rtol 1e-4 / atol 2e-4, match scores within atol 1e-5,
   K1's indices from both equal or a printed near-tie; the f32 plain
   version's own error; CUDA-event and in-kernel times, the plain version's
   time (f32) and the FLOP bound; threads and dynamic shared memory per
   block and workspace bytes per sample;
7. sweep_charades: Trainer.test() and Trainer.infer_trainset() at batch 96
   (span_decode: pallas) with sweep_backend flax and fused on seeded random
   weights at Charades width: R@1 and mIoU of both, the samples whose
   indices differ (near-ties only), K2 and K1 launches equal to the number
   of batches, wall time and samples/s, a torch.profiler breakdown of one
   test sweep per backend with the device's idle share, and the pickle's
   schema;
8. train_charades: on the same dataset and device table, (a) one train
   step at drop 0 on the card against the same step on the CPU, at
   Charades and at ActivityNet width: loss components, grads and parameter
   deltas within the CPU tests' bounds, K1's indices equal to the plain
   decode's; (b) ``Trainer.train()`` for 2 epochs (the reference's 50, cut)
   on the first 1,600 train queries (the full 776-step epoch is
   loop_charades's round) at batch 16, drop 0.2, ``span_decode: pallas``,
   ``sweep_backend: fused``: per epoch the train seconds, steps/s, samples/s, mean loss, test
   R@1/mIoU and the launches of K1 (one a train step and a test batch) and
   K2 (one a test batch); the loss must be finite and fall; (c) a
   torch.profiler breakdown of 20 train steps; (d) a resume check in a
   fresh process (``--resume-worker``) through ``cli.main`` with
   ``--deterministic``, on a synthetic set of 512 train queries at
   Charades width: an uninterrupted 2-epoch run, one stopped after epoch 0
   and its resume from ``state.pt``, bit-equal; and the ms of a train step
   with deterministic algorithms on and off; (e) the MC sweep at
   ``mc_droprate`` 0.5 with both backends, and live gumbel passes on a
   subset;
9. streaming_charades, the Trainer's last options on the same dataset:
   (a) the native loader: the 1,334 test-split videos written as raw
   ``.npy`` files (their raw lengths, 24-120 clips x 1024 f32) and read by
   ``FeatureStore.from_dir`` natively and through NumPy in turns, the tables
   bit-equal (it fails if the library does not build or load); (b) in a
   fresh deterministic process (``--streaming-worker``), on the resume
   check's 512-query set, 2 epochs and ``infer_trainset()`` at
   ``mc_droprate`` 0.5 resident against streamed, for an f32 table and an
   int8 one (auto mode, the budget under the table): params, ``best.npz``
   and the pickle bit-equal; (c) one epoch of the Train cell's 1,600
   queries resident and streamed in turns, and one streamed int8 epoch:
   ms a step, the upload's bytes and time a step, 20 streamed steps
   profiled, K1 once a step and a test batch, K2 never, and the fused ->
   flax warning; (d) the MC passes at ``mc_droprate`` 0.5 on 20 batches of
   96, folded and sequential in turns: clean logits within rtol 1e-4 / atol
   1e-5, spans equal or a printed near-tie, folded passes live; (e)
   ``Predictor.from_trainer`` on (c)'s streamed trainer and
   ``export_bundle(trainer)`` -> ``Predictor.from_bundle`` on 96 raw test
   requests: equal spans and logits, spans equal to the trainer's eval
   path;
10. bf16_charades, K2's ``mxu_bf16`` path and the bf16 options: (a) K2 with
   bf16 products against its plain version in f64 without rounding, at
   (96,64,13), (32,100,30) and (3,17,5): (B) |x - f64| <= 0.05 + 0.03 *
   max|f64| on logits and <= max(0.05, 1.5 x the plain bf16 version's own
   distance) on match scores, (S) rms(x - f64) /
   rms(plain bf16 - f64) in [0.5, 2], (R) rms(x - f64) > 100 * rms(K2 f32 -
   f64); times beside K2 f32's and the bf16 FLOP bound; (b) the test sweep
   and ``infer_trainset()`` with ``fused_mxu_bf16``: bf16 K2 launches equal
   the batches, R@1/mIoU and equal spans beside the f32 sweep's; (c) one
   epoch of ``Trainer.train()`` at ``compute_dtype: bfloat16`` on the train
   phase's 1,600 queries: the loss finite and falling, K1 once a step; (d)
   ``infer_trainset()`` at ``mc_droprate`` 0.5 with ``mc_dtype: bfloat16``
   over 20 batches of 96: clean outputs bit-equal to the f32 trainer's, MC
   logits finite and live;
11. loop_charades: the AL loop (``hual_tpu_torch.orchestrate``, ``cli``,
   ``active``), in the build directory: (a) ``update_labels`` on the sweep
   pickle at Charades-STA size (12,408 records; 6,204 selected, one oracle
   point each, positive iff inside the GT index span); (b)
   ``run_rounds(start_round=1, rounds=1)`` at Charades width, 1 epoch (the
   reference's 50, cut), on the train phase's table (the same tensor) and
   from its model's MC pickle: seconds of the update, train and infer
   stages, best R@1@0.7, K1 and K2 launches equal to the steps and batches
   run; (c) re0 train and infer through ``cli.main``, then
   ``orchestrate.main`` for 2 rounds on the dataset and schedule of
   ``tools/synthetic_quality_comparison.py``: round 1's old pseudo-mIoU
   0.5565 (the same dataset), each round's pseudo-mIoU inside
   ``hual_tpu``'s and the reference's seed band, launches equal to the
   epochs' steps and batches;
12. graphs_charades, the device-resident loops as captured CUDA graphs
   (``runtime/graphs.py``), which every resident Trainer above replays on
   the card: (a)-(c) in a fresh deterministic process (``--graphs-worker``)
   on the Sweep/Train cell's table, each Trainer graphed and, on the same
   weights, eager: (a) ``Trainer.train()`` for one epoch of 1,605 queries
   (100 replayed steps and a ragged eager one) at ``compute_dtype``
   float32 and bfloat16: params, optimizer moments, losses and IoUs
   bit-equal; (b) ``test()`` (flax, fused, ``fused_mxu_bf16``) and
   ``infer_trainset()`` at mc 0 and 0.5 (sequential, ``fold_mc``,
   ``mc_dtype: bfloat16``) on (a)'s weights: IoUs and pickles bit-equal;
   (c) a fused test sweep captured before the epoch and replayed after it
   equals the eager one (the pack is refreshed in place); then, outside
   deterministic mode on the Train cell: one graphed epoch, ms a step
   graphed and eager in turns, 20 graphed steps profiled (the host's launch
   calls and the device's idle share), each capture's seconds and pool
   bytes, the test sweep and the MC sweep at mc 0.5 (whole train split)
   graphed and eager in turns; K1 and K2 launches equal to the steps and
   batches replayed in every run;
13. parallel_charades, data parallelism (``hual_tpu_torch.parallel``) on
   the Sweep/Train cell's table: (a) in a fresh deterministic process
   (``--parallel-worker <dir> 1 0``), world 1 over NCCL (``file://``
   rendezvous): a Trainer with a mesh on the one-rank group against the
   unsharded Trainer, one epoch of 1,605 queries (100 replayed steps and a
   ragged one), graphs captured with the collectives inside: params,
   losses, IoUs and test IoUs bit-equal; the fused and flax test sweeps and
   the MC sweep at mc 0.5 over 20 batches of 96, bit-equal; ms a graphed
   step sharded and unsharded in turns and 20 sharded steps profiled (NCCL
   kernels); then world 2's workload at world 1, its reference, with a
   float-noise control (the weights scaled by 1 + 1e-7 N(0, 1)); (b) two
   processes at once (``--parallel-worker <dir> 2 <rank>``), world 2 over
   gloo on the one card, deterministic: each rank's table bytes on the
   device (ceil(6672 / 2) x 64 x 1024 x 4), one step and 21 steps (a ragged
   batch of 5, whole on each rank) eager, the fused test sweep in f32 and
   with ``fused_mxu_bf16`` and the MC sweep over 10 batches on (a)'s
   weights; held against (a): one step within the CPU tests' bounds, 21
   steps within 10x the control's distance, K2's bounds on the test
   sweep's logits (spans equal or a printed near-tie), (B)'s band on the
   bf16 sweep, the MC passes within K2's bound against the largest logit;
   K1 and K2 launched on both ranks, only rank 0 wrote the pickle;
14. migrate_charades, TF1 checkpoint migration (``utils/tf1_port.py``)
   with no TensorFlow: a seeded random model's params at Charades width
   written as a reference-named Saver checkpoint (V2 bundle, with the Adam
   slots, ``global_step`` and the GloVe table; ``tests/torch_tf1_bundle.py``)
   read back by the TF-free reader (and its crc check timed alone, in
   turns) and ported to ``best.npz`` (seconds of each); ``Trainer.restore``
   of it, the fused test sweep (K2 and K1), then ``export_bundle`` ->
   ``Predictor.from_bundle`` serving 96 raw test requests (K1): params,
   the sweep's logits, spans and match scores, the served spans and
   logits bit-equal to those of the same params loaded directly;
15. tools_charades: each of the five tools (``tools/torch_{bench_span_decode,
   bench_fused,bench_serve,validate_pipeline,full_loop_demo}.py``) in its own
   process at a cut (``tools_phase``): exit 0, its JSON's keys, K1 launched
   in each and K2 in the three with fused sweeps; their numbers;
16. kernels: one entry per ported kernel (K2's bf16 path apart) with its
   launches on the main paths and its check against the plain version; the
   seconds per phase.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
import pickle
import re
import shutil
import statistics
import string
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# imported before anything is printed: outside a checkout this fails at once
from hual_tpu_torch import cli, native, orchestrate
from hual_tpu_torch.active.engine import update_labels
from hual_tpu_torch.config import Config, apply_matmul_precision
from hual_tpu_torch.data.datasets import gen_or_load_dataset
from hual_tpu_torch.data.features import (FeatureStore, quantize_features,
                                          visual_feature_sampling)
from hual_tpu_torch.data.labels_device import make_span_labels_device
from hual_tpu_torch.data.loader import EvalLoader, TrainLoader
from hual_tpu_torch.data.vocab import PAD, UNK
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops import decode
from hual_tpu_torch.ops.fused_forward import (PackedWeights,
                                              forward_math, pack_weights)
from hual_tpu_torch.ops.kernels import build
from hual_tpu_torch.ops.kernels import fused_forward as k2
from hual_tpu_torch.ops.kernels import span_decode as k1
from hual_tpu_torch.ops.optim import make_optimizer
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.runtime.debug import enable_deterministic
from hual_tpu_torch.runtime.trainer import Trainer
from hual_tpu_torch.serve import Predictor, export_bundle, export_model_bundle
from hual_tpu_torch.utils.metrics import time_to_index_al
from hual_tpu_torch.utils.tf1_port import (crc32c, load_tf1_checkpoint,
                                           port_checkpoint, word_vectors_path)
from hual_tpu_torch.weights import _leaves, load_jax_params, to_jax_params

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
DEVICE = torch.device("cuda")

# model section of configs/charades/SeqPAN.yaml and configs/anet/SeqPAN.yaml
# (the machine with the card may have no pyyaml)
CHARADES = dict(name="SeqPAN", max_vlen=64, max_tlen=30, vdim=1024, dim=128,
                num_heads=8, word_dim=300, char_dim=50, attn_layer=2)
ANET = dict(CHARADES, max_vlen=100, char_dim=100)
SERVE_BATCHES = (8, 32, 96)
N_REQUESTS = 203            # ragged final chunk at every batch size
MAX_WLEN, MAX_CLEN = 30, 12
DECODE_SHAPES = ((8, 64), (32, 64), (96, 64), (32, 100), (96, 100), (256, 100),
                 (96, 128), (5, 33), (3, 1))   # the last two: a ragged block, T=1
MAIN_SHAPE = (96, 64)       # the span decode of one batch-96 Charades chunk
# NVIDIA's data-sheet peaks of the H100 SXM at 700 W: device memory bytes/s,
# fp32 FLOP/s outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
CARD: list[str] = []        # nvidia-smi's name and power limit, once known


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sleep_ms(cycles: int) -> float:
    """Device time of ``torch.cuda._sleep(cycles)`` by CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def device_times_ms(fn, per_round: int, rounds: int = 1,
                    warmup: int = 10) -> tuple[float, dict]:
    """Median device time of one call by CUDA events, and how the calls
    were queued.

    Each round queues ``per_round`` calls behind a device sleep three times
    as long as the host takes to queue them (measured first), so the card
    runs them back to back and the events time the device, not the host's
    launch rate. The card's launch queue is finite: a round that holds too
    many kernels blocks the host, and then ``queued_rounds`` falls short of
    ``rounds``.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    torch.cuda.synchronize()
    probe = 10_000_000
    cycles = int(probe * (3.0 * host_ms * per_round + 5.0) / sleep_ms(probe))
    times, queued_rounds = [], 0
    for _ in range(rounds):
        slept = torch.cuda.Event(enable_timing=True)
        woke = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(cycles)
        woke.record()
        t0 = time.perf_counter()
        events = []
        for _ in range(per_round):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in events]
        queued_rounds += queued_ms < slept.elapsed_time(woke)
    return statistics.median(times), {"calls": len(times), "rounds": rounds,
                                      "queued_rounds": queued_rounds,
                                      "host_ms_per_call": host_ms}


def launch_ms(profile: dict) -> tuple[float | None, float]:
    """(ms in the kernel per launch, launches captured per call) of the top
    kernel of a profile whose calls launch one kernel each.  The profiler
    may capture fewer launches than calls were made, so the time is taken
    per captured launch, not per call; it may also record none (PERF.md
    §7), and then the time is None: not measured."""
    if "top_kernels" not in profile:
        return None, 0.0
    k = profile["top_kernels"][0]
    return k["ms_per_call"] / k["launches_per_call"], k["launches_per_call"]


def device_profile(fn, calls: int = 3, top: int = 12, match: str = "") -> dict:
    """Device time by kernel over ``calls`` calls of ``fn`` (torch.profiler).

    The device's idle share is the part of the span from the first kernel's
    start to the last one's end in which no kernel ran (one stream, so
    kernels do not overlap).  ``match`` adds the time and launches of the
    kernels whose name holds it.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # record_function ranges (runtime/observability.trace) also appear on
    # the device's timeline; they are not kernels
    events = prof.events()
    ranges = {e.name for e in events if e.is_user_annotation}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in ranges]
    if not kernels:
        return {"device_time": "not measured: the profiler recorded no kernel"}
    # the host's launch calls (cudaLaunchKernel, cudaGraphLaunch, ...)
    host_launches: dict[str, float] = {}
    for e in events:
        if e.device_type != DeviceType.CUDA and e.name.startswith("cu") \
                and "Launch" in e.name:
            host_launches[e.name] = host_launches.get(e.name, 0) + 1 / calls
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    check(busy_us <= span_us * 1.001 + 1.0,
          f"profiler: {busy_us} us busy in a {span_us} us span (overlapping events)")
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    matched = {}
    if match:
        hits = [v for name, v in by_name.items() if match in name]
        us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
        matched = {"matched": {"name": match, "ms_per_call": us / calls / 1e3,
                               "launches_per_call": n / calls,
                               "busy_share": us / busy_us}}
    return {"calls": calls, "kernels_per_call": len(kernels) / calls, **matched,
            "host_launches_per_call": host_launches,
            "busy_ms_per_call": busy_us / calls / 1e3,
            "span_ms_per_call": span_us / calls / 1e3,
            "device_idle_share": 1.0 - busy_us / span_us if span_us else None,
            "top_kernels": [{"name": name[:80], "ms_per_call": us / calls / 1e3,
                             "launches_per_call": n / calls}
                            for name, (us, n) in ranked]}


def launch_counts() -> dict:
    """The kernels' launch counts: K1, K2's f64 and bf16 product paths."""
    return {"span_decode": k1.span_decode.launches,
            "fused_forward": k2.fused_forward.launches,
            "fused_forward_bf16": k2.fused_forward.launches_bf16}


def reset_launches() -> None:
    k1.span_decode.launches = k2.fused_forward.launches = 0
    k2.fused_forward.launches_bf16 = 0


# -- phase 1 ------------------------------------------------------------------
def environment() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    CARD.append(smi.splitlines()[0])
    apply_matmul_precision("default")
    emit({"env": {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda, "python": sys.version.split()[0],
                  "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                  "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                  "float32_matmul_precision":
                      torch.get_float32_matmul_precision()}})


# -- phase 2 ------------------------------------------------------------------
def ptxas_resources(log: str) -> dict:
    """Registers, stack and spill bytes of each kernel in nvcc's -Xptxas -v
    log (a function's properties count for the entry compiled before it)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {"registers": None, "stack_bytes": 0, "spill_bytes": 0}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                      r"stores, (\d+) bytes spill loads", line)):
            out[name]["stack_bytes"] += int(m[1])
            out[name]["spill_bytes"] += int(m[2]) + int(m[3])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m[1])
    return out


def sass_count(name: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of kernel library ``name``."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    n = 0
    for line in sass.splitlines():
        words = line.split("*/", 1)[1].split() if "*/" in line else []
        if words and words[0].startswith("@"):       # a predicate
            words = words[1:]
        n += bool(words) and words[0].split(".")[0] == opcode
    return n


def build_kernels() -> None:
    names = build.names()
    t0 = time.perf_counter()
    compiled = build.build(names)
    check(set(compiled) == set(names),
          f"kernels were not built from the sources: {sorted(compiled)} of {names}")
    resources = {n: ptxas_resources(c["log"]) for n, c in compiled.items()}
    for n, kernels in resources.items():
        check(kernels, f"{n}: no ptxas resource report")
        for k, r in kernels.items():
            check(r.get("spill_bytes", 0) == 0, f"{n}: ptxas spills in {k}: {r}")
    dmma = sass_count("fused_forward", "DMMA")
    check(dmma > 0, "K2's SASS holds no DMMA instruction")
    hmma = sass_count("fused_forward", "HMMA")
    check(hmma > 0, "K2's SASS holds no HMMA instruction (its mxu_bf16 path)")
    emit({"build": {"seconds": time.perf_counter() - t0, "compiled": compiled,
                    "ptxas": resources, "fused_forward_sass_dmma": dmma,
                    "fused_forward_sass_hmma": hmma,
                    "arch": build.ARCH, "nvcc_flags": list(build.NVCC_FLAGS),
                    "libraries": [os.path.relpath(build.library_path(n), ROOT)
                                  for n in names]}})
    return resources


# -- phase 3 ------------------------------------------------------------------
def decode_inputs(B: int, T: int, rng: np.random.Generator):
    sl = rng.normal(size=(B, T)).astype(np.float32)
    el = rng.normal(size=(B, T)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    if B >= 4 and T >= 8:
        lens[:4] = (1, 2, T, T)
        sl[2] = el[2] = 0.25                    # every position ties
        sl[3, 1:4] = sl[3].max() + 1.0          # tied start maxima
        el[3, 2:5] = el[3].max() + 1.0          # tied end maxima
    if B >= 6 and T >= 40:
        lens[4:6] = (T, T // 2 + 3)
        el[4] = -5.0                            # the start in chunk 0, the
        el[4, T - 2] = sl[4, 0] = 5.0           # suffix maximum in the last
        sl[5] = el[5] = -0.75                   # all-equal probabilities
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    dev = torch.device("cuda")
    return (torch.from_numpy(sl).to(dev), torch.from_numpy(el).to(dev),
            torch.from_numpy(mask).to(dev))


def decode_phase() -> dict:
    rng = np.random.default_rng(SEED)
    rows = []
    for B, T in DECODE_SHAPES:
        sl, el, mask = decode_inputs(B, T, rng)
        ks, ke = k1.span_decode(sl, el, mask)
        torch.cuda.synchronize()
        ps, pe = decode.span_decode(sl, el, mask)
        check(torch.equal(ks, ps) and torch.equal(ke, pe),
              f"span_decode kernel indices differ from the plain decode at {(B, T)}")
        if B >= 4 and T >= 8:
            check(ks[2].item() == 0 and ke[2].item() == 0 and ks[3].item() == 1
                  and ke[3].item() == 2, f"span_decode tie-break wrong at {(B, T)}")
        if B >= 6 and T >= 40:
            check((ks[4].item(), ke[4].item(), ks[5].item(), ke[5].item())
                  == (0, T - 2, 0, 0), f"span_decode crafted rows wrong at {(B, T)}")
        max_err = max((ks - ps).abs().max().item(), (ke - pe).abs().max().item())
        # least work: read three (B,T) arrays, write two (B,) ones; ~24 f32
        # operations per element in the O(T) form (masked softmax of both
        # rows, running maxima, products, argmax)
        n_bytes = 3 * B * T * 4 + 2 * B * 4
        n_ops = 24 * B * T
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_FLOPS * 1e3
        kernel = lambda: k1.span_decode(sl, el, mask)  # noqa: E731
        plain = lambda: decode.span_decode(sl, el, mask)  # noqa: E731
        # ~3 launch-queue entries a kernel call (2 events), ~22 a plain call
        ms, queue = device_times_ms(kernel, per_round=100)
        plain_ms, plain_queue = device_times_ms(plain, per_round=10, rounds=10)
        busy = device_profile(kernel, calls=100, top=1)
        plain_busy = device_profile(plain, calls=100, top=1)
        rows.append({
            "B": B, "T": T, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "us": ms * 1e3, "plain_us": plain_ms * 1e3,
            "busy_us": None if launch_ms(busy)[0] is None else launch_ms(busy)[0] * 1e3,
            "launches_captured_per_call": launch_ms(busy)[1],
            "plain_busy_us": plain_busy["busy_ms_per_call"] * 1e3,
            "plain_kernels_per_call": plain_busy["kernels_per_call"],
            "queue": queue, "plain_queue": plain_queue,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops})
    emit({"span_decode": {"exact": True, "shapes": rows,
                          "timing": "ms: median of 100 calls by CUDA events, queued "
                                    "behind device sleeps; busy_us: kernel time per "
                                    "captured launch; plain_busy_us: kernel time per "
                                    "call by torch.profiler over 100 calls"}})
    return next(r for r in rows if (r["B"], r["T"]) == MAIN_SHAPE)


# -- phase 4 ------------------------------------------------------------------
def synthetic_text(rng: np.random.Generator):
    letters = string.ascii_lowercase
    words: set[str] = set()
    while len(words) < 1000:
        n = int(rng.integers(3, 11))
        words.add("".join(rng.choice(list(letters), size=n)))
    vocab = sorted(words)
    word_dict = {w: i for i, w in enumerate([PAD, UNK] + vocab)}
    chars = list(letters + string.digits + ".,'-!?&:;()/\"")[:58]
    char_dict = {c: i for i, c in enumerate([PAD, UNK] + chars)}
    word_vectors = rng.normal(scale=0.3, size=(len(vocab), 300)).astype(np.float32)
    return vocab, word_dict, char_dict, word_vectors


def make_requests(rng, vocab, n: int, vdim: int, clips: tuple[int, int]):
    requests = []
    for i in range(n):
        n_clips = int(rng.integers(clips[0], clips[1] + 1))
        feats = np.abs(rng.normal(size=(n_clips, vdim))).astype(np.float32)
        words = list(rng.choice(vocab, size=int(rng.integers(4, 15))))
        if i % 5 == 0:
            words.insert(1, "qzxjv")             # out of vocabulary
        requests.append((feats, float(rng.uniform(10.0, 40.0)),
                         " ".join(words) + "."))
    return requests


def write_bundle(path: str, model_cfg: dict, span_decode: str, text) -> str:
    vocab, word_dict, char_dict, word_vectors = text
    config = Config.from_dict({"task": "charades", "model": dict(
        model_cfg, span_decode=span_decode, num_chars=len(char_dict),
        num_words=len(word_dict))})
    model = SeqPAN.from_config(config,
                               generator=torch.Generator().manual_seed(SEED))
    return export_model_bundle(model, path, config=config, word_dict=word_dict,
                               char_dict=char_dict, word_vectors=word_vectors,
                               max_wlen=MAX_WLEN, max_clen=MAX_CLEN)


def with_decode(src: str, dst: str, span_decode: str) -> str:
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "meta.json")) as f:
        meta = json.load(f)
    meta["config"]["model"]["span_decode"] = span_decode
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    return dst


def check_results(results, n: int, where: str) -> None:
    check(len(results) == n, f"{where}: {len(results)} results for {n} requests")
    for r in results:
        check(r["start_index"] <= r["end_index"] < r["v_len"],
              f"{where}: bad span {r}")
        check(0.0 < r["score"] <= 1.0 and math.isfinite(r["score"]),
              f"{where}: bad score {r}")


def forward_logits(pred, host_batch):
    batch = {k: torch.from_numpy(v).to(pred.device) for k, v in host_batch.items()}
    with torch.inference_mode():
        out = pred.model(batch, pred.word_vectors)
    return out["start_logits"].cpu(), out["end_logits"].cpu()


def serve_phase(workdir: str) -> int:
    rng = np.random.default_rng(SEED + 1)
    text = synthetic_text(rng)
    requests = make_requests(rng, text[0], N_REQUESTS, CHARADES["vdim"], (24, 120))
    bundle = write_bundle(os.path.join(workdir, "charades"), CHARADES, "pallas", text)
    plain_bundle = with_decode(bundle, os.path.join(workdir, "charades_xla"), "xla")
    cpu_results = Predictor.from_bundle(
        bundle, batch_size=max(SERVE_BATCHES), device="cpu").predict_batch(requests)

    main_launches, rows = 0, []
    for bs in SERVE_BATCHES:
        pred = Predictor.from_bundle(bundle, batch_size=bs)
        check(pred.device.type == "cuda" and pred.model.span_decode == "pallas",
              "the Predictor is not serving the kernel path on the card")
        pred.warmup()
        torch.cuda.synchronize()
        k1.span_decode.launches = 0                   # main path starts
        t0 = time.perf_counter()
        results = pred.predict_batch(requests)
        seconds = time.perf_counter() - t0
        launches = k1.span_decode.launches            # main path ends
        chunks = math.ceil(N_REQUESTS / bs)
        check(launches == chunks,
              f"batch {bs}: span_decode launched {launches} times for {chunks} chunks")
        main_launches += launches
        check_results(results, N_REQUESTS, f"charades batch {bs}")

        plain = Predictor.from_bundle(plain_bundle, batch_size=bs).predict_batch(requests)
        same = [(r["start_index"], r["end_index"]) == (p["start_index"], p["end_index"])
                for r, p in zip(results, plain)]
        check(all(same), f"batch {bs}: kernel and plain decode disagree on the card "
                         f"for {same.count(False)} requests")

        host_batch = pred.encode_batch(requests[:bs])
        card_s, card_e = forward_logits(pred, host_batch)
        cpu_s, cpu_e = forward_logits(
            Predictor.from_bundle(bundle, batch_size=bs, device="cpu"), host_batch)
        logit_err = max((card_s - cpu_s).abs().max().item(),
                        (card_e - cpu_e).abs().max().item())
        check(torch.allclose(card_s, cpu_s, rtol=1e-4, atol=2e-4)
              and torch.allclose(card_e, cpu_e, rtol=1e-4, atol=2e-4),
              f"batch {bs}: card logits differ from the CPU forward by {logit_err}")

        agree = sum((r["start_index"], r["end_index"]) == (c["start_index"], c["end_index"])
                    for r, c in zip(results, cpu_results))
        batch = {k: torch.from_numpy(v).to(pred.device) for k, v in host_batch.items()}
        with torch.inference_mode():
            forward = lambda: pred.model(batch, pred.word_vectors)  # noqa: E731
            # ~900 kernels a forward: one forward per round
            fwd_ms, fwd_queue = device_times_ms(forward, per_round=1, rounds=20,
                                                warmup=5)
            fwd_busy = device_profile(forward, calls=3, top=0)
        t0 = time.perf_counter()
        for lo in range(0, N_REQUESTS, bs):
            pred.encode_batch(requests[lo:lo + bs])
        encode_seconds = time.perf_counter() - t0
        rows.append({"batch_size": bs, "chunks": chunks, "span_decode_launches": launches,
                     "requests_per_s": N_REQUESTS / seconds, "seconds": seconds,
                     "host_encode_seconds": encode_seconds,
                     "forward_ms": fwd_ms, "forward_queue": fwd_queue,
                     "forward_busy_ms": fwd_busy["busy_ms_per_call"],
                     "forward_kernels": fwd_busy["kernels_per_call"],
                     "forward_device_idle_share": fwd_busy["device_idle_share"],
                     "max_logit_err_vs_cpu": logit_err,
                     "indices_equal_plain_decode_on_card": True,
                     "indices_agree_with_cpu": f"{agree}/{N_REQUESTS}"})
    emit({"serve_charades": {"requests": N_REQUESTS, "raw_clips": [24, 120],
                             "rows": rows,
                             "cpu_agreement_note": "CPU and card sum in other "
                             "orders; a near-tie can decode differently"}})
    # the last Predictor serves the largest batch; `batch` is its first chunk
    chunk = requests[:pred.batch_size]
    with torch.inference_mode():
        forward_profile = device_profile(lambda: pred.model(batch, pred.word_vectors))
    emit({"serve_profile": {
        "batch_size": pred.batch_size,
        "predict_batch": device_profile(lambda: pred.predict_batch(chunk)),
        "forward": forward_profile,
        "note": "predict_batch includes host encoding; forward is SeqPAN on "
                "a batch already on the card"}})

    # ActivityNet width: span_decode at T=100
    bundle = write_bundle(os.path.join(workdir, "anet"), ANET, "pallas", text)
    anet_requests = make_requests(rng, text[0], 40, ANET["vdim"], (50, 300))
    pred = Predictor.from_bundle(bundle, batch_size=32)
    k1.span_decode.launches = 0
    results = pred.predict_batch(anet_requests)
    launches = k1.span_decode.launches
    check(launches == 2, f"anet: span_decode launched {launches} times for 2 chunks")
    check_results(results, len(anet_requests), "anet")
    plain = Predictor.from_bundle(
        with_decode(bundle, os.path.join(workdir, "anet_xla"), "xla"),
        batch_size=32).predict_batch(anet_requests)
    check(all((r["start_index"], r["end_index"]) == (p["start_index"], p["end_index"])
              for r, p in zip(results, plain)), "anet: kernel and plain decode disagree")
    emit({"serve_anet": {"requests": len(anet_requests), "batch_size": 32, "T": 100,
                         "span_decode_launches": launches,
                         "max_v_len": max(r["v_len"] for r in results)}})
    return main_launches


# -- phase 5 ------------------------------------------------------------------
# Charades-STA's split sizes: queries over videos
CHARADES_STA = {"train": (12408, 5338), "test": (3720, 1334)}


def sweep_dataset(workdir: str, rng: np.random.Generator):
    """A synthetic Charades-STA-sized dataset in the reference's file formats
    (records JSON, feature_shapes.json, a GloVe text file), its features
    built in memory into the port's FeatureStore.  Returns (config, store,
    dataset dict)."""
    root = os.path.join(workdir, "sweep")
    data_dir = os.path.join(root, "data", "charades_re0")
    feat_dir = os.path.join(root, "data", "features", "charades_i3d")
    os.makedirs(data_dir)
    os.makedirs(feat_dir)
    vocab = synthetic_text(rng)[0]
    glove_path = os.path.join(root, "glove.txt")
    with open(glove_path, "w") as f:
        for w in vocab + ["."]:
            vec = rng.normal(scale=0.3, size=CHARADES["word_dim"])
            f.write(w + " " + " ".join(f"{x:.4f}" for x in vec) + "\n")
    features, shapes = {}, {}
    for split, (n_queries, n_videos) in CHARADES_STA.items():
        vids = [f"{split}{i:05d}" for i in range(n_videos)]
        durations = {}
        for vid in vids:                # raw lengths 24-120: downsampling runs
            raw = rng.standard_normal((int(rng.integers(24, 121)), CHARADES["vdim"]),
                                      dtype=np.float32)
            features[vid] = visual_feature_sampling(raw, CHARADES["max_vlen"])
            shapes[vid] = raw.shape[0]
            durations[vid] = round(float(rng.uniform(10.0, 40.0)), 2)
        # every video gets a query, the rest go to random videos
        owners = vids + list(rng.choice(vids, size=n_queries - n_videos))
        records = []
        for vid in (owners[i] for i in rng.permutation(n_queries)):
            dur = durations[vid]
            span = float(rng.uniform(0.1, 0.6)) * dur
            s_time = float(rng.uniform(0.0, dur - span))
            words = rng.choice(vocab, size=int(rng.integers(4, 13)))
            records.append([vid, dur, [round(s_time, 2), round(s_time + span, 2)],
                            " ".join(words) + "."])
        with open(os.path.join(data_dir, f"{split}.json"), "w") as f:
            json.dump(records, f)
    with open(os.path.join(feat_dir, "feature_shapes.json"), "w") as f:
        json.dump(shapes, f)
    config = Config.from_dict({
        "task": "charades", "suffix": "re0",
        "paths": {"cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": feat_dir, "glove_path": glove_path,
                  "train_path": os.path.join(data_dir, "train.json"),
                  "test_path": os.path.join(data_dir, "test.json")},
        "train": {"batch_size": 16, "seed": SEED},
        "model": dict(CHARADES, span_decode="pallas")})
    store = FeatureStore(features, CHARADES["max_vlen"])
    return config, store, gen_or_load_dataset(config)


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


def span_probs(start_logits, end_logits, mask, spans) -> np.ndarray:
    """p(s, e) = softmax(start)[s] * softmax(end)[e] of each row's span, f64."""
    sl = np.where(mask > 0, start_logits.astype(np.float64), -np.inf)
    el = np.where(mask > 0, end_logits.astype(np.float64), -np.inf)
    sp = np.exp(sl - sl.max(1, keepdims=True))
    ep = np.exp(el - el.max(1, keepdims=True))
    sp /= sp.sum(1, keepdims=True)
    ep /= ep.sum(1, keepdims=True)
    rows = np.arange(len(spans))
    return sp[rows, spans[:, 0]] * ep[rows, spans[:, 1]]


def near_ties(logits, mask, spans_a, spans_b) -> list[dict]:
    """Rows whose two spans differ; raises unless the two spans'
    probabilities (under ``logits``) lie within 1e-6 of each other."""
    rows = np.nonzero((spans_a != spans_b).any(axis=1))[0]
    out = []
    if len(rows):
        pa = span_probs(logits[0][rows], logits[1][rows], mask[rows], spans_a[rows])
        pb = span_probs(logits[0][rows], logits[1][rows], mask[rows], spans_b[rows])
        for r, a, b in zip(rows, pa, pb):
            out.append({"row": int(r), "spans": [spans_a[r].tolist(), spans_b[r].tolist()],
                        "probs": [float(a), float(b)]})
            check(abs(a - b) <= 1e-6, f"spans differ beyond a near-tie: {out[-1]}")
    return out


def k2_inputs(B: int, T: int, W: int, rng: np.random.Generator):
    v_len = rng.integers(1, T + 1, B)
    q_len = rng.integers(1, W + 1, B)
    v_len[0] = 1                         # a length-1 video
    q_len[min(1, B - 1)] = 1             # a query of one valid word
    if B > 2:
        v_len[2], q_len[2] = T, W
    vf = rng.normal(size=(B, T, CHARADES["dim"])).astype(np.float32)
    qf = rng.normal(size=(B, W, CHARADES["dim"])).astype(np.float32)
    vm = (np.arange(T)[None] < v_len[:, None]).astype(np.int32)
    qm = (np.arange(W)[None] < q_len[:, None]).astype(np.int32)
    return [torch.from_numpy(a).to(DEVICE) for a in (vf, qf, vm, qm)]


def k2_packs() -> dict[int, PackedWeights]:
    """K2's packed weights of seeded random models at Charades width, T=64
    and T=100."""
    packs = {}
    for T in (64, 100):
        model = SeqPAN(**{k: v for k, v in CHARADES.items() if k not in ("name", "max_tlen")}
                       | {"max_vlen": T, "num_chars": 60},
                       generator=torch.Generator().manual_seed(SEED)).to(DEVICE).eval()
        packs[T] = pack_weights(model)
    return packs


def fused_forward_phase(W: int) -> dict:
    """K2 against its plain version on the card at the sweep's shapes."""
    rng = np.random.default_rng(SEED + 2)
    # at ActivityNet width the queries take the serve phase's word bound;
    # (3,17,5) is ragged in every tile dimension (weights of the T=64 model)
    shapes = ((96, 64, W), (8, 64, W), (5, 64, W), (1, 64, W), (32, 100, MAX_WLEN),
              (3, 17, 5))
    packs = k2_packs()
    kw = dict(attn_layer=CHARADES["attn_layer"], num_heads=CHARADES["num_heads"],
              tau=0.3, use_gumbel=False)
    check(k2._library().fused_forward_max_len() == k2.MAX_LEN
          and k2._library().fused_forward_max_dim() == k2.MAX_DIM,
          "the wrapper's shape limit differs from the kernel's")
    rows = []
    dims = (CHARADES["dim"], CHARADES["num_heads"])
    for B, T, Wq in shapes:
        packed = packs[64 if T <= 64 else 100]
        args = k2_inputs(B, T, Wq, rng)
        got = k2.fused_forward(packed, *args, **kw)
        torch.cuda.synchronize()
        # the plain version in f64 is the reference; in f32 it is itself
        # ~1e-5 off on the match scores at B=96, which the row reports
        ref = forward_math(PackedWeights(packed.buffer.double(), packed.layout,
                                         packed.attn_layer),
                           *(a.double() if a.is_floating_point() else a for a in args),
                           **kw)
        plain32 = forward_math(packed, *args, **kw)

        def err(outs, i):
            return (outs[i].double() - ref[i]).abs().max().item()

        logit_err, ms_err = max(err(got, 0), err(got, 1)), err(got, 2)
        check(all(torch.allclose(got[i].double(), ref[i], rtol=1e-4, atol=2e-4)
                  for i in (0, 1)),
              f"K2 logits differ from the plain version at {(B, T, Wq)}: {logit_err}")
        check(ms_err <= 1e-5, f"K2 match scores differ at {(B, T, Wq)}: {ms_err}")
        vm = args[2]
        ref32 = [r.float() for r in ref]
        spans = [torch.stack(k1.span_decode(s, e, vm), 1).cpu().numpy()
                 for s, e in (got[:2], ref32[:2])]
        ties = near_ties([ref32[0].cpu().numpy(), ref32[1].cpu().numpy()],
                         vm.cpu().numpy(), spans[0], spans[1])
        kernel = lambda: k2.fused_forward(packed, *args, **kw)  # noqa: E731
        plain = lambda: forward_math(packed, *args, **kw)  # noqa: E731
        ms, queue = device_times_ms(kernel, per_round=20, warmup=3)
        plain_ms, plain_queue = device_times_ms(plain, per_round=1, rounds=10, warmup=3)
        busy = device_profile(kernel, calls=10, top=1)
        plain_busy = device_profile(plain, calls=2, top=0)
        flops = k2_flops(B, T, Wq)
        n_bytes = (packed.buffer.numel() * 4 + sum(a.numel() * 4 for a in args)
                   + B * T * 6 * 4)
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        rows.append({"B": B, "T": T, "W": Wq, "max_abs_err": logit_err,
                     "match_scores_max_abs_err": ms_err, "near_ties": ties,
                     "plain_f32_max_abs_err": max(err(plain32, 0), err(plain32, 1)),
                     "plain_f32_match_scores_max_abs_err": err(plain32, 2),
                     "ms": ms, "busy_ms": launch_ms(busy)[0],
                     "launches_captured_per_call": launch_ms(busy)[1],
                     "plain_ms": plain_ms, "plain_busy_ms": plain_busy["busy_ms_per_call"],
                     "plain_kernels_per_call": plain_busy["kernels_per_call"],
                     "queue": queue, "plain_queue": plain_queue,
                     "flops": flops, "bytes": n_bytes,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "gflops_per_s": flops / (ms * 1e-3) / 1e9,
                     "threads_per_block": k2.threads_per_block(),
                     "smem_bytes_per_block": k2.smem_bytes(T, Wq, *dims),
                     "heads_per_group": k2.heads_per_group(T, Wq, *dims),
                     "workspace_bytes_per_sample":
                         4 * k2.workspace_floats(T, Wq, CHARADES["dim"],
                                                 CHARADES["num_heads"])})
    emit({"fused_forward": {
        "shapes": rows, "max_len": k2.MAX_LEN, "max_dim": k2.MAX_DIM,
        "reference": "errors against the plain version in f64 on the card; "
                     "plain_ms times it in f32",
        "timing": "ms: median of 20 calls by CUDA events, queued behind a device "
                  "sleep; busy_ms: kernel time per captured launch by "
                  "torch.profiler; plain_busy_ms: kernel time per call; the "
                  "bound counts products only"}})
    return rows[0]


def pickle_schema(path: str, n: int, T: int) -> dict:
    with open(path, "rb") as f:
        rows = pickle.load(f)
    check(len(rows) == n, f"pickle has {len(rows)} rows for {n} records")
    keys = ["vid", "duration", "psuedo_idx", "sentence", "v_len", "prop_idx",
            "prop_logits", "prop_logits1", "prop_logits2", "m_score"]
    for r in rows:
        check(list(r) == keys, f"pickle keys {list(r)}")
        check(isinstance(r["vid"], str) and isinstance(r["sentence"], str)
              and isinstance(r["duration"], float) and type(r["v_len"]) is int,
              f"pickle scalar types in {r['vid']}")
        check(all(type(i) is int for i in r["psuedo_idx"] + r["prop_idx"]),
              f"pickle index types in {r['vid']}")
        for k in ("prop_logits", "prop_logits1", "prop_logits2"):
            check(all(isinstance(a, np.ndarray) and a.dtype == np.float32
                      and a.shape == (T,) for a in r[k]), f"pickle {k} in {r['vid']}")
        check(r["m_score"].dtype == np.float32 and r["m_score"].shape == (T, 4),
              f"pickle m_score in {r['vid']}")
    return {"rows": n, "keys": keys, "logits": f"float32 ({T},)",
            "m_score": f"float32 ({T}, 4)"}


def sweep_phase(workdir: str, config, store, dataset) -> dict:
    """Trainer.test() and Trainer.infer_trainset() at batch 96 with both
    sweep backends; returns the fused run's launch counts."""
    quiet = logging.getLogger("chip_smoke.trainer")
    trainers = {}
    for backend in ("flax", "fused"):
        cfg = copy.deepcopy(config)
        cfg.train.sweep_backend = backend
        shared = trainers["flax"].export_device_features() if trainers else None
        tr = Trainer(cfg, dataset, store, logger=quiet, device_features=shared,
                     device=DEVICE)
        tr.init_state()
        tr.test()                                   # warm-up
        trainers[backend] = tr
    n_batches = {split: math.ceil(len(ds) / config.eval_batch_size)
                 for split, ds in (("test", trainers["flax"].test_set),
                                   ("train", trainers["flax"].train_set))}
    runs = {}
    for backend, tr in trainers.items():
        pkl = os.path.join(workdir, f"{backend}.pkl")
        reset_launches()   # main path starts
        t0 = time.perf_counter()
        test_m = tr.test()
        test_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        infer_m = tr.infer_trainset(save_path=pkl)
        infer_s = time.perf_counter() - t0
        launches = {"fused_forward": k2.fused_forward.launches,  # main path ends
                    "span_decode": k1.span_decode.launches}
        total = n_batches["test"] + n_batches["train"]
        want_k2 = total if backend == "fused" else 0
        check(launches == {"fused_forward": want_k2, "span_decode": total},
              f"{backend}: launches {launches}, batches {n_batches}")
        runs[backend] = {"test": test_m, "infer_trainset": infer_m,
                         "test_seconds": test_s, "infer_seconds": infer_s,
                         "test_samples_per_s": len(tr.test_set) / test_s,
                         "infer_samples_per_s": len(tr.train_set) / infer_s,
                         "launches": launches, "pickle": pkl}

    # per sample, both backends: indices and the plain (flax) logits
    diffs, outs = {}, {}
    for split in ("test", "train"):
        for backend, tr in trainers.items():
            data, ds = ((tr._test_data, tr.test_set) if split == "test"
                        else (tr._train_data, tr.train_set))
            pairs = list(EvalLoader(ds, config.eval_batch_size, pad_to_batch=True)
                         .index_iter())
            sels = torch.from_numpy(np.stack([sel for sel, _ in pairs])).to(DEVICE)
            sweep = steps.fused_infer_sweep if backend == "fused" else steps.infer_sweep
            o = sweep(tr.model, steps.resident_batches(data, sels, [n for _, n in pairs]),
                      tr.word_vectors)
            outs[split, backend] = {k: v.cpu().numpy() for k, v in o.items()}
        f, x = outs[split, "fused"], outs[split, "flax"]
        mask = (np.arange(CHARADES["max_vlen"])[None] < ds.v_len[:, None]).astype(np.int32)
        ties = near_ties([x["start_logits"], x["end_logits"]], mask,
                         np.stack([f["start_index"], f["end_index"]], 1),
                         np.stack([x["start_index"], x["end_index"]], 1))
        logit_err = float(max(np.abs(f[k] - x[k]).max() for k in ("start_logits", "end_logits")))
        diffs[split] = {"samples": len(ds), "indices_differ": len(ties), "near_ties": ties,
                        "max_logit_err_fused_vs_flax": logit_err}
        key = "test" if split == "test" else "infer_trainset"
        if not ties:
            check(runs["fused"][key] == runs["flax"][key],
                  f"{split}: metrics differ with equal indices: {runs['fused'][key]} "
                  f"vs {runs['flax'][key]}")
    for backend in trainers:
        with open(runs[backend]["pickle"], "rb") as fh:
            spans = [r["prop_idx"] for r in pickle.load(fh)]
        o = outs["train", backend]
        check(spans == np.stack([o["start_index"], o["end_index"]], 1).tolist(),
              f"{backend}: the pickle's spans differ from its sweep's")
    schema = pickle_schema(runs["fused"]["pickle"], len(trainers["fused"].train_set),
                           CHARADES["max_vlen"])
    profiles = {backend: device_profile(tr.test, calls=1, top=8)
                for backend, tr in trainers.items()}
    emit({"sweep_charades": {
        "splits": {s: {"queries": len(getattr(trainers["flax"], f"{s}_set")),
                       "videos": CHARADES_STA[s][1], "batches": n_batches[s]}
                   for s in ("test", "train")},
        "cut": "none", "batch_size": config.eval_batch_size,
        "max_wlen": dataset["max_wlen"],
        "table_gb": store.packed.nbytes / 1e9,
        "runs": runs, "backend_agreement": diffs, "pickle_schema": schema,
        "profile_test_sweep": profiles,
        "timing": "seconds: host clock around Trainer.test() / infer_trainset(), "
                  "each ending in a host fetch (infer_trainset includes writing "
                  "the pickle); profile: one test() sweep under torch.profiler"}})
    return runs["fused"]["launches"], trainers["flax"].export_device_features()


# -- phase 8 ------------------------------------------------------------------
# the train section of configs/charades/SeqPAN.yaml; 50 epochs cut to 2
TRAIN = dict(epochs=2, batch_size=16, lr=1e-4, droprate=0.2, clip_norm=1.0,
             weight_decay=0.01)
TRAIN_QUERIES, PROFILE_STEPS, GUMBEL_QUERIES = 1600, 20, 960


def train_config(config, ckpt_dir: str, **train):
    cfg = copy.deepcopy(config)
    for k, v in {**TRAIN, "sweep_backend": "fused", **train}.items():
        setattr(cfg.train, k, v)
    cfg.paths.ckpt_dir = ckpt_dir
    return cfg


def random_batch(rng, B: int, T: int, W: int, C: int, n_words: int, n_chars: int):
    """A labelled batch of random queries and features on the card."""
    v_len = rng.integers(1, T + 1, B).astype(np.int32)
    v_len[:2] = (1, T)
    q_len = rng.integers(1, W + 1, B)
    word_ids = np.where(np.arange(W)[None] < q_len[:, None],
                        rng.integers(1, n_words, (B, W)), 0).astype(np.int32)
    char_ids = rng.integers(1, n_chars, (B, W, C)).astype(np.int32)
    char_ids[word_ids == 0] = 0
    s = rng.integers(0, v_len).astype(np.int32)
    batch = {"video_features": rng.normal(size=(B, T, CHARADES["vdim"])).astype(np.float32),
             "video_seq_len": v_len, "word_ids": word_ids, "char_ids": char_ids,
             "s_ind": s, "e_ind": np.minimum(s + rng.integers(0, 12, B), v_len - 1),
             "duration": rng.uniform(10, 40, B).astype(np.float32)}
    batch = {k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in batch.items()}
    y1, y2, match, inner = make_span_labels_device(
        batch["s_ind"], batch["e_ind"], batch["video_seq_len"], T)
    batch.update(y1=y1, y2=y2, match_labels=match, inner_labels=inner)
    return batch


def step_against_cpu(widths: dict, batch: dict, word_vectors) -> dict:
    """One train step at drop 0 of the same weights on the card and on the
    CPU, held to tests/test_torch_train_step.py's bounds (card against CPU
    here): losses rtol 1e-5, clipped grads rtol 1e-3 / atol
    1e-6*max(1,max|g|), deltas rtol 2e-2 / atol 1e-5.  label_emb is moved
    off its orthogonal init, where the penalty's gradient is rounding noise."""
    gen = torch.Generator().manual_seed(SEED + 4)
    model = SeqPAN(**widths, span_decode="pallas", generator=gen)
    with torch.no_grad():
        model.label_emb.add_(0.1 * torch.randn(model.label_emb.shape, generator=gen))
    cpu = copy.deepcopy(model)
    card = model.to(DEVICE)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    with torch.no_grad():
        out = card(batch, word_vectors)
    plain = decode.span_decode(out["start_logits"], out["end_logits"], out["v_mask"])
    check(torch.equal(out["start_index"], plain[0]) and torch.equal(out["end_index"], plain[1]),
          f"train step at {widths['max_vlen']}: K1's indices differ from the plain decode")
    opts = {"card": make_optimizer(card, 1.0, 0.01), "cpu": make_optimizer(cpu, 1.0, 0.01)}
    before = {"card": to_jax_params(card), "cpu": to_jax_params(cpu)}
    k1.span_decode.launches = 0
    got = steps.train_step(card, opts["card"], batch, word_vectors, TRAIN["lr"],
                           torch.Generator(DEVICE), drop_rate=0.0)
    torch.cuda.synchronize()
    check(k1.span_decode.launches == 1,
          f"the train step launched K1 {k1.span_decode.launches} times")
    want = steps.train_step(cpu, opts["cpu"], cpu_batch, word_vectors.cpu(), TRAIN["lr"],
                            torch.Generator(), drop_rate=0.0)
    loss_err = max(abs(got[k].item() - want[k].item()) / abs(want[k].item())
                   for k in ("loc_loss", "match_loss", "align_loss", "loss"))
    check(loss_err <= 1e-5, f"train step losses: rel err {loss_err}")
    step_ious = steps.device_ious(out["start_index"], out["end_index"], batch["s_ind"],
                                  batch["e_ind"], batch["video_seq_len"], batch["duration"])
    check(torch.equal(got["ious"], step_ious), "the step's IoUs are not its decode's")
    grad_err = delta_err = 0.0
    to_jax = {key: move for key, _, _, move in _leaves(cpu)}
    for key, g_card, g_cpu in zip(opts["cpu"].keys, opts["card"].mu, opts["cpu"].mu):
        g, w = (to_jax[key](t.cpu().numpy()) / 0.1 for t in (g_card, g_cpu))
        bound = 1e-3 * np.abs(w) + 1e-6 * max(1.0, float(np.abs(w).max()))
        grad_err = max(grad_err, float((np.abs(g - w) / bound).max()))
    after = {"card": to_jax_params(card), "cpu": to_jax_params(cpu)}
    for key in after["cpu"]:
        d = after["card"][key] - before["card"][key]
        w = after["cpu"][key] - before["cpu"][key]
        delta_err = max(delta_err, float((np.abs(d - w) / (1e-5 + 2e-2 * np.abs(w))).max()))
    check(grad_err <= 1.0 and delta_err <= 1.0,
          f"train step at T={widths['max_vlen']}: grads {grad_err}, deltas {delta_err} "
          "of their bounds")
    return {"T": widths["max_vlen"], "char_dim": widths["char_dim"],
            "B": int(batch["word_ids"].shape[0]), "loss": got["loss"].item(),
            "loss_max_rel_err": loss_err, "grad_err_of_bound": grad_err,
            "delta_err_of_bound": delta_err, "k1_launches": 1,
            "ious_card_vs_cpu_equal": bool(torch.equal(got["ious"].cpu(), want["ious"]))}


class Stop(Exception):
    pass


# the resume check's synthetic set (tools/make_synthetic_data.py) at Charades
# width: 512 train queries (32 steps an epoch), 192 test queries
RESUME_DATA = dict(n_train=512, n_test=192, vdim=CHARADES["vdim"], max_raw_len=120,
                   min_raw_len=24, seed=SEED % 997)


def resume_set(workdir: str) -> str:
    """Write the resume check's set and its ``SeqPAN.yaml`` under
    ``workdir/resume``; returns that directory."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_synthetic_data import make_dataset

    root = os.path.join(workdir, "resume")
    make_dataset(root, task="charades", **RESUME_DATA)
    Config.from_dict({
        "task": "charades",
        "paths": {"ckpt_dir": "./ckpt", "cache_dir": "./data_pkl/",
                  "feature_path": "./data/features/charades_i3d",
                  "glove_path": "./data/glove/glove.840B.300d.txt",
                  "train_path": "./data/charades_gt/train.json",
                  "test_path": "./data/charades_gt/test.json"},
        "train": dict(TRAIN, sweep_backend="fused", save_state_every=1),
        "model": dict(CHARADES, span_decode="pallas")}).save(
            os.path.join(root, "SeqPAN.yaml"))
    return root


def resume_check(workdir: str) -> dict:
    """A resume through ``cli.main(["--deterministic", ...])`` in a fresh
    process (``--resume-worker``), where deterministic mode starts before
    CUDA does, as for a user: 2 epochs uninterrupted, 2 epochs stopped after
    epoch 0 and resumed from ``state.pt``; final params, best R@1@0.7 and
    best checkpoint must be bit-equal.  The worker also times a train step
    with deterministic algorithms on and off."""
    root = resume_set(workdir)
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume-worker",
                           root], capture_output=True, text=True, env=env, timeout=900)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"resume worker exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {**out, "data": RESUME_DATA, "seconds_process": seconds}


def resume_worker(root: str) -> None:
    """The resume check's process: three ``cli.main`` train runs with
    ``--deterministic`` in ``root``, then 20-step timings with deterministic
    algorithms on, off, off and on; prints one JSON line."""
    os.chdir(root)
    built, stop, resumed_at = [], [False], []
    real = cli.build_trainer

    def build(c, **kw):
        tr = real(c, **kw)
        load_state = tr.load_state

        def loaded(path):
            load_state(path)
            resumed_at.append([tr.state.epoch, tr.state.step])
        tr.load_state = loaded
        if stop[0]:                      # stop after epoch 0, as a preemption would
            train = tr.train

            def stopped(epoch_callback=None):
                def at(epoch, _):
                    if epoch == 0:
                        raise Stop
                return train(epoch_callback=at)
            tr.train = stopped
        built.append(tr)
        return tr

    cli.build_trainer = build
    args = ["--config", "SeqPAN.yaml", "--mode", "train", "--seed", str(SEED),
            "--deterministic"]
    t0 = time.perf_counter()
    check(cli.main(args + ["--suffix", "a"]) == 0, "resume: run a failed")
    check(torch.are_deterministic_algorithms_enabled()
          and os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8",
          "--deterministic did not set deterministic mode")
    a = built[-1]
    stop[0] = True
    try:
        cli.main(args + ["--suffix", "b"])
        check(False, "the stop after epoch 0 did not happen")
    except Stop:
        pass
    stop[0] = False
    state = os.path.join("ckpt", "charades_b", "state.pt")
    check(cli.main(args + ["--suffix", "b", "--checkpoint", state]) == 0,
          "resume: run c failed")
    c = built[-1]
    seconds = time.perf_counter() - t0
    pa, pc = a.model.state_dict(), c.model.state_dict()
    same = all(torch.equal(pa[k], pc[k]) for k in pa)
    with np.load(os.path.join("ckpt", "charades_a", "best.npz")) as fa, \
            np.load(os.path.join("ckpt", "charades_b", "best.npz")) as fc:
        same_best = set(fa) == set(fc) and all(np.array_equal(fa[k], fc[k]) for k in fa)
    check(same and same_best and a.state.best_r1i7 == c.state.best_r1i7
          and a.state.step == c.state.step,
          f"resume: params equal {same}, best checkpoint equal {same_best}, best "
          f"{a.state.best_r1i7} vs {c.state.best_r1i7}, step {a.state.step} vs {c.state.step}")

    # the cost of deterministic mode: ms a train step (B=16), on/off/off/on
    order = torch.randperm(len(a.train_set), generator=torch.Generator().manual_seed(SEED))
    sels = [order[i * 16:(i + 1) * 16].to(DEVICE) for i in range(PROFILE_STEPS + 1)]

    def step_ms() -> float:
        def one(i):
            b = steps.gather_batch(a._train_data, sels[i], with_labels=True)
            steps.train_step(a.model, a.state.opt, b, a.word_vectors, TRAIN["lr"],
                             steps.make_generator(DEVICE, SEED, i),
                             drop_rate=TRAIN["droprate"])
        one(PROFILE_STEPS)                              # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(PROFILE_STEPS):
            one(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / PROFILE_STEPS

    timing = {"deterministic": [], "default": []}
    for mode in ("deterministic", "default", "default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        timing[mode].append(step_ms())
    emit({"queries": len(a.train_set), "epochs": TRAIN["epochs"],
          "resumed_at_epoch_step": resumed_at[0],
          "steps": c.state.step, "best_r1i7": c.state.best_r1i7, "bit_equal": True,
          "seconds_three_runs": seconds,
          "deterministic": "cli.main --deterministic: CUBLAS_WORKSPACE_CONFIG="
                           + os.environ["CUBLAS_WORKSPACE_CONFIG"]
                           + " set before CUDA started, deterministic algorithms",
          "step_ms": timing,
          "step_ms_note": f"host clock over {PROFILE_STEPS} steps of B=16 ending in a "
                          "synchronize, in turns on/off/off/on; 'default' keeps "
                          "CUBLAS_WORKSPACE_CONFIG and turns the algorithms off"})


def mc_sweeps(workdir: str, config, dataset, store, table, flat) -> dict:
    """The AL sweep at mc_droprate 0.5, timed, with both backends; live
    gumbel passes on a subset."""
    out = {}
    for backend in ("flax", "fused"):
        cfg = train_config(config, "", sweep_backend=backend, mc_droprate=0.5)
        tr = Trainer(cfg, dataset, store, logger=logging.getLogger("chip_smoke.mc"),
                     device_features=table, device=DEVICE)
        tr.load_params(flat)
        pairs, sels = tr._sweep_sels("infer", tr.train_set, cfg.infer_batch_size)
        reset_launches()   # main path starts
        t0 = time.perf_counter()
        metrics = tr.infer_trainset(save_path=os.path.join(workdir, f"mc_{backend}.pkl"))
        seconds = time.perf_counter() - t0
        launches = {"fused_forward": k2.fused_forward.launches,  # main path ends
                    "span_decode": k1.span_decode.launches}
        n = len(pairs)
        check(launches == {"fused_forward": n if backend == "fused" else 0,
                           "span_decode": n},
              f"mc sweep {backend}: launches {launches} for {n} batches")
        sweep = steps.fused_infer_sweep if backend == "fused" else steps.infer_sweep
        part = sels[:8]
        clean = sweep(tr.model, steps.resident_batches(tr._train_data, part), tr.word_vectors)
        live = sweep(tr.model, steps.resident_batches(tr._train_data, part), tr.word_vectors,
                     0.5, cfg.train.seed)
        for k in ("start_logits", "end_logits", "match_scores", "start_index", "end_index"):
            check(torch.equal(live[k], clean[k]), f"mc sweep {backend}: the clean {k} moved")
        valid = (torch.arange(CHARADES["max_vlen"], device=DEVICE)
                 < tr._train_data["v_len"][part.reshape(-1)][:, None])
        share = {f"{a}_vs_{b}": float((live[a][valid] != live[b][valid]).float().mean())
                 for a, b in (("start_logits1", "start_logits"),
                              ("start_logits1", "start_logits2"),
                              ("end_logits2", "end_logits"))}
        check(min(share.values()) > 0.9, f"mc sweep {backend}: passes not live: {share}")
        out[backend] = {"batches": n, "launches": launches, "seconds": seconds,
                        "samples_per_s": len(tr.train_set) / seconds,
                        "infer_trainset": metrics, "logits_differ_share": share}
    # gumbel noise live at mc 0 on a subset
    sub = dict(dataset, train_set=dataset["train_set"][:GUMBEL_QUERIES])
    cfg = train_config(config, "")
    cfg.loss.no_gumbel = False
    tr = Trainer(cfg, sub, store, logger=logging.getLogger("chip_smoke.mc"),
                 device_features=table, device=DEVICE)
    tr.load_params(flat)
    pairs, sels = tr._sweep_sels("infer", tr.train_set, cfg.infer_batch_size)
    reset_launches()
    live = steps.fused_infer_sweep(tr.model, steps.resident_batches(tr._train_data, sels),
                                   tr.word_vectors, 0.0, cfg.train.seed)
    check(k2.fused_forward.launches == k1.span_decode.launches == len(pairs),
          "gumbel sweep launches")
    gumbel = {"queries": GUMBEL_QUERIES, "batches": len(pairs),
              "differ_share": float((live["start_logits1"] != live["start_logits2"])
                                    .float().mean()),
              "clean_differ_share": float((live["start_logits1"] != live["start_logits"])
                                          .float().mean())}
    check(gumbel["differ_share"] > 0.5 and gumbel["clean_differ_share"] > 0.5,
          f"gumbel passes not live: {gumbel}")
    out["gumbel_fused"] = gumbel
    return out


def train_phase(workdir: str, config, store, dataset, table) -> dict:
    """Phase 8; returns the launch counts of the train and MC paths."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)
    cfg = train_config(config, os.path.join(workdir, "ckpt"))
    probe = Trainer(cfg, dataset, store, logger=logging.getLogger("chip_smoke.train"),
                    device_features=table, device=DEVICE)
    sel = torch.from_numpy(rng.permutation(len(probe.train_set))[:TRAIN["batch_size"]]
                           .astype(np.int32)).to(DEVICE)
    batch = steps.gather_batch(probe._train_data, sel, with_labels=True)
    n_chars = dataset["n_chars"]
    widths = {k: v for k, v in CHARADES.items() if k not in ("name", "max_tlen")}
    widths["num_chars"] = n_chars
    step_rows = [step_against_cpu(widths, batch, probe.word_vectors)]
    anet_widths = {k: v for k, v in ANET.items() if k not in ("name", "max_tlen")}
    anet_widths["num_chars"] = n_chars
    anet = random_batch(rng, TRAIN["batch_size"], ANET["max_vlen"], MAX_WLEN, MAX_CLEN,
                        len(probe.word_vectors) + 2, n_chars)
    step_rows.append(step_against_cpu(anet_widths, anet, probe.word_vectors))
    del probe

    # (b) Trainer.train() for 2 epochs on a subset: loop_charades trains a
    # full-size epoch
    sub = dict(dataset, train_set=dataset["train_set"][:TRAIN_QUERIES])
    epochs = []
    here = os.getcwd()
    os.chdir(workdir)                        # train() writes ./logs/<task>/
    try:
        tr = Trainer(cfg, sub, store, logger=logging.getLogger("chip_smoke.train"),
                     device_features=table, device=DEVICE)
        tr.init_state()
        n_steps = math.ceil(len(tr.train_set) / TRAIN["batch_size"])
        n_test = math.ceil(len(tr.test_set) / cfg.eval_batch_size)

        def on_epoch(epoch, test_m):
            epochs.append({"epoch": epoch, "test": test_m, **tr.last_epoch_wall,
                           "span_decode_launches": k1.span_decode.launches,
                           "fused_forward_launches": k2.fused_forward.launches})
            reset_launches()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()   # main path starts
        t0 = time.perf_counter()
        best = tr.train(epoch_callback=on_epoch)
        train_seconds = time.perf_counter() - t0
        tr.close()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join("logs", cfg.task, f"metrics_{cfg.suffix}.jsonl")) as f:
            records = [json.loads(line) for line in f]
    finally:
        os.chdir(here)
    losses = [r["train"]["loss"] for r in records if r["kind"] == "epoch"]
    launches = {"span_decode": sum(e["span_decode_launches"] for e in epochs),
                "fused_forward": sum(e["fused_forward_launches"] for e in epochs)}
    for e, rec in zip(epochs, (r for r in records if r["kind"] == "epoch")):
        check(e["span_decode_launches"] == n_steps + n_test
              and e["fused_forward_launches"] == n_test,
              f"epoch {e['epoch']}: K1 {e['span_decode_launches']}, K2 "
              f"{e['fused_forward_launches']} for {n_steps} steps, {n_test} test batches")
        e.update(loss=rec["train"]["loss"], train_metrics=rec["train"],
                 steps_per_s=n_steps / e["train_s"],
                 samples_per_s=len(tr.train_set) / e["train_s"])
    check(len(losses) == TRAIN["epochs"] and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"train losses {losses}")
    flat = to_jax_params(tr.model)

    # (c) where a train step's time goes
    order = torch.randperm(len(tr.train_set), generator=torch.Generator().manual_seed(SEED))
    sels = [order[i * 16:(i + 1) * 16].to(DEVICE) for i in range(PROFILE_STEPS + 1)]
    count = iter(range(10 ** 6))

    def one_step():
        i = next(count)
        b = steps.gather_batch(tr._train_data, sels[i % len(sels)], with_labels=True)
        steps.train_step(tr.model, tr.state.opt, b, tr.word_vectors, TRAIN["lr"],
                         steps.make_generator(DEVICE, SEED, i), drop_rate=TRAIN["droprate"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    profile = device_profile(one_step, calls=PROFILE_STEPS, top=12, match="span_decode")

    resume = resume_check(workdir)
    mc = mc_sweeps(workdir, config, dataset, store, table, flat)
    warm = {"features": tr.features, "device_features": tr.export_device_features(),
            "dataset": dataset}
    emit({"train_charades": {
        "card": CARD[0], "reduced": {"epochs": "50 -> 2",
                                       "train_queries": f"12,408 -> {TRAIN_QUERIES}"},
        "config": dict(TRAIN, span_decode="pallas", sweep_backend="fused",
                       T=CHARADES["max_vlen"], dim=CHARADES["dim"],
                       heads=CHARADES["num_heads"], attn_layer=CHARADES["attn_layer"]),
        "train_queries": len(tr.train_set), "steps_per_epoch": n_steps,
        "test_batches_per_epoch": n_test,
        "step_vs_cpu": step_rows,
        "epochs": epochs, "train_seconds_total": train_seconds,
        "best": {k: best[k] for k in ("r1i7", "epoch", "improved")},
        "max_memory_allocated_bytes": peak, "launches": launches,
        "step_ms_host_clock": step_ms, "profile_train_step": profile,
        "resume": resume, "mc_sweep": mc, "seconds": time.perf_counter() - t_phase,
        "timing": "train_s: host clock from the epoch's start to its one fetch of "
                  "losses and IoUs; step_ms_host_clock: 20 steps after training, "
                  "ending in a synchronize; profile: torch.profiler over 20 steps; "
                  "mc seconds: host clock around infer_trainset() (pickle included)"}})
    f32 = {"step_ms": [e["train_s"] * 1e3 / n_steps for e in epochs],
           "max_memory_allocated_bytes": peak, "flat": flat}
    return {"train": launches, "mc_sweep_fused": mc["fused"]["launches"]}, warm, f32


# -- phase 9 ------------------------------------------------------------------
FOLD_BATCHES = 20


class Captured(logging.Handler):
    """Keeps the records logged through it."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


def native_loader(workdir: str, dataset) -> dict:
    """(a) The Sweep dataset's 1,334 test-split videos as raw .npy files
    (their raw lengths, 24-120 clips x 1024 f32, seeded values), read by
    FeatureStore.from_dir through the native loader and through NumPy, in
    turns native, NumPy, NumPy, native: the tables bit-equal."""
    feat_dir = os.path.join(workdir, "sweep", "data", "features", "charades_i3d")
    with open(os.path.join(feat_dir, "feature_shapes.json")) as f:
        shapes = json.load(f)
    raw_dir = os.path.join(workdir, "raw_test")
    os.makedirs(raw_dir)
    rng = np.random.default_rng(SEED + 7)
    vids = sorted({r["vid"] for r in dataset["test_set"]})
    for vid in vids:
        np.save(os.path.join(raw_dir, f"{vid}.npy"),
                rng.standard_normal((shapes[vid], CHARADES["vdim"]), dtype=np.float32))
    check(native.get_lib() is not None,
          f"the native npy loader did not build or load: {native.error()}")
    seconds: dict[str, list] = {"native": [], "numpy": []}
    stores = {}
    for mode in ("native", "numpy", "numpy", "native"):
        t0 = time.perf_counter()
        stores[mode] = FeatureStore.from_dir(raw_dir, CHARADES["max_vlen"],
                                             use_native=mode == "native")
        seconds[mode].append(time.perf_counter() - t0)
    a, b = stores["native"], stores["numpy"]
    differ = int((a.packed != b.packed).sum())
    check(a.vid_index == b.vid_index and np.array_equal(a.lengths, b.lengths)
          and differ == 0, f"native loader: {differ} values differ from NumPy's")
    raw_bytes = sum(os.path.getsize(os.path.join(raw_dir, f"{v}.npy")) for v in vids)
    shutil.rmtree(raw_dir)
    return {"videos": len(vids), "raw_bytes": raw_bytes,
            "table_shape": list(a.packed.shape), "bit_equal": True,
            "downsampled": int((np.array([shapes[v] for v in vids])
                                > CHARADES["max_vlen"]).sum()),
            "seconds_in_turns": seconds,
            "library": str(native.library_path().relative_to(ROOT))}


def replay_check(workdir: str) -> dict:
    """(b) Streamed against resident training in a fresh deterministic
    process (``--streaming-worker``) on the resume check's 512-query set."""
    root = os.path.join(workdir, "resume")
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--streaming-worker", root],
                          capture_output=True, text=True, env=env, timeout=600)
    check(proc.returncode == 0, f"streaming worker exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {**out, "seconds_process": time.perf_counter() - t0}


# the replay's four runs: name, feature dtype, train.host_streaming (None:
# auto, with train.hbm_budget_gb set to half the table)
REPLAY_RUNS = (("f32_resident", "float32", False), ("f32_streamed", "float32", True),
               ("int8_resident", "int8", False), ("int8_auto", "int8", None))


def streaming_worker(root: str) -> None:
    """The replay's process: deterministic mode before CUDA starts, then 2
    epochs from one init and ``infer_trainset()`` at mc_droprate 0.5 (flax
    sweeps) for each of REPLAY_RUNS through ``cli.build_trainer``; the
    streamed runs must equal the resident ones bit for bit (params,
    best.npz, pickle).  Prints one JSON line."""
    enable_deterministic()
    os.chdir(root)
    base = Config.load("SeqPAN.yaml")
    shared: dict = {}
    runs, out = {}, {}
    for name, dtype, hs in REPLAY_RUNS:
        cfg = copy.deepcopy(base)
        cfg.suffix, cfg.model.feature_dtype = name, dtype
        cfg.train.seed, cfg.train.save_state_every = SEED, 0
        cfg.train.sweep_backend, cfg.train.mc_droprate = "flax", 0.5
        cfg.train.host_streaming = hs
        if hs is None:
            packed = shared["features"].packed
            cfg.train.hbm_budget_gb = packed.size / 1e9 / 2      # int8: 1 byte
        tr = cli.build_trainer(cfg, features=shared.get("features"),
                               base_dataset=shared.get("dataset"), device=DEVICE)
        shared.update(features=tr.features, dataset=tr.dataset)
        check(tr.host_streaming == (hs is not False)
              and (tr.export_device_features() is None) == tr.host_streaming,
              f"replay {name}: host_streaming {tr.host_streaming}")
        tr.init_state(SEED)
        t0 = time.perf_counter()
        best = tr.train()
        train_s = time.perf_counter() - t0
        pkl = os.path.join("results", f"{name}.pkl")
        tr.infer_trainset(save_path=pkl)
        with np.load(os.path.join(cfg.model_dir(), "best.npz")) as f:
            best_npz = dict(f)
        with open(pkl, "rb") as f:
            rows = pickle.load(f)
        runs[name] = (tr.model.state_dict(), best_npz, rows)
        out[name] = {"host_streaming": tr.host_streaming, "train_s": train_s,
                     "steps": tr.state.step, "best_r1i7": best["r1i7"],
                     "best_epoch": best["epoch"]}
        tr.close()
    check(native.get_lib() is not None, "replay: the native loader was not used")
    for a, b in (("f32_resident", "f32_streamed"), ("int8_resident", "int8_auto")):
        pa, ba, ra = runs[a]
        pb, bb, rb = runs[b]
        params = all(torch.equal(pa[k], pb[k]) for k in pa)
        best = ba.keys() == bb.keys() and all(np.array_equal(ba[k], bb[k]) for k in ba)
        rows = len(ra) == len(rb) and all(_same_row(x, y) for x, y in zip(ra, rb))
        check(params and best and rows, f"replay {b} vs {a}: params equal {params}, "
                                        f"best.npz equal {best}, pickle equal {rows}")
    emit({"queries": len(shared["dataset"]["train_set"]), "epochs": base.train.epochs,
          "runs": out, "bit_equal": True, "pickles_equal": True,
          "deterministic": "runtime.debug.enable_deterministic() before CUDA started",
          "auto_budget_gb": shared["features"].packed.size / 1e9 / 2})


def _same_row(a: dict, b: dict) -> bool:
    if list(a) != list(b):
        return False
    for k, v in a.items():
        if k in ("prop_logits", "prop_logits1", "prop_logits2"):
            if not all(np.array_equal(x, y) for x, y in zip(v, b[k])):
                return False
        elif k == "m_score":
            if not np.array_equal(v, b[k]):
                return False
        elif v != b[k]:
            return False
    return True


def upload_bytes(tr: Trainer, sel: np.ndarray) -> dict:
    """Host-to-device bytes of one streamed train batch, by array."""
    host = tr.train_set.gather(sel, with_labels=False)
    out = {"float32": {k: int(v.nbytes) for k, v in host.items()}}
    q, scales = quantize_features(host["video_features"])
    out["int8"] = dict(out["float32"], video_features=int(q.nbytes),
                       feature_scales=int(scales.nbytes))
    return {k: {"total": sum(v.values()), **v} for k, v in out.items()}


def streamed_epochs(workdir: str, config, store, dataset, table) -> tuple[dict, object]:
    """(c) One epoch each of the Train cell's 1,600 queries, resident and
    streamed in turns (resident, streamed, streamed, resident; f32, fused
    sweeps asked for), then one streamed int8 epoch; the upload's bytes and
    time, and a profile of 20 streamed steps.  Returns the record and the
    streamed f32 trainer."""
    sub = dict(dataset, train_set=dataset["train_set"][:TRAIN_QUERIES])
    log = logging.getLogger("chip_smoke.streaming")
    captured = Captured()
    log.addHandler(captured)
    trainers = {}
    for name, hs, dtype in (("resident", False, "float32"), ("streamed", True, "float32"),
                            ("streamed_int8", True, "int8")):
        cfg = train_config(config, os.path.join(workdir, f"ckpt_{name}"), epochs=1,
                           host_streaming=hs)
        cfg.suffix, cfg.model.feature_dtype = name, dtype
        trainers[name] = Trainer(cfg, sub, store, logger=log,
                                 device_features=table if dtype == "float32" else None,
                                 device=DEVICE)
    log.removeHandler(captured)
    warnings = [r.getMessage() for r in captured.records if r.levelno == logging.WARNING]
    check(len(warnings) == 2 and all("using the flax sweep backend instead" in w
                                     for w in warnings),
          f"streaming: the fused -> flax warning was not logged twice: {warnings}")
    check(trainers["streamed"].export_device_features() is None
          and trainers["resident"].export_device_features()[0] is table[0],
          "streaming: residency")
    n_steps = math.ceil(TRAIN_QUERIES / TRAIN["batch_size"])
    n_test = math.ceil(len(dataset["test_set"]) / config.eval_batch_size)
    epochs: dict[str, list] = {"resident": [], "streamed": [], "streamed_int8": []}
    main_k1 = 0
    here = os.getcwd()
    os.chdir(workdir)                        # train() writes ./logs/<task>/
    try:
        for name in ("resident", "streamed", "streamed", "resident", "streamed_int8"):
            tr = trainers[name]
            tr.init_state()
            reset_launches()                 # main path starts (streamed runs)
            t0 = time.perf_counter()
            tr.train()
            seconds = time.perf_counter() - t0
            launches = launch_counts()       # main path ends
            streamed = name != "resident"
            if streamed:
                main_k1 += launches["span_decode"]
            check(launches["span_decode"] == n_steps + n_test
                  and launches["fused_forward"] == (0 if streamed else n_test),
                  f"streaming {name}: launches {launches} for {n_steps} steps and "
                  f"{n_test} test batches")
            wall = tr.last_epoch_wall
            epochs[name].append({"step_ms": wall["train_s"] * 1e3 / n_steps,
                                 "train_s": wall["train_s"], "eval_s": wall["eval_s"],
                                 "seconds": seconds, "launches": launches})
            tr.close()
    finally:
        os.chdir(here)

    # the upload alone, and 20 streamed steps on the host clock and profiled
    tr = trainers["streamed"]
    loader_sels = [s for s in TrainLoader(tr.train_set, TRAIN["batch_size"],
                                          seed=tr.config.train.seed).index_iter(0)]
    nbytes = upload_bytes(tr, loader_sels[0])
    upload_ms = []
    for sel in loader_sels[:PROFILE_STEPS]:
        host = tr.train_set.gather(sel, with_labels=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.upload_batch(host, DEVICE, with_labels=True)
        torch.cuda.synchronize()
        upload_ms.append((time.perf_counter() - t0) * 1e3)
    stream = tr._stream(tr.train_set, ((s, len(s)) for s in loader_sels),
                        with_labels=True)
    count = iter(range(10 ** 6))

    def one_step():
        batch, _ = next(stream)
        steps.train_step(tr.model, tr.state.opt, batch, tr.word_vectors, TRAIN["lr"],
                         steps.make_generator(DEVICE, SEED, next(count)),
                         drop_rate=TRAIN["droprate"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    profile = device_profile(one_step, calls=PROFILE_STEPS, top=8, match="span_decode")
    stream.close()   # left after 2 x PROFILE_STEPS batches: ends its prefetch thread
    step_median = statistics.median(e["step_ms"] for e in epochs["streamed"])
    return {"queries": TRAIN_QUERIES, "steps_per_epoch": n_steps,
            "test_batches_per_epoch": n_test, "epochs_in_turns": epochs,
            "fallback_warnings": warnings,
            "upload_bytes_per_step": nbytes,
            "upload_ms_median": statistics.median(upload_ms),
            "upload_share_of_streamed_step": statistics.median(upload_ms) / step_median,
            "streamed_step_ms_host_clock_20": step_ms,
            "profile_streamed_step": profile, "k1_main_path": main_k1}, tr


def fold_mc_check(workdir: str, config, store, dataset, table, flat) -> dict:
    """(d) The MC passes at mc_droprate 0.5 on the eager (flax) sweep over
    FOLD_BATCHES batches of 96, folded and sequential in turns (sequential,
    folded, folded, sequential, twice), on the train phase's weights."""
    sub = dict(dataset, train_set=dataset["train_set"][:FOLD_BATCHES * 96])
    trainers = {}
    for fold in (False, True):
        cfg = train_config(config, "", sweep_backend="flax", mc_droprate=0.5,
                           fold_mc=fold)
        trainers[fold] = Trainer(cfg, sub, store,
                                 logger=logging.getLogger("chip_smoke.fold_mc"),
                                 device_features=table, device=DEVICE)
        trainers[fold].load_params(flat)
    seconds: dict[str, list] = {"sequential": [], "folded": []}
    rows, main_k1 = {}, 0
    for fold in (False, True, True, False) * 2:
        name = "folded" if fold else "sequential"
        path = os.path.join(workdir, f"fold_{name}.pkl")
        reset_launches()                     # main path starts (folded runs)
        t0 = time.perf_counter()
        trainers[fold].infer_trainset(save_path=path)
        seconds[name].append(time.perf_counter() - t0)
        launches = launch_counts()           # main path ends
        check(launches == {"span_decode": FOLD_BATCHES, "fused_forward": 0,
                           "fused_forward_bf16": 0},
              f"fold_mc {name}: launches {launches}")
        main_k1 += launches["span_decode"] if fold else 0
        if name not in rows:
            with open(path, "rb") as fh:
                rows[name] = pickle.load(fh)
    # the sweep alone (no pickle), in turns: the passes' own cost
    sweep_s: dict[str, list] = {"sequential": [], "folded": []}
    for fold in (False, True, True, False) * 2:
        tr = trainers[fold]
        _, sels = tr._sweep_sels("infer", tr.train_set, tr.config.infer_batch_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = steps.infer_sweep(tr.model, steps.resident_batches(tr._train_data, sels),
                                tr.word_vectors, 0.5, tr.config.train.seed, fold_mc=fold)
        out["start_logits"].cpu()
        sweep_s["folded" if fold else "sequential"].append(time.perf_counter() - t0)
    seq, fol = rows["sequential"], rows["folded"]
    x = np.concatenate([np.stack(r["prop_logits"]).ravel() for r in seq])
    y = np.concatenate([np.stack(r["prop_logits"]).ravel() for r in fol])
    of_bound = np.abs(y - x) / (1e-5 + 1e-4 * np.abs(x))
    err = float(of_bound.max())
    worst = int(of_bound.argmax())
    check(err <= 1.0, f"fold_mc: clean logits at {err} of rtol 1e-4 / atol 1e-5 "
                      f"(sequential {x[worst]}, folded {y[worst]})")
    T = CHARADES["max_vlen"]
    mask = (np.arange(T)[None] < np.array([r["v_len"] for r in seq])[:, None]).astype(np.int32)
    ties = near_ties([np.stack([r["prop_logits"][0] for r in seq]),
                      np.stack([r["prop_logits"][1] for r in seq])], mask,
                     np.array([r["prop_idx"] for r in seq]),
                     np.array([r["prop_idx"] for r in fol]))
    live = {}
    for a, b, key in (("prop_logits1", "prop_logits", "mc1_vs_clean"),
                      ("prop_logits1", "prop_logits2", "mc1_vs_mc2"),
                      ("prop_logits2", "prop_logits", "mc2_vs_clean")):
        live[key] = float(np.mean([(r[a][0] != r[b][0])[:r["v_len"]].mean() for r in fol]))
    check(min(live.values()) > 0.9, f"fold_mc: passes not live: {live}")
    m_err = max(float(np.abs(a["m_score"] - b["m_score"]).max()) for a, b in zip(seq, fol))
    return {"batches": FOLD_BATCHES, "queries": len(seq), "seconds_in_turns": seconds,
            "sweep_seconds_in_turns": sweep_s,
            "clean_logits_err_of_bound": err,
            "clean_logits_worst": {"sequential": float(x[worst]), "folded": float(y[worst])},
            "clean_logits_max_abs_diff": float(np.abs(y - x).max()),
            "clean_logits_equal_share": float((x == y).mean()),
            "clean_logits_over_half_bound": int((of_bound > 0.5).sum()),
            "match_scores_max_abs_diff": m_err,
            "indices_differ": len(ties), "near_ties": ties,
            "folded_logits_differ_share": live, "k1_main_path": main_k1}


def test_requests(tr: Trainer, n: int) -> list:
    """The first ``n`` test samples as raw (features, duration, query)
    requests, their features the store's rows."""
    with open(tr.config.paths.test_path) as f:
        records = json.load(f)[:n]
    requests = []
    for i, (vid, duration, _, sentence) in enumerate(records):
        check(tr.test_set.records[i]["vid"] == vid, "serve: test split order")
        row = tr.features.vid_index[vid]
        requests.append((tr.features.packed[row, :tr.features.lengths[row]],
                         duration, sentence))
    return requests


def serve_from_trainer(workdir: str, tr: Trainer) -> dict:
    """(e) ``Predictor.from_trainer`` on the streamed trainer and
    ``export_bundle(trainer)`` -> ``Predictor.from_bundle``, on the first 96
    test samples as raw requests: spans and logits equal to each other,
    spans equal to the trainer's eval path on the same samples."""
    n = 96
    requests = test_requests(tr, n)
    reset_launches()                         # main path starts
    pred = Predictor.from_trainer(tr, batch_size=n)
    got = pred.predict_batch(requests)
    bundle = Predictor.from_bundle(export_bundle(tr, os.path.join(workdir, "trainer_bundle")),
                                   batch_size=n, device=DEVICE)
    again = bundle.predict_batch(requests)
    launches = launch_counts()               # main path ends
    check(launches == {"span_decode": 2, "fused_forward": 0, "fused_forward_bf16": 0},
          f"serve from trainer: launches {launches}")
    host = pred.encode_batch(requests)
    logits = [forward_logits(p, host) for p in (pred, bundle)]
    check(got == again and all(torch.equal(a, b) for a, b in zip(*logits)),
          "serve: from_trainer and the exported bundle disagree")
    out = steps.eval_step(tr.model, steps.upload_batch(
        tr.test_set.gather(np.arange(n), with_labels=False), DEVICE), tr.word_vectors)
    spans = np.stack([out["start_index"].cpu().numpy(), out["end_index"].cpu().numpy()], 1)
    check(spans.tolist() == [[r["start_index"], r["end_index"]] for r in got],
          "serve: from_trainer's spans differ from the trainer's eval path")
    return {"requests": n, "spans_equal_eval_path": True,
            "bundle_equal_from_trainer": True, "k1_main_path": launches["span_decode"]}


def streaming_phase(workdir: str, config, store, dataset, table, flat) -> dict:
    """Phase 9; returns K1's launches on the phase's main paths."""
    t0 = time.perf_counter()
    loader = native_loader(workdir, dataset)
    replay = replay_check(workdir)
    epochs, streamed = streamed_epochs(workdir, config, store, dataset, table)
    fold = fold_mc_check(workdir, config, store, dataset, table, flat)
    serving = serve_from_trainer(workdir, streamed)
    emit({"streaming_charades": {
        "card": CARD[0], "native_loader": loader, "replay": replay, "train": epochs,
        "fold_mc": fold, "serve_from_trainer": serving,
        "reduced": {"train": f"12,408 queries -> {TRAIN_QUERIES}, 50 epochs -> 1 a run",
                    "fold_mc": f"12,408 queries -> {FOLD_BATCHES * 96}",
                    "replay": f"{RESUME_DATA['n_train']} queries, 2 epochs"},
        "seconds": time.perf_counter() - t0,
        "timing": "seconds: host clock; step_ms: an epoch's train seconds over its "
                  "steps (one fetch at the epoch's end); upload_ms: one batch's "
                  "synchronous upload with labels, between synchronizes; the "
                  "resident and streamed epochs run in turns"}})
    return {"streaming": epochs["k1_main_path"], "fold_mc": fold["k1_main_path"],
            "serve_from_trainer": serving["k1_main_path"]}


# -- phase 10 -----------------------------------------------------------------
BF16_MC_BATCHES = 20


def rms(a: torch.Tensor) -> float:
    return a.double().pow(2).mean().sqrt().item()


def bf16_stats(got, exact, plain_bf16, k2_f32) -> tuple[dict, list[str]]:
    """(B), (S) and (R) of K2's bf16 outputs (start, end, match scores)
    against the plain version in f64 without rounding; returns the
    statistics and the checks that failed.

    (B) on match scores is max(0.05, 1.5 x the plain bf16 version's own
    distance from f64): over a batch of 96 x 64 positions the plain bf16
    version itself is up to 0.13-0.18 from f64 (CPU rehearsal at D=32), so
    the fixed 0.05 of the 5-sample CPU tests cannot hold here."""
    stats, failed = {}, []
    for name, x, ref, pb, f in zip(("start_logits", "end_logits", "match_scores"),
                                   got, exact, plain_bf16, k2_f32):
        x = x.double()
        plain_err = (pb - ref).abs().max().item()
        band = (max(0.05, 1.5 * plain_err) if name == "match_scores"
                else 0.05 + 0.03 * ref.abs().max().item())
        st = {"max_abs_err": (x - ref).abs().max().item(), "band": band,
              "plain_bf16_max_abs_err": plain_err,
              "S": rms(x - ref) / rms(pb - ref),
              "R": rms(x - ref) / max(rms(f.double() - ref), 1e-30),
              "finite": bool(torch.isfinite(x).all())}
        stats[name] = st
        failed += [f"{name} {c}" for c, ok in (
            ("finite", st["finite"]), ("(B)", st["max_abs_err"] <= band),
            ("(S)", 0.5 <= st["S"] <= 2.0), ("(R)", st["R"] > 100.0)) if not ok]
    return stats, failed


def k2_bf16_check(W: int, resources: dict) -> dict:
    """(a) K2 with bf16 products against its plain version on the card."""
    rng = np.random.default_rng(SEED + 7)
    packs = k2_packs()
    kw = dict(attn_layer=CHARADES["attn_layer"], num_heads=CHARADES["num_heads"],
              tau=0.3, use_gumbel=False)
    dims = (CHARADES["dim"], CHARADES["num_heads"])
    rows, failed = [], []
    for B, T, Wq in ((96, 64, W), (32, 100, MAX_WLEN), (3, 17, 5)):
        packed = packs[64 if T <= 64 else 100]
        args = k2_inputs(B, T, Wq, rng)
        got = k2.fused_forward(packed, *args, **kw, mxu_bf16=True)
        f32 = k2.fused_forward(packed, *args, **kw)
        torch.cuda.synchronize()
        p64 = PackedWeights(packed.buffer.double(), packed.layout, packed.attn_layer)
        a64 = [a.double() if a.is_floating_point() else a for a in args]
        exact = forward_math(p64, *a64, **kw)
        plain_bf16 = forward_math(p64, *a64, **kw, mxu_bf16=True)
        stats, bad = bf16_stats(got, exact, plain_bf16, f32)
        failed += [f"{(B, T, Wq)}: {b}" for b in bad]
        vm = args[2]
        spans = [torch.stack(k1.span_decode(s, e, vm), 1) for s, e in
                 (got[:2], [r.float() for r in plain_bf16[:2]], f32[:2])]
        kernel = lambda: k2.fused_forward(packed, *args, **kw, mxu_bf16=True)  # noqa: E731
        kernel_f32 = lambda: k2.fused_forward(packed, *args, **kw)  # noqa: E731
        plain = lambda: forward_math(packed, *args, **kw, mxu_bf16=True)  # noqa: E731
        ms, queue = device_times_ms(kernel, per_round=20, warmup=3)
        f32_ms, _ = device_times_ms(kernel_f32, per_round=20, warmup=3)
        plain_ms, _ = device_times_ms(plain, per_round=1, rounds=10, warmup=3)
        busy = device_profile(kernel, calls=10, top=1)
        flops = k2_flops(B, T, Wq)
        n_bytes = (packed.buffer.numel() * 4 + sum(a.numel() * 4 for a in args)
                   + B * T * 6 * 4)
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        rows.append({"B": B, "T": T, "W": Wq, "errors": stats,
                     "max_abs_err": max(stats["start_logits"]["max_abs_err"],
                                        stats["end_logits"]["max_abs_err"]),
                     "spans_equal_plain_bf16": (spans[0] == spans[1]).all(1).float()
                     .mean().item(),
                     "spans_equal_k2_f32": (spans[0] == spans[2]).all(1).float().mean().item(),
                     "ms": ms, "f32_ms": f32_ms, "busy_ms": launch_ms(busy)[0],
                     "plain_ms": plain_ms, "queue": queue, "flops": flops,
                     "bytes": n_bytes, "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "bound_share": bound / ms,
                     "smem_bytes_per_block": k2.smem_bytes(T, Wq, *dims)})
    emit({"bf16_k2": {
        "shapes": rows, "ptxas": resources.get("fused_forward"),
        "reference": "errors against the plain version in f64 without rounding; "
                     "S: rms(K2 bf16 - f64) / rms(plain bf16 - f64), the plain "
                     "bf16 version rounding the operands of the JAX kernel's mm/mmt "
                     "with f64 sums; R: rms(K2 bf16 - f64) / rms(K2 f32 - f64)",
        "timing": "ms and f32_ms: median of 20 calls by CUDA events, queued behind "
                  "a device sleep; busy_ms: kernel time per captured launch; "
                  "plain_ms: the plain version with bf16 rounding, in f32; the "
                  "bound counts products only, at the dense bf16 tensor-core rate"}})
    check(not failed, f"K2 bf16 against its plain version: {failed}")
    return rows[0]


def bf16_sweep(workdir: str, config, store, dataset, table) -> dict:
    """(b) The test sweep and infer_trainset() with fused_mxu_bf16, in turns
    with the f32 fused sweep (f32, bf16, bf16, f32) on the sweep phase's
    weights; the bf16 runs are the main path."""
    trainers = {}
    for name in ("f32", "bf16"):
        cfg = copy.deepcopy(config)
        cfg.train.sweep_backend, cfg.train.fused_mxu_bf16 = "fused", name == "bf16"
        tr = Trainer(cfg, dataset, store, logger=logging.getLogger("chip_smoke.bf16"),
                     device_features=table, device=DEVICE)
        tr.init_state()                             # the sweep phase's weights
        tr.test()                                   # warm-up
        trainers[name] = tr
    n = {split: math.ceil(len(ds) / config.eval_batch_size)
         for split, ds in (("test", tr.test_set), ("train", tr.train_set))}
    total = n["test"] + n["train"]
    runs: dict[str, list] = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        tr = trainers[name]
        reset_launches()                            # main path starts (bf16)
        t0 = time.perf_counter()
        test_m = tr.test()
        test_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        infer_m = tr.infer_trainset(save_path=os.path.join(workdir, f"mxu_{name}.pkl"))
        infer_s = time.perf_counter() - t0
        launches = launch_counts()                  # main path ends
        bf16 = name == "bf16"
        check(launches == {"span_decode": total, "fused_forward": 0 if bf16 else total,
                           "fused_forward_bf16": total if bf16 else 0},
              f"{name} sweep: launches {launches} for {n} batches")
        runs[name].append({"test": test_m, "infer_trainset": infer_m,
                           "test_seconds": test_s, "infer_seconds": infer_s,
                           "launches": launches})
    spans = {}
    for name in ("f32", "bf16"):
        with open(os.path.join(workdir, f"mxu_{name}.pkl"), "rb") as fh:
            spans[name] = [r["prop_idx"] for r in pickle.load(fh)]
    same = sum(a == b for a, b in zip(spans["bf16"], spans["f32"]))
    return {"batches": n, "runs_in_turns": runs,
            "launches": {k: sum(r["launches"][k] for r in runs["bf16"])
                         for k in ("span_decode", "fused_forward", "fused_forward_bf16")},
            "train_spans_equal_f32": f"{same}/{len(spans['bf16'])}"}


def bf16_train(workdir: str, config, store, dataset, table, f32: dict) -> dict:
    """(c) One epoch of Trainer.train() at compute_dtype bfloat16 on the
    train phase's queries."""
    sub = dict(dataset, train_set=dataset["train_set"][:TRAIN_QUERIES])
    cfg = train_config(config, os.path.join(workdir, "ckpt_bf16"), epochs=1)
    cfg.suffix = "bf16"
    cfg.model.compute_dtype = "bfloat16"
    here = os.getcwd()
    os.chdir(workdir)                        # train() writes ./logs/<task>/
    try:
        tr = Trainer(cfg, sub, store, logger=logging.getLogger("chip_smoke.bf16"),
                     device_features=table, device=DEVICE)
        tr.init_state()
        n_steps = math.ceil(len(tr.train_set) / TRAIN["batch_size"])
        n_test = math.ceil(len(tr.test_set) / cfg.eval_batch_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                                        # main path starts
        t0 = time.perf_counter()
        with recorded(tr._graphs, "train_epoch") as epochs:     # the graphed epoch
            tr.train()
        seconds = time.perf_counter() - t0
        launches = launch_counts()                             # main path ends
        tr.close()
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(here)
    losses = torch.cat([losses for losses, _ in epochs]).cpu().numpy()
    k = max(1, len(losses) // 5)                    # the first and last fifth
    first, last = float(losses[:k].mean()), float(losses[-k:].mean())
    check(len(losses) == n_steps and np.isfinite(losses).all() and last < first,
          f"bf16 train: {len(losses)} losses, first {k} {first}, last {k} {last}")
    check(launches == {"span_decode": n_steps + n_test, "fused_forward": n_test,
                       "fused_forward_bf16": 0},
          f"bf16 train: launches {launches} for {n_steps} steps, {n_test} test batches")
    return {"steps": n_steps, "test_batches": n_test, "launches": launches,
            "loss_first_fifth": first, "loss_last_fifth": last,
            "train_s": tr.last_epoch_wall["train_s"], "seconds": seconds,
            "step_ms": tr.last_epoch_wall["train_s"] * 1e3 / n_steps,
            "f32_step_ms": f32["step_ms"], "max_memory_allocated_bytes": peak,
            "f32_max_memory_allocated_bytes": f32["max_memory_allocated_bytes"]}


def bf16_mc(workdir: str, config, store, dataset, table, flat) -> dict:
    """(d) infer_trainset() at mc_droprate 0.5 with mc_dtype bfloat16 over
    BF16_MC_BATCHES batches, against an f32 trainer's on the same weights."""
    sub = dict(dataset, train_set=dataset["train_set"][:BF16_MC_BATCHES * 96])
    rows, out = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = train_config(config, "", mc_droprate=0.5, mc_dtype=dtype)
        tr = Trainer(cfg, sub, store, logger=logging.getLogger("chip_smoke.bf16"),
                     device_features=table, device=DEVICE)
        tr.load_params(flat)
        check((tr.mc_model is None) == (dtype == "float32"), "mc_model")
        path = os.path.join(workdir, f"mc_{dtype}.pkl")
        reset_launches()
        t0 = time.perf_counter()
        tr.infer_trainset(save_path=path)
        out[dtype] = {"seconds": time.perf_counter() - t0, "launches": launch_counts()}
        check(out[dtype]["launches"] == {"span_decode": BF16_MC_BATCHES,
                                         "fused_forward": BF16_MC_BATCHES,
                                         "fused_forward_bf16": 0},
              f"bf16 mc: launches {out[dtype]['launches']}")
        with open(path, "rb") as fh:
            rows[dtype] = pickle.load(fh)
    clean = all(a["prop_idx"] == b["prop_idx"]
                and all(np.array_equal(x, y) for x, y in zip(a["prop_logits"], b["prop_logits"]))
                and np.array_equal(a["m_score"], b["m_score"])
                for a, b in zip(rows["float32"], rows["bfloat16"]))
    check(clean, "bf16 mc: the clean outputs differ from the f32 trainer's")
    b16 = rows["bfloat16"]
    finite = all(x.dtype == np.float32 and np.isfinite(x).all()
                 for r in b16 for k in ("prop_logits1", "prop_logits2") for x in r[k])
    live = float(np.mean([not np.array_equal(r["prop_logits1"][0], r["prop_logits2"][0])
                          for r in b16]))
    check(finite and live > 0.9, f"bf16 mc: MC logits finite {finite}, live share {live}")
    return {"queries": len(b16), "batches": BF16_MC_BATCHES, "clean_bit_equal": True,
            "mc_logits_finite": True, "passes_differ_share": live,
            "seconds": {k: v["seconds"] for k, v in out.items()},
            "launches": {k: out["float32"]["launches"][k] + out["bfloat16"]["launches"][k]
                         for k in ("span_decode", "fused_forward")}}


def bf16_phase(workdir: str, config, store, dataset, table, f32_train: dict,
               W: int, resources: dict) -> tuple[dict, int, dict]:
    """Phase 10; returns K2 bf16's main-shape row and launches, and the K1
    and K2 f32 launches of the bf16 options' runs."""
    k2_row = k2_bf16_check(W, resources)
    sweep = bf16_sweep(workdir, config, store, dataset, table)
    train = bf16_train(workdir, config, store, dataset, table, f32_train)
    mc = bf16_mc(workdir, config, store, dataset, table, f32_train["flat"])
    emit({"bf16_charades": {
        "card": CARD[0], "sweep_fused_mxu_bf16": sweep, "train_compute_bf16": train,
        "mc_dtype_bf16": mc,
        "reduced": {"train": f"12,408 queries -> {TRAIN_QUERIES}, 50 epochs -> 1",
                    "mc": f"12,408 queries -> {BF16_MC_BATCHES * 96}"},
        "timing": "seconds: host clock around test() / infer_trainset() / train(), "
                  "each ending in a host fetch (infer_trainset includes writing the "
                  "pickle); step_ms: the epoch's train seconds over its steps; the "
                  "sweeps run in turns f32, bf16, bf16, f32"}})
    return k2_row, sweep["launches"]["fused_forward_bf16"], {
        k: sweep["launches"][k] + train["launches"][k] + mc["launches"][k]
        for k in ("span_decode", "fused_forward")}


# -- phase 11 -----------------------------------------------------------------
# tools/synthetic_quality_comparison.py:260-261 and its schedule: 15 epochs,
# re0 + 2 rounds, mc_droprate 0, train seed 12345
QUALITY_DATA = dict(n_train=600, n_test=300, vdim=128, max_raw_len=64, seed=31)
QUALITY_TRAIN = dict(TRAIN, epochs=15, mc_droprate=0.0, seed=12345)
QUALITY_ROUNDS = 2
# round 1's old pseudo-mIoU there (ref_initial_old in
# results/synthetic_quality_comparison.json): the same dataset gives it
QUALITY_OLD_MIOU = 0.5565
# the union of the reference's and hual_tpu's pseudo-mIoU over their seeds
# (ROADMAP.md, "Last evidence PRs"; results/synthetic_quality_comparison.json),
# widened by 0.006, the widest across-seed spread at any round
QUALITY_BANDS = {1: (0.568, 0.590), 2: (0.588, 0.606)}


def loop_tree(workdir: str, config) -> str:
    """A round-0 tree for the sweep dataset: its records are the GT
    (``charades_gt``), and round 0's pseudo spans are them jittered by up
    to 25% of the duration."""
    rng = np.random.default_rng(SEED + 6)
    src = os.path.dirname(config.paths.train_path)
    data = os.path.join(workdir, "loop", "data")
    for sub in ("charades_gt", "charades_re0"):
        os.makedirs(os.path.join(data, sub))
        shutil.copy(os.path.join(src, "test.json"), os.path.join(data, sub))
    shutil.copy(os.path.join(src, "train.json"), os.path.join(data, "charades_gt"))
    with open(os.path.join(src, "train.json")) as f:
        records = json.load(f)
    for rec in records:
        dur, (s, e) = rec[1], rec[2]
        s2, e2 = np.clip(np.array([s, e]) + rng.uniform(-0.25, 0.25, 2) * dur, 0, dur)
        if e2 <= s2:
            s2, e2 = 0.0, dur
        rec[2] = [round(float(s2), 2), round(float(e2), 2)]
    with open(os.path.join(data, "charades_re0", "train.json"), "w") as f:
        json.dump(records, f)
    return data


def check_update(data: str, stats: dict, pkl_rows: list) -> dict:
    """One point on each selected record, none elsewhere, positive iff it
    lies inside the GT index span."""
    with open(os.path.join(data, "charades_gt", "train.json")) as f:
        gt = json.load(f)
    with open(os.path.join(data, "charades_re1", "train.json")) as f:
        new = json.load(f)
    n = len(gt)
    check(len(new) == n == len(pkl_rows), f"update: {len(new)} records for {n}")
    selected = set(stats["selected_idx"])
    check(stats["n_selected"] == len(selected) == math.ceil(n / 2),
          f"update: {stats['n_selected']} selected of {n}")
    counts = {"pos": 0, "neg": 0}
    for i, (rec, g, row) in enumerate(zip(new, gt, pkl_rows)):
        ap = rec[4]
        points = ap["pos_idx"] + ap["neg_idx"]
        check(len(points) == (i in selected), f"update: record {i} has points {ap}")
        if points:
            gs, ge = time_to_index_al(g[2], g[1], row["v_len"])
            positive = bool(ap["pos_idx"])
            check(positive == (gs <= points[0] <= ge),
                  f"update: record {i}: point {points[0]}, GT {gs}-{ge}, {ap}")
            counts["pos" if positive else "neg"] += 1
    return {"records": n, "selected": len(selected), "points": counts}


def full_width_round(workdir: str, config, data: str, warm: dict) -> dict:
    """(a) the label update on the sweep pickle at Charades-STA size;
    (b) run_rounds(start_round=1, rounds=1) at Charades width, 1 epoch, on
    the train phase's table, from the train phase's model's MC pickle."""
    root = os.path.dirname(data)
    # (a)
    results = os.path.join(root, "results_update")
    os.makedirs(os.path.join(results, "charades"))
    shutil.copy(os.path.join(workdir, "fused.pkl"),
                os.path.join(results, "charades", "re0.pkl"))
    t0 = time.perf_counter()
    stats = update_labels("charades", 1, data_root=data, results_root=results)
    update_s = time.perf_counter() - t0
    with open(os.path.join(results, "charades", "re0.pkl"), "rb") as f:
        rows = pickle.load(f)
    update = {"seconds": update_s, "old_miou": stats["old_miou"],
              "new_miou": stats["new_miou"], **check_update(data, stats, rows),
              "pickle": "sweep_charades's fused pickle (random weights, mc 0)"}

    # (b)
    cfg = train_config(config, os.path.join(root, "ckpt"), epochs=1)
    cfg.suffix = ""
    cfg.paths.cache_dir = os.path.join(root, "data_pkl")
    cfg.paths.train_path = os.path.join(data, "charades_gt", "train.json")
    cfg.paths.test_path = os.path.join(data, "charades_gt", "test.json")
    base_path = os.path.join(root, "configs", "SeqPAN.yaml")
    cfg.save(base_path)
    results = os.path.join(root, "results")
    os.makedirs(os.path.join(results, "charades"))
    shutil.copy(os.path.join(workdir, "mc_fused.pkl"),
                os.path.join(results, "charades", "re0.pkl"))
    stages, built = {}, []
    real_update, real_build = orchestrate.update_labels, cli.build_trainer

    def timed(name, fn):
        def run(*args, **kw):
            before, t0 = launch_counts(), time.perf_counter()
            out = fn(*args, **kw)
            stages[name] = {"seconds": time.perf_counter() - t0,
                            **{k: v - before[k] for k, v in launch_counts().items()}}
            return out
        return run

    def build(c, **kw):
        tr = real_build(c, **kw)
        tr.train, tr.infer_trainset = timed("train", tr.train), timed("infer", tr.infer_trainset)
        built.append(tr)
        return tr

    orchestrate.update_labels, cli.build_trainer = timed("update", real_update), build
    here = os.getcwd()
    os.chdir(root)                          # the loop writes ./logs/<task>/
    try:
        reset_launches()   # main path starts
        t0 = time.perf_counter()
        history = orchestrate.run_rounds("charades", rounds=1, start_round=1,
                                         base_config_path=base_path, data_root=data,
                                         results_root=results, warm_start=warm,
                                         device=DEVICE)
        seconds = time.perf_counter() - t0
        launches = launch_counts()                                 # main path ends
    finally:
        os.chdir(here)
        orchestrate.update_labels, cli.build_trainer = real_update, real_build
    tr = built[-1]
    check(len(built) == 1 and tr.export_device_features()[0] is warm["device_features"][0],
          "the round did not reuse the train phase's table on the card")
    n_steps = math.ceil(len(tr.train_set) / cfg.train.batch_size)
    n_test = math.ceil(len(tr.test_set) / cfg.eval_batch_size)
    n_infer = math.ceil(len(tr.train_set) / cfg.infer_batch_size)
    want = {"span_decode": n_steps + n_test + n_infer, "fused_forward": n_test + n_infer,
            "fused_forward_bf16": 0}
    check(launches == want, f"round at full width: launches {launches}, want {want} "
                            f"({n_steps} steps, {n_test} test, {n_infer} infer batches)")
    check(os.path.exists(os.path.join(results, "charades", "re1.pkl"))
          and os.path.exists(os.path.join(root, "configs", "SeqPAN_re1.yaml")),
          "the round wrote no pickle or derived config")
    h = history[0]
    return {"update": update, "round": {
        "seconds": seconds, "stages": stages, "launches": launches,
        "steps": n_steps, "test_batches": n_test, "infer_batches": n_infer,
        "best_r1i7": h["best"]["r1i7"], "best_test": h["best"]["test_metrics"],
        "infer": h["infer"], "old_miou": h["label_stats"]["old_miou"],
        "new_miou": h["label_stats"]["new_miou"], "table_reused": True,
        "re0_pickle": "the train phase's model, MC sweep at 0.5 (fused)"}}


def quality_loop(workdir: str) -> dict:
    """(c) re0 train and infer through the CLI, then orchestrate.main for 2
    rounds, on tools/synthetic_quality_comparison.py's dataset and schedule;
    the pseudo-mIoU of each round against hual_tpu's and the reference's
    seed band."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_synthetic_data import make_dataset

    root = os.path.join(workdir, "quality")
    make_dataset(root, task="charades", **QUALITY_DATA)
    base = Config.from_dict({
        "task": "charades",
        "paths": {"ckpt_dir": "./ckpt", "cache_dir": "./data_pkl/",
                  "feature_path": "./data/features/charades_i3d",
                  "glove_path": "./data/glove/glove.840B.300d.txt",
                  "train_path": "./data/charades_gt/train.json",
                  "test_path": "./data/charades_gt/test.json"},
        "train": dict(QUALITY_TRAIN, sweep_backend="fused"),
        "model": dict(CHARADES, vdim=QUALITY_DATA["vdim"], span_decode="pallas")})
    base_path = os.path.join(root, "configs", "charades", "SeqPAN.yaml")
    re0_path = os.path.join(root, "configs", "charades", "SeqPAN_re0.yaml")
    base.save(base_path)
    base.derive_round(0).save(re0_path)
    here = os.getcwd()
    os.chdir(root)
    try:
        reset_launches()   # main path starts
        t0 = time.perf_counter()
        check(cli.main(["--config", re0_path, "--mode", "train", "--suffix", "re0"]) == 0
              and cli.main(["--config", re0_path, "--mode", "infer_trainset",
                            "--suffix", "re0"]) == 0, "the re0 CLI runs failed")
        re0_s = time.perf_counter() - t0
        check(orchestrate.main(["charades", "--config", base_path,
                                "--rounds", str(QUALITY_ROUNDS)]) == 0, "orchestrate.main")
        seconds = time.perf_counter() - t0
        launches = launch_counts()                                 # main path ends
        with open(os.path.join("results", "charades", "rounds_summary.json")) as f:
            summary = json.load(f)
        with open(os.path.join("logs", "charades", "metrics_re0.jsonl")) as f:
            re0_best = [json.loads(line) for line in f][-1]
    finally:
        os.chdir(here)
    n_train, n_test = QUALITY_DATA["n_train"], QUALITY_DATA["n_test"]
    runs, epochs = 1 + QUALITY_ROUNDS, QUALITY_TRAIN["epochs"]
    test_batches, infer_batches = math.ceil(n_test / 96), math.ceil(n_train / 96)
    want = {"span_decode": runs * (epochs * (math.ceil(n_train / 16) + test_batches)
                                   + infer_batches),
            "fused_forward": runs * (epochs * test_batches + infer_batches),
            "fused_forward_bf16": 0}
    check(launches == want, f"quality loop: launches {launches}, want {want}")
    check([h["round"] for h in summary] == [1, 2], f"rounds {summary}")
    old = summary[0]["label_stats"]["old_miou"]
    check(round(old, 4) == QUALITY_OLD_MIOU,
          f"round 1's old pseudo-mIoU {old}: not the comparison's dataset")
    pseudo = {h["round"]: h["label_stats"]["new_miou"] for h in summary}
    for r, (lo, hi) in QUALITY_BANDS.items():
        check(lo <= pseudo[r] <= hi,
              f"round {r}: pseudo-mIoU {pseudo[r]} outside the seed band [{lo}, {hi}]")
    with open(os.path.join(ROOT, "results", "synthetic_quality_comparison.json")) as f:
        recorded = json.load(f)
    return {
        "dataset": QUALITY_DATA, "config": dict(QUALITY_TRAIN, rounds=QUALITY_ROUNDS,
                                                vdim=QUALITY_DATA["vdim"]),
        "seconds": seconds, "re0_seconds": re0_s, "launches": launches,
        "old_miou_round1": old, "pseudo_miou": pseudo, "bands": QUALITY_BANDS,
        "best_test": {0: re0_best["test_metrics"],
                      **{h["round"]: h["best"]["test_metrics"] for h in summary}},
        "hual_tpu_best_test": {o["train_seed"]: o["rounds"] for o in recorded["ours"]},
        "hual_tpu_pseudo_miou": recorded["label_quality"]["rounds"],
        "note": "best test R@1 at 300 test queries is training noise: printed, "
                "not checked"}


def loop_phase(workdir: str, config, warm: dict) -> dict:
    """Phase 11; returns the loop's launch counts."""
    data = loop_tree(workdir, config)
    full = full_width_round(workdir, config, data, warm)
    quality = quality_loop(workdir)
    emit({"loop_charades": {
        "card": CARD[0], "reduced": {"epochs": "50 -> 1 (full-width round)"},
        **full, "quality": quality,
        "timing": "seconds: host clock; stages: host clock around the label "
                  "update, Trainer.train() and infer_trainset() of the round "
                  "(each ending in a host fetch or the pickle write)"}})
    return {k: full["round"]["launches"][k] + quality["launches"][k]
            for k in ("span_decode", "fused_forward")}


# -- phase 12 -----------------------------------------------------------------
# (a)'s train set: the Train cell's queries and 5 more, 100 full batches of 16
# (replayed) and a ragged one of 5 (the eager step after the replays)
GRAPH_QUERIES = TRAIN_QUERIES + 5
# (b)'s Trainers: train options on train_config's (fused sweeps); test() runs
# on those at mc 0, infer_trainset() on all
GRAPH_SWEEPS = {"flax": dict(sweep_backend="flax"), "fused": {},
                "fused_mxu_bf16": dict(fused_mxu_bf16=True),
                "flax_mc": dict(sweep_backend="flax", mc_droprate=0.5),
                "flax_fold_mc": dict(sweep_backend="flax", mc_droprate=0.5,
                                     fold_mc=True),
                "fused_mc": dict(mc_droprate=0.5),
                "fused_mc_dtype_bf16": dict(mc_droprate=0.5, mc_dtype="bfloat16")}


class recorded:
    """Within the block, every call of ``obj.name`` appends its result to
    the list the block gets."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.calls = obj, name, []

    def __enter__(self) -> list:
        real = self.real = getattr(self.obj, self.name)

        def wrapped(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls.append(out)
            return out
        setattr(self.obj, self.name, wrapped)
        return self.calls

    def __exit__(self, *exc) -> None:
        setattr(self.obj, self.name, self.real)


def graphed_vs_eager_training(root: str, config, store, sub: dict, table) -> tuple:
    """(a) and (c): per compute dtype, Trainer.train() for one epoch from one
    init, graphed and eager, with a test sweep before it (the fused sweep's
    graph captured on the initial weights) and after it."""
    out, flat = {}, None
    for dtype in ("float32", "bfloat16"):
        runs = {}
        for graphed in (True, False):
            name = f"{dtype}_{'graphed' if graphed else 'eager'}"
            cfg = train_config(config, os.path.join(root, f"ckpt_{name}"), epochs=1)
            cfg.suffix, cfg.model.compute_dtype = name, dtype
            tr = Trainer(cfg, sub, store, logger=logging.getLogger("chip_smoke.graphs"),
                         device_features=table, device=DEVICE)
            table = tr.export_device_features()
            check(tr._graphs is not None, "a resident Trainer on the card has no graphs")
            if not graphed:
                tr._graphs = None                   # the eager loops of runtime/steps.py
            tr.init_state(SEED)
            before = tr._sweep_ious("test")
            reset_launches()
            t0 = time.perf_counter()
            with recorded(tr._graphs if graphed else steps, "train_epoch") as epochs:
                best = tr.train()
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            losses, ious = epochs[0]
            runs[graphed] = {"tr": tr, "before": before, "after": tr._sweep_ious("test"),
                             "losses": losses.cpu(), "ious": ious.cpu(), "best": best,
                             "seconds": seconds, "launches": launches}
        g, e = runs[True], runs[False]
        pg, pe = g["tr"].model.state_dict(), e["tr"].model.state_dict()
        og, oe = g["tr"].state.opt, e["tr"].state.opt
        same = {"params": all(torch.equal(pg[k], pe[k]) for k in pg),
                "moments": all(torch.equal(a, b) for a, b in zip(og.mu + og.nu,
                                                                 oe.mu + oe.nu)),
                "losses": torch.equal(g["losses"], e["losses"]),
                "ious": torch.equal(g["ious"], e["ious"]),
                "test_before": bool(np.array_equal(g["before"], e["before"])),
                "test_after_epoch": bool(np.array_equal(g["after"], e["after"]))}
        check(all(same.values()), f"graphs {dtype}: graphed vs eager bit-equal: {same}")
        check(not np.array_equal(e["before"], e["after"]),
              f"graphs {dtype}: the test IoUs did not move with training")
        n_steps = len(g["losses"])
        n_test = math.ceil(len(g["tr"].test_set) / config.eval_batch_size)
        for r in (g, e):
            # K1 once a step and a test batch, K2 once a test batch
            check(r["launches"] == {"span_decode": n_steps + n_test,
                                    "fused_forward": n_test, "fused_forward_bf16": 0},
                  f"graphs {dtype}: launches {r['launches']}")
        if flat is None:
            flat = to_jax_params(g["tr"].model)
        out[dtype] = {"steps": n_steps, "replayed": n_steps - 1, "ragged_eager": 1,
                      "bit_equal": same, "loss_first": float(g["losses"][0]),
                      "loss_last": float(g["losses"][-1]),
                      "train_seconds": {"graphed": g["seconds"], "eager": e["seconds"]},
                      "launches": g["launches"],
                      "graphs": g["tr"]._graphs.stats()}
        for r in (g, e):
            r["tr"].close()
        del runs, g, e
        torch.cuda.empty_cache()
    return out, flat, table


def graphed_vs_eager_sweeps(root: str, config, store, sub: dict, table, flat) -> dict:
    """(b): test() and infer_trainset() graphed and eager on the trained
    weights, per GRAPH_SWEEPS entry: IoUs and pickles bit-equal."""
    out = {}
    for name, opts in GRAPH_SWEEPS.items():
        cfg = train_config(config, "", **opts)
        tr = Trainer(cfg, sub, store, logger=logging.getLogger("chip_smoke.graphs"),
                     device_features=table, device=DEVICE)
        tr.load_params(flat)
        cache, res = tr._graphs, {}
        for graphed in (True, False):
            tr._graphs = cache if graphed else None
            reset_launches()
            t0 = time.perf_counter()
            test = None if cfg.train.mc_droprate else tr._sweep_ious("test")
            pkl = os.path.join(root, f"{name}_{graphed}.pkl")
            metrics = tr.infer_trainset(save_path=pkl)
            seconds = time.perf_counter() - t0
            with open(pkl, "rb") as fh:
                rows = pickle.load(fh)
            res[graphed] = (test, rows, metrics, seconds, launch_counts())
        (tg, rg, mg, sg, lg), (te, re_, me, se, _) = res[True], res[False]
        same_test = tg is None or bool(np.array_equal(tg, te))
        same_rows = len(rg) == len(re_) and all(_same_row(a, b) for a, b in zip(rg, re_))
        check(same_test and same_rows and mg == me,
              f"graphs {name}: test IoUs equal {same_test}, pickles equal {same_rows}")
        n = math.ceil(len(sub["train_set"]) / cfg.infer_batch_size) + (
            0 if tg is None else math.ceil(len(tr.test_set) / cfg.eval_batch_size))
        fused = cfg.train.sweep_backend == "fused"
        want = {"span_decode": n,
                "fused_forward": n if fused and not cfg.train.fused_mxu_bf16 else 0,
                "fused_forward_bf16": n if cfg.train.fused_mxu_bf16 else 0}
        check(lg == want, f"graphs {name}: launches {lg}, want {want}")
        out[name] = {"test_bit_equal": same_test if tg is not None else None,
                     "pickle_bit_equal": same_rows, "batches": n, "launches": lg,
                     "seconds": {"graphed": sg, "eager": se}}
        tr._graphs = cache
        tr.close()
    return out


def graphs_worker(root: str) -> None:
    """graphs_charades (a)-(c) in a fresh process: deterministic mode
    before CUDA starts, the Sweep/Train cell's table and dataset from
    ``root/world.pkl``; every check runs a Trainer graphed (its default on
    the card) and, on the same weights, eager (``Trainer._graphs = None``).
    Prints one JSON line."""
    enable_deterministic()
    with open(os.path.join(root, "world.pkl"), "rb") as f:
        config, store, dataset = pickle.load(f)
    sub = dict(dataset, train_set=dataset["train_set"][:GRAPH_QUERIES])
    here = os.getcwd()
    os.chdir(root)                           # train() writes ./logs/<task>/
    try:
        t0 = time.perf_counter()
        train, flat, table = graphed_vs_eager_training(root, config, store, sub, None)
        t1 = time.perf_counter()
        sweeps = graphed_vs_eager_sweeps(root, config, store, sub, table, flat)
        t2 = time.perf_counter()
    finally:
        os.chdir(here)
    emit({"queries": len(sub["train_set"]), "train": train, "sweeps": sweeps,
          "seconds": {"train": t1 - t0, "sweeps": t2 - t1},
          "deterministic": "runtime.debug.enable_deterministic() before CUDA started"})


def graphs_phase(workdir: str, config, store, dataset, table) -> dict:
    """Phase 12; returns the K1/K2 launches of its graphed main paths."""
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "graphs")
    os.makedirs(root)
    world = os.path.join(root, "world.pkl")
    with open(world, "wb") as f:
        pickle.dump((config, store, dataset), f, protocol=pickle.HIGHEST_PROTOCOL)
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--graphs-worker",
                           root], capture_output=True, text=True, env=env, timeout=600)
    worker_s = time.perf_counter() - t0
    os.remove(world)
    check(proc.returncode == 0, f"graphs worker exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    bit_equal = json.loads(proc.stdout.strip().splitlines()[-1])

    # outside deterministic mode, on the Train cell: one epoch through
    # train(), then steps and sweeps graphed and eager in turns
    sub = dict(dataset, train_set=dataset["train_set"][:TRAIN_QUERIES])
    cfg = train_config(config, os.path.join(workdir, "ckpt_graphs"), epochs=1)
    cfg.suffix = "graphs"
    log = logging.getLogger("chip_smoke.graphs")
    tr = Trainer(cfg, sub, store, logger=log, device_features=table, device=DEVICE)
    tr.init_state()
    cache = tr._graphs
    n_steps = math.ceil(TRAIN_QUERIES / TRAIN["batch_size"])
    n_test = math.ceil(len(tr.test_set) / cfg.eval_batch_size)
    here = os.getcwd()
    os.chdir(workdir)                        # train() writes ./logs/<task>/
    try:
        reset_launches()                     # main path starts
        t0 = time.perf_counter()
        tr.train()
        epoch_s = time.perf_counter() - t0
        epoch_launches = launch_counts()     # main path ends
    finally:
        os.chdir(here)
    check(epoch_launches == {"span_decode": n_steps + n_test, "fused_forward": n_test,
                             "fused_forward_bf16": 0},
          f"graphs: the epoch's launches {epoch_launches}")
    loader = TrainLoader(tr.train_set, TRAIN["batch_size"], seed=cfg.train.seed)
    orders = [torch.from_numpy(np.concatenate(list(loader.index_iter(e)))).to(DEVICE)
              for e in (1, 2)]
    step = [tr.state.step]

    def train_steps(graphed: bool, order) -> float:
        fn = cache.train_epoch if graphed else steps.train_epoch
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses, _ = fn(tr.model, tr.state.opt, tr._train_data, order, TRAIN["batch_size"],
                       tr.word_vectors, TRAIN["lr"], SEED, step[0],
                       drop_rate=TRAIN["droprate"])
        losses.cpu()
        step[0] += losses.numel()
        return (time.perf_counter() - t) * 1e3 / losses.numel()

    step_ms: dict[str, list] = {"graphed": [], "eager": []}
    timed_steps = PROFILE_STEPS * TRAIN["batch_size"]
    for graphed in (True, False, False, True):
        step_ms["graphed" if graphed else "eager"].append(
            train_steps(graphed, orders[0][:timed_steps]))
    reset_launches()
    graphed_100 = train_steps(True, orders[1])       # one full epoch of replays
    check(launch_counts()["span_decode"] == n_steps,
          f"graphs: {launch_counts()} for {n_steps} replayed steps")
    one = iter(range(10 ** 6))

    def graphed_step() -> None:               # one replay, no fetch
        i = next(one) % n_steps
        cache.train_epoch(tr.model, tr.state.opt, tr._train_data,
                          orders[0][i * 16:(i + 1) * 16], TRAIN["batch_size"],
                          tr.word_vectors, TRAIN["lr"], SEED, step[0] + i,
                          drop_rate=TRAIN["droprate"])

    profile = device_profile(graphed_step, calls=PROFILE_STEPS, top=8,
                             match="span_decode")

    test_s: dict[str, list] = {"graphed": [], "eager": []}
    for graphed in (True, False, False, True):
        tr._graphs = cache if graphed else None
        reset_launches()
        t0 = time.perf_counter()
        tr.test()
        test_s["graphed" if graphed else "eager"].append(time.perf_counter() - t0)
        check(launch_counts() == {"span_decode": n_test, "fused_forward": n_test,
                                  "fused_forward_bf16": 0}, f"graphs: test sweep {launch_counts()}")
    tr._graphs = cache
    test_profile = device_profile(tr.test, calls=1, top=8)
    captures = cache.stats()
    flat = to_jax_params(tr.model)
    tr.close()

    # the MC sweep at mc 0.5 over the whole train split (fused), in turns
    mcfg = train_config(config, "", mc_droprate=0.5)
    mc = Trainer(mcfg, dataset, store, logger=log, device_features=table, device=DEVICE)
    mc.load_params(flat)
    mc_cache, mc_s = mc._graphs, {"graphed": [], "eager": []}
    n_infer = math.ceil(len(mc.train_set) / mcfg.infer_batch_size)
    for graphed in (True, False, True):
        mc._graphs = mc_cache if graphed else None
        reset_launches()
        t0 = time.perf_counter()
        mc.infer_trainset(save_path=os.path.join(workdir, "graphs_mc.pkl"))
        mc_s["graphed" if graphed else "eager"].append(time.perf_counter() - t0)
        check(launch_counts() == {"span_decode": n_infer, "fused_forward": n_infer,
                                  "fused_forward_bf16": 0}, f"graphs: MC sweep {launch_counts()}")
    mc._graphs = mc_cache
    captures += mc_cache.stats()
    mc.close()
    emit({"graphs_charades": {
        "card": CARD[0], "bit_equal_worker": bit_equal, "worker_seconds": worker_s,
        "epoch": {"steps": n_steps, "test_batches": n_test, "seconds": epoch_s,
                  **tr.last_epoch_wall, "launches": epoch_launches},
        "step_ms_in_turns": step_ms, "graphed_epoch_step_ms": graphed_100,
        "profile_graphed_step": profile, "profile_graphed_test_sweep": test_profile,
        "captures": captures, "test_sweep_seconds_in_turns": test_s,
        "mc_sweep_seconds_in_turns": mc_s, "mc_sweep_batches": n_infer,
        "reduced": {"train": f"12,408 queries -> {TRAIN_QUERIES} (worker: "
                             f"{GRAPH_QUERIES}), 50 epochs -> 1"},
        "seconds": time.perf_counter() - t_phase,
        "timing": "step_ms: host clock over 20 steps ending in a fetch of the "
                  "losses, graphed and eager in turns; graphed_epoch_step_ms: 100 "
                  "replays; profile: torch.profiler over 20 graphed steps queued "
                  "back to back; test and MC seconds: host clock around test() / "
                  "infer_trainset() (pickle included), in turns; capture_seconds: "
                  "capture and instantiation; pool_bytes: memory reserved by the "
                  "capture"}})
    return {"span_decode": epoch_launches["span_decode"],
            "fused_forward": epoch_launches["fused_forward"]}


# -- phase 13 -------------------------------------------------------------------
# world 2: 20 steps and a ragged batch of 5, which runs whole on each rank;
# and one step alone
PARALLEL_W2_QUERIES = 20 * TRAIN["batch_size"] + 5
PARALLEL_ONE_STEP = TRAIN["batch_size"]
# the float-noise control: world 1 from weights scaled by 1 + 1e-7 N(0, 1);
# over the run, world 2 may stray from world 1 by up to this factor times
# the control's largest distance (the step where either leaves the other
# is itself a matter of noise)
PARALLEL_NOISE, PARALLEL_ENVELOPE = 1e-7, 10.0
# the MC sweeps at mc 0.5: world 1 over 20 batches of 96, world 2 over 10
PARALLEL_INFER = {1: 20 * 96, 2: 10 * 96}
# one rank's part of the Sweep/Train cell's table at world 2, f32
PARALLEL_TABLE_BYTES = math.ceil((CHARADES_STA["train"][1] + CHARADES_STA["test"][1]) / 2) \
    * CHARADES["max_vlen"] * CHARADES["vdim"] * 4


def parallel_trainer(root: str, config, store, dataset, queries: int, mesh,
                     table, tag: str, **train) -> Trainer:
    """A one-epoch Trainer on the first ``queries`` train queries, with
    ``mesh`` (None: unsharded)."""
    cfg = train_config(config, os.path.join(root, f"ckpt_{tag}"), epochs=1, **train)
    cfg.suffix = tag
    sub = dict(dataset, train_set=dataset["train_set"][:queries])
    return Trainer(cfg, sub, store, logger=logging.getLogger("chip_smoke.parallel"),
                   device_features=table, device=DEVICE, mesh=mesh)


def trained(tr: Trainer, loops, off_orthogonal: bool = False, noise: float = 0.0) -> dict:
    """Trainer.train() from SEED's weights: the epoch's losses and IoUs (as
    ``loops.train_epoch`` returned them), the params, the launches.
    ``off_orthogonal`` moves ``label_emb`` off its orthogonal init first, as
    the CPU tests do: at that init the penalty's gradient is rounding noise
    whose direction two summation orders pick differently, and through the
    global-norm clip it moves every update (ROADMAP queue 3), so world 2
    and world 1 could not be compared from it.  ``noise`` then scales
    every weight by 1 + noise * N(0, 1): the float-noise control."""
    tr.init_state(SEED)
    if off_orthogonal:
        flat = to_jax_params(tr.model)
        flat["params/label_emb"] = (flat["params/label_emb"] + 0.1 * np.random.default_rng(
            SEED).normal(size=flat["params/label_emb"].shape)).astype(np.float32)
        rng = np.random.default_rng(SEED + 1)
        for k, v in flat.items():
            if noise:
                flat[k] = (v * (1 + noise * rng.normal(size=v.shape))).astype(np.float32)
        tr.load_params(flat)
    reset_launches()
    with recorded(loops, "train_epoch") as epochs:
        tr.train()
    losses, ious = epochs[0]
    return {"losses": losses.cpu().numpy(), "ious": ious.cpu().numpy(),
            "flat": to_jax_params(tr.model), "launches": launch_counts()}


def test_split_outputs(tr: Trainer, mxu_bf16: bool) -> dict:
    """The clean pass of the fused sweep over the test split (K2 and K1):
    logits, spans and match scores of every query, on every rank."""
    loops, inputs, rows = tr._sweep_args("test", tr.test_set)
    out = loops.fused_infer_sweep(tr.model, *inputs, tr.word_vectors, 0.0, 0, None,
                                  mxu_bf16=mxu_bf16, rows=rows)
    res = {k: out[k].cpu().numpy() for k in ("start_logits", "end_logits",
                                             "start_index", "end_index",
                                             "match_scores")}
    T = res["start_logits"].shape[1]
    res["mask"] = (np.arange(T)[None] < tr.test_set.v_len[:, None]).astype(np.int32)
    return res


def eager_step_ms(tr: Trainer, mesh, steps_n: int = 10) -> float:
    """Host ms a train step of ``runtime/steps.py``'s eager loop on the
    Trainer's split, ending in a fetch of the losses."""
    steps_n = min(steps_n, len(tr.train_set) // TRAIN["batch_size"])
    order = torch.arange(steps_n * TRAIN["batch_size"], device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, _ = steps.train_epoch(tr.model, tr.state.opt, tr._train_data, order,
                                  TRAIN["batch_size"], tr.word_vectors, TRAIN["lr"],
                                  SEED, tr.state.step, drop_rate=TRAIN["droprate"],
                                  mesh=mesh)
    losses.cpu()
    return (time.perf_counter() - t0) * 1e3 / steps_n


def parallel_world1(root: str) -> None:
    """World 1 over NCCL, deterministic: the sharded Trainer (a mesh on a
    one-rank group, graphs captured with the collectives inside) against
    the unsharded one, bit for bit; the graphed step's ms in turns and a
    profiled step; then world 2's workload at world 1 as its reference.
    Prints one JSON line."""
    import torch.distributed as dist

    from hual_tpu_torch.parallel import make_mesh

    enable_deterministic()
    with open(os.path.join(root, "world.pkl"), "rb") as f:
        config, store, dataset = pickle.load(f)
    dist.init_process_group("nccl", init_method=f"file://{root}/init_world1", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    here = os.getcwd()
    os.chdir(root)                           # train() writes ./logs/<task>/
    try:
        mesh = make_mesh()
        out, tables, runs = {"mesh": repr(mesh)}, {}, {}
        # (a) one epoch of 1,605 queries: 100 replayed steps and a ragged one
        for name, m in (("sharded", mesh), ("unsharded", None)):
            tr = parallel_trainer(root, config, store, dataset, GRAPH_QUERIES, m,
                                  tables.get(name), name)
            tables[name] = tr.export_device_features()
            check(tr._graphs is not None, f"parallel: the {name} Trainer is not graphed")
            runs[name] = dict(trained(tr, tr._graphs), tr=tr, test=tr._sweep_ious("test"))
        s, u = runs["sharded"], runs["unsharded"]
        same = {"params": all(np.array_equal(s["flat"][k], u["flat"][k]) for k in s["flat"]),
                "losses": bool(np.array_equal(s["losses"], u["losses"])),
                "ious": bool(np.array_equal(s["ious"], u["ious"])),
                "test_ious": bool(np.array_equal(s["test"], u["test"]))}
        check(all(same.values()), f"parallel: world 1 sharded vs unsharded: {same}")
        n_test = math.ceil(len(s["tr"].test_set) / config.eval_batch_size)
        n_steps = len(s["losses"])
        for r in (s, u):
            check(r["launches"] == {"span_decode": n_steps + n_test,
                                    "fused_forward": n_test, "fused_forward_bf16": 0},
                  f"parallel: world 1 launches {r['launches']}")
        out["train"] = {"steps": n_steps, "bit_equal": same, "launches": s["launches"],
                        "graphs": s["tr"]._graphs.stats()}
        # (c) the graphed step, sharded and unsharded in turns; a profiled step
        loader = TrainLoader(s["tr"].train_set, TRAIN["batch_size"], seed=SEED)
        order = torch.from_numpy(np.concatenate(list(loader.index_iter(1)))).to(DEVICE)
        order = order[:PROFILE_STEPS * TRAIN["batch_size"]]
        step_ms: dict[str, list] = {"sharded": [], "unsharded": []}
        for name in ("sharded", "unsharded", "unsharded", "sharded"):
            tr, m = runs[name]["tr"], mesh if name == "sharded" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, _ = tr._graphs.train_epoch(
                tr.model, tr.state.opt, tr._train_data, order, TRAIN["batch_size"],
                tr.word_vectors, TRAIN["lr"], SEED, tr.state.step,
                drop_rate=TRAIN["droprate"], mesh=m)
            losses.cpu()
            step_ms[name].append((time.perf_counter() - t0) * 1e3 / PROFILE_STEPS)
        one = iter(range(10 ** 6))
        tr = s["tr"]

        def sharded_step() -> None:               # one replay, no fetch
            i = next(one) % PROFILE_STEPS
            tr._graphs.train_epoch(tr.model, tr.state.opt, tr._train_data,
                                   order[i * 16:(i + 1) * 16], TRAIN["batch_size"],
                                   tr.word_vectors, TRAIN["lr"], SEED, i,
                                   drop_rate=TRAIN["droprate"], mesh=mesh)

        profile = device_profile(sharded_step, calls=PROFILE_STEPS, top=8, match="nccl")
        out["step_ms_in_turns"] = step_ms
        out["profile_sharded_step"] = profile
        flat = s["flat"]
        for r in runs.values():
            r["tr"].close()
        del runs, s, u, tr
        torch.cuda.empty_cache()

        # (b) the fused and flax test sweeps and the MC sweep at mc 0.5 over
        # 20 batches of 96, on (a)'s weights
        sweeps = {}
        for backend in ("fused", "flax"):
            res = {}
            for name, m in (("sharded", mesh), ("unsharded", None)):
                tr = parallel_trainer(root, config, store, dataset, PARALLEL_INFER[1], m,
                                      tables[name], f"{backend}_{name}",
                                      sweep_backend=backend, mc_droprate=0.5)
                tr.load_params(flat)
                reset_launches()
                test = tr._sweep_ious("test")
                pkl = os.path.join(root, f"w1_{backend}_{name}.pkl")
                metrics = tr.infer_trainset(save_path=pkl)
                launches = launch_counts()
                with open(pkl, "rb") as fh:
                    rows = pickle.load(fh)
                res[name] = (test, rows, metrics, launches)
                tr.close()
            (ts, rs, ms, ls), (tu, ru, mu, lu) = res["sharded"], res["unsharded"]
            same_rows = len(rs) == len(ru) and all(_same_row(a, b) for a, b in zip(rs, ru))
            check(bool(np.array_equal(ts, tu)) and same_rows and ms == mu and ls == lu,
                  f"parallel: world 1 {backend} sweeps sharded vs unsharded")
            sweeps[backend] = {"test_bit_equal": True, "pickle_bit_equal": True,
                               "infer": ms, "launches": ls,
                               "batches": n_test + PARALLEL_INFER[1] // 96}
        out["sweeps"] = sweeps

        # (d) world 2's workload at world 1, sharded: its reference
        tr = parallel_trainer(root, config, store, dataset, PARALLEL_W2_QUERIES, mesh,
                              tables["sharded"], "w2_reference")
        ref = trained(tr, tr._graphs, off_orthogonal=True)
        control = trained(tr, tr._graphs, off_orthogonal=True, noise=PARALLEL_NOISE)
        tr.load_params(flat)
        tests = {mx: test_split_outputs(tr, mx) for mx in (False, True)}
        tr.close()
        tr = parallel_trainer(root, config, store, dataset, PARALLEL_ONE_STEP, mesh,
                              tables["sharded"], "w2_reference_one_step")
        one = trained(tr, tr._graphs, off_orthogonal=True)
        tr.close()
        tr = parallel_trainer(root, config, store, dataset, PARALLEL_INFER[2], mesh,
                              tables["sharded"], "w2_reference_mc", mc_droprate=0.5)
        tr.load_params(flat)
        tr.infer_trainset(save_path=os.path.join(root, "w1_reference.pkl"))
        tr.close()
        np.savez(os.path.join(root, "w1_reference.npz"), losses=ref["losses"],
                 ious=ref["ious"], **{f"flat/{k}": v for k, v in ref["flat"].items()},
                 control_losses=control["losses"],
                 **{f"control/{k}": v for k, v in control["flat"].items()},
                 one_step_loss=one["losses"],
                 **{f"one_step/{k}": v for k, v in one["flat"].items()},
                 **{f"weights/{k}": v for k, v in flat.items()},
                 **{f"test_{int(mx)}/{k}": v for mx, t in tests.items()
                    for k, v in t.items()})
    finally:
        os.chdir(here)
        dist.destroy_process_group()
    emit(out)


def parallel_world2(root: str, rank: int) -> None:
    """One of two ranks on the one card over gloo, deterministic: the
    table's bytes on the device, world 2's workload (20 steps and a ragged
    one from SEED's weights, eager), then on world 1's weights the fused
    test sweep in f32 and with bf16 products and the MC sweep over 10
    batches.  Saves its outputs beside world 1's; prints one JSON line."""
    import torch.distributed as dist

    from hual_tpu_torch.parallel import make_mesh

    enable_deterministic()
    with open(os.path.join(root, "world.pkl"), "rb") as f:
        config, store, dataset = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{root}/init_world2", rank=rank,
                            world_size=2)
    here = os.getcwd()
    os.chdir(root)
    try:
        mesh = make_mesh(device=DEVICE)
        desc = repr(mesh)
        before = torch.cuda.memory_allocated(DEVICE)
        table = (mesh.shard_rows(store.packed), None)
        table_bytes = torch.cuda.memory_allocated(DEVICE) - before
        with np.load(os.path.join(root, "w1_reference.npz")) as f:
            weights = {k[len("weights/"):]: f[k] for k in f if k.startswith("weights/")}
        tr = parallel_trainer(root, config, store, dataset, PARALLEL_W2_QUERIES, mesh,
                              table, "w2")
        check(tr._graphs is None, "parallel: a Trainer over gloo holds graphs")
        train = trained(tr, steps, off_orthogonal=True)
        step_ms = eager_step_ms(tr, mesh)
        tr.close()
        tr = parallel_trainer(root, config, store, dataset, PARALLEL_ONE_STEP, mesh,
                              table, "w2_one_step")
        one = trained(tr, steps, off_orthogonal=True)
        tr.load_params(weights)
        reset_launches()
        tests = {mx: test_split_outputs(tr, mx) for mx in (False, True)}
        test_metrics = tr.test()
        sweep_launches = launch_counts()
        tr.close()
        tr = parallel_trainer(root, config, store, dataset, PARALLEL_INFER[2], mesh,
                              table, "w2_mc", mc_droprate=0.5)
        tr.load_params(weights)
        pkl = os.path.join(root, f"w2_rank{rank}.pkl")
        reset_launches()
        infer = tr.infer_trainset(save_path=pkl)
        infer_launches = launch_counts()
        tr.close()
        np.savez(os.path.join(root, f"w2_rank{rank}.npz"), losses=train["losses"],
                 ious=train["ious"], **{f"flat/{k}": v for k, v in train["flat"].items()},
                 one_step_loss=one["losses"],
                 **{f"one_step/{k}": v for k, v in one["flat"].items()},
                 **{f"test_{int(mx)}/{k}": v for mx, t in tests.items()
                    for k, v in t.items()})
    finally:
        os.chdir(here)
        dist.destroy_process_group()
    emit({"rank": rank, "mesh": desc, "graphed": False, "table_bytes": table_bytes,
          "eager_step_ms": step_ms, "launches": {"train": train["launches"],
                                                 "test_sweeps": sweep_launches,
                                                 "infer": infer_launches},
          "test": test_metrics, "infer": infer, "wrote_pickle": os.path.exists(pkl)})


def _worker_json(proc: subprocess.CompletedProcess, what: str) -> dict:
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def k2_close(got: dict, want: dict, where: str) -> dict:
    """K2's bounds on the clean pass: logits rtol 1e-4 / atol 2e-4, match
    scores atol 1e-5, spans equal or a printed near-tie."""
    for k in ("start_logits", "end_logits"):
        check(np.allclose(got[k], want[k], rtol=1e-4, atol=2e-4), f"{where}: {k}")
    check(np.allclose(got["match_scores"], want["match_scores"], rtol=0, atol=1e-5),
          f"{where}: match scores")
    spans = [np.stack([t["start_index"], t["end_index"]], 1) for t in (got, want)]
    mask = want["mask"]
    return {"max_abs_logit_diff": float(max(np.abs(got[k] - want[k]).max()
                                            for k in ("start_logits", "end_logits"))),
            "near_ties": near_ties((want["start_logits"], want["end_logits"]), mask,
                                   spans[0], spans[1])}


def bf16_band(got: dict, want: dict, where: str) -> dict:
    """bf16 products against the world-1 bf16 sweep: bf16_charades's band
    (B), |x - ref| <= 0.05 + 0.03 max|ref| on the logits."""
    out = {}
    for k in ("start_logits", "end_logits"):
        valid = want["mask"] > 0
        d = float(np.abs(got[k] - want[k])[valid].max())
        bound = 0.05 + 0.03 * float(np.abs(want[k][valid]).max())
        check(d <= bound, f"{where}: {k} {d} over the band {bound}")
        out[k] = {"max_abs_diff": d, "band": bound}
    out["spans_differ"] = int(((got["start_index"] != want["start_index"])
                               | (got["end_index"] != want["end_index"])).sum())
    return out


def parallel_phase(workdir: str, config, store, dataset) -> dict:
    """Phase 13; returns the K1/K2 launches of its main paths."""
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "parallel")
    os.makedirs(root)
    world = os.path.join(root, "world.pkl")
    with open(world, "wb") as f:
        pickle.dump((config, store, dataset), f, protocol=pickle.HIGHEST_PROTOCOL)
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    me = [sys.executable, os.path.abspath(__file__), "--parallel-worker", root]
    t0 = time.perf_counter()
    w1 = _worker_json(subprocess.run(me + ["1", "0"], capture_output=True, text=True,
                                     env=env, timeout=600), "parallel world 1")
    w1_s = time.perf_counter() - t0
    emit({"parallel_world1": w1})
    t0 = time.perf_counter()
    procs = [subprocess.Popen(me + ["2", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in (0, 1)]
    try:
        done = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [_worker_json(subprocess.CompletedProcess(p.args, p.returncode, o, e),
                          f"parallel world 2 rank {r}")
             for r, (p, (o, e)) in enumerate(zip(procs, done))]
    w2_s = time.perf_counter() - t0
    os.remove(world)

    ref = dict(np.load(os.path.join(root, "w1_reference.npz")))
    with open(os.path.join(root, "w1_reference.pkl"), "rb") as f:
        ref_rows = pickle.load(f)
    checks = []
    for r, out in enumerate(ranks):
        got = dict(np.load(os.path.join(root, f"w2_rank{r}.npz")))
        flat = [k for k in ref if k.startswith("flat/")]
        rel = np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])
        control = np.abs(ref["control_losses"] - ref["losses"]) / np.abs(ref["losses"])
        param_diff = max(float(np.abs(got[k] - ref[k]).max()) for k in flat)
        control_param_diff = max(float(np.abs(ref["control/" + k[5:]] - ref[k]).max())
                                 for k in flat)
        one_step = [k for k in ref if k.startswith("one_step/")]
        diag = {"rank": r,
                "one_step": {"loss_rel_diff": float(abs(got["one_step_loss"][0]
                                                        - ref["one_step_loss"][0])
                                                    / abs(ref["one_step_loss"][0])),
                             "max_param_diff": max(float(np.abs(got[k] - ref[k]).max())
                                                   for k in one_step)},
                "loss_rel_diff_by_step": [float(x) for x in rel],
                "control_loss_rel_diff_by_step": [float(x) for x in control],
                "max_param_diff": param_diff, "control_max_param_diff": control_param_diff,
                "train_ious_differ": int((got["ious"] != ref["ious"]).sum())}
        emit({"parallel_world2_rank": diag})
        check(out["table_bytes"] == PARALLEL_TABLE_BYTES,
              f"parallel: rank {r} holds {out['table_bytes']} B of the table, "
              f"not {PARALLEL_TABLE_BYTES}")
        for path, n in out["launches"].items():
            check(n["span_decode"] > 0, f"parallel: rank {r} launched no K1 in {path}")
        check(out["launches"]["test_sweeps"]["fused_forward"] > 0
              and out["launches"]["test_sweeps"]["fused_forward_bf16"] > 0
              and out["launches"]["infer"]["fused_forward"] > 0,
              f"parallel: rank {r} launched no K2: {out['launches']}")
        # one step: the CPU bounds (tests/test_sharding.py's), loss rtol 1e-5,
        # params rtol 2e-4 / atol 2e-6
        check(np.allclose(got["one_step_loss"], ref["one_step_loss"], rtol=1e-5, atol=0)
              and all(np.allclose(got[k], ref[k], rtol=2e-4, atol=2e-6) for k in one_step),
              f"parallel: rank {r} one step: {diag['one_step']}")
        # 21 steps: world 1 itself strays that far from a 1e-7 change of its
        # weights (float chaos: ties in relu and max flip, Adam amplifies), so
        # world 2 is held within PARALLEL_ENVELOPE times that control: the
        # losses (at least rtol 1e-5) and the final params
        check(float(rel.max()) <= max(1e-5, PARALLEL_ENVELOPE * float(control.max())),
              f"parallel: rank {r} losses outside the noise envelope: {diag}")
        check(param_diff <= max(2e-6, PARALLEL_ENVELOPE * control_param_diff),
              f"parallel: rank {r} params outside the noise envelope: {diag}")
        f32 = k2_close({k[7:]: v for k, v in got.items() if k.startswith("test_0/")},
                       {k[7:]: v for k, v in ref.items() if k.startswith("test_0/")},
                       f"parallel: rank {r} fused test sweep")
        bf16 = bf16_band({k[7:]: v for k, v in got.items() if k.startswith("test_1/")},
                         {k[7:]: v for k, v in ref.items() if k.startswith("test_1/")},
                         f"parallel: rank {r} fused_mxu_bf16 test sweep")
        checks.append(dict(diag, fused_test=f32, fused_mxu_bf16_test=bf16))
    check([o["wrote_pickle"] for o in ranks] == [True, False],
          "parallel: a rank other than 0 wrote the pickle")
    with open(os.path.join(root, "w2_rank0.pkl"), "rb") as f:
        rows = pickle.load(f)
    check(len(rows) == len(ref_rows), "parallel: the world-2 pickle's rows")
    pick = lambda rs, k: np.stack([np.stack(x[k]) for x in rs])  # noqa: E731

    def clean(rs: list) -> dict:
        logits = pick(rs, "prop_logits")
        T = logits.shape[-1]
        return {"start_logits": logits[:, 0], "end_logits": logits[:, 1],
                "start_index": np.array([x["prop_idx"][0] for x in rs]),
                "end_index": np.array([x["prop_idx"][1] for x in rs]),
                "match_scores": np.stack([x["m_score"] for x in rs]),
                "mask": (np.arange(T)[None] < np.array([x["v_len"] for x in rs])[:, None]
                         ).astype(np.int32)}

    infer = k2_close(clean(rows), clean(ref_rows),
                     "parallel: the world-2 MC sweep's clean pass")
    valid = clean(ref_rows)["mask"][:, None, :] > 0
    mc_diff = {}
    for k in ("prop_logits1", "prop_logits2"):
        got_k, ref_k = pick(rows, k), pick(ref_rows, k)
        d = np.abs(got_k - ref_k)
        # the same masks (global draws); the eager model's products at 48
        # rows against 96 sum in other orders: K2's bound with its relative
        # term taken against the largest logit
        bound = 2e-4 + 1e-4 * float(np.abs(ref_k).max())
        mc_diff[k] = {"max_abs_diff": float(d.max()), "bound": bound,
                      "max_abs_diff_valid": float(d[np.broadcast_to(valid, d.shape)].max())}
    emit({"parallel_world2_mc_passes": mc_diff})
    for k, v in mc_diff.items():
        check(v["max_abs_diff"] <= v["bound"], f"parallel: the world-2 MC sweep's {k}: {v}")
    launches = {"span_decode": w1["train"]["launches"]["span_decode"]
                + sum(sum(o["launches"][p]["span_decode"] for p in o["launches"])
                      for o in ranks),
                "fused_forward": w1["train"]["launches"]["fused_forward"]
                + sum(sum(o["launches"][p]["fused_forward"] for p in o["launches"])
                      for o in ranks),
                "fused_forward_bf16": sum(o["launches"]["test_sweeps"]["fused_forward_bf16"]
                                          for o in ranks)}
    emit({"parallel_charades": {
        "card": CARD[0], "world1_nccl": w1, "world1_seconds": w1_s,
        "noise_control": {"scale": PARALLEL_NOISE, "envelope": PARALLEL_ENVELOPE},
        "world2_gloo": ranks, "world2_seconds": w2_s, "world2_checks": checks,
        "world2_mc_sweep": dict(infer, mc_passes=mc_diff), "graphed": {"world1_nccl": True, "world2_gloo": False},
        "table_bytes_per_rank_expected": PARALLEL_TABLE_BYTES,
        "reduced": {"world1_train": f"12,408 queries -> {GRAPH_QUERIES}, 1 epoch",
                    "world2_train": f"12,408 queries -> {PARALLEL_W2_QUERIES}, 1 epoch",
                    "mc_sweeps": f"{PARALLEL_INFER[1]} (world 1) and {PARALLEL_INFER[2]} "
                                 "(world 2) train queries",
                    "world2": "two ranks share one H100 over gloo: NCCL refuses two "
                              "ranks on one device; world >= 2 over NCCL not run"},
        "seconds": time.perf_counter() - t_phase,
        "timing": "step_ms: host clock over 20 graphed steps ending in a fetch of the "
                  "losses, sharded and unsharded in turns; eager_step_ms: host clock over "
                  "10 eager steps under gloo ending in a fetch; profile: torch.profiler "
                  "over 20 graphed sharded steps queued back to back"}})
    return launches


# -- phase 14 -------------------------------------------------------------------
MIGRATE_STEP = 12345


def migrate_phase(workdir: str, config, store, dataset, table) -> dict:
    """Phase 14; returns the K1/K2 launches of its main path: the restored
    Trainer's fused test sweep and the served chunk of 96 requests."""
    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_tf1_bundle as bundle_writer

    root = os.path.join(workdir, "migrate")
    cfg = train_config(config, os.path.join(root, "ckpt_port"), epochs=1)
    quiet = logging.getLogger("chip_smoke.migrate")
    direct = Trainer(cfg, dataset, store, logger=quiet, device_features=table,
                     device=DEVICE)
    direct.init_state(SEED + 10)
    flat = to_jax_params(direct.model)
    direct.load_params(flat)                 # the same params, loaded directly
    values = bundle_writer.saver_values(flat, dataset["word_vector"], MIGRATE_STEP,
                                        np.random.default_rng(SEED + 10))
    ckpt_dir = os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    prefix = bundle_writer.write_bundle(
        os.path.join(ckpt_dir, f"best_SeqPAN.ckpt-{MIGRATE_STEP}"), values)
    bundle_writer.write_pointer(ckpt_dir, prefix)
    write_s = time.perf_counter() - t0
    bundle_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                       for f in os.listdir(ckpt_dir))

    # the reader, and its crc check alone (crc32c over every tensor's bytes),
    # in turns
    reader_s: dict[str, list] = {"reader": [], "crc_check": []}
    for part in ("reader", "crc_check", "crc_check", "reader"):
        t0 = time.perf_counter()
        if part == "reader":
            read = load_tf1_checkpoint(ckpt_dir)
        else:
            for v in read.values():
                crc32c(np.ascontiguousarray(v).data)
        reader_s[part].append(time.perf_counter() - t0)
    check(read.keys() == values.keys()
          and all(np.asarray(read[k]).dtype == v.dtype and np.shape(read[k]) == v.shape
                  and np.asarray(read[k]).tobytes() == v.tobytes()
                  for k, v in values.items()),
          "migrate: the reader's values differ from the bundle's")
    out = os.path.join(root, "ported", "best.npz")
    t0 = time.perf_counter()
    ported, word_vectors = port_checkpoint(ckpt_dir, out)
    port_s = time.perf_counter() - t0
    check(ported.keys() == flat.keys()
          and all(ported[k].tobytes() == v.tobytes() for k, v in flat.items()),
          "migrate: the ported params differ from the written ones")
    check(np.array_equal(word_vectors, dataset["word_vector"])
          and np.array_equal(np.load(word_vectors_path(out)), dataset["word_vector"]),
          "migrate: the ported word vectors differ")

    restored = Trainer(copy.deepcopy(cfg), dataset, store, logger=quiet,
                       device_features=table, device=DEVICE)
    restored.restore(out)
    check(all(v.tobytes() == flat[k].tobytes()
              for k, v in to_jax_params(restored.model).items()),
          "migrate: Trainer.restore's params differ from the written ones")
    requests = test_requests(restored, 96)
    # the reference: the directly loaded params, the same calls (not counted)
    want_test = direct.test()
    want_out = test_split_outputs(direct, mxu_bf16=False)
    want_pred = Predictor.from_bundle(export_bundle(direct, os.path.join(root, "direct")),
                                      batch_size=96, device=DEVICE)
    want_served = want_pred.predict_batch(requests)

    reset_launches()                         # main path starts
    t0 = time.perf_counter()
    test_m = restored.test()
    test_s = time.perf_counter() - t0
    pred = Predictor.from_bundle(export_bundle(restored, os.path.join(root, "bundle")),
                                 batch_size=96, device=DEVICE)
    served = pred.predict_batch(requests)
    launches = launch_counts()               # main path ends
    n_test = math.ceil(len(restored.test_set) / cfg.eval_batch_size)
    check(launches == {"span_decode": n_test + 1, "fused_forward": n_test,
                       "fused_forward_bf16": 0},
          f"migrate: launches {launches} ({n_test} test batches, 1 served chunk)")
    got_out = test_split_outputs(restored, mxu_bf16=False)
    check_results(served, len(requests), "migrate")
    check(test_m == want_test
          and all(np.array_equal(got_out[k], want_out[k]) for k in want_out),
          "migrate: the restored model's test sweep is not bit-equal to the "
          "directly loaded params'")
    host = pred.encode_batch(requests)
    check(served == want_served
          and all(torch.equal(a, b) for a, b in zip(forward_logits(pred, host),
                                                    forward_logits(want_pred, host))),
          "migrate: the served spans or logits differ from the directly loaded params'")
    direct.close()
    restored.close()
    emit({"migrate_charades": {
        "card": CARD[0], "variables": len(values),
        "model_params": int(sum(v.size for v in flat.values())),
        "bundle_bytes": bundle_bytes, "write_seconds": write_s,
        "reader_seconds": reader_s["reader"],
        "crc_check_seconds": reader_s["crc_check"],
        "port_checkpoint_seconds": port_s, "test_seconds": test_s,
        "test": test_m, "served_requests": len(served), "launches": launches,
        "bit_equal": {"params": True, "test_sweep_logits": True,
                      "served_logits": True, "spans": True},
        "seconds": time.perf_counter() - t_phase,
        "timing": "host clock; the reader (its crc check included) and the crc "
                  "check alone over the same tensors, in turns"}})
    return launches


# -- phase 15 -------------------------------------------------------------------
# each tool at its cut: (name, arguments, K2 launched, keys its JSON holds)
TOOLS = (
    ("bench_span_decode", ["--iters", "20"], False,
     ("decode_plain_b96_t64_us", "decode_kernel_b96_t64_us", "decode_plain_b96_t100_us",
      "decode_kernel_b96_t100_us", "infer_step_plain_b96_t64_ms",
      "infer_step_kernel_b96_t64_ms")),
    ("bench_fused", ["--iters", "3", "--steps", "7"], True, ("rows", "graphed")),
    ("bench_serve", ["--single", "16", "--chunks", "2"], False,
     ("single_latency_ms", "batched")),
    ("validate_pipeline", ["--n-train", "256", "--n-test", "64", "--epochs", "1"], True,
     ("stages",)),
    ("full_loop_demo", ["--n-train", "256", "--n-test", "64", "--epochs", "1",
                        "--rounds", "1"], True, ("times", "rounds", "round_stages")),
)


def tools_phase(workdir: str) -> dict:
    """Phase 15: each of the five tools once, in its own process, at its
    cut: ``torch_bench_span_decode`` 20 calls a decoder and 4 infer steps
    (its shapes are not cut); ``torch_bench_fused`` 3 sweeps of 7 batches of
    96 a row (21 batches, 10 sweeps); ``torch_bench_serve`` 16 single
    requests and 2 chunks a batch size (64 and 10); ``torch_validate_pipeline``
    256 train / 64 test queries, 1 epoch (2,000 / 500, 3 epochs);
    ``torch_full_loop_demo`` 256 / 64 queries, 1 epoch, 1 round (12,403 /
    3,720, 50 epochs, 3 rounds).  Each must exit 0, write its JSON with the
    expected keys and launch K1; the three that run fused sweeps must launch
    K2.  Returns the launches of all five."""
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "tools")
    os.makedirs(root)
    total = {"span_decode": 0, "fused_forward": 0, "fused_forward_bf16": 0}
    runs = {}
    for name, args, with_k2, keys in TOOLS:
        out = os.path.join(root, f"torch_{name}.json")
        if name in ("bench_serve", "validate_pipeline", "full_loop_demo"):
            args = args + ["--root", os.path.join(root, name)]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", f"torch_{name}.py"),
                               *args, "--out", out], cwd=root, capture_output=True,
                              text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"tools: torch_{name} exited {proc.returncode}:\n"
                                    f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(out) as f:
            res = json.load(f)
        check(all(k in res for k in keys), f"tools: torch_{name}'s JSON lacks "
                                           f"{[k for k in keys if k not in res]}")
        n = res["launches"]
        printed = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith('{"launches"')]
        check(printed == [{"launches": n}], f"tools: torch_{name} printed {printed}")
        check(n["span_decode"] > 0 and (n["fused_forward"] > 0) == with_k2
              and n["fused_forward_bf16"] == 0,
              f"tools: torch_{name} launched {n}")
        for k in total:
            total[k] += n[k]
        if name == "full_loop_demo":
            res = {k: res[k] for k in ("times", "round_stages", "re0_launches",
                                       "launches", "card")}
        runs[name] = {"arguments": args, "seconds": seconds, "result": res}
    emit({"tools_charades": {"card": CARD[0], "runs": runs, "launches": total,
                             "seconds": time.perf_counter() - t_phase}})
    return total


def main(argv: list[str]) -> None:
    if argv[:1] == ["--resume-worker"]:
        resume_worker(argv[1])
        return
    if argv[:1] == ["--streaming-worker"]:
        streaming_worker(argv[1])
        return
    if argv[:1] == ["--graphs-worker"]:
        graphs_worker(argv[1])
        return
    if argv[:1] == ["--parallel-worker"]:
        if argv[2] == "1":
            parallel_world1(argv[1])
        else:
            parallel_world2(argv[1], int(argv[3]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is false")
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    timed("environment", environment)
    resources = timed("build", build_kernels)
    k1_main = timed("span_decode", decode_phase)
    build_root = os.path.join(ROOT, "build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        serve_launches = timed("serve", serve_phase, workdir)
        config, store, dataset = timed("sweep_dataset", sweep_dataset, workdir,
                                       np.random.default_rng(SEED + 3))
        emit({"sweep_dataset": {"seconds": seconds["sweep_dataset"],
                                "max_wlen": dataset["max_wlen"],
                                "n_train": dataset["n_train"], "n_test": dataset["n_test"]}})
        k2_main = timed("fused_forward", fused_forward_phase, dataset["max_wlen"])
        sweep_launches, table = timed("sweep_charades", sweep_phase, workdir, config,
                                      store, dataset)
        train_launches, warm, f32_train = timed("train_charades", train_phase, workdir,
                                                config, store, dataset, table)
        streaming_launches = timed("streaming_charades", streaming_phase, workdir,
                                   config, store, dataset, table, f32_train["flat"])
        bf16_main, bf16_launches, bf16_options = timed(
            "bf16_charades", bf16_phase, workdir, config, store, dataset, table,
            f32_train, dataset["max_wlen"], resources)
        loop_launches = timed("loop_charades", loop_phase, workdir, config, warm)
        graph_launches = timed("graphs_charades", graphs_phase, workdir, config, store,
                               dataset, table)
        parallel_launches = timed("parallel_charades", parallel_phase, workdir, config,
                                  store, dataset)
        migrate_launches = timed("migrate_charades", migrate_phase, workdir, config,
                                 store, dataset, table)
        tool_launches = timed("tools_charades", tools_phase, workdir)
    emit({"phase_seconds": seconds, "card": CARD[0]})
    emit({"kernels": [{
        "name": "span_decode", "route": "cuda",
        "source": "hual_tpu_torch/csrc/span_decode.cu",
        "replaces": "hual_tpu/ops/pallas/span_decode.py:33",
        "launches": (serve_launches + sweep_launches["span_decode"]
                     + train_launches["train"]["span_decode"]
                     + train_launches["mc_sweep_fused"]["span_decode"]
                     + bf16_options["span_decode"] + loop_launches["span_decode"]
                     + sum(streaming_launches.values()) + graph_launches["span_decode"]
                     + parallel_launches["span_decode"] + migrate_launches["span_decode"]
                     + tool_launches["span_decode"]),
        "launches_by_path": {"serve": serve_launches,
                             "sweep_fused": sweep_launches["span_decode"],
                             "train": train_launches["train"]["span_decode"],
                             "mc_sweep_fused":
                                 train_launches["mc_sweep_fused"]["span_decode"],
                             "bf16_options": bf16_options["span_decode"],
                             "loop": loop_launches["span_decode"],
                             **streaming_launches,
                             "graphs": graph_launches["span_decode"],
                             "parallel": parallel_launches["span_decode"],
                             "migrate": migrate_launches["span_decode"],
                             "tools": tool_launches["span_decode"]},
        "max_abs_err": k1_main["max_abs_err"],
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": None, "shape": list(MAIN_SHAPE)}, {
        "name": "fused_forward", "route": "cuda",
        "source": "hual_tpu_torch/csrc/fused_forward.cu",
        "replaces": "hual_tpu/ops/pallas/fused_forward.py:438",
        "launches": (sweep_launches["fused_forward"]
                     + train_launches["train"]["fused_forward"]
                     + train_launches["mc_sweep_fused"]["fused_forward"]
                     + bf16_options["fused_forward"] + loop_launches["fused_forward"]
                     + graph_launches["fused_forward"] + parallel_launches["fused_forward"]
                     + migrate_launches["fused_forward"] + tool_launches["fused_forward"]),
        "launches_by_path": {"sweep_fused": sweep_launches["fused_forward"],
                             "train": train_launches["train"]["fused_forward"],
                             "mc_sweep_fused":
                                 train_launches["mc_sweep_fused"]["fused_forward"],
                             "bf16_options": bf16_options["fused_forward"],
                             "loop": loop_launches["fused_forward"],
                             "graphs": graph_launches["fused_forward"],
                             "parallel": parallel_launches["fused_forward"],
                             "migrate": migrate_launches["fused_forward"],
                             "tools": tool_launches["fused_forward"]},
        "max_abs_err": k2_main["max_abs_err"],
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": None, "shape": [k2_main["B"], k2_main["T"], k2_main["W"]]}, {
        "name": "fused_forward_bf16", "route": "cuda",
        "source": "hual_tpu_torch/csrc/fused_forward.cu",
        "replaces": "hual_tpu/ops/pallas/fused_forward.py:438",
        "branch": "mxu_bf16 (_forward_math, hual_tpu/ops/pallas/fused_forward.py:189-224)",
        "launches": bf16_launches + parallel_launches["fused_forward_bf16"],
        "launches_by_path": {"sweep_fused_mxu_bf16": bf16_launches,
                             "parallel": parallel_launches["fused_forward_bf16"]},
        "max_abs_err": bf16_main["max_abs_err"],
        "error_stats": bf16_main["errors"],
        "ms": bf16_main["ms"], "plain_ms": bf16_main["plain_ms"],
        "bound_ms": bf16_main["bound_ms"], "bound_by": bf16_main["bound_by"],
        "library_ms": None,
        "shape": [bf16_main["B"], bf16_main["T"], bf16_main["W"]]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main(sys.argv[1:])
