#!/usr/bin/env python3
"""Drive the PyTorch port (``hual_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports neither JAX nor ``hual_tpu``.  Phases, each printing one JSON
line; any failure exits non-zero before the last line:

1. environment: ``nvidia-smi`` name and power limit, torch / CUDA versions,
   the TF32 flags after the port pins full fp32;
2. build: every kernel of ``hual_tpu_torch/csrc`` compiled for sm_90a, one
   nvcc per source, all started together; ptxas's registers and spills per
   kernel (any spill fails), and the count of DMMA (f64 tensor-core)
   instructions in K2's SASS by ``cuobjdump -sass`` (0 fails);
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
8. kernels: one entry per ported kernel with its launches on the main
   paths and its check against the plain version.

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
from hual_tpu_torch.config import Config, apply_matmul_precision
from hual_tpu_torch.data.datasets import gen_or_load_dataset
from hual_tpu_torch.data.features import FeatureStore, visual_feature_sampling
from hual_tpu_torch.data.loader import EvalLoader
from hual_tpu_torch.data.vocab import PAD, UNK
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops import decode
from hual_tpu_torch.ops.fused_forward import (PackedWeights, forward_math,
                                              pack_weights)
from hual_tpu_torch.ops.kernels import build
from hual_tpu_torch.ops.kernels import fused_forward as k2
from hual_tpu_torch.ops.kernels import span_decode as k1
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.runtime.trainer import Trainer
from hual_tpu_torch.serve import Predictor, export_bundle

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
# fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12


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


def launch_ms(profile: dict) -> tuple[float, float]:
    """(ms in the kernel per launch, launches captured per call) of the top
    kernel of a profile whose calls launch one kernel each.  The profiler
    may capture fewer launches than calls were made, so the time is taken
    per captured launch, not per call."""
    k = profile["top_kernels"][0]
    return k["ms_per_call"] / k["launches_per_call"], k["launches_per_call"]


def device_profile(fn, calls: int = 3, top: int = 12) -> dict:
    """Device time by kernel over ``calls`` calls of ``fn`` (torch.profiler).

    The device's idle share is the part of the span from the first kernel's
    start to the last one's end in which no kernel ran (one stream, so
    kernels do not overlap).
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
    return {"calls": calls, "kernels_per_call": len(kernels) / calls,
            "busy_ms_per_call": busy_us / calls / 1e3,
            "span_ms_per_call": span_us / calls / 1e3,
            "device_idle_share": 1.0 - busy_us / span_us if span_us else None,
            "top_kernels": [{"name": name[:80], "ms_per_call": us / calls / 1e3,
                             "launches_per_call": n / calls}
                            for name, (us, n) in ranked]}


# -- phase 1 ------------------------------------------------------------------
def environment() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
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
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
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
    emit({"build": {"seconds": time.perf_counter() - t0, "compiled": compiled,
                    "ptxas": resources, "fused_forward_sass_dmma": dmma,
                    "arch": build.ARCH, "nvcc_flags": list(build.NVCC_FLAGS),
                    "libraries": [os.path.relpath(build.library_path(n), ROOT)
                                  for n in names]}})


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
            "busy_us": launch_ms(busy)[0] * 1e3,
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
    return export_bundle(model, path, config=config, word_dict=word_dict,
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


def fused_forward_phase(W: int) -> dict:
    """K2 against its plain version on the card at the sweep's shapes."""
    rng = np.random.default_rng(SEED + 2)
    # at ActivityNet width the queries take the serve phase's word bound;
    # (3,17,5) is ragged in every tile dimension (weights of the T=64 model)
    shapes = ((96, 64, W), (8, 64, W), (5, 64, W), (1, 64, W), (32, 100, MAX_WLEN),
              (3, 17, 5))
    packs = {}
    for T in (64, 100):
        model = SeqPAN(**{k: v for k, v in CHARADES.items() if k not in ("name", "max_tlen")}
                       | {"max_vlen": T, "num_chars": 60},
                       generator=torch.Generator().manual_seed(SEED)).to(DEVICE).eval()
        packs[T] = pack_weights(model)
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
        k1.span_decode.launches = k2.fused_forward.launches = 0   # main path starts
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
            o = sweep(tr.model, data, sels, tr.word_vectors)
            outs[split, backend] = {
                k: np.concatenate([v.cpu().numpy()[i, :n] for i, (_, n) in enumerate(pairs)])
                for k, v in o.items()}
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
    return runs["fused"]["launches"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is false")
    environment()
    build_kernels()
    k1_main = decode_phase()
    build_root = os.path.join(ROOT, "build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        serve_launches = serve_phase(workdir)
        t0 = time.perf_counter()
        config, store, dataset = sweep_dataset(workdir, np.random.default_rng(SEED + 3))
        emit({"sweep_dataset": {"seconds": time.perf_counter() - t0,
                                "max_wlen": dataset["max_wlen"],
                                "n_train": dataset["n_train"], "n_test": dataset["n_test"]}})
        k2_main = fused_forward_phase(dataset["max_wlen"])
        sweep_launches = sweep_phase(workdir, config, store, dataset)
    emit({"kernels": [{
        "name": "span_decode", "route": "cuda",
        "source": "hual_tpu_torch/csrc/span_decode.cu",
        "replaces": "hual_tpu/ops/pallas/span_decode.py:33",
        "launches": serve_launches + sweep_launches["span_decode"],
        "launches_by_path": {"serve": serve_launches,
                             "sweep_fused": sweep_launches["span_decode"]},
        "max_abs_err": k1_main["max_abs_err"],
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": None, "shape": list(MAIN_SHAPE)}, {
        "name": "fused_forward", "route": "cuda",
        "source": "hual_tpu_torch/csrc/fused_forward.cu",
        "replaces": "hual_tpu/ops/pallas/fused_forward.py:438",
        "launches": sweep_launches["fused_forward"],
        "launches_by_path": {"sweep_fused": sweep_launches["fused_forward"]},
        "max_abs_err": k2_main["max_abs_err"],
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": None, "shape": [k2_main["B"], k2_main["T"], k2_main["W"]]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
