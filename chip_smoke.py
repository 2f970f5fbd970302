#!/usr/bin/env python3
"""Drive the PyTorch port (``hual_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports neither JAX nor ``hual_tpu``.  Phases, each printing one JSON
line; any failure exits non-zero before the last line:

1. environment: ``nvidia-smi`` name and power limit, torch / CUDA versions,
   the TF32 flags after the port pins full fp32;
2. build: every kernel of ``hual_tpu_torch/csrc`` compiled for sm_90a, one
   nvcc per source, all started together;
3. span_decode: the kernel against its plain PyTorch version on the card,
   at the main path's shapes and larger, indices exactly equal; CUDA-event
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
5. kernels: one entry per ported kernel with its launches on the main path
   and its check against the plain version.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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
from hual_tpu_torch.data.vocab import PAD, UNK
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops import decode
from hual_tpu_torch.ops.kernels import build
from hual_tpu_torch.ops.kernels import span_decode as k1
from hual_tpu_torch.serve import Predictor, export_bundle

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# model section of configs/charades/SeqPAN.yaml and configs/anet/SeqPAN.yaml
# (the machine with the card may have no pyyaml)
CHARADES = dict(name="SeqPAN", max_vlen=64, max_tlen=30, vdim=1024, dim=128,
                num_heads=8, word_dim=300, char_dim=50, attn_layer=2)
ANET = dict(CHARADES, max_vlen=100, char_dim=100)
SERVE_BATCHES = (8, 32, 96)
N_REQUESTS = 203            # ragged final chunk at every batch size
MAX_WLEN, MAX_CLEN = 30, 12
DECODE_SHAPES = ((8, 64), (32, 64), (96, 64), (32, 100), (96, 100), (256, 100),
                 (5, 33), (3, 1))   # the last two: a ragged block, T=1
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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured: the profiler recorded no kernel"}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
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
def build_kernels() -> None:
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    compiled = build.build(names)
    check(set(compiled) == set(names),
          f"kernels were not built from the sources: {sorted(compiled)} of {names}")
    emit({"build": {"seconds": time.perf_counter() - t0, "compiled": compiled,
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
            "busy_us": busy["busy_ms_per_call"] * 1e3,
            "plain_busy_us": plain_busy["busy_ms_per_call"] * 1e3,
            "plain_kernels_per_call": plain_busy["kernels_per_call"],
            "queue": queue, "plain_queue": plain_queue,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops})
    emit({"span_decode": {"exact": True, "shapes": rows,
                          "timing": "ms: median of 100 calls by CUDA events, queued "
                                    "behind device sleeps; busy_us: kernel time per "
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is false")
    environment()
    build_kernels()
    k1_main = decode_phase()
    build_root = os.path.join(ROOT, "build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        launches = serve_phase(workdir)
    emit({"kernels": [{
        "name": "span_decode", "route": "cuda",
        "source": "hual_tpu_torch/csrc/span_decode.cu",
        "replaces": "hual_tpu/ops/pallas/span_decode.py:33",
        "launches": launches, "max_abs_err": k1_main["max_abs_err"],
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": None, "shape": list(MAIN_SHAPE)}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
