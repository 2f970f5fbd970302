#!/usr/bin/env python3
"""Probe where the port's train step spends its time on one NVIDIA GPU.

For each tree given (a directory holding a ``hual_tpu_torch`` package; the
repository root by default) a fresh process imports the package from that
tree and runs ``runtime.steps.train_step`` on SeqPAN at Charades width
(B=16, T=64, D=128, 8 heads, 2 layers, drop 0.2, ``span_decode: pallas``)
on seeded random batches, then prints one JSON line:

* ``step_ms``: host clock per step over ``--steps`` steps after 5 warm-up
  steps, ending in a synchronize;
* ``kernels_per_step``, ``busy_ms_per_step``, ``device_idle_share``:
  torch.profiler over 10 steps;
* ``syncs``: the Python lines that made the host wait for the card in two
  steps, with counts (``torch.cuda.set_sync_debug_mode("warn")``);
* ``host_top``: the operators with the most host time of their own over 5
  steps (torch.profiler ``self_cpu_time_total``).

Trees run in the order given, so ``A B B A`` compares two versions inside
one call.  Run from the repository root:
``python3 tools/torch_train_probe.py [--steps N] [TREE ...]``.  Needs the
card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(steps: int) -> dict:
    import warnings

    import numpy as np
    import torch

    from hual_tpu_torch.config import apply_matmul_precision
    from hual_tpu_torch.data.labels_device import make_span_labels_device
    from hual_tpu_torch.models.seqpan import SeqPAN
    from hual_tpu_torch.ops.optim import make_optimizer
    from hual_tpu_torch.runtime import steps as st

    dev = torch.device("cuda")
    apply_matmul_precision("default")
    B, T, W, C, n_words, n_chars = 16, 64, 13, 12, 1002, 60
    rng = np.random.default_rng(0)
    model = SeqPAN(vdim=1024, dim=128, num_heads=8, attn_layer=2, max_vlen=T,
                   word_dim=300, char_dim=50, num_chars=n_chars, span_decode="pallas",
                   generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model, 1.0, 0.01)
    wv = torch.from_numpy(rng.normal(size=(n_words - 2, 300)).astype(np.float32)).to(dev)
    batches = []
    for _ in range(8):
        v_len = rng.integers(8, T + 1, B).astype(np.int32)
        q_len = rng.integers(4, W + 1, B)
        word_ids = np.where(np.arange(W)[None] < q_len[:, None],
                            rng.integers(2, n_words, (B, W)), 0).astype(np.int32)
        char_ids = rng.integers(1, n_chars, (B, W, C)).astype(np.int32)
        char_ids[word_ids == 0] = 0
        s = rng.integers(0, v_len).astype(np.int32)
        b = {"video_features": rng.normal(size=(B, T, 1024)).astype(np.float32),
             "video_seq_len": v_len, "word_ids": word_ids, "char_ids": char_ids,
             "s_ind": s, "e_ind": np.minimum(s + 8, v_len - 1).astype(np.int32),
             "duration": rng.uniform(10, 40, B).astype(np.float32)}
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        y1, y2, match, inner = make_span_labels_device(b["s_ind"], b["e_ind"],
                                                       b["video_seq_len"], T)
        b.update(y1=y1, y2=y2, match_labels=match, inner_labels=inner)
        batches.append(b)
    count = iter(range(10 ** 6))

    def step():
        i = next(count)
        st.train_step(model, opt, batches[i % len(batches)], wv, 1e-4,
                      st.make_generator(dev, 0, i), drop_rate=0.2)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    import time
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(2):
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
    torch.cuda.synchronize()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name for e in events if e.is_user_annotation}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    with profile(activities=[ProfilerActivity.CPU]) as host:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    top = sorted(host.key_averages(), key=lambda a: -a.self_cpu_time_total)[:15]
    return {"step_ms": step_ms, "steps": steps,
            "kernels_per_step": len(kernels) / 10, "busy_ms_per_step": busy / 10 / 1e3,
            "device_idle_share": 1.0 - busy / span,
            "syncs_in_two_steps": syncs,
            "host_top": [{"op": a.key[:60], "calls_per_step": a.count / 5,
                          "self_ms_per_step": a.self_cpu_time_total / 5 / 1e3}
                         for a in top]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*", default=[ROOT])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(measure(args.steps)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for tree in args.trees:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               "--steps", str(args.steps)], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        print(json.dumps({"tree": os.path.relpath(tree, ROOT), "card": smi,
                          **json.loads(proc.stdout.strip().splitlines()[-1])}), flush=True)


if __name__ == "__main__":
    main()
