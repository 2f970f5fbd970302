#!/usr/bin/env python
"""The eval sweep's throughput against its batch size, on the card.

The port's counterpart of tools/bench_eval_batch.py: the graphed ``fused``
eval sweep (``runtime/graphs.py``: one captured step a batch, the input
front, K2 and K1 inside; the sweep every epoch of the loop runs over the
test split) at each of ``--batches``, over ``--pairs`` samples of a
device-resident split of N=2,000 at Charades width (D=128, vdim 1,024),
at T=64 (Charades) and T=100 (ActivityNet's clips), seeded weights.  A
row of ``grid``: pairs/s and ms a sweep (``dispatch_ms``), the FLOPs of
one batch (``count_flops`` over the eager forward, which computes K2's
function) and the share of the f32 peak (``mfu``; K2's f64 sums run on the
FP64 tensor cores at the same 67 TFLOP/s; above 1 the tool exits
non-zero).  ``best`` holds each T's fastest row.  Launches K2 (f64 path)
and K1.  On the CPU the sweep is eager, through K2's plain version.

Protocol: ``seconds_per_call`` over ``--iters`` sweeps after 2 warm-up
sweeps (the first captures the graph), the host clock ending at a
synchronisation and a fetch of the last sweep's IoUs.

Writes results/torch_bench_eval_batch.json (``--out``).

    python tools/torch_bench_eval_batch.py [--iters 10] [--batches 16 48 96 192]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tool_common import (Loops, add_common_flags, count_flops,  # noqa: E402
                               device_info, device_of, peak_share, reset_launches,
                               seconds_per_call, seeded_model, synthetic_split,
                               write_result)

from hual_tpu_torch.runtime import steps  # noqa: E402

DATA = dict(n=2000, vdim=1024)           # bench.build's (the tests narrow it)
CLIPS = (64, 100)      # Charades' and ActivityNet's T (the tests narrow them)
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 48, 96, 192])
    ap.add_argument("--pairs", type=int, default=2016,
                    help="samples a timed sweep (divisible by the batches)")
    add_common_flags(ap, "bench_eval_batch")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()

    N = DATA["n"]
    grid = []
    for T in CLIPS:
        data, word_vectors = synthetic_split(device, N, T, DATA["vdim"])
        model = seeded_model(device, max_vlen=T, vdim=DATA["vdim"], **WIDTHS)
        loops = Loops(device)
        for B in args.batches:
            S = args.pairs // B
            sels = (torch.arange(S * B, device=device) % N).view(S, B)
            flops = count_flops(lambda: steps.eval_step(
                model, steps.gather_batch(data, sels[0]), word_vectors))
            dt = seconds_per_call(lambda: loops.sweep(
                "fused_eval_sweep", model, data, sels, word_vectors), device, args.iters)
            row = {"T": T, "batch_size": B, "n_batches": S,
                   "pairs_per_sec": S * B / dt, "dispatch_ms": dt * 1e3,
                   "batch_flops_g": flops / 1e9,
                   "mfu": peak_share(f"eval T={T} B={B}", flops * S, dt, "float32")}
            grid.append(row)
            print(json.dumps(row), flush=True)
        loops.close()
        del data, word_vectors, model

    best = {f"T{T}": max((r for r in grid if r["T"] == T),
                         key=lambda r: r["pairs_per_sec"]) for T in CLIPS}
    write_result(args.out, {
        **device_info(device),
        "workload": "graphed fused eval sweep (1 deterministic forward a sample: "
                    "input front, K2, K1), Charades width at T=64 and T=100",
        "graphed": device.type == "cuda",
        "peak_flops_assumed": {"float32": 67e12},
        "protocol": "host clock over --iters sweeps ending at a synchronisation "
                    "and a fetch of the last sweep's IoUs, after 2 warm-up sweeps",
        "grid": grid, "best": best})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
