#!/usr/bin/env python
"""The train epoch's throughput against its batch size, on the card.

The port's counterpart of tools/bench_train_batch.py: the graphed train
epoch (``runtime/graphs.py``: the production step, forward + backward +
BERT-AdamW + K1 + the IoU, captured once per batch size and replayed per
batch) at each of ``--batches`` over a device-resident split of N=2,000
samples at Charades width (T=64, vdim 1,024, D=128), seeded weights, drop
0.2, f32.  A row: pairs/s, ms an epoch and a step, the FLOPs of one step
(``count_flops`` over an eager step) and the share of the f32 peak
(``mfu``; above 1 the tool exits non-zero).

It is a throughput knob, not a speed-up: another batch than 16 changes the
optimisation against the reference schedule (``train.batch_size`` 16).
Launches K1.  On the CPU the epoch is eager.

Protocol: ``seconds_per_call`` over ``--iters`` epochs after 2 warm-up
epochs (the first captures the graph), the host clock ending at a
synchronisation and a fetch of the last epoch's losses.

Writes results/torch_bench_train_batch.json (``--out``).

    python tools/torch_bench_train_batch.py [--iters 10] [--batches 16 32 64 128 256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tool_common import (Loops, add_common_flags, count_flops,  # noqa: E402
                               device_info, device_of, peak_share, reset_launches,
                               seconds_per_call, seeded_model, synthetic_split,
                               train_step_call, write_result)

DATA = dict(n=2000, T=64, vdim=1024)     # bench.build's (the tests narrow it)
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 32, 64, 128, 256])
    add_common_flags(ap, "bench_train_batch")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()

    N, T = DATA["n"], DATA["T"]
    data, word_vectors = synthetic_split(device, N, T, DATA["vdim"])
    rows = []
    for B in args.batches:
        S = N // B
        model = seeded_model(device, max_vlen=T, vdim=DATA["vdim"], **WIDTHS)
        flops = count_flops(train_step_call(model, data, word_vectors, B))
        loops = Loops(device)
        dt = seconds_per_call(loops.epoch(model, data, word_vectors, B, S), device,
                              args.iters)
        loops.close()
        row = {"batch_size": B, "steps_per_epoch": S, "pairs_per_sec": S * B / dt,
               "epoch_ms": dt * 1e3, "step_ms": dt * 1e3 / S,
               "step_flops_g": flops / 1e9,
               "mfu": peak_share(f"train B={B}", flops * S, dt, "float32")}
        rows.append(row)
        print(json.dumps(row), flush=True)

    best = max(rows, key=lambda r: r["pairs_per_sec"])
    b16 = next((r for r in rows if r["batch_size"] == 16), None)
    out = {
        **device_info(device),
        "workload": f"graphed train epoch (fwd+bwd+BERT-AdamW+K1+IoU), Charades "
                    f"width T={T} vdim={DATA['vdim']}, N={N}, drop 0.2, f32",
        "graphed": device.type == "cuda",
        "protocol": "host clock over --iters epochs ending at a synchronisation "
                    "and a fetch of the last epoch's losses, after 2 warm-up "
                    "epochs; one capture a batch size",
        "caveat": "throughput knob only: a batch other than 16 departs from the "
                  "reference optimisation schedule",
        "rows": rows, "best": best}
    if b16 is not None:
        out["speedup_vs_b16"] = best["pairs_per_sec"] / b16["pairs_per_sec"]
    write_result(args.out, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
