#!/usr/bin/env python
"""The train epoch at ``model.compute_dtype`` float32 against bfloat16, on
the card.

The port's counterpart of tools/bench_bf16_train.py: the graphed train
epoch (``runtime/graphs.py``, the step captured once and replayed per
batch) at ``--batch`` over a device-resident split of N=2,000 samples at
Charades width (T=64, vdim 1,024, D=128), seeded weights (the same for
both dtypes), drop 0.2, once with f32 activations and once with bf16 ones
(f32 parameters, optimizer and sums: ``models/seqpan.py``).  A row:
pairs/s, ms an epoch (``scanned_epoch_ms``, the JAX tool's name for its
scanned epoch) and a step, the FLOPs of one step (``count_flops`` over an
eager step) and the share of the dtype's peak (``mfu``: 67 TFLOP/s f32,
989 bf16; above 1 the tool exits non-zero); ``bf16_speedup`` is bf16's
pairs/s over f32's.  Launches K1.  On the CPU the epoch is eager.

Protocol: ``seconds_per_call`` over ``--iters`` epochs after 2 warm-up
epochs (the first captures the graph), the host clock ending at a
synchronisation and a fetch of the last epoch's losses.

Writes results/torch_bench_bf16_train.json (``--out``).

    python tools/torch_bench_bf16_train.py [--iters 10] [--batch 16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tool_common import (Loops, PEAK_FLOPS, add_common_flags,  # noqa: E402
                               count_flops, device_info, device_of, peak_share,
                               reset_launches, seconds_per_call, seeded_model,
                               synthetic_split, train_step_call, write_result)

DATA = dict(n=2000, T=64, vdim=1024)     # bench.build's (the tests narrow it)
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    add_common_flags(ap, "bench_bf16_train")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()

    N, T, B = DATA["n"], DATA["T"], args.batch
    S = N // B
    data, word_vectors = synthetic_split(device, N, T, DATA["vdim"])
    rows = []
    for dtype in ("float32", "bfloat16"):
        model = seeded_model(device, max_vlen=T, vdim=DATA["vdim"],
                             compute_dtype=dtype, **WIDTHS)
        flops = count_flops(train_step_call(model, data, word_vectors, B))
        loops = Loops(device)
        dt = seconds_per_call(loops.epoch(model, data, word_vectors, B, S), device,
                              args.iters)
        loops.close()
        rows.append({"compute_dtype": dtype, "pairs_per_sec": S * B / dt,
                     "scanned_epoch_ms": dt * 1e3, "step_ms": dt * 1e3 / S,
                     "step_flops_g": flops / 1e9,
                     "mfu": peak_share(f"train {dtype}", flops * S, dt, dtype)})
        print(json.dumps(rows[-1]), flush=True)

    f32, bf16 = rows
    write_result(args.out, {
        **device_info(device),
        "workload": f"graphed train epoch, Charades width B={B} T={T} "
                    f"vdim={DATA['vdim']}, N={N}, drop 0.2",
        "graphed": device.type == "cuda",
        "peak_flops_assumed": PEAK_FLOPS,
        "protocol": "host clock over --iters epochs ending at a synchronisation "
                    "and a fetch of the last epoch's losses, after 2 warm-up epochs",
        "rows": rows,
        "bf16_speedup": bf16["pairs_per_sec"] / f32["pairs_per_sec"]})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
