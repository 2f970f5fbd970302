#!/usr/bin/env python
"""The int8 feature table against f32 and bf16, on the card.

The port's counterpart of tools/bench_int8_table.py, in two parts:

1. ``upload_probe``: a seeded host table of ``--rows`` x 64 x 1,024 f32
   (256 MiB at 1,024 rows); the host seconds of its int8 quantization
   (``data.features.quantize_features``: per-clip scales), then the
   seconds to upload it as f32, as bf16 (converted on the host first) and
   as int8 with its scales, each the least of 2 trials, the clock ending at
   a synchronisation and a fetch of each array's last element (a first
   upload warms the copy engine up);
2. ``gather_path``: over a device-resident split of N=2,000 at Charades
   width (T=64, vdim 1,024, D=128), seeded weights, with its table f32 and
   then int8 (dequantized on the gather: ``runtime.steps.gather_batch``):
   the graphed train epoch at ``--batch`` (``runtime/graphs.py``) and the
   graphed ``fused`` MC sweep at ``mc_droprate`` 0.5 in batches of 96 (the
   clean pass on K2 and K1), pairs/s and ms each, and each one's share of
   the f32 peak (``count_flops`` over the eager step; above 1 the tool
   exits non-zero); the int8 rows over the f32 rows.

Launches K1 and K2.  On the CPU the loops are eager, K2 through its plain
version, and an upload is a host copy.

Protocol: ``seconds_per_call`` over ``--iters`` epochs or sweeps after 2
warm-up ones (the first captures the graphs), the host clock ending at a
synchronisation and a fetch of the last one's losses or IoUs.

Writes results/torch_bench_int8_table.json (``--out``).

    python tools/torch_bench_int8_table.py [--rows 1024] [--iters 10]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tool_common import (Loops, add_common_flags, count_flops,  # noqa: E402
                               device_info, device_of, peak_share, reset_launches,
                               seconds_per_call, seeded_model, synchronize,
                               synthetic_split, train_step_call, write_result)

from hual_tpu_torch.data.features import quantize_features  # noqa: E402
from hual_tpu_torch.runtime import steps  # noqa: E402

DATA = dict(n=2000, T=64, vdim=1024)     # bench.build's (the tests narrow it)
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)
PROBE = dict(T=64, vdim=1024)            # the upload probe's clips and width
SWEEP_BATCH = 96


def timed_upload(tensors: list[torch.Tensor], device: torch.device,
                 trials: int = 2) -> float:
    """The least seconds over ``trials`` to copy ``tensors`` to ``device``,
    ending at a synchronisation and a fetch of each copy's last element."""
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        on_dev = [t.to(device, copy=True) for t in tensors]
        synchronize(device)
        probe = sum(float(t.reshape(-1)[-1].float().cpu()) for t in on_dev)
        best = min(best, time.perf_counter() - t0)
        if not np.isfinite(probe):
            raise RuntimeError(f"a non-finite upload: {probe}")
        del on_dev
    return best


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=1024,
                    help="table rows of the upload probe (1,024 = 256 MiB f32)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    add_common_flags(ap, "bench_int8_table")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()

    # -- 1. the upload probe: one table, three storage dtypes
    rng = np.random.default_rng(0)
    table = rng.standard_normal((args.rows, PROBE["T"], PROBE["vdim"]), dtype=np.float32)
    t0 = time.perf_counter()
    q, scales = quantize_features(table)
    quantize_s = time.perf_counter() - t0
    host = torch.from_numpy(table)
    timed_upload([torch.zeros((2, 1024, 1024))], device, trials=1)
    uploads = {"float32": timed_upload([host], device),
               "bfloat16": timed_upload([host.to(torch.bfloat16)], device),
               "int8": timed_upload([torch.from_numpy(q), torch.from_numpy(scales)],
                                    device)}
    del host, table, q, scales

    # -- 2. the gather path: train epoch and AL sweep on f32 and int8 tables
    N, T, B = DATA["n"], DATA["T"], args.batch
    data, word_vectors = synthetic_split(device, N, T, DATA["vdim"])
    q2, scales2 = quantize_features(data["features"].cpu().numpy())
    data_int8 = dict(data, features=torch.from_numpy(q2).to(device),
                     feature_scales=torch.from_numpy(scales2).to(device))
    del q2, scales2
    n_sweep = N - N % SWEEP_BATCH
    sweep_sels = torch.arange(n_sweep, device=device).view(-1, SWEEP_BATCH)
    # the work does not depend on the table's dtype: counted once, on f32
    model = seeded_model(device, max_vlen=T, vdim=DATA["vdim"], **WIDTHS)
    train_flops = count_flops(train_step_call(model, data, word_vectors, B))
    gens = [torch.Generator(device=device).manual_seed(k) for k in range(2)]
    sweep_flops = count_flops(lambda: steps.infer_step(
        model, steps.gather_batch(data, sweep_sels[0]), word_vectors, 0.5, gens))
    rows = []
    for name, d in (("float32", data), ("int8", data_int8)):
        model = seeded_model(device, max_vlen=T, vdim=DATA["vdim"], **WIDTHS)
        loops = Loops(device)
        dt_train = seconds_per_call(loops.epoch(model, d, word_vectors, B, N // B),
                                    device, args.iters)
        seed = [0]

        def sweep_once():
            seed[0] += 1
            return loops.sweep("fused_infer_sweep", model, d, sweep_sels, word_vectors,
                               mc_droprate=0.5, seed=seed[0])["ious"]

        dt_sweep = seconds_per_call(sweep_once, device, args.iters)
        loops.close()
        rows.append({
            "table_dtype": name,
            "train_pairs_per_sec": N // B * B / dt_train,
            "train_epoch_ms": dt_train * 1e3,
            "train_mfu": peak_share(f"train {name}", train_flops * (N // B),
                                    dt_train, "float32"),
            "sweep_pairs_per_sec": n_sweep / dt_sweep,
            "sweep_ms": dt_sweep * 1e3,
            "sweep_mfu": peak_share(f"sweep {name}", sweep_flops * len(sweep_sels),
                                    dt_sweep, "float32")})
        print(json.dumps(rows[-1]), flush=True)

    f32_row, i8_row = rows
    write_result(args.out, {
        **device_info(device),
        "graphed": device.type == "cuda",
        "upload_probe": {
            "shape": [args.rows, PROBE["T"], PROBE["vdim"]],
            "f32_mib": args.rows * PROBE["T"] * PROBE["vdim"] * 4 / 2 ** 20,
            "quantize_host_s": quantize_s,
            "upload_s": uploads,
            "int8_speedup_vs_f32": uploads["float32"] / uploads["int8"]},
        "gather_path": {
            "rows": rows,
            "train_ratio_int8_vs_f32": i8_row["train_pairs_per_sec"]
            / f32_row["train_pairs_per_sec"],
            "sweep_ratio_int8_vs_f32": i8_row["sweep_pairs_per_sec"]
            / f32_row["sweep_pairs_per_sec"]},
        "protocol": "epochs and sweeps: host clock over --iters runs ending at a "
                    "synchronisation and a fetch of the last run's losses or IoUs, "
                    "after 2 warm-up runs; uploads: the least of 2 trials, ending "
                    "at a synchronisation and a fetch of each array's last element"})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
