#!/usr/bin/env python
"""The AL sweep's MC-dropout passes folded against sequential, on the card.

The port's counterpart of tools/sweep_ablation.py: the graphed AL
inference sweep (``runtime/graphs.py``; the clean pass and two MC passes at
``--mc`` a batch) over ``--pairs`` samples of a device-resident split of
N=2,000 at Charades width (T=64, vdim 1,024, D=128), seeded weights, for
each ``train.fold_mc`` of ``--folds`` x infer batch of ``--batches``, on
both sweep backends (``train.sweep_backend``):

* ``flax``: the eager model; folded (``fold_mc`` 1), the three passes run
  as one forward over 3B rows, else one after the other;
* ``fused``: the clean pass through the input front, K2 and K1, the MC
  passes on the eager model, one after the other.  ``train.fold_mc``
  folds the eager sweeps only (``runtime/steps.py``), so the grid has no
  folded ``fused`` row: ``not_applicable`` says so.

``--mc-dtype bfloat16`` runs the MC passes at bf16 activations
(``train.mc_dtype``; a bf16 ``mc_model`` never folds).  A row of ``grid``:
pairs/s, ms a sweep (``dispatch_ms``), the FLOPs of one batch
(``count_flops`` over the eager step, which computes the same passes) and
the share of the peak (``mfu``: of the f32 peak, of the bf16 peak when the
MC passes run in bf16, a guard that is then lenient; above 1 the tool
exits non-zero).  ``best`` is the fastest row.  Launches K2 on the
``fused`` rows' clean passes, and K1 on every clean pass.  On the CPU the
sweeps are eager, K2 through its plain version.

Protocol: ``seconds_per_call`` over ``--iters`` sweeps after 2 warm-up
sweeps (the first captures the graph), each with new MC streams, the
host clock ending at a synchronisation and a fetch of the last sweep's
IoUs.

Writes results/torch_sweep_ablation.json (``--out``; ``--out-suffix``
goes before its ``.json``).

    python tools/torch_sweep_ablation.py [--iters 10] [--pairs 4096] [--mc-dtype bfloat16]
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

DATA = dict(n=2000, T=64, vdim=1024)     # bench.build's (the tests narrow it)
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)
SWEEPS = {"flax": "infer_sweep", "fused": "fused_infer_sweep"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=4096, help="samples a timed sweep")
    ap.add_argument("--mc", type=float, default=0.5)
    ap.add_argument("--batches", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--folds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--mc-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="activation dtype of the MC passes (train.mc_dtype)")
    ap.add_argument("--out-suffix", default="")
    add_common_flags(ap, "sweep_ablation")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()

    N, T = DATA["n"], DATA["T"]
    data, word_vectors = synthetic_split(device, N, T, DATA["vdim"])
    model = seeded_model(device, max_vlen=T, vdim=DATA["vdim"], **WIDTHS)
    mc_model = (model.with_compute_dtype("bfloat16")
                if args.mc_dtype == "bfloat16" else None)
    loops = Loops(device)
    grid = []
    for fold in (bool(f) for f in args.folds):
        for backend in SWEEPS:
            if fold and backend == "fused":
                continue
            for B in args.batches:
                n_batches = max(args.pairs // B, 2)
                sels = (torch.arange(n_batches * B, device=device) % N).view(n_batches, B)
                gens = [torch.Generator(device=device).manual_seed(k) for k in range(2)]
                flops = count_flops(lambda: steps.infer_step(
                    model, steps.gather_batch(data, sels[0]), word_vectors, args.mc,
                    gens, mc_model, fold))
                opts = dict(mc_droprate=args.mc, mc_model=mc_model)
                if backend == "flax":
                    opts["fold_mc"] = fold
                seed = [0]

                def once():
                    seed[0] += 1
                    return loops.sweep(SWEEPS[backend], model, data, sels,
                                       word_vectors, seed=seed[0], **opts)["ious"]

                dt = seconds_per_call(once, device, args.iters)
                folded = steps.folds(model, args.mc, fold, mc_model)
                peak = "bfloat16" if mc_model is not None else "float32"
                row = {"sweep_backend": backend, "fold_mc": fold, "folded": folded,
                       "mc_dtype": args.mc_dtype, "batch_size": B,
                       "n_batches": n_batches, "pairs_per_sec": n_batches * B / dt,
                       "dispatch_ms": dt * 1e3, "step_flops_g": flops / 1e9,
                       "mfu": peak_share(f"sweep {backend} fold={fold} B={B}",
                                         flops * n_batches, dt, peak)}
                grid.append(row)
                print(json.dumps(row), flush=True)
    loops.close()

    out = args.out.replace(".json", args.out_suffix + ".json")
    write_result(out, {
        **device_info(device),
        "workload": f"graphed MC-dropout sweep, mc={args.mc:.2f}, Charades width "
                    f"T={T} vdim={DATA['vdim']}",
        "graphed": device.type == "cuda",
        "peak_flops_assumed": {"float32": 67e12, "bfloat16": 989e12},
        "protocol": "host clock over --iters sweeps ending at a synchronisation "
                    "and a fetch of the last sweep's IoUs, after 2 warm-up sweeps",
        "grid": grid, "best": max(grid, key=lambda r: r["pairs_per_sec"]),
        "not_applicable": {
            "fold_mc with sweep_backend fused": "train.fold_mc folds the eager "
            "sweeps only: the fused sweep's clean pass runs on K2, apart from "
            "the MC passes"}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
