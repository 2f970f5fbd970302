#!/usr/bin/env python
"""The fused sweeps (K2 + K1) against the eager ones, on the card.

The port's counterpart of tools/bench_fused.py.  At the shipped sweep
shapes (B=96, SeqPAN at Charades width, seeded weights, a resident split of
2,000 samples), the eval sweep (one deterministic forward a sample) and
the AL sweep (the clean pass and 2 MC passes at 0.5, the clean pass on K2
and K1 in the fused rows), over ``--steps`` batches; the ``bf16stoch``
rows run the MC passes at bf16 activations (``train.mc_dtype``), and
``--mxu-bf16`` gives K2 bf16 products (``train.fused_mxu_bf16``).  On the
card the sweeps replay captured CUDA graphs, as the Trainer's do
(``runtime/graphs.py``); on the CPU they run eagerly.  There is no
``--blocks``: K2 runs one thread block per sample and the graphs replay one
captured step per batch, so no block count is chosen.

Protocol: the host clock over ``--iters`` sweeps after 2 warm-up sweeps,
ending at ``torch.cuda.synchronize()`` and a fetch of the last sweep's
IoUs.

Writes results/torch_bench_fused.json (``--out``); rows of an earlier run
with other names are kept.

    python tools/torch_bench_fused.py [--iters 10] [--mxu-bf16] [--skip-flax]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tool_common import (Loops, add_common_flags, device_info,  # noqa: E402
                               device_of, reset_launches, seconds_per_call,
                               seeded_model, synthetic_split, write_result)

N_SAMPLES = 2000
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--steps", type=int, default=21)
    ap.add_argument("--mxu-bf16", action="store_true",
                    help="bf16 products (f32 sums) inside K2")
    ap.add_argument("--skip-flax", action="store_true",
                    help="time the fused rows only")
    add_common_flags(ap, "bench_fused")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()

    widths = {"max_vlen": 64, "vdim": 1024, **WIDTHS}
    data, word_vectors = synthetic_split(device, N_SAMPLES, widths["max_vlen"],
                                         widths["vdim"])
    model = seeded_model(device, **widths)
    mc16 = model.with_compute_dtype("bfloat16")
    B, S = args.batch, args.steps
    pairs = B * S
    sels = (torch.arange(pairs, device=device) % N_SAMPLES).view(S, B)
    loops = Loops(device)

    def sweep(name: str, **kw):
        return loops.sweep(name, model, data, sels, word_vectors, **kw)

    rows = []

    def timed(name: str, fn, is_infer: bool) -> None:
        seed = [0]

        def once():
            seed[0] += 1
            out = fn(seed[0]) if is_infer else fn()
            return out["ious"] if is_infer else out

        dt = seconds_per_call(once, device, args.iters)
        row = {"name": name, "pairs_per_sec": pairs / dt, "sweep_ms": dt * 1e3}
        rows.append(row)
        print(json.dumps(row), flush=True)

    mx = args.mxu_bf16
    tag = "_bf16mxu" if mx else ""
    if not args.skip_flax:
        timed("eval_flax", lambda: sweep("eval_sweep"), False)
    timed(f"eval_fused{tag}", lambda: sweep("fused_eval_sweep", mxu_bf16=mx), False)
    if not args.skip_flax:
        timed("infer_flax_mc0.5",
              lambda s: sweep("infer_sweep", mc_droprate=0.5, seed=s), True)
    timed(f"infer_fusedclean_mc0.5{tag}",
          lambda s: sweep("fused_infer_sweep", mc_droprate=0.5, seed=s, mxu_bf16=mx),
          True)
    if not args.skip_flax:
        timed("infer_flax_mc0.5_bf16stoch",
              lambda s: sweep("infer_sweep", mc_droprate=0.5, seed=s, mc_model=mc16),
              True)
    timed(f"infer_fusedclean_bf16stoch{tag}",
          lambda s: sweep("fused_infer_sweep", mc_droprate=0.5, seed=s,
                          mc_model=mc16, mxu_bf16=mx), True)
    loops.close()

    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f).get("rows", [])
        have = {r["name"] for r in rows}
        rows = [r for r in prev if r["name"] not in have] + rows
    write_result(args.out, {
        **device_info(device),
        "workload": f"sweeps, B={B} x {S} batches, SeqPAN at Charades width",
        "graphed": loops.graphs is not None,
        "protocol": "host clock over --iters sweeps ending at a synchronisation "
                    "and a fetch of the last sweep's IoUs, after 2 warm-up sweeps",
        "rows": rows})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
