#!/usr/bin/env python
"""K1 (the span-decode kernel) against the plain decode, on the card.

The port's counterpart of tools/bench_span_decode.py.  Times the two
decoders of the answer predictor (reference ans_predictor,
models/layers.py:194-203) alone at the AL sweep's shapes, batch 96 at T=64
(Charades) and T=100 (ActivityNet), and the MC-dropout infer step (the
clean pass and 2 passes at mc 0.5) at batch 96 and Charades width with
each wired in (``model.span_decode``).

Protocol: the decoders alone, CUDA events around ``--iters`` calls queued
behind a device sleep (so they run back to back on the card) after a
warm-up; the infer step, the host clock over ``--iters`` / 5 steps ending
at ``torch.cuda.synchronize()`` and a fetch of the last step's IoUs.

Writes results/torch_bench_span_decode.json (``--out``).

    python tools/torch_bench_span_decode.py [--iters 50] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tool_common import (add_common_flags, device_info, device_of,  # noqa: E402
                               ms_per_call, reset_launches, seconds_per_call,
                               seeded_model, synthetic_split, write_result)

from hual_tpu_torch.ops import decode  # noqa: E402
from hual_tpu_torch.ops.kernels import span_decode as k1  # noqa: E402
from hual_tpu_torch.runtime import steps  # noqa: E402

SHAPES = ((96, 64), (96, 100))
INFER_BATCH, INFER_SAMPLES, INFER_T = 96, 512, 64
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)
DECODERS = {"plain": decode.span_decode, "kernel": k1.span_decode}


def bench_decode(device: torch.device, B: int, T: int, variant: str,
                 iters: int) -> float:
    """Microseconds a call of one decoder on seeded (B, T) logits."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32)).to(device)
    e = torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32)).to(device)
    lens = rng.integers(2, T + 1, B)
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(np.int32)).to(device)
    fn = DECODERS[variant]
    return ms_per_call(lambda: fn(s, e, mask), device, iters) * 1e3


def bench_infer_step(device: torch.device, model, data: dict, word_vectors,
                     decoder: str, iters: int) -> float:
    """Milliseconds an MC infer step at mc 0.5 with ``decoder``."""
    model.span_decode = decoder
    sel = torch.arange(INFER_BATCH, device=device)
    calls = [0]

    def step():
        calls[0] += 1
        gens = [steps.make_generator(device, 0, calls[0], k) for k in range(2)]
        return steps.infer_step(model, steps.gather_batch(data, sel), word_vectors,
                                0.5, gens)["ious"]

    return seconds_per_call(step, device, iters) * 1e3


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=50,
                    help="calls a decoder is timed over (infer steps: a fifth)")
    add_common_flags(ap, "bench_span_decode")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()
    res = device_info(device)
    for B, T in SHAPES:
        for variant in DECODERS:
            res[f"decode_{variant}_b{B}_t{T}_us"] = bench_decode(device, B, T, variant,
                                                                 args.iters)
    widths = {"max_vlen": INFER_T, **WIDTHS}
    data, word_vectors = synthetic_split(device, INFER_SAMPLES, widths["max_vlen"],
                                         widths.get("vdim", 1024))
    model = seeded_model(device, **widths)
    for variant, decoder in (("plain", "xla"), ("kernel", "pallas")):
        res[f"infer_step_{variant}_b{INFER_BATCH}_t{INFER_T}_ms"] = bench_infer_step(
            device, model, data, word_vectors, decoder, max(2, args.iters // 5))
    res["protocol"] = ("decoders: CUDA events around calls queued behind a device "
                       "sleep, after a warm-up (host clock on the CPU); infer step "
                       "(clean + 2 MC passes at 0.5, batch 96): host clock ending "
                       "at a synchronisation and a fetch of the IoUs")
    write_result(args.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
