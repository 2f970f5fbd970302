#!/usr/bin/env python
"""Split the port's B=16 train step into stages, on the card.

The port's counterpart of tools/bench_step_breakdown.py, on its data: a
device-resident split of N=2,000 samples (T=64 clips of vdim 1,024, W=14
words of C=12 characters; a 0.52 GB f32 table) and SeqPAN at Charades
width (D=128, 8 heads, 2 layers, ``span_decode: pallas``), seeded weights.
Stages, ms a call, each as the JAX tool's compiled stage: on the card
replayed from a CUDA graph captured once (``runtime.graphs.StepGraph``)
and timed by ``ms_per_call`` (CUDA events around ``--iters`` replays
queued behind a device sleep), so each is the stage's device time:

* ``gather_labels_ms``: a batch gathered from the split, labels built on
  the device (``runtime.steps.gather_batch``);
* ``forward_ms``: the forward, deterministic (K1 decodes);
* ``fwd_bwd_ms``: the forward at drop 0.2, the losses and the backward,
  no optimizer;
* ``graphed_step_ms``: the full step (+ the clip, BERT-AdamW, K1 and the
  IoU) replayed from the train epoch's graph (``runtime/graphs.py``) over
  an epoch of ``--epoch-steps`` steps, the epoch timed by
  ``seconds_per_call`` (host clock ending in a synchronisation and a fetch
  of its losses) over 3 epochs after 2 warm-up ones, divided by its
  steps: the JAX tool's scanned epoch.

``eager_*_ms`` time the same stages and the full step
(``runtime.steps.train_step``) eagerly, as the CPU, host streaming and
the ragged last batch run them, by ``ms_per_call`` too; an eager call of
thousands of kernels fills the card's launch queue behind the sleep, so
its time is the host's issue rate where that is the slower.  On the CPU
nothing is graphed and the stages run eagerly.

``step_flops_g`` counts one eager step (``count_flops``) and ``mfu`` is
the graphed step's share of the f32 peak.  The ``lax.scan`` unroll and the
threefry/rbg PRNG are JAX's: ``not_applicable`` names them.  Launches K1,
not K2.

Writes results/torch_bench_step_breakdown.json (``--out``).

    python tools/torch_bench_step_breakdown.py [--iters 50] [--epoch-steps 125]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tool_common import (Loops, add_common_flags, count_flops,  # noqa: E402
                               device_info, device_of, ms_per_call, peak_share,
                               reset_launches, seconds_per_call, seeded_model,
                               synthetic_split, train_step_call, write_result)

from hual_tpu_torch.models.seqpan import seqpan_loss  # noqa: E402
from hual_tpu_torch.runtime import graphs, steps  # noqa: E402

# the JAX tool's data (tools/bench_step_breakdown.py; the tests narrow it)
DATA = dict(n=2000, B=16, T=64, W=14, C=12, vdim=1024)
WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)
NOT_APPLICABLE = {
    "scan_step_unroll1_ms": "lax.scan's unroll is JAX's: the port replays one "
                            "captured step per batch (graphed_step_ms)",
    "scan_step_unroll2_ms": "lax.scan's unroll is JAX's",
    "scan_step_unroll4_ms": "lax.scan's unroll is JAX's",
    "scan_step_rbg_ms": "the threefry/rbg PRNG choice is JAX's: the port's "
                        "dropout draws from torch Philox generators",
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=50, help="timed calls a stage")
    ap.add_argument("--epoch-steps", type=int, default=125,
                    help="steps of the graphed epoch (the JAX tool's scan: 125)")
    add_common_flags(ap, "bench_step_breakdown")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()

    d = DATA
    B, T = d["B"], d["T"]
    data, word_vectors = synthetic_split(device, d["n"], T, d["vdim"], W=d["W"],
                                         C=d["C"])
    model = seeded_model(device, max_vlen=T, vdim=d["vdim"], **WIDTHS)
    sel0 = torch.arange(B, device=device)
    batch0 = steps.gather_batch(data, sel0, with_labels=True)
    params = [p for p in model.parameters() if p.requires_grad]
    gen = torch.Generator(device=device).manual_seed(1)
    loops = Loops(device)
    epoch = loops.epoch(model, data, word_vectors, B, args.epoch_steps)
    eager_step = train_step_call(model, data, word_vectors, B)

    def gather():
        return steps.gather_batch(data, sel0, with_labels=True)

    def forward():
        with torch.inference_mode():
            return {"start_logits": model(batch0, word_vectors)["start_logits"]}

    def fwd_bwd():
        out = model(batch0, word_vectors, batch0["match_labels"], drop_rate=0.2,
                    generator=gen)
        total, _ = seqpan_loss(out, batch0, 1.0)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return {str(i): g for i, g in enumerate(grads) if g is not None}

    res = {**device_info(device), "B": B, "T": T, "N": d["n"],
           "graphed": loops.graphs is not None}
    for name, body in (("gather_labels", gather), ("forward", forward),
                       ("fwd_bwd", fwd_bwd)):
        res[f"eager_{name}_ms"] = ms_per_call(body, device, args.iters)
        if loops.graphs is None:
            res[f"{name}_ms"] = res[f"eager_{name}_ms"]
            continue
        stage = graphs.StepGraph(body, device, [gen] if name == "fwd_bwd" else [])
        stage()                                       # warm up and capture
        res[f"{name}_ms"] = ms_per_call(stage, device, args.iters)
        stage.reset()
    res["eager_step_ms"] = ms_per_call(eager_step, device, args.iters)
    flops = count_flops(eager_step)
    epoch_s = seconds_per_call(epoch, device, 3)
    loops.close()
    res["graphed_epoch_ms"] = epoch_s * 1e3
    res["graphed_step_ms"] = epoch_s * 1e3 / args.epoch_steps
    res["step_flops_g"] = flops / 1e9
    res["mfu"] = peak_share("graphed train step", flops * args.epoch_steps, epoch_s,
                            "float32")
    write_result(args.out, {
        **res,
        "workload": f"train step B={B}, T={T}, vdim {d['vdim']}, SeqPAN at Charades "
                    "width, drop 0.2, f32",
        "protocol": "stages: ms_per_call (CUDA events around --iters calls, on the "
                    "card graph replays, queued behind a device sleep); the graphed "
                    "epoch: host clock over 3 epochs ending at a synchronisation and "
                    "a fetch of its losses, after 2 warm-up epochs",
        "not_applicable": NOT_APPLICABLE})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
