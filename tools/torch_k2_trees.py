#!/usr/bin/env python3
"""Time K2 on two source trees in turns, on one NVIDIA GPU.

    python3 tools/torch_k2_trees.py [--mxu-bf16] OLD_TREE NEW_TREE

Each tree is a directory holding a ``hual_tpu_torch`` package (an unpacked
``git archive`` of another commit, or the repository root).  The trees run
in the order OLD, NEW, NEW, OLD, each in a fresh process that builds its
own copy of the kernel into the tree's ``build/``, on the same seeded
weights and inputs at Charades width (D=128, 8 heads, 2 layers) and two
shapes, (B,T,W) = (96,64,13) and (32,100,30).  K2 runs its default path
(f32 operands, f64 sums), or its bf16 path with ``--mxu-bf16``.  Per run
and shape it prints five CUDA-event times (ms a call, each the mean of 20
back-to-back calls, sorted) and a digest of the outputs (SHA-256 of the
bytes of start_logits, end_logits and match_scores); the last line adds
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r'''
import hashlib, json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.fused_forward import pack_weights
from hual_tpu_torch.ops.kernels import fused_forward as k2

MXU_BF16 = sys.argv[1] == "1"
dev = torch.device("cuda")
rows = {}
for B, T, W in ((96, 64, 13), (32, 100, 30)):
    D = 128
    model = SeqPAN(vdim=1024, dim=D, num_heads=8, attn_layer=2, max_vlen=T,
                   word_dim=300, char_dim=50, num_chars=60,
                   generator=torch.Generator().manual_seed(1)).to(dev).eval()
    packed = pack_weights(model)
    rng = np.random.default_rng(0)
    vf = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32)).to(dev)
    qf = torch.from_numpy(rng.normal(size=(B, W, D)).astype(np.float32)).to(dev)
    vm = torch.from_numpy((np.arange(T)[None] < rng.integers(1, T + 1, B)[:, None])
                          .astype(np.int32)).to(dev)
    qm = torch.from_numpy((np.arange(W)[None] < rng.integers(1, W + 1, B)[:, None])
                          .astype(np.int32)).to(dev)
    call = lambda: k2.fused_forward(packed, vf, qf, vm, qm, attn_layer=2,
                                    num_heads=8, tau=0.3, use_gumbel=False,
                                    mxu_bf16=MXU_BF16)
    for _ in range(5):
        outs = call()
    torch.cuda.synchronize()
    digest = hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in outs))
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 20)
    rows[f"{B},{T},{W}"] = {"ms": sorted(times), "digest": digest.hexdigest()}
print(json.dumps(rows))
'''


def main(argv: list[str]) -> None:
    bf16 = argv[:1] == ["--mxu-bf16"]
    argv = argv[1:] if bf16 else argv
    if len(argv) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} [--mxu-bf16] OLD_TREE NEW_TREE")
    trees = {"old": os.path.abspath(argv[0]), "new": os.path.abspath(argv[1])}
    runs = []
    for name in ("old", "new", "new", "old"):
        proc = subprocess.run([sys.executable, "-c", RUN, str(int(bf16))],
                              cwd=trees[name], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} tree failed:\n{proc.stderr[-3000:]}")
        runs.append({"tree": name, "path": trees[name],
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    path = "bf16" if bf16 else "f32"
    print(json.dumps({f"k2_{path}_in_turns": runs, "card": card}))


if __name__ == "__main__":
    main(sys.argv[1:])
