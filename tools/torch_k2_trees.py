#!/usr/bin/env python3
"""Time K2's default (f32 operand, f64 sum) path on two source trees in
turns, on one NVIDIA GPU.

    python3 tools/torch_k2_trees.py OLD_TREE NEW_TREE

Each tree is a directory holding a ``hual_tpu_torch`` package (an unpacked
``git archive`` of another commit, or the repository root).  The trees run
in the order OLD, NEW, NEW, OLD, each in a fresh process that builds its
own copy of the kernel into the tree's ``build/``, at Charades width
(B=96, T=64, W=13, D=128, 8 heads, 2 layers) on the same seeded weights and
inputs.  Per run it prints a JSON line with five CUDA-event times (ms a
call, each the mean of 20 back-to-back calls, sorted); the last line adds
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.ops.fused_forward import pack_weights
from hual_tpu_torch.ops.kernels import fused_forward as k2

dev = torch.device("cuda")
model = SeqPAN(vdim=1024, dim=128, num_heads=8, attn_layer=2, max_vlen=64,
               word_dim=300, char_dim=50, num_chars=60,
               generator=torch.Generator().manual_seed(1)).to(dev).eval()
packed = pack_weights(model)
rng = np.random.default_rng(0)
B, T, W, D = 96, 64, 13, 128
vf = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32)).to(dev)
qf = torch.from_numpy(rng.normal(size=(B, W, D)).astype(np.float32)).to(dev)
vm = torch.from_numpy((np.arange(T)[None] < rng.integers(1, T + 1, B)[:, None])
                      .astype(np.int32)).to(dev)
qm = torch.from_numpy((np.arange(W)[None] < rng.integers(1, W + 1, B)[:, None])
                      .astype(np.int32)).to(dev)
call = lambda: k2.fused_forward(packed, vf, qf, vm, qm, attn_layer=2,
                                num_heads=8, tau=0.3, use_gumbel=False)
for _ in range(5):
    call()
torch.cuda.synchronize()
times = []
for _ in range(5):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        call()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end) / 20)
print(json.dumps({"ms": sorted(times)}))
'''


def main(argv: list[str]) -> None:
    if len(argv) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} OLD_TREE NEW_TREE")
    trees = {"old": os.path.abspath(argv[0]), "new": os.path.abspath(argv[1])}
    runs = []
    for name in ("old", "new", "new", "old"):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=trees[name],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} tree failed:\n{proc.stderr[-3000:]}")
        runs.append({"tree": name, "path": trees[name],
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"k2_f32_in_turns": runs, "card": card}))


if __name__ == "__main__":
    main(sys.argv[1:])
