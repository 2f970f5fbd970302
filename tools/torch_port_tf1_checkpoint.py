#!/usr/bin/env python
"""Port a trained reference (renjie-liang/HUAL) TF1 checkpoint to hual_tpu_torch.

The reference saves TF1 Saver checkpoints of its SeqPAN graph (reference
main.py:57,71-75: ``ckpt/<task>_/best_SeqPAN.ckpt-<step>``).  This tool
reads one with NumPy alone (no TensorFlow; hual_tpu_torch/utils/tf1_port.py),
maps every model variable onto the port's weights and writes a ``best.npz``
that ``Trainer.restore``, ``cli --checkpoint`` and ``Predictor`` load,
plus the checkpoint's frozen GloVe matrix as ``<out stem>_word_vectors.npy``.

    python tools/torch_port_tf1_checkpoint.py ckpt/charades_ /tmp/ported/best.npz
    python -m hual_tpu_torch.cli --config configs/charades/SeqPAN.yaml \\
        --mode test --checkpoint /tmp/ported/best.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt", help="TF1 Saver prefix, or a directory with a "
                                 "'checkpoint' pointer file (latest wins)")
    ap.add_argument("out", help="output best.npz")
    args = ap.parse_args(argv)

    from hual_tpu_torch.utils.tf1_port import port_checkpoint, word_vectors_path

    flat, wv = port_checkpoint(args.ckpt, args.out)

    n_params = sum(int(np.prod(np.shape(x))) for x in flat.values())
    out = os.path.abspath(args.out)
    print(f"ported {len(flat)} tensors / {n_params:,} parameters -> {out}")
    if wv is not None:
        print(f"word vectors {np.shape(wv)} -> {word_vectors_path(out)}")
    else:
        print("no word_embs/word_table in the checkpoint (word vectors "
              "must come from the data pipeline)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
