"""The yardstick's arithmetic: the card's peak rates, the guard on a share of
them, K2's product FLOPs and the FLOPs of the reference's own work.

Copied from ``tools/torch_tool_common.py`` (``PEAK_FLOPS``, ``peak_share``,
``k2_flops``, ``count_flops``), so a later change to the port's tools cannot
move the benchmark's numbers; the guard here refuses a share over 105%.
"""

from __future__ import annotations

import math
from typing import Callable

# One H100 SXM's published dense peaks at 700 W: float32 outside the tensor
# cores (the port's f32 products run with TF32 off; K2's f64 sums run on
# the FP64 tensor cores, 67 TFLOP/s too) and bf16 on the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def peak_share(name: str, flops: float, seconds: float, dtype: str = "float32") -> float:
    """``flops`` done in ``seconds`` as a percentage of the ``dtype`` peak.
    Over 105% the operations are counted too high or the time leaves out
    part of the work: raises."""
    share = 100.0 * flops / seconds / PEAK_FLOPS[dtype] if seconds > 0 else math.inf
    if not math.isfinite(share) or share > 105.0:
        raise RuntimeError(f"{name}: {flops:.4g} FLOPs in {seconds:.4g} s is {share:.4g}% "
                           f"of the {dtype} peak, over 105%")
    return share


def k2_flops(B: int, T: int, W: int, D: int = 128, attn_layer: int = 2) -> int:
    """FLOPs of K2's products (2 per multiply-add) at these shapes; the
    elementwise work (softmax, LN, gates) is left out, so the bound it
    gives is a lower bound."""
    def mm(rows, k, n):
        return 2 * rows * k * n

    def conv(rows):                     # 4 x (depthwise k=7 + pointwise)
        return 4 * (mm(rows, D, D) + 2 * 7 * rows * D)

    def attn(tq, tk):                   # q k^T and p v over all heads
        return 2 * mm(tq, D, tk)

    def dual(tq, tk):                   # 14 D x D products on `from` rows, 2 on `to`
        return 14 * mm(tq, D, D) + 2 * mm(tk, D, D) + attn(tq, tq) + attn(tq, tk)

    def cq(t1, t2):                     # trilinear, c2q, score_ @ score_t^T, q2c, dense
        return 2 * mm(t1, D, t2) + mm(t1, t2, t1) + mm(t1, t1, D) + mm(t1, 4 * D, D)

    fe = conv(T) + 3 * mm(T, D, D) + attn(T, T) + mm(T, D, D)
    per_sample = (conv(T) + conv(W) + attn_layer * (dual(T, W) + dual(W, T))
                  + cq(T, W) + cq(W, T) + mm(T, 2 * D, D) + mm(T, D, 4)
                  + mm(T, 4, D) + 2 * fe + 2 * mm(T, 2 * D, D) + 2 * mm(T, D, 1))
    return B * per_sample


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one call of ``fn``, counted by ``torch.utils.flop_counter.
    FlopCounterMode`` over the operators it runs (products and
    convolutions, forward and backward): the work, not the implementation."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def reference_flops(spec: dict, batch_size: int, W: int, C: int, train: bool) -> int:
    """FLOPs of one reference forward (and, with ``train``, its loss and
    backward) over a batch at the configuration's widths, counted on the
    CPU on the meta device: shapes alone, nothing computed."""
    import torch

    from benchmark import data
    from benchmark.reference import seqpan as ref

    m = spec["config"]["model"]
    T = m["max_vlen"]
    meta = torch.device("meta")
    model = data.reference_model(spec, meta)
    B = batch_size
    batch = {"video_features": torch.zeros(B, T, m["vdim"], device=meta),
             "video_seq_len": torch.full((B,), T, dtype=torch.int32, device=meta),
             "word_ids": torch.ones(B, W, dtype=torch.int32, device=meta),
             "char_ids": torch.ones(B, W, C, dtype=torch.int32, device=meta)}
    vectors = torch.zeros(16, m["word_dim"], device=meta)

    def step():
        if not train:
            return model(batch, vectors)
        labels = torch.zeros(B, T, device=meta)
        full = dict(batch, y1=labels, y2=labels, inner_labels=labels)
        out = model(full, vectors, torch.zeros(B, T, dtype=torch.int32, device=meta))
        return torch.autograd.grad(ref.loss(out, full), list(model.parameters()),
                                   allow_unused=True)
    return count_flops(step)
