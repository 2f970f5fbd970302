"""The reference's side of each comparison, and the numbers compared.

Every function here runs the plain reference (``reference/seqpan.py``) on
the run's inputs and weights; none reads anything the port made except the
outputs being judged.  The control (``precision="tf32"``) is the reference
itself at the next precision below the configuration's: TF32 products in
place of f32 with TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from benchmark import data
from benchmark.reference import seqpan as ref


@contextlib.contextmanager
def precision(name: str):
    """``f32`` (the configuration's) or ``tf32`` (the control's)."""
    ref.set_precision(name == "tf32")
    try:
        yield
    finally:
        ref.set_precision(False)


def model(spec: dict, weights: dict, device: torch.device) -> ref.SeqPAN:
    m = data.reference_model(spec, device)
    m.load_state_dict(weights)
    return m


def sweep_batches(n: int, batch_size: int):
    """(indices, n_valid) of each batch of an ordered sweep over ``n``
    samples; the last batch padded with its last sample."""
    for lo in range(0, n, batch_size):
        sel = np.arange(lo, min(lo + batch_size, n))
        n_valid = len(sel)
        if n_valid < batch_size:
            sel = np.concatenate([sel, np.full(batch_size - n_valid, sel[-1])])
        yield sel, n_valid


@torch.no_grad()
def sweep(net: ref.SeqPAN, split: data.Split, table: torch.Tensor, vectors: torch.Tensor,
          batch_size: int, mc_rate: float = 0.0, seed: Optional[int] = None) -> dict:
    """The reference's outputs over a split in the sweeps' batches: the clean
    pass's logits, match scores and decoded span, and with ``seed`` the two
    MC passes' logits at ``mc_rate`` (batch ``i``'s pass ``j`` drawing from
    ``stream_seed(seed, i, j)``).  Valid rows only, on the host."""
    cols = split.data(table)
    outs = []
    for i, (sel, n) in enumerate(sweep_batches(len(split), batch_size)):
        batch = ref.gather(cols, torch.from_numpy(sel).to(table.device))
        clean = net(batch, vectors)
        s, e = ref.span_decode(clean["start_logits"], clean["end_logits"], clean["v_mask"])
        o = {"start_logits": clean["start_logits"], "end_logits": clean["end_logits"],
             "match_scores": clean["match_scores"], "start_index": s, "end_index": e,
             "v_mask": clean["v_mask"]}
        if seed is not None:
            for j in range(2):
                mc = net(batch, vectors, rate=mc_rate, gen=ref.generator(table.device, seed, i, j))
                o[f"start_logits{j + 1}"] = mc["start_logits"]
                o[f"end_logits{j + 1}"] = mc["end_logits"]
        outs.append({k: v[:n].cpu() for k, v in o.items()})
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def span_gap(start, end, mask, s_idx, e_idx) -> float:
    """The widest gap, over rows, by which the log-probability of the span
    (s_idx, e_idx) lies below the best span's, both under the reference's
    logits ``start``/``end``."""
    grid = ref.span_log_probs(start, end, mask)
    best = grid.flatten(1).amax(1)
    rows = torch.arange(grid.shape[0])
    chosen = grid[rows, s_idx.long(), e_idx.long()]
    return float((best - chosen).max())


def masked_max_abs(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    """max |a - b| over the valid positions (``mask`` (N, T) broadcast over
    trailing axes)."""
    m = mask.bool()
    while m.dim() < a.dim():
        m = m[..., None]
    return float(torch.where(m, (a.double() - b.double()).abs(), 0.0).max())


def ious(split: data.Split, s_idx: torch.Tensor, e_idx: torch.Tensor) -> np.ndarray:
    return ref.ious(s_idx, e_idx, split.s_ind.cpu(), split.e_ind.cpu(), split.v_len.cpu(),
                    split.duration.cpu()).numpy()


def leaf_gap(prog: dict, refs: dict, counted: Optional[set] = None) -> float:
    """The worst leaf's gap between two norms: ``|prog[k] - refs[k]|``
    over the larger of ``refs[k]`` and the median leaf's ``refs``, leaves
    ``counted`` only (all if None)."""
    keys = [k for k in refs if counted is None or k in counted]
    median = float(np.median([refs[k] for k in keys]))
    return max(abs(prog[k] - refs[k]) / max(refs[k], median) for k in keys)
