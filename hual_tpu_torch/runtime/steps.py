"""Eval and AL-inference steps and sweeps (counterpart of
``hual_tpu/runtime/steps.py``).

The split lives on the device (``Trainer``): the feature table plus the
per-sample columns.  A sweep takes the (n_batches, B) index matrix, gathers
each batch on the device and runs one deterministic forward per batch; the
JAX package's ``lax.scan`` is a Python loop here.  Outputs stay on the
device, stacked (n_batches, B, ...), until the caller fetches them.

Two backends, chosen by ``train.sweep_backend``:

* ``flax``: the port's eager ``SeqPAN`` (its span decode follows
  ``model.span_decode``);
* ``fused``: ``encoder_inputs`` + K2 (``ops/kernels/fused_forward.py``) +
  K1 (``ops/kernels/span_decode.py``), with the weights packed once per
  sweep.

MC reuse rule: at ``mc_droprate`` 0 with the gumbel head off nothing is
stochastic at eval, so both "stochastic" passes are the clean pass.  Live
stochastic passes (dropout, gumbel noise) come with slice 3 of the port;
until then they raise.  The train step and epoch come with slice 3 too.
"""

from __future__ import annotations

import torch

from hual_tpu_torch.ops.fused_forward import pack_weights, seqpan_forward_fused


def device_ious(start_idx, end_idx, s_ind, e_ind, v_len, duration) -> torch.Tensor:
    """f32 interval IoU of predicted vs (pseudo) GT spans on the device, in
    the trainer convention s = i*dur/T, e = (i+1)*dur/T."""
    vl = v_len.to(torch.float32)
    dur = duration.to(torch.float32)
    ps = start_idx.to(torch.float32) * dur / vl
    pe = (end_idx.to(torch.float32) + 1.0) * dur / vl
    gs = s_ind.to(torch.float32) * dur / vl
    ge = (e_ind.to(torch.float32) + 1.0) * dur / vl
    inter = torch.minimum(pe, ge) - torch.maximum(ps, gs)
    union = torch.maximum(pe, ge) - torch.minimum(ps, gs)
    positive = union > 0
    iou = torch.where(positive, inter / torch.where(positive, union, 1.0), 0.0)
    return torch.clamp(iou, min=0.0)


def dequantize_batch(batch: dict) -> dict:
    """f32 video features from an int8 batch (with its per-clip
    ``feature_scales``) or a bf16 one; f32 batches pass unchanged."""
    feats = batch["video_features"]
    if feats.dtype == torch.int8:
        batch = dict(batch)
        scales = batch.pop("feature_scales")
        batch["video_features"] = feats.to(torch.float32) * scales[..., None]
    elif feats.dtype != torch.float32:
        batch = dict(batch)
        batch["video_features"] = feats.to(torch.float32)
    return batch


def gather_batch(data: dict, sel: torch.Tensor) -> dict:
    """One batch gathered on the device from the device-resident split.

    ``data`` holds ``features`` (n_videos, T, vdim) in f32, bf16 or int8
    (then with ``feature_scales`` (n_videos, T)) and the per-sample
    columns; ``sel`` (B,) indexes the samples.  Only the B gathered rows
    are dequantized; compute stays f32.
    """
    def take(name):
        return data[name].index_select(0, sel)

    feat_rows = take("feat_rows")
    batch = {"video_features": data["features"].index_select(0, feat_rows)}
    if "feature_scales" in data:
        batch["feature_scales"] = data["feature_scales"].index_select(0, feat_rows)
    batch = dequantize_batch(batch)
    batch.update(video_seq_len=take("v_len"), word_ids=take("word_ids"),
                 char_ids=take("char_ids"), s_ind=take("s_ind"),
                 e_ind=take("e_ind"), duration=take("duration"))
    return batch


def _ious(out: dict, batch: dict) -> torch.Tensor:
    return device_ious(out["start_index"], out["end_index"], batch["s_ind"],
                       batch["e_ind"], batch["video_seq_len"], batch["duration"])


def check_mc_passes(model, mc_droprate: float) -> None:
    """Raise unless the MC reuse rule holds (mc_droprate 0, gumbel off)."""
    if mc_droprate != 0.0:
        raise NotImplementedError(
            f"train.mc_droprate={mc_droprate}: dropout MC passes come with "
            "slice 3 of the port (ROADMAP.md queue 1); use 0.0")
    if model.use_gumbel:
        raise NotImplementedError(
            "loss.no_gumbel: false: the live gumbel passes of the AL sweep "
            "come with slice 3 of the port (ROADMAP.md queue 1)")


def _infer_outputs(out: dict, batch: dict) -> dict:
    # MC reuse rule: both "stochastic" passes are the clean pass
    s, e = out["start_logits"], out["end_logits"]
    return {"match_scores": out["match_scores"], "start_logits": s,
            "end_logits": e, "start_index": out["start_index"],
            "end_index": out["end_index"], "start_logits1": s,
            "end_logits1": e, "start_logits2": s, "end_logits2": e,
            "ious": _ious(out, batch)}


def _stack(outs: list[dict]) -> dict:
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


@torch.inference_mode()
def eval_step(model, batch: dict, word_vectors: torch.Tensor) -> dict:
    batch = dequantize_batch(batch)
    out = model(batch, word_vectors)
    return {"start_index": out["start_index"], "end_index": out["end_index"],
            "ious": _ious(out, batch)}


@torch.inference_mode()
def infer_step(model, batch: dict, word_vectors: torch.Tensor,
               mc_droprate: float = 0.0) -> dict:
    """Clean forward plus the two MC passes (the clean pass, by the reuse
    rule)."""
    check_mc_passes(model, mc_droprate)
    batch = dequantize_batch(batch)
    return _infer_outputs(model(batch, word_vectors), batch)


@torch.inference_mode()
def eval_sweep(model, data: dict, sels: torch.Tensor,
               word_vectors: torch.Tensor) -> torch.Tensor:
    """sels (n_batches, B) -> ious (n_batches, B), eager model."""
    return torch.stack([eval_step(model, gather_batch(data, sel), word_vectors)["ious"]
                        for sel in sels])


@torch.inference_mode()
def infer_sweep(model, data: dict, sels: torch.Tensor,
                word_vectors: torch.Tensor, mc_droprate: float = 0.0) -> dict:
    """sels (n_batches, B) -> dict of (n_batches, B, ...), eager model."""
    check_mc_passes(model, mc_droprate)
    return _stack([infer_step(model, gather_batch(data, sel), word_vectors)
                   for sel in sels])


@torch.inference_mode()
def fused_eval_sweep(model, data: dict, sels: torch.Tensor,
                     word_vectors: torch.Tensor) -> torch.Tensor:
    """Eval sweep through K2 and K1: sels (n_batches, B) -> ious."""
    packed = pack_weights(model)
    ious = []
    for sel in sels:
        batch = gather_batch(data, sel)
        ious.append(_ious(seqpan_forward_fused(model, packed, batch,
                                               word_vectors), batch))
    return torch.stack(ious)


@torch.inference_mode()
def fused_infer_sweep(model, data: dict, sels: torch.Tensor,
                      word_vectors: torch.Tensor,
                      mc_droprate: float = 0.0) -> dict:
    """AL sweep with the clean pass through K2 and K1; same stacked schema
    as :func:`infer_sweep`."""
    check_mc_passes(model, mc_droprate)
    packed = pack_weights(model)
    outs = []
    for sel in sels:
        batch = gather_batch(data, sel)
        outs.append(_infer_outputs(
            seqpan_forward_fused(model, packed, batch, word_vectors), batch))
    return _stack(outs)
