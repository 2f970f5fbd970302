"""Train, eval and AL-inference steps and sweeps (counterpart of
``hual_tpu/runtime/steps.py``).

The split lives on the device (``Trainer``): the feature table plus the
per-sample columns.  A step gathers its batch on the device from an index
vector; the loops here run the JAX package's ``lax.scan`` over batches as
a Python loop of eager steps, and outputs stay on the device until the
caller fetches them.  These loops serve the CPU, host streaming and the
ragged last train batch; on the card the device-resident loops replay the
same steps from captured CUDA graphs (``runtime/graphs.py``).  Under host
streaming a step takes a host batch instead: ``upload_batch`` puts it on
the device (labels built there, as ``gather_batch`` builds them).  The
loops take their batches from an iterator, so one loop serves both:
``train_batches`` (labelled device batches) and the sweeps ((device batch,
n_valid) pairs, ``resident_batches`` or the Trainer's host stream).

* Train step: labels built on the device, SeqPAN at the train drop rate,
  loc + match + align losses, BERT-AdamW (``ops/optim.py``), the span decode
  of the training forward (K1 under ``span_decode: pallas``) and the IoU.
  ``train_epoch`` runs one epoch's shuffled order and returns its losses
  and IoUs still on the device.
* Sweeps, two backends chosen by ``train.sweep_backend``: ``flax``, the
  port's eager ``SeqPAN`` (its span decode follows ``model.span_decode``);
  ``fused``, ``encoder_inputs`` + K2 (``ops/kernels/fused_forward.py``,
  with bf16 products under ``mxu_bf16``, ``train.fused_mxu_bf16``) + K1
  (``ops/kernels/span_decode.py``) with the weights packed at the start of
  each sweep.

MC passes: the clean pass is deterministic; the two stochastic passes run
the eager model at ``mc_droprate``, each with its own generator, and do not
decode.  ``fold_mc`` (``train.fold_mc``, eager sweeps only) runs the three
passes as one forward over the batch repeated three times, with the
per-sample rates ``[0]*B + [mc]*2B`` and the batch's first generator: the
rate-0 rows are the clean pass (up to the summation order of the larger
products), decoded with the others; it folds only at a nonzero
``mc_droprate`` with the gumbel head off and no ``mc_model``, since gumbel
noise would reach the clean rows and the folded forward is one model.
``mc_model`` (``train.mc_dtype``: the model at another activation dtype,
sharing its parameters) runs the stochastic passes only; the clean pass
always runs the main model.  Reuse rule: at ``mc_droprate`` 0 with the
gumbel head off nothing is stochastic, so both "stochastic" passes are the
clean pass.

Data parallelism (``hual_tpu_torch.parallel``): under a ``Mesh`` built on
a process group every rank is given the global batch's indices and runs
its rows of the batch (``Mesh.batch_rows``; a batch the data axis does not
divide runs whole on every rank, with no reduction).  ``gather_batch``
reads a row-sharded table by the owned-rows gather; the forward draws its
rows of the global batch's masks; the loss is this rank's share of the
global loss (``models/layers.py``); the gradients are summed over the data
group before the optimizer's global-norm clip, so every rank takes the
unsharded update; the reported losses are summed over the group and every
output comes back to every rank in batch order.  ``rows`` (a
``parallel.Rows``) and ``mesh`` are None on one device.

Random streams: the generator of train step ``k`` is seeded from
``(train.seed + 17, k)``, those of sweep batch ``i`` from ``(seed, i, 0)``
and ``(seed, i, 1)`` (:func:`stream_seed`, through ``make_generator`` here
and a reseeded generator in ``runtime/graphs.py``), so a run replays from
its counters alone.  On the card they are Philox streams; they do not give the
JAX package's bits, so dropout parity is distributional.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hual_tpu_torch.data.labels_device import make_span_labels_device
from hual_tpu_torch.models.seqpan import seqpan_loss
from hual_tpu_torch.ops.fused_forward import pack_weights, seqpan_forward_fused
from hual_tpu_torch.parallel import (Mesh, Rows, RowShard, gather_outputs,
                                     sum_grads, sum_over)


def stream_seed(*words: int) -> int:
    """The seed of the random stream named by ``words``, hashed by
    ``np.random.SeedSequence``: a pure function of its arguments."""
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])


def make_generator(device: torch.device, *words: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``stream_seed(*words)``."""
    return torch.Generator(device=device).manual_seed(stream_seed(*words))


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


def batch_rows(mesh: Optional[Mesh], n: int) -> Optional[Rows]:
    """This rank's rows of a global batch of ``n`` under ``mesh``."""
    return None if mesh is None else mesh.batch_rows(n)


def gather_batch(data: dict, sel: torch.Tensor, with_labels: bool = False,
                 rows: Optional[Rows] = None) -> dict:
    """One batch gathered on the device from the device-resident split.

    ``data`` holds ``features`` (n_videos, T, vdim) in f32, bf16 or int8
    (then with ``feature_scales`` (n_videos, T)) and the per-sample
    columns; ``sel`` (B,) indexes the samples.  Only the B gathered rows
    are dequantized; compute stays f32.  ``with_labels`` adds ``y1``,
    ``y2``, ``match_labels`` and ``inner_labels``, built on the device.
    With ``rows`` the batch is this rank's rows of ``sel``; a row-sharded
    table (``parallel.RowShard``) is read for all of ``sel``, since every
    rank of its group reads the same rows, and then narrowed.
    """
    mine = sel if rows is None else sel[rows.lo:rows.lo + rows.n]

    def take(name):
        return data[name].index_select(0, mine)

    def table(name):
        if not isinstance(data[name], RowShard):
            return data[name].index_select(0, take("feat_rows"))
        out = data[name].index_select(0, data["feat_rows"].index_select(0, sel))
        return out if rows is None else out[rows.lo:rows.lo + rows.n]

    batch = {"video_features": table("features")}
    if "feature_scales" in data:
        batch["feature_scales"] = table("feature_scales")
    batch = dequantize_batch(batch)
    batch.update(video_seq_len=take("v_len"), word_ids=take("word_ids"),
                 char_ids=take("char_ids"), s_ind=take("s_ind"),
                 e_ind=take("e_ind"), duration=take("duration"))
    return _with_labels(batch) if with_labels else batch


def upload_batch(host: dict, device: torch.device,
                 with_labels: bool = False) -> dict:
    """A host batch (``PackedDataset.gather(..., with_labels=False)``, its
    features f32, or int8 with ``feature_scales``) on ``device``: one
    synchronous copy per array; ``with_labels`` builds the labels on the
    device, as :func:`gather_batch` does.  Dequantization is the step's
    (``dequantize_batch``)."""
    batch = {k: torch.from_numpy(v).to(device, copy=True) for k, v in host.items()}
    return _with_labels(batch) if with_labels else batch


def _with_labels(batch: dict) -> dict:
    y1, y2, match, inner = make_span_labels_device(
        batch["s_ind"], batch["e_ind"], batch["video_seq_len"],
        batch["video_features"].shape[1])
    batch.update(y1=y1, y2=y2, match_labels=match, inner_labels=inner)
    return batch


def _ious(out: dict, batch: dict) -> torch.Tensor:
    return device_ious(out["start_index"], out["end_index"], batch["s_ind"],
                       batch["e_ind"], batch["video_seq_len"], batch["duration"])


def train_step(model, opt, batch: dict, word_vectors: torch.Tensor,
               lr: float | torch.Tensor, generator: torch.Generator, *,
               drop_rate: float, match_lambda: float = 1.0,
               rows: Optional[Rows] = None) -> dict:
    """One update of ``model``'s parameters through ``opt`` (a
    ``BertAdamW`` over them) at rate ``lr`` (a float, or ``opt.lr``) on a
    labelled batch; returns the detached loss components and the IoUs of
    the training forward's decoded spans.  With ``rows`` the batch is this
    rank's rows of the global batch: the gradients are summed over the data
    group before the update, and the losses and IoUs returned are the
    global batch's."""
    batch = dequantize_batch(batch)
    out = model(batch, word_vectors, batch["match_labels"], drop_rate=drop_rate,
                generator=generator, rows=rows)
    total, aux = seqpan_loss(out, batch, match_lambda, rows)
    grads = torch.autograd.grad(total, opt.params, allow_unused=True,
                                materialize_grads=True)
    opt.step(sum_grads(grads, rows), lr)
    names = list(aux)
    losses = sum_over(torch.stack([aux[k].detach() for k in names]), rows)
    metrics = dict(zip(names, losses.unbind()))
    metrics["ious"] = gather_outputs({"ious": _ious(out, batch)}, rows)["ious"]
    return metrics


def train_epoch(model, opt, data: dict, order: torch.Tensor, batch_size: int,
                word_vectors: torch.Tensor, lr: float, seed: int, step0: int, *,
                drop_rate: float, match_lambda: float = 1.0,
                mesh: Optional[Mesh] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One epoch over ``order`` (the epoch's shuffled sample indices, on the
    device), cut into batches of ``batch_size`` (the last may be ragged).
    Step ``k`` draws from ``make_generator(device, seed, k)`` with ``k``
    counted from ``step0``.  Returns (losses (n_steps,), ious (n,)), on the
    device; under ``mesh`` the global batches'."""
    def batch(lo):
        sel = order[lo:lo + batch_size]
        rows = batch_rows(mesh, sel.numel())
        return gather_batch(data, sel, with_labels=True, rows=rows), rows

    batches = (batch(lo) for lo in range(0, order.numel(), batch_size))
    return train_batches(model, opt, batches, word_vectors, lr, seed, step0,
                         drop_rate=drop_rate, match_lambda=match_lambda)


def train_batches(model, opt, batches, word_vectors: torch.Tensor, lr: float,
                  seed: int, step0: int, *, drop_rate: float,
                  match_lambda: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One train step per (labelled device batch, its ``Rows`` or None) of
    ``batches``, step ``k`` (counted from ``step0``) drawing from
    ``make_generator(device, seed, k)``: :func:`train_epoch`'s loop, which
    the streamed epoch runs over uploaded batches.  Returns (losses
    (n_steps,), ious (n,)), on the device."""
    losses, ious = [], []
    for i, (batch, rows) in enumerate(batches):
        metrics = train_step(model, opt, batch, word_vectors, lr,
                             make_generator(word_vectors.device, seed, step0 + i),
                             drop_rate=drop_rate, match_lambda=match_lambda,
                             rows=rows)
        losses.append(metrics["loss"])
        ious.append(metrics["ious"])
    return torch.stack(losses), torch.cat(ious)


def _stochastic(model, mc_droprate: float) -> bool:
    return mc_droprate != 0.0 or model.use_gumbel


def folds(model, mc_droprate: float, fold_mc: bool, mc_model=None) -> bool:
    """Whether the MC passes run folded (``hual_tpu/runtime/steps.py``
    ``make_infer_step``): asked for, at a nonzero rate, with no gumbel noise
    and no ``mc_model``."""
    return (fold_mc and mc_droprate != 0.0 and not model.use_gumbel
            and mc_model is None)


def _folded_passes(model, batch: dict, word_vectors: torch.Tensor,
                   mc_droprate: float, generator: torch.Generator,
                   rows: Optional[Rows] = None) -> tuple[dict, list[dict]]:
    """The clean pass and the two MC passes as one forward over 3B rows at
    the rates ``[0]*B + [mc_droprate]*2B`` (under ``rows``, each of the
    three copies draws this rank's rows of the global copy's masks)."""
    b = batch["video_features"].shape[0]
    device = batch["video_features"].device
    batch3 = {k: torch.cat([v, v, v]) for k, v in batch.items()}
    rates = torch.cat([torch.zeros(b, device=device),
                       torch.full((2 * b,), mc_droprate, device=device)])
    out = model(batch3, word_vectors, drop_rate=rates, generator=generator,
                rows=rows)
    clean, mc1, mc2 = ({k: v[i * b:(i + 1) * b] if v.dim() else v
                        for k, v in out.items()} for i in range(3))
    return clean, [mc1, mc2]


def _mc_passes(model, batch: dict, word_vectors: torch.Tensor,
               mc_droprate: float, generators, clean: dict,
               mc_model=None, rows: Optional[Rows] = None) -> list[dict]:
    """The two MC passes: the clean pass twice by the reuse rule, else two
    stochastic eager passes of ``mc_model`` (``model`` if None) that do not
    decode."""
    if not _stochastic(model, mc_droprate):
        return [clean, clean]
    if generators is None or len(generators) != 2:
        raise ValueError("the stochastic MC passes need two generators")
    stoch = model if mc_model is None else mc_model
    return [stoch(batch, word_vectors, drop_rate=mc_droprate, generator=g,
                  decode=False, rows=rows) for g in generators]


def _mc_generators(model, mc_droprate: float, device: torch.device, seed: int,
                   i: int):
    if not _stochastic(model, mc_droprate):
        return None
    return [make_generator(device, seed, i, k) for k in range(2)]


def _infer_outputs(out: dict, mc: list[dict], batch: dict,
                   rows: Optional[Rows] = None) -> dict:
    return gather_outputs({"match_scores": out["match_scores"],
            "start_logits": out["start_logits"], "end_logits": out["end_logits"],
            "start_index": out["start_index"], "end_index": out["end_index"],
            "start_logits1": mc[0]["start_logits"],
            "end_logits1": mc[0]["end_logits"],
            "start_logits2": mc[1]["start_logits"],
            "end_logits2": mc[1]["end_logits"],
            "ious": _ious(out, batch)}, rows)


@torch.inference_mode()
def eval_step(model, batch: dict, word_vectors: torch.Tensor,
              rows: Optional[Rows] = None) -> dict:
    """The decoded spans and IoUs of a batch (of the global batch, on every
    rank, when ``batch`` is this rank's ``rows`` of it)."""
    batch = dequantize_batch(batch)
    out = model(batch, word_vectors)
    return gather_outputs({"start_index": out["start_index"],
                           "end_index": out["end_index"],
                           "ious": _ious(out, batch)}, rows)


@torch.inference_mode()
def infer_step(model, batch: dict, word_vectors: torch.Tensor,
               mc_droprate: float = 0.0, generators=None, mc_model=None,
               fold_mc: bool = False, rows: Optional[Rows] = None) -> dict:
    """Clean forward plus the two MC passes; ``generators`` (two) are
    needed unless the reuse rule holds.  Folded (:func:`folds`), one
    forward draws from the first.  Under ``rows`` the outputs are the
    global batch's."""
    batch = dequantize_batch(batch)
    if folds(model, mc_droprate, fold_mc, mc_model):
        if not generators:
            raise ValueError("the folded MC passes need a generator")
        clean, mc = _folded_passes(model, batch, word_vectors, mc_droprate,
                                   generators[0], rows)
        return _infer_outputs(clean, mc, batch, rows)
    clean = model(batch, word_vectors)
    return _infer_outputs(clean, _mc_passes(model, batch, word_vectors,
                                            mc_droprate, generators, clean,
                                            mc_model, rows), batch, rows)


def resident_batches(data: dict, sels: torch.Tensor, n_valid=None,
                     rows: Optional[Rows] = None):
    """(device batch, n_valid) per row of ``sels`` (n_batches, B), gathered
    from the device-resident split: the sweeps' input when the split lives
    on the device.  Every row is valid unless ``n_valid`` (one count per
    batch) says otherwise.  Under ``rows`` a batch is this rank's rows of
    its row of ``sels``; ``n_valid`` counts the global batch's."""
    for i, sel in enumerate(sels):
        yield gather_batch(data, sel, rows=rows), (sel.numel() if n_valid is None
                                                   else n_valid[i])


def _valid_rows(outs: list[tuple[dict, int]]) -> dict:
    return {k: torch.cat([o[k][:n] for o, n in outs]) for k in outs[0][0]}


@torch.inference_mode()
def eval_sweep(model, batches, word_vectors: torch.Tensor,
               rows: Optional[Rows] = None) -> torch.Tensor:
    """The eval sweep on the eager model: ``batches`` yields (device batch,
    n_valid) (:func:`resident_batches` or the Trainer's host stream);
    returns the valid rows' IoUs, concatenated on the device.  ``rows``:
    each batch is this rank's rows of its global batch."""
    return torch.cat([eval_step(model, batch, word_vectors, rows)["ious"][:n]
                      for batch, n in batches])


@torch.inference_mode()
def infer_sweep(model, batches, word_vectors: torch.Tensor,
                mc_droprate: float = 0.0, seed: int = 0, mc_model=None,
                fold_mc: bool = False, rows: Optional[Rows] = None) -> dict:
    """The AL sweep on the eager model over :func:`eval_sweep`'s
    ``batches``; batch ``i``'s MC passes draw from ``(seed, i, 0)`` and
    ``(seed, i, 1)``, wherever the batch came from.  Returns the valid rows
    of each output, concatenated on the device."""
    outs = []
    for i, (batch, n) in enumerate(batches):
        gens = _mc_generators(model, mc_droprate, word_vectors.device, seed, i)
        outs.append((infer_step(model, batch, word_vectors, mc_droprate, gens,
                                mc_model, fold_mc, rows), n))
    return _valid_rows(outs)


@torch.inference_mode()
def fused_eval_step(model, packed, batch: dict, word_vectors: torch.Tensor,
                    mxu_bf16: bool = False, rows: Optional[Rows] = None
                    ) -> torch.Tensor:
    """One batch's IoUs through K2 and K1 on the weights ``packed``."""
    batch = dequantize_batch(batch)
    ious = _ious(seqpan_forward_fused(model, packed, batch, word_vectors,
                                      mxu_bf16), batch)
    return gather_outputs({"ious": ious}, rows)["ious"]


@torch.inference_mode()
def fused_infer_step(model, packed, batch: dict, word_vectors: torch.Tensor,
                     mc_droprate: float = 0.0, generators=None, mc_model=None,
                     mxu_bf16: bool = False, rows: Optional[Rows] = None) -> dict:
    """:func:`infer_step` with the clean pass through K2 and K1 on the
    weights ``packed`` and the stochastic passes on the eager model."""
    batch = dequantize_batch(batch)
    clean = seqpan_forward_fused(model, packed, batch, word_vectors, mxu_bf16)
    mc = _mc_passes(model, batch, word_vectors, mc_droprate, generators, clean,
                    mc_model, rows)
    return _infer_outputs(clean, mc, batch, rows)


@torch.inference_mode()
def fused_eval_sweep(model, batches, word_vectors: torch.Tensor,
                     mxu_bf16: bool = False, rows: Optional[Rows] = None
                     ) -> torch.Tensor:
    """:func:`eval_sweep` through K2 and K1."""
    packed = pack_weights(model)
    return torch.cat([fused_eval_step(model, packed, batch, word_vectors,
                                      mxu_bf16, rows)[:n] for batch, n in batches])


@torch.inference_mode()
def fused_infer_sweep(model, batches, word_vectors: torch.Tensor,
                      mc_droprate: float = 0.0, seed: int = 0, mc_model=None,
                      mxu_bf16: bool = False, rows: Optional[Rows] = None) -> dict:
    """:func:`infer_sweep` with the clean pass through K2 and K1 and the
    stochastic passes on the eager model; the same outputs and streams."""
    packed = pack_weights(model)
    outs = []
    for i, (batch, n) in enumerate(batches):
        gens = _mc_generators(model, mc_droprate, word_vectors.device, seed, i)
        outs.append((fused_infer_step(model, packed, batch, word_vectors,
                                      mc_droprate, gens, mc_model, mxu_bf16,
                                      rows), n))
    return _valid_rows(outs)
