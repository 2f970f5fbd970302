"""Trainer: training, eval and AL-inference on one device (counterpart of
``hual_tpu/runtime/trainer.py``).

``Trainer`` puts the whole dataset on the card (the feature table in f32,
bf16, or int8 with its per-clip scales, and the per-sample columns); a step
or a sweep sends only indices.  Host streaming (``train.host_streaming``,
or by default a table over ``train.hbm_budget_gb``) builds no device table:
each batch is gathered in NumPy on a prefetch thread (and quantized per
clip there for an int8 table; f32 and bf16 tables both stream f32, as in
``hual_tpu``), uploaded, and run through the same steps in the same order
and random streams, so a streamed run replays a resident one; the sweeps
then run on the eager model.  ``train()`` runs the reference schedule:
linear LR decay per epoch, one train step per batch, a test sweep each
epoch, the best R@1@0.7 params kept as a checkpoint, and a full-state save
every ``train.save_state_every`` epochs for resume.  ``test()`` gives R@1
and mIoU of a split; ``infer_trainset()`` writes the round pickle with the
reference schema, which ``active.engine.update_labels`` reads.
``train.sweep_backend`` picks the eager model (``flax``) or K2 + K1
(``fused``, with bf16 products in K2 under ``train.fused_mxu_bf16``) for the
sweeps, see ``runtime/steps.py``; ``train.fold_mc`` folds the eager AL
sweep's three passes into one forward.  On the card the device-resident
epoch and sweeps replay captured CUDA graphs (``runtime/graphs.py``, the
JAX package's scanned programs), with K1 and, under ``fused``, K2 inside
them; the CPU and host streaming run ``runtime/steps.py``'s eager loops,
which a graphed run equals bit for bit in deterministic mode.  There is
no switch: ``hual_tpu`` has none for its scanned programs either.
``model.compute_dtype`` is the eager
model's activation dtype; ``train.mc_dtype``, when it differs, runs the
stochastic MC passes on a view of the model at that dtype that shares its
parameters (nothing is added to ``best.npz`` or ``state.pt``).

Checkpoints are the port's own: the best params as the JAX package's flat
``params.npz`` dict (``weights.to_jax_params``) in ``<model_dir>/best.npz``,
which either package can load; the full state (params, optimizer moments,
step, best R@1@0.7, epochs done) through ``torch.save``.  A resumed run
replays the uninterrupted one: the shuffle is a function of the epoch and
each step's generator of the global step.  On the card that replay is bit
for bit only in deterministic mode (``runtime/debug.enable_deterministic``,
the ``--deterministic`` flag of ``cli`` and ``orchestrate``).

Data parallelism (``mesh``, a ``parallel.Mesh`` built on a process group,
as ``hual_tpu``'s ``Trainer(mesh=)``): every rank holds the same weights
and runs its rows of every batch (``runtime/steps.py``); the feature table
is row-sharded over every rank (the residency budget is then per rank: the
table's GB over the number of shards) and the GloVe matrix over the model
group; host streaming gathers, and quantizes, only this rank's rows.  A
batch the data axis does not divide runs whole on every rank.  ``test()``
and ``infer_trainset()`` return the global results on every rank; rank 0
alone writes the logs, the metrics, ``best.npz``, ``state.pt`` and the
round pickle, and the other ranks wait for it at a barrier.  The graphs are
captured over NCCL only (``graphs.capturable``); under gloo the loops run
eager.  A mesh built on a group takes the sharded path at world size 1
too; without a mesh, or with the local one, nothing changes.

It runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from hual_tpu_torch.config import (Config, apply_matmul_precision,
                                   resolve_device)
from hual_tpu_torch.data.features import FeatureStore, quantize_features
from hual_tpu_torch.data.loader import (EvalLoader, PackedDataset,
                                        TrainLoader, prefetch)
from hual_tpu_torch.models import get_model_class
from hual_tpu_torch.ops.optim import BertAdamW, count_params, make_optimizer
from hual_tpu_torch.parallel import Mesh, RowShard
from hual_tpu_torch.runtime import graphs, steps
from hual_tpu_torch.runtime.logger import get_logger
from hual_tpu_torch.runtime.observability import MetricsWriter, StepTimer, trace
from hual_tpu_torch.utils.io import save_pickle
from hual_tpu_torch.utils.metrics import rank1_metrics
from hual_tpu_torch.weights import load_jax_params, to_jax_params

_FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "int8": torch.int8}
# (table, int8 scales or None); each a RowShard under a mesh
_DeviceTable = tuple[Any, Optional[Any]]


@dataclass
class TrainState:
    """What training carries besides the params, which live in the model."""

    opt: BertAdamW
    step: int = 0
    best_r1i7: float = -1.0
    # epochs completed so far (== the next epoch train() runs)
    epoch: int = 0


class Trainer:
    def __init__(self, config: Config, dataset: dict,
                 feature_store: FeatureStore, mesh: Optional[Mesh] = None,
                 logger=None, device_features: Optional[_DeviceTable] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        tcfg = config.train
        if self.device.type == "cuda":
            apply_matmul_precision(config.model.matmul_precision)
        self.config = config
        self.dataset = dataset
        self.features = feature_store
        # the sharded path runs on a mesh built on a process group only
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.is_writer = self.mesh is None or self.mesh.is_writer
        self.logger = logger or get_logger(f"./logs/{config.task}",
                                           config.suffix or "run",
                                           to_file=self.is_writer)

        # residency: the device table, or host streaming when asked for or
        # when this rank's part of the table (rows padded to the shards x T
        # x D in the storage dtype; int8 scales not counted) is over the
        # budget, as hual_tpu counts it per chip
        self._feat_dtype = _FEATURE_DTYPES[config.model.feature_dtype]
        packed = feature_store.packed
        shards = 1 if self.mesh is None else self.mesh.size
        self._table_shape = (packed.shape[0] + (-packed.shape[0]) % shards,
                             *packed.shape[1:])
        table_gb = (math.prod(self._table_shape) * self._feat_dtype.itemsize
                    / 1e9 / shards)
        hs = tcfg.host_streaming
        self.host_streaming = (table_gb > tcfg.hbm_budget_gb if hs is None
                               else bool(hs))
        if tcfg.sweep_backend == "fused" and self.host_streaming:
            # hual_tpu's documented fallback and warning
            # (hual_tpu/runtime/trainer.py), kept for parity: the fused
            # sweeps would take the streamed batches as they are
            self.logger.warning(
                "train.sweep_backend='fused' requires a device-resident "
                "dataset; host-streaming mode is active, using the flax "
                "sweep backend instead")
        self._fused = tcfg.sweep_backend == "fused" and not self.host_streaming

        max_wlen, max_clen = dataset["max_wlen"], dataset["max_clen"]
        self.train_set = PackedDataset(dataset["train_set"], feature_store,
                                       max_wlen, max_clen)
        self.test_set = PackedDataset(dataset["test_set"], feature_store,
                                      max_wlen, max_clen)
        self.val_set = (PackedDataset(dataset["val_set"], feature_store,
                                      max_wlen, max_clen)
                        if dataset.get("val_set") else None)

        config.model.num_chars = dataset["n_chars"]
        config.model.num_words = dataset["n_words"]
        self.model = get_model_class(config.model.name).from_config(config)
        self.model = self.model.to(self.device).eval()
        # the stochastic MC passes' model (hual_tpu Trainer._mc_model)
        self.mc_model = (None if tcfg.mc_dtype == config.model.compute_dtype
                         else self.model.with_compute_dtype(tcfg.mc_dtype))
        vectors = np.asarray(dataset["word_vector"], np.float32)
        self.word_vectors = (torch.as_tensor(vectors, device=self.device)
                             if self.mesh is None
                             else self.mesh.shard_vocab(vectors, self.device))

        self._device_features: Optional[_DeviceTable] = None
        self._train_data = self._test_data = self._val_data = None
        if self.host_streaming:
            self.logger.info(
                f"host-streaming mode: feature table would be {table_gb:.1f} "
                f"GB a rank (budget {tcfg.hbm_budget_gb} GB); batches are "
                "gathered on host and prefetched")
            if self._feat_dtype == torch.int8:
                self.logger.info(
                    "host-streaming with model.feature_dtype='int8': batches "
                    "are quantized per clip on the prefetch thread and "
                    "shipped as (int8, f32 scales), a quarter of the f32 "
                    "upload bytes")
            if device_features is not None:
                self.logger.info("host-streaming mode: the device_features "
                                 "passed in are not used")
        else:
            if device_features is None:
                device_features = self._put_feature_table(packed)
            table, scales = device_features
            if (tuple(table.shape) != self._table_shape
                    or isinstance(table, RowShard) != (self.mesh is not None)
                    or table.dtype != self._feat_dtype
                    or (scales is None) != (self._feat_dtype != torch.int8)):
                raise ValueError(f"device_features {tuple(table.shape)} "
                                 f"{table.dtype} do not match the store's "
                                 f"{self._table_shape} {self._feat_dtype}")
            self._device_features = (table, scales)
            self._train_data = self._device_data(self.train_set)
            self._test_data = self._device_data(self.test_set)
            self._val_data = (self._device_data(self.val_set)
                              if self.val_set is not None else None)
        # the resident loops on the card: captured CUDA graphs, built at
        # first use, kept across epochs and sweeps (None: the eager loops)
        self._graphs: Optional[graphs.Graphs] = None
        if (self.device.type == "cuda" and not self.host_streaming
                and graphs.capturable(self.mesh)):
            self._graphs = graphs.Graphs(self.device)
        # eval/infer index matrices depend only on the split and the batch
        # size: built and put on the device once
        self._sweep_cache: dict[str, tuple[Any, list, torch.Tensor, int]] = {}
        self.state: Optional[TrainState] = None
        self.metrics: Optional[MetricsWriter] = None
        self.last_epoch_wall: dict[str, float] = {}

    def close(self) -> None:
        """Release the metrics JSONL handle and the captured graphs (a
        multi-round loop builds one trainer per round)."""
        if self.metrics is not None:
            self.metrics.close()
            self.metrics = None
        if self._graphs is not None:
            self._graphs.close()

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Draw every weight from a ``torch.Generator`` seeded with
        ``train.seed`` (or ``seed``); zero optimizer moments."""
        seed = self.config.train.seed if seed is None else seed
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.logger.info(f"initialized {self.config.model.name}: "
                         f"{count_params(self.model)} params")
        return self._fresh_state()

    def load_params(self, flat: Mapping[str, np.ndarray]) -> TrainState:
        """Load the JAX package's flat params dict (a bundle's
        ``params.npz``; keys like ``params/d_attn_0/...``); zero optimizer
        moments."""
        load_jax_params(self.model, flat)
        return self._fresh_state()

    def _fresh_state(self) -> TrainState:
        tcfg = self.config.train
        self.state = TrainState(opt=make_optimizer(self.model, tcfg.clip_norm,
                                                   tcfg.weight_decay))
        return self.state

    def export_device_features(self) -> Optional[_DeviceTable]:
        """The device table, to reuse across rounds: (table, scales), with
        scales None unless the table is int8 (each this rank's
        ``RowShard`` under a mesh); None under host streaming."""
        return self._device_features

    def _put_feature_table(self, packed: np.ndarray) -> _DeviceTable:
        if self._feat_dtype == torch.int8:
            q, scales = quantize_features(packed)
            return self._put(q), self._put(scales)
        table = self._put(packed)
        if isinstance(table, RowShard):
            return RowShard(table.local.to(self._feat_dtype), table.lo,
                            table.total, table.group), None
        return table.to(self._feat_dtype), None

    def _put(self, rows: np.ndarray):
        """A table on the device: whole, or this rank's RowShard under a
        mesh (``feature_sharding``)."""
        if self.mesh is None:
            return torch.from_numpy(rows).to(self.device)
        return self.mesh.shard_rows(rows, self.device)

    def _barrier(self) -> None:
        """Under a mesh, wait until rank 0 has written what the others read."""
        if self.mesh is not None:
            self.mesh.barrier()

    def _rows(self, sel: np.ndarray):
        """(this rank's indices of a global batch ``sel``, their Rows)."""
        rows = steps.batch_rows(self.mesh, len(sel))
        return (sel if rows is None else sel[rows.lo:rows.lo + rows.n]), rows

    def _device_data(self, packed: PackedDataset) -> dict:
        cols = {"feat_rows": packed.feat_rows, "word_ids": packed.word_ids,
                "char_ids": packed.char_ids, "s_ind": packed.s_ind,
                "e_ind": packed.e_ind, "v_len": packed.v_len,
                "duration": packed.duration}
        data = {k: torch.from_numpy(v).to(self.device) for k, v in cols.items()}
        data["features"], scales = self._device_features
        if scales is not None:
            data["feature_scales"] = scales
        return data

    def _hs_stream(self, it: Iterable[tuple[dict, int]]
                   ) -> Iterator[tuple[dict, int]]:
        """The streamed batches' transform on the prefetch thread: an int8
        table's batches are quantized per clip (``quantize_features``, the
        resident table's scheme, so both dequantize to the same values) and
        ship as (int8, f32 scales).  The identity for f32 and for bf16
        tables: a bf16 table streams f32, as ``hual_tpu`` does."""
        if self._feat_dtype != torch.int8:
            yield from it
            return
        for host, n in it:
            q, scales = quantize_features(host["video_features"])
            yield dict(host, video_features=q, feature_scales=scales), n

    def _stream(self, dataset: PackedDataset, sels: Iterable[tuple[Any, int]],
                with_labels: bool = False) -> Iterator[tuple[dict, int]]:
        """(device batch, n_valid) per (indices, n_valid) of ``sels``: the
        NumPy gather and ``_hs_stream`` run on the prefetch thread, which
        makes no CUDA call; the upload runs in the caller's."""
        host = ((dataset.gather(sel, with_labels=False), n) for sel, n in sels)
        stream = prefetch(self._hs_stream(host))
        try:
            for batch, n in stream:
                yield steps.upload_batch(batch, self.device, with_labels), n
        finally:
            stream.close()   # a stream left early (a step raised) ends its thread

    def _sweep_sels(self, key: str, dataset: PackedDataset, batch_size: int
                    ) -> tuple[list, torch.Tensor]:
        cached = self._sweep_cache.get(key)
        if cached is None or cached[0] is not dataset or cached[3] != batch_size:
            loader = EvalLoader(dataset, batch_size, pad_to_batch=True)
            pairs = list(loader.index_iter())
            sels = torch.from_numpy(np.stack([s for s, _ in pairs])).to(self.device)
            cached = (dataset, pairs, sels, batch_size)
            self._sweep_cache[key] = cached
        return cached[1], cached[2]

    def _resident_sweep(self, key: str, dataset: PackedDataset,
                        batch_size: int) -> tuple[dict, torch.Tensor, list]:
        """The graphed sweeps' inputs: the device split, its index matrix
        (n_batches, B) and each batch's valid rows."""
        data = {"infer": self._train_data, "test": self._test_data,
                "val": self._val_data}[key]
        pairs, sels = self._sweep_sels(key, dataset, batch_size)
        return data, sels, [n for _, n in pairs]

    def _sweep_args(self, key: str, dataset: PackedDataset) -> tuple:
        """The loops (``self._graphs`` or ``runtime/steps.py``, whose sweeps
        share their names), a sweep's inputs over ``dataset`` (the device
        split, its index matrix and valid rows for the graphs, the batches
        for the eager loops) and the ``Rows`` of its batches."""
        batch_size = min(self.config.eval_batch_size if key != "infer"
                         else self.config.infer_batch_size, len(dataset))
        rows = steps.batch_rows(self.mesh, batch_size)
        if self._graphs is None:
            return steps, (self._sweep_batches(key, dataset, batch_size, rows),), rows
        return self._graphs, self._resident_sweep(key, dataset, batch_size), rows

    def _sweep_batches(self, key: str, dataset: PackedDataset,
                       batch_size: int, rows) -> Iterator[tuple[dict, int]]:
        """A sweep's (device batch, n_valid) pairs over ``dataset`` in
        ``EvalLoader``'s padded batches: gathered from the device split, or
        streamed from the host in the same order (batch ``i`` is the same
        batch, so it draws from the same MC streams); this rank's ``rows``
        of each under a mesh."""
        if self.host_streaming:
            loader = EvalLoader(dataset, batch_size, pad_to_batch=True)
            return self._stream(dataset, ((self._rows(sel)[0], n)
                                          for sel, n in loader.index_iter()))
        return steps.resident_batches(*self._resident_sweep(key, dataset,
                                                            batch_size), rows)

    def _require_weights(self) -> None:
        if self.state is None:
            raise RuntimeError("no weights: call init_state() or load_params()")

    # ------------------------------------------------------------------
    def test(self, split: str = "test") -> dict[str, float]:
        """R@1@{0.3,0.5,0.7} and mIoU of a split, one sweep ending in one
        host fetch."""
        return rank1_metrics(self._sweep_ious(split))

    def _sweep_ious(self, split: str) -> np.ndarray:
        """The split's IoUs from one eval sweep, graphed on the card."""
        self._require_weights()
        ds = {"test": self.test_set, "val": self.val_set}[split]
        if ds is None:
            raise ValueError(f"{split} set is not available")
        with trace(f"eval_sweep_{split}"):
            loops, inputs, rows = self._sweep_args(split, ds)
            args = (self.model, *inputs, self.word_vectors)
            ious = (loops.fused_eval_sweep(
                        *args, mxu_bf16=self.config.train.fused_mxu_bf16,
                        rows=rows)
                    if self._fused else loops.eval_sweep(*args, rows=rows))
            return ious.cpu().numpy()

    def infer_trainset(self, save_path: Optional[str] = None,
                       seed: Optional[int] = None) -> dict[str, float]:
        """Full-train-set MC-dropout inference; writes the round pickle with
        the reference schema (NumPy float32 arrays and Python ints).  The
        stochastic passes draw from ``train.seed`` (or ``seed``).  Under a
        mesh every rank returns the metrics and rank 0 writes the pickle."""
        self._require_weights()
        cfg = self.config
        seed = cfg.train.seed if seed is None else seed
        if save_path is None:
            save_path = f"./results/{cfg.task}/{cfg.suffix}.pkl"
        with trace("infer_sweep"):
            loops, inputs, rows = self._sweep_args("infer", self.train_set)
            args = (self.model, *inputs, self.word_vectors,
                    cfg.train.mc_droprate, seed, self.mc_model)
            outs = (loops.fused_infer_sweep(*args,
                                            mxu_bf16=cfg.train.fused_mxu_bf16,
                                            rows=rows)
                    if self._fused
                    else loops.infer_sweep(*args, fold_mc=cfg.train.fold_mc,
                                           rows=rows))
            host = {k: v.cpu().numpy() for k, v in outs.items()}

        metrics = rank1_metrics(host["ious"])
        if self.is_writer:
            self._write_pickle(host, save_path)
            self.logger.info(
                "predict train set:\t{r1i3:.2f}\t{r1i5:.2f}\t{r1i7:.2f}\t"
                "{miou:.2f}\t".format(**metrics))
        self._barrier()
        return metrics

    def _write_pickle(self, host: dict, save_path: str) -> None:
        save_list = []
        for i, rec in enumerate(self.train_set.records):
            save_list.append({
                "vid": rec["vid"],
                "duration": rec["duration"],
                "psuedo_idx": [rec["s_ind"], rec["e_ind"]],
                "sentence": " ".join(rec["words"]),
                "v_len": int(rec["v_len"]),
                "prop_idx": [int(host["start_index"][i]),
                             int(host["end_index"][i])],
                "prop_logits": [host["start_logits"][i], host["end_logits"][i]],
                "prop_logits1": [host["start_logits1"][i], host["end_logits1"][i]],
                "prop_logits2": [host["start_logits2"][i], host["end_logits2"][i]],
                "m_score": host["match_scores"][i],
            })
        save_pickle(save_list, save_path)

    # ------------------------------------------------------------------
    def train(self, epoch_callback: Optional[Callable[[int, dict], None]] = None
              ) -> dict[str, Any]:
        """Run the configured epochs from ``state.epoch``; returns the
        best-epoch record.

        ``epoch_callback(epoch, test_metrics)`` fires after each epoch's
        checkpoint and state save; an exception from it stops the run where
        a preemption would.
        """
        cfg = self.config
        tcfg = cfg.train
        if self.state is None:
            self.init_state()
        state = self.state
        if self.metrics is None and self.is_writer:
            self.metrics = MetricsWriter(os.path.join(
                "logs", cfg.task, f"metrics_{cfg.suffix or 'run'}.jsonl"))
        loader = TrainLoader(self.train_set, tcfg.batch_size, seed=tcfg.seed)
        # the persisted best seeds the threshold, so a resumed run cannot
        # overwrite a better checkpoint
        best = {"r1i7": state.best_r1i7, "train_line": "", "test_line": "",
                "epoch": -1, "test_metrics": {}, "train_metrics": {},
                "improved": False}
        model_dir = os.path.abspath(cfg.model_dir())
        if self.is_writer:
            os.makedirs(model_dir, exist_ok=True)
        timer = StepTimer(warmup_steps=1)
        if state.epoch:
            self.logger.info(f"resuming at epoch {state.epoch} "
                             f"(step {state.step})")
        for epoch in range(state.epoch, tcfg.epochs):
            # linear LR decay (reference main.py:61)
            cur_lr = tcfg.lr * (1.0 - epoch / tcfg.epochs)
            t0 = time.perf_counter()
            timer.start()
            with trace(f"train_epoch_{epoch}"):
                if self.host_streaming:
                    # the resident path's batch order and step streams;
                    # the stream carries each batch's Rows through
                    sels = (self._rows(sel) for sel in loader.index_iter(epoch))
                    losses, ious = steps.train_batches(
                        self.model, state.opt,
                        self._stream(self.train_set, sels, with_labels=True),
                        self.word_vectors, cur_lr, tcfg.seed + 17, state.step,
                        drop_rate=tcfg.droprate,
                        match_lambda=cfg.loss.match_lambda)
                else:
                    # graphed on the card: the full batches replay one
                    # captured step, the ragged rest runs eager
                    order = torch.from_numpy(np.concatenate(
                        list(loader.index_iter(epoch)))).to(self.device)
                    loops = steps if self._graphs is None else self._graphs
                    losses, ious = loops.train_epoch(
                        self.model, state.opt, self._train_data, order,
                        loader.batch_size, self.word_vectors, cur_lr,
                        tcfg.seed + 17, state.step, drop_rate=tcfg.droprate,
                        match_lambda=cfg.loss.match_lambda, mesh=self.mesh)
                # the epoch's one fetch, and its only synchronisation but
                # for the streamed batches' synchronous uploads
                fetched = torch.cat([losses, ious]).cpu().numpy()
            state.step += losses.numel()
            timer.stop(loader.num_samples())
            train_s = time.perf_counter() - t0
            train_m = rank1_metrics(fetched[losses.numel():])
            train_m["loss"] = float(np.mean(fetched[:losses.numel()]))
            train_line = ("TRAIN:\t{r1i3:.2f}\t{r1i5:.2f}\t{r1i7:.2f}\t{miou:.2f}\t"
                          .format(**train_m))
            self.logger.info(f"Epoch {epoch}|{tcfg.epochs}: loss "
                             f"{train_m['loss']:.4f} "
                             f"({loader.num_samples() / train_s:.0f} pairs/s)")
            self.logger.info(train_line)

            t1 = time.perf_counter()
            test_m = self.test()
            eval_s = time.perf_counter() - t1
            test_line = ("TEST:\t{r1i3:.2f}\t{r1i5:.2f}\t{r1i7:.2f}\t{miou:.2f}\t"
                         .format(**test_m))
            self.logger.info(test_line)
            if self.metrics is not None:
                self.metrics.write("epoch", epoch=epoch, lr=cur_lr, train=train_m,
                                   test=test_m, pairs_per_sec=timer.pairs_per_sec,
                                   step_ms=timer.mean_step_ms,
                                   train_wall_s=train_s, eval_wall_s=eval_s)
            self.last_epoch_wall = {"train_s": train_s, "eval_s": eval_s,
                                    "steps": int(losses.numel())}

            # keep the params of the best test R@1@0.7 (reference main.py:70-75)
            if test_m["r1i7"] > best["r1i7"]:
                best.update(r1i7=test_m["r1i7"], train_line=train_line,
                            test_line=test_line, epoch=epoch,
                            test_metrics=test_m, train_metrics=train_m,
                            improved=True)
                state.best_r1i7 = float(test_m["r1i7"])
                if self.is_writer:
                    _save_npz(os.path.join(model_dir, "best.npz"),
                              to_jax_params(self.model))
            state.epoch = epoch + 1
            # the resume point, after the best checkpoint, so a resume's
            # threshold matches the checkpoint on disk
            every = tcfg.save_state_every
            if every and state.epoch % every == 0 and state.epoch < tcfg.epochs:
                self.save_state(os.path.join(model_dir, "state.pt"))
            if epoch_callback is not None:
                epoch_callback(epoch, test_m)
        self.logger.info("Highest R1i7 epoch:\n%s\n%s",
                         best["train_line"], best["test_line"])
        best["pairs_per_sec"] = timer.pairs_per_sec
        if self.metrics is not None:
            self.metrics.write("best", **{k: v for k, v in best.items()
                                          if not k.endswith("_line")})
        self._barrier()
        return best

    # ------------------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Params, optimizer moments, step, best R@1@0.7 and epochs done,
        through ``torch.save`` (written to a temporary file, then renamed);
        by rank 0 under a mesh, the others waiting at a barrier."""
        self._require_weights()
        if self.is_writer:
            self._write_state(path)
        self._barrier()

    def _write_state(self, path: str) -> None:
        state = self.state
        blob = {"params": {k: v.detach().cpu().clone()
                           for k, v in self.model.state_dict().items()},
                "opt": {name: {k: v.cpu().clone() for k, v in part.items()}
                        for name, part in state.opt.state_dict().items()},
                "step": state.step, "best_r1i7": state.best_r1i7,
                "epoch": state.epoch}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)

    def load_state(self, path: str) -> None:
        """Resume from :meth:`save_state`'s file."""
        if self.state is None:
            self._fresh_state()
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(blob["params"])
        self.state.opt.load_state_dict(blob["opt"])
        self.state.step = int(blob["step"])
        self.state.best_r1i7 = float(blob["best_r1i7"])
        self.state.epoch = int(blob["epoch"])

    def restore(self, path: Optional[str] = None) -> None:
        """Load the best checkpoint (``<model_dir>/best.npz`` by default);
        the optimizer state and counters are left as they are."""
        if path is None:
            path = os.path.join(os.path.abspath(self.config.model_dir()),
                                "best.npz")
        if not os.path.exists(path):
            raise ValueError(f"no pre-trained model exists at {path}")
        with np.load(path) as flat:
            load_jax_params(self.model, dict(flat))
        if self.state is None:
            self._fresh_state()


def _save_npz(path: str, flat: Mapping[str, np.ndarray]) -> None:
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
