"""Trainer: the eval and AL-inference sweeps on one device (counterpart of
``hual_tpu/runtime/trainer.py``, the sweep half).

``Trainer`` puts the whole dataset on the card (the feature table in f32,
bf16, or int8 with its per-clip scales, and the per-sample columns); a sweep
sends only the index matrix, cached per split.  ``test()`` gives R@1 and
mIoU of a split; ``infer_trainset()`` writes the round pickle with the
reference schema, which ``hual_tpu.active.engine.update_labels`` reads.
``train.sweep_backend`` picks the eager model (``flax``) or K2 + K1
(``fused``), see ``runtime/steps.py``.

It runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card it raises.  Training, state save/load and
checkpoint restore come with slice 3 of the port (ROADMAP.md queue 1), as do
the options that raise NotImplementedError here.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from hual_tpu_torch.config import (Config, apply_matmul_precision,
                                   resolve_device)
from hual_tpu_torch.data.features import FeatureStore, quantize_features
from hual_tpu_torch.data.loader import EvalLoader, PackedDataset
from hual_tpu_torch.models import get_model_class
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.runtime.logger import get_logger
from hual_tpu_torch.runtime.observability import trace
from hual_tpu_torch.utils.io import save_pickle
from hual_tpu_torch.utils.metrics import rank1_metrics
from hual_tpu_torch.weights import load_jax_params

_FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "int8": torch.int8}
_DeviceTable = tuple[torch.Tensor, Optional[torch.Tensor]]


def _slice3(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               "slice 3 of the port (ROADMAP.md queue 1)")


class Trainer:
    def __init__(self, config: Config, dataset: dict,
                 feature_store: FeatureStore, logger=None,
                 device_features: Optional[_DeviceTable] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        tcfg = config.train
        if tcfg.fold_mc:
            raise _slice3("train.fold_mc (folded MC-dropout passes)")
        if tcfg.mc_dtype != config.model.compute_dtype:
            raise _slice3(f"train.mc_dtype={tcfg.mc_dtype!r} (a bf16 clone "
                          "for the MC passes)")
        if tcfg.fused_mxu_bf16:
            raise _slice3("train.fused_mxu_bf16 (bf16 products in K2)")
        if self.device.type == "cuda":
            apply_matmul_precision(config.model.matmul_precision)
        self.config = config
        self.dataset = dataset
        self.features = feature_store
        self.logger = logger or get_logger(f"./logs/{config.task}",
                                           config.suffix or "run")

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
        self.word_vectors = torch.as_tensor(
            np.asarray(dataset["word_vector"], np.float32), device=self.device)

        # the device-resident dataset; host streaming is not ported yet
        self._feat_dtype = _FEATURE_DTYPES[config.model.feature_dtype]
        packed = feature_store.packed
        table_gb = packed.size * self._feat_dtype.itemsize / 1e9
        if tcfg.host_streaming or (tcfg.host_streaming is None
                                   and table_gb > tcfg.hbm_budget_gb):
            raise _slice3(f"host streaming (a {table_gb:.2f} GB feature table, "
                          f"budget train.hbm_budget_gb={tcfg.hbm_budget_gb})")
        if device_features is None:
            device_features = self._put_feature_table(packed)
        table, scales = device_features
        if (tuple(table.shape) != packed.shape or table.dtype != self._feat_dtype
                or (scales is None) != (self._feat_dtype != torch.int8)):
            raise ValueError(f"device_features {tuple(table.shape)} "
                             f"{table.dtype} do not match the store's "
                             f"{packed.shape} {self._feat_dtype}")
        self._device_features = (table, scales)
        self._train_data = self._device_data(self.train_set)
        self._test_data = self._device_data(self.test_set)
        self._val_data = (self._device_data(self.val_set)
                          if self.val_set is not None else None)
        if tcfg.sweep_backend == "fused":
            self._eval_sweep = steps.fused_eval_sweep
            self._infer_sweep = steps.fused_infer_sweep
        else:
            self._eval_sweep = steps.eval_sweep
            self._infer_sweep = steps.infer_sweep
        # eval/infer index matrices depend only on the split and the batch
        # size: built and put on the device once
        self._sweep_cache: dict[str, tuple[Any, list, torch.Tensor, int]] = {}
        self.ready = False

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> None:
        """Draw every weight from a ``torch.Generator`` seeded with
        ``train.seed`` (or ``seed``)."""
        seed = self.config.train.seed if seed is None else seed
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.ready = True
        n = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"initialized {self.config.model.name}: {n} params")

    def load_params(self, flat: Mapping[str, np.ndarray]) -> None:
        """Load the JAX package's flat params dict (a bundle's
        ``params.npz``; keys like ``params/d_attn_0/...``)."""
        load_jax_params(self.model, flat)
        self.ready = True

    def export_device_features(self) -> _DeviceTable:
        """The device table, to reuse across rounds: (table, scales), with
        scales None unless the table is int8."""
        return self._device_features

    def _put_feature_table(self, packed: np.ndarray) -> _DeviceTable:
        if self._feat_dtype == torch.int8:
            q, scales = quantize_features(packed)
            return (torch.from_numpy(q).to(self.device),
                    torch.from_numpy(scales).to(self.device))
        table = torch.from_numpy(packed).to(self.device)
        return table.to(self._feat_dtype), None

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

    def _require_weights(self) -> None:
        if not self.ready:
            raise RuntimeError("no weights: call init_state() or load_params()")

    # ------------------------------------------------------------------
    def test(self, split: str = "test") -> dict[str, float]:
        """R@1@{0.3,0.5,0.7} and mIoU of a split, one device-resident sweep
        ending in one host fetch."""
        self._require_weights()
        ds = {"test": self.test_set, "val": self.val_set}[split]
        if ds is None:
            raise ValueError(f"{split} set is not available")
        data = {"test": self._test_data, "val": self._val_data}[split]
        batch_size = min(self.config.eval_batch_size, len(ds))
        pairs, sels = self._sweep_sels(split, ds, batch_size)
        with trace(f"eval_sweep_{split}"):
            ious = self._eval_sweep(self.model, data, sels,
                                    self.word_vectors).cpu().numpy()
        kept = np.concatenate([ious[i, :n] for i, (_, n) in enumerate(pairs)])
        return rank1_metrics(kept)

    def infer_trainset(self, save_path: Optional[str] = None) -> dict[str, float]:
        """Full-train-set inference; writes the round pickle with the
        reference schema (NumPy float32 arrays and Python ints)."""
        self._require_weights()
        cfg = self.config
        steps.check_mc_passes(self.model, cfg.train.mc_droprate)
        if save_path is None:
            save_path = f"./results/{cfg.task}/{cfg.suffix}.pkl"
        batch_size = min(cfg.infer_batch_size, len(self.train_set))
        pairs, sels = self._sweep_sels("infer", self.train_set, batch_size)
        with trace("infer_sweep"):
            outs = self._infer_sweep(self.model, self._train_data, sels,
                                     self.word_vectors, cfg.train.mc_droprate)
            host = {}
            for k, v in outs.items():
                stacked = v.cpu().numpy()                    # (n_batches, B, ...)
                host[k] = np.concatenate(
                    [stacked[i, :n] for i, (_, n) in enumerate(pairs)], axis=0)

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
        metrics = rank1_metrics(host["ious"])
        self.logger.info(
            "predict train set:\t{r1i3:.2f}\t{r1i5:.2f}\t{r1i7:.2f}\t{miou:.2f}\t"
            .format(**metrics))
        return metrics

    def train(self, *args, **kwargs):
        raise _slice3("Trainer.train")

    def save_state(self, path: str) -> None:
        raise _slice3("Trainer.save_state")

    def load_state(self, path: str) -> None:
        raise _slice3("Trainer.load_state")

    def restore(self, path: Optional[str] = None) -> None:
        raise _slice3("Trainer.restore")
