"""Deployment inference: (video features, duration, query) -> moment span.

Counterpart of ``hual_tpu/serve.py``, reading and writing the same bundle
(``params.npz`` with the JAX package's leaf names, ``word_vectors.npy``,
``vocab.json``, ``meta.json``, format_version 1), so a bundle exported by
either package serves in either.

``Predictor`` runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card and without that argument it raises, and
it never moves to the CPU on its own.  Host encoding mirrors the JAX
package's quirk for quirk: words cut at ``max_vlen`` and then at
``max_wlen``, the UNK fallback, mean-pool downsampling of long videos, and
ragged chunks padded by repeating their last request.  Each chunk is one
deterministic SeqPAN forward, one span decode (the Hopper kernel under
``model.span_decode: pallas``) and one span-confidence score, ending in one
device-to-host copy.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from hual_tpu_torch.config import (Config, apply_matmul_precision,
                                   resolve_device)
from hual_tpu_torch.data.features import visual_feature_sampling
from hual_tpu_torch.data.tokenize import tokenize
from hual_tpu_torch.data.vocab import UNK
from hual_tpu_torch.models import get_model_class
from hual_tpu_torch.ops.masking import mask_logits
from hual_tpu_torch.utils.metrics import index_to_time
from hual_tpu_torch.weights import load_jax_params, to_jax_params

_META = "meta.json"
_PARAMS = "params.npz"
_VOCAB = "vocab.json"
_WORDVECS = "word_vectors.npy"

Request = tuple[np.ndarray, float, str]


def export_bundle(trainer, path: str) -> str:
    """Write a serving bundle of a (trained) ``runtime.trainer.Trainer``:
    its params, GloVe rows, vocabularies, config and packed text bounds.
    Either package reads it.  Returns ``path``."""
    trainer._require_weights()
    return export_model_bundle(
        trainer.model, path, config=trainer.config,
        word_dict=trainer.dataset["word_dict"],
        char_dict=trainer.dataset["char_dict"],
        word_vectors=trainer.dataset["word_vector"],
        max_wlen=trainer.train_set.max_wlen,
        max_clen=trainer.train_set.max_clen)


def export_model_bundle(model: torch.nn.Module, path: str, *, config: Config,
                        word_dict: dict[str, int], char_dict: dict[str, int],
                        word_vectors: np.ndarray, max_wlen: int,
                        max_clen: int) -> str:
    """Write a serving bundle of a model and its text tables, passed
    directly.  Either package reads it.  Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _PARAMS), **to_jax_params(model))
    np.save(os.path.join(path, _WORDVECS), np.asarray(word_vectors, np.float32))
    with open(os.path.join(path, _VOCAB), "w") as f:
        json.dump({"word_dict": word_dict, "char_dict": char_dict}, f)
    meta = {"config": config.to_dict(), "max_wlen": int(max_wlen),
            "max_clen": int(max_clen), "format_version": 1}
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def span_score(start_logits: torch.Tensor, end_logits: torch.Tensor,
               v_mask: torch.Tensor) -> torch.Tensor:
    """Span confidence: max of triu(softmax(start) ⊗ softmax(end)), (B,)."""
    sp = torch.softmax(mask_logits(start_logits, v_mask), dim=-1)
    ep = torch.softmax(mask_logits(end_logits, v_mask), dim=-1)
    return torch.triu(sp[:, :, None] * ep[:, None, :]).amax(dim=(1, 2))


class Predictor:
    """Batched moment-retrieval inference on one device.

    ``predict``/``predict_batch`` end on a device-to-host copy of the
    indices and scores, which is their sync point.
    """

    def __init__(self, config: Config, params: dict[str, np.ndarray],
                 word_dict: dict[str, int], char_dict: dict[str, int],
                 word_vectors: np.ndarray, max_wlen: int, max_clen: int,
                 batch_size: int = 8, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            apply_matmul_precision(config.model.matmul_precision)
        self.config = config
        model = get_model_class(config.model.name).from_config(config)
        self.model = load_jax_params(model, params).to(self.device).eval()
        self.word_dict, self.char_dict = word_dict, char_dict
        self.max_wlen, self.max_clen = int(max_wlen), int(max_clen)
        self.batch_size = int(batch_size)
        self.max_vlen = int(config.model.max_vlen)
        self.vdim = int(config.model.vdim)
        self._unk_w = word_dict[UNK]
        self._unk_c = char_dict[UNK]
        self.word_vectors = torch.as_tensor(
            np.asarray(word_vectors, np.float32), device=self.device)

    @classmethod
    def from_trainer(cls, trainer, batch_size: int = 8) -> "Predictor":
        """A Predictor on the trainer's device with a copy of its current
        params (later training does not move it)."""
        trainer._require_weights()
        return cls(trainer.config, to_jax_params(trainer.model),
                   trainer.dataset["word_dict"], trainer.dataset["char_dict"],
                   np.asarray(trainer.dataset["word_vector"], np.float32),
                   trainer.train_set.max_wlen, trainer.train_set.max_clen,
                   batch_size=batch_size, device=trainer.device)

    @classmethod
    def from_bundle(cls, path: str, batch_size: int = 8,
                    device: str | torch.device = "cuda") -> "Predictor":
        device = resolve_device(device)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        with open(os.path.join(path, _VOCAB)) as f:
            vocab = json.load(f)
        with np.load(os.path.join(path, _PARAMS)) as npz:
            params = dict(npz)
        return cls(Config.from_dict(meta["config"]), params,
                   vocab["word_dict"], vocab["char_dict"],
                   np.load(os.path.join(path, _WORDVECS)),
                   meta["max_wlen"], meta["max_clen"],
                   batch_size=batch_size, device=device)

    # -- host-side encoding (mirrors the training pipeline) -----------------
    def encode_query(self, query: str) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize + vocab-map one query to fixed-shape id arrays."""
        words = tokenize(query)[:self.max_vlen][:self.max_wlen]
        word_ids = np.zeros((self.max_wlen,), np.int32)
        char_ids = np.zeros((self.max_wlen, self.max_clen), np.int32)
        for j, w in enumerate(words):
            word_ids[j] = self.word_dict.get(w, self._unk_w)
            for k, c in enumerate(w[:self.max_clen]):
                char_ids[j, k] = self.char_dict.get(c, self._unk_c)
        return word_ids, char_ids

    def encode_video(self, features: np.ndarray) -> tuple[np.ndarray, int]:
        """(n_clips, vdim) raw features -> (max_vlen, vdim) padded + v_len."""
        feats = np.asarray(features, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.vdim:
            raise ValueError(f"features must be (n_clips, {self.vdim}), "
                             f"got {feats.shape}")
        if feats.shape[0] == 0:
            raise ValueError("empty video")
        if feats.shape[0] > self.max_vlen:
            feats = visual_feature_sampling(feats, self.max_vlen)
        v_len = feats.shape[0]
        if v_len < self.max_vlen:
            feats = np.concatenate(
                [feats, np.zeros((self.max_vlen - v_len, self.vdim),
                                 np.float32)], axis=0)
        return feats, v_len

    def encode_batch(self, chunk: Sequence[Request]) -> dict[str, np.ndarray]:
        """Up to ``batch_size`` requests -> one padded host batch; missing
        rows repeat the last request."""
        bs = self.batch_size
        chunk = list(chunk) + [chunk[-1]] * (bs - len(chunk))
        vf = np.zeros((bs, self.max_vlen, self.vdim), np.float32)
        vl = np.zeros((bs,), np.int32)
        wid = np.zeros((bs, self.max_wlen), np.int32)
        cid = np.zeros((bs, self.max_wlen, self.max_clen), np.int32)
        for i, (feats, _, query) in enumerate(chunk):
            vf[i], vl[i] = self.encode_video(feats)
            wid[i], cid[i] = self.encode_query(query)
        return {"video_features": vf, "video_seq_len": vl,
                "word_ids": wid, "char_ids": cid}

    # -- inference -----------------------------------------------------------
    @torch.inference_mode()
    def forward(self, batch: dict[str, np.ndarray]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Host batch -> (start_index, end_index, score) on the device."""
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        out = self.model(batch, self.word_vectors)
        score = span_score(out["start_logits"], out["end_logits"],
                           out["v_mask"])
        return out["start_index"], out["end_index"], score

    def warmup(self) -> None:
        """Run one dummy batch: builds the kernels and warms the device."""
        dummy = (np.zeros((1, self.vdim), np.float32), 1.0, "")
        self.predict_batch([dummy])

    def predict(self, features: np.ndarray, duration: float,
                query: str) -> dict[str, Any]:
        """One request -> {'start_time','end_time','score',...} seconds."""
        return self.predict_batch([(features, duration, query)])[0]

    def predict_batch(self, requests: Sequence[Request]) -> list[dict[str, Any]]:
        """Batched requests, chunked and padded to ``batch_size``."""
        results: list[Optional[dict]] = [None] * len(requests)
        for lo in range(0, len(requests), self.batch_size):
            chunk = requests[lo:lo + self.batch_size]
            batch = self.encode_batch(chunk)
            s_idx, e_idx, score = (t.cpu().numpy()
                                   for t in self.forward(batch))
            v_len = batch["video_seq_len"]
            for i, (_, duration, _) in enumerate(chunk):
                s_t, e_t = index_to_time(int(s_idx[i]), int(e_idx[i]),
                                         int(v_len[i]), float(duration))
                results[lo + i] = {
                    "start_time": s_t, "end_time": e_t,
                    "score": float(score[i]),
                    "start_index": int(s_idx[i]), "end_index": int(e_idx[i]),
                    "v_len": int(v_len[i]),
                }
        return results  # type: ignore[return-value]
