"""The active-learning sweep: ``Trainer.infer_trainset()`` over the train
split at the configuration's MC rate, one call after another, each writing
the round pickle under the run's work directory.

Set-up runs one sweep, which captures its CUDA graph and packs K2's weights.
After the window the last call's pickle is read back and held against the
reference over every row: the clean pass's logits, span and match scores,
both MC passes' logits (the same dropout streams), and the pickle's own
fields against the records the run made.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from benchmark import compare
from benchmark.cellbase import Base


class Entry(Base):
    def __init__(self, ctx, mode: str = "program"):
        super().__init__(ctx, mode)
        tcfg = ctx.spec["config"]["train"]
        self.n = len(self.inputs.splits["train"])
        self.batch_size = min(tcfg["infer_batch_size"], self.n)
        self.mc_rate = tcfg["mc_droprate"]
        self.pickle = os.path.join(ctx.workdir, "round.pkl")
        if self.trainer is not None:
            self.trainer.infer_trainset(save_path=self.pickle)

    def call(self) -> int:
        if self.trainer is None:
            return 0
        self.trainer.infer_trainset(save_path=self.pickle)
        return self.n

    def facts(self) -> dict:
        return {"queries": self.n, "batch_size": self.batch_size,
                **self.model_sizes}

    def _reference(self, prec: str) -> dict:
        net = compare.model(self.ctx.spec, self.weights, self.ctx.device)
        with compare.precision(prec):
            return compare.sweep(net, self.inputs.splits["train"], self.inputs.table,
                                 self.inputs.word_vectors, self.batch_size, self.mc_rate,
                                 self.ctx.seed)

    def _program(self) -> tuple[dict, int]:
        """The pickle's arrays, and how many rows disagree with the records
        the run made (vid, labelled span, clip count, duration, sentence)."""
        with open(self.pickle, "rb") as f:
            rows = pickle.load(f)
        recs = self.inputs.dataset["train_set"]
        wrong = abs(len(rows) - len(recs)) + sum(
            r["vid"] != q["vid"] or list(r["psuedo_idx"]) != [q["s_ind"], q["e_ind"]]
            or r["v_len"] != q["v_len"] or r["duration"] != q["duration"]
            or r["sentence"] != " ".join(q["words"]) for r, q in zip(rows, recs))

        def col(f):
            return torch.from_numpy(np.stack([np.asarray(f(r)) for r in rows]))
        out = {"start_logits": col(lambda r: r["prop_logits"][0]),
               "end_logits": col(lambda r: r["prop_logits"][1]),
               "start_logits1": col(lambda r: r["prop_logits1"][0]),
               "end_logits1": col(lambda r: r["prop_logits1"][1]),
               "start_logits2": col(lambda r: r["prop_logits2"][0]),
               "end_logits2": col(lambda r: r["prop_logits2"][1]),
               "match_scores": col(lambda r: r["m_score"]),
               "start_index": col(lambda r: r["prop_idx"][0]),
               "end_index": col(lambda r: r["prop_idx"][1])}
        return out, wrong

    def check(self) -> dict:
        """clean_logit_gap, mc_logit_gap, match_gap (widest absolute gaps over
        valid clips), span_gap (widest log-probability by which a chosen span
        lies below the reference's best) and pickle_rows_wrong."""
        want = self._reference("f32")
        if self.mode == "program":
            got, wrong = self._program()
        else:
            got, wrong = self._reference("tf32"), 0
        mask = want["v_mask"]
        gap = compare.masked_max_abs
        return {
            "clean_logit_gap": max(gap(got[k], want[k], mask)
                                   for k in ("start_logits", "end_logits")),
            "mc_logit_gap": max(gap(got[k], want[k], mask) for k in
                                ("start_logits1", "end_logits1", "start_logits2", "end_logits2")),
            "match_gap": gap(got["match_scores"], want["match_scores"], mask),
            "span_gap": compare.span_gap(want["start_logits"], want["end_logits"], mask,
                                         got["start_index"], got["end_index"]),
            "pickle_rows_wrong": float(wrong)}
