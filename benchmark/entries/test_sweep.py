"""The test sweep: ``Trainer.test()`` over the test split, one call after
another.

Set-up runs one sweep, which captures its CUDA graph and packs K2's weights.
Every window call returns R@1 at IoU 0.3 / 0.5 / 0.7 and mIoU; after the
window the reference sweeps the same split on the same weights (clean pass,
span decode, interval IoU) and each call's answer is held against it.
"""

from __future__ import annotations

from benchmark import compare
from benchmark.cellbase import Base
from benchmark.reference import seqpan as ref


class Entry(Base):
    def __init__(self, ctx, mode: str = "program"):
        super().__init__(ctx, mode)
        self.n = len(self.inputs.splits["test"])
        self.batch_size = min(ctx.spec["config"]["train"]["eval_batch_size"], self.n)
        self.answers: list[dict] = []
        if self.trainer is not None:
            self.trainer.test()

    def call(self) -> int:
        if self.trainer is None:
            return 0
        self.answers.append(self.trainer.test())
        return self.n

    def facts(self) -> dict:
        return {"queries": self.n, "batch_size": self.batch_size,
                **self.model_sizes}

    def _reference_metrics(self, prec: str) -> dict:
        split = self.inputs.splits["test"]
        net = compare.model(self.ctx.spec, self.weights, self.ctx.device)
        with compare.precision(prec):
            out = compare.sweep(net, split, self.inputs.table, self.inputs.word_vectors,
                                self.batch_size)
        return ref.rank1(compare.ious(split, out["start_index"], out["end_index"]))

    def check(self) -> dict:
        """miou_gap and r1_gap (percentage points): the widest distance of a
        call's mIoU, and of its R@1 at any threshold, from the reference's."""
        want = self._reference_metrics("f32")
        answers = (self.answers if self.mode == "program"
                   else [self._reference_metrics("tf32")])
        return {"miou_gap": max(abs(a["miou"] - want["miou"]) for a in answers),
                "r1_gap": max(abs(a[k] - want[k]) for a in answers
                              for k in ("r1i3", "r1i5", "r1i7"))}

