"""What the entries (``entries/<entry>.py``) share: the run's inputs and
weights from the seed, and the port's ``Trainer`` on them.

``mode`` is ``program`` in every run of the benchmark.  The calibration of
the limits (``calibrate.py``) also runs ``control`` (the reference at TF32
in the port's place) and the faults an entry knows; those modes build no
``Trainer`` and their window does no work.
"""

from __future__ import annotations

from benchmark import data, port


class Base:
    def __init__(self, ctx, mode: str = "program"):
        self.ctx, self.mode = ctx, mode
        spec, dev = ctx.spec, ctx.device
        self.inputs = data.make_inputs(spec, ctx.seed, dev)
        self.flat, self.weights = data.make_weights(spec, ctx.seed, dev)
        self.trainer = None
        if mode == "program":
            self.trainer = port.trainer(spec, ctx.seed, self.inputs, self.flat, ctx.workdir, dev)

    @property
    def model_sizes(self) -> dict:
        m = self.ctx.spec["config"]["model"]
        return {"T": m["max_vlen"], "W": self.inputs.dataset["max_wlen"],
                "C": max(self.inputs.dataset["max_clen"], 4), "D": m["dim"],
                "attn_layer": m["attn_layer"]}

    def release(self) -> None:
        if self.trainer is not None:
            self.trainer.close()
            self.trainer = None
