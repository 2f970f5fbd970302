"""Whole training epochs through ``Trainer.train()``.

Set-up runs epoch 0, which captures the train step's and the test sweep's
CUDA graphs, then ``warm_epochs`` more (the traffic file's): the first
half-minute of epochs runs about 12% slower than the rest, for a varying
number of epochs, so the window starts after it.  Each window call runs the
next epoch (its graphed B=16 steps, the ragged last batch eager, the fused
test sweep, the best checkpoint and the metrics line, under the run's work
directory), stopped after one epoch through ``train``'s epoch callback.

The comparison follows the contract for training: epoch 0 is the window's
own call and feed, and the first three of its steps are observed from
outside the port (a profile hook on the Python calls): each step's loss,
the optimizer's state after one step (its first moment is ``(1 - b1)``
times the clipped first gradient) and the parameters after three.  After
the window the reference runs the same three steps (the same rows, dropout
streams and learning rate) and the numbers are the worst gaps.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import compare
from benchmark.cellbase import Base
from benchmark.reference import seqpan as ref

B1 = 0.9


class _Stop(Exception):
    """Raised from the epoch callback: the epoch is done."""


def _stop(epoch, metrics):
    raise _Stop


class _FirstSteps:
    """Watches the first epoch from outside: counts train steps (graph
    replays on the card; returns of the eager ``train_step`` elsewhere, or
    while not capturing), snapshots the optimizer's first moments after step
    1 and the parameters after step 3, and keeps the epoch's per-step losses
    from ``train_epoch``'s return."""

    def __init__(self, opt, model_params):
        self.opt, self.params = opt, model_params
        self.steps = 0
        self.mu1 = self.after3 = self.losses = None

    def _done(self) -> None:
        if self.steps == 1 and self.mu1 is None:
            self.mu1 = {k: m.detach().clone() for k, m in zip(self.opt.keys, self.opt.mu)}
        if self.steps == 3 and self.after3 is None:
            self.after3 = {k: p.detach().clone() for k, p in zip(self.opt.keys, self.params)}

    def __call__(self, frame, event, arg):
        name = frame.f_code.co_name
        if event == "call" and name == "replay" and isinstance(frame.f_locals.get("self"),
                                                                torch.cuda.CUDAGraph):
            self._done()             # the state before this replayed step
            self.steps += 1
        elif event == "return" and name == "train_step" and "opt" in frame.f_locals:
            if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
                self.steps += 1
                self._done()
        elif event == "return" and name == "train_epoch" and self.losses is None \
                and isinstance(arg, tuple):
            self.losses = arg[0].detach().clone()


class _ReplayTrace:
    """Stops the tracer after ``n`` graph replays (the traced slice of an epoch)."""

    def __init__(self, tracer, n: int):
        self.tracer, self.n, self.seen = tracer, n, 0

    def __call__(self, frame, event, arg):
        if event == "call" and frame.f_code.co_name == "replay" and isinstance(
                frame.f_locals.get("self"), torch.cuda.CUDAGraph):
            self.seen += 1
            if self.seen > self.n:
                sys.setprofile(None)
                self.tracer.stop()


class Entry(Base):
    def __init__(self, ctx, mode: str = "program"):
        super().__init__(ctx, mode)
        self.n = len(self.inputs.splits["train"])
        self.epochs: list[dict] = []
        if self.trainer is None:
            return
        opt = self.trainer.state.opt
        watch = _FirstSteps(opt, opt.params)
        sys.setprofile(watch)
        try:
            self._epoch()
        finally:
            sys.setprofile(None)
        if watch.mu1 is None or watch.after3 is None or watch.losses is None:
            raise RuntimeError("the first three train steps were not observed")
        self.watch = watch
        for _ in range(int(ctx.traffic.get("warm_epochs", 0))):
            self._epoch()

    def _epoch(self) -> None:
        try:
            self.trainer.train(epoch_callback=_stop)
        except _Stop:
            pass

    def call(self) -> int:
        if self.trainer is None:
            return 0
        tracer = self.ctx.tracer
        if tracer is not None and tracer.running:
            sys.setprofile(_ReplayTrace(tracer, int(self.ctx.traffic["trace_steps"])))
        try:
            self._epoch()
        finally:
            sys.setprofile(None)
        self.epochs.append(dict(self.trainer.last_epoch_wall))
        return self.n

    def facts(self) -> dict:
        return {"epochs": self.epochs, "samples": self.n,
                "batch_size": self.ctx.spec["config"]["train"]["batch_size"], **self.model_sizes}

    def check(self) -> dict:
        """loss_gap, grad_gap and change_gap of the first three steps."""
        spec, dev, seed = self.ctx.spec, self.ctx.device, self.ctx.seed
        tcfg = spec["config"]["train"]
        B = tcfg.get("batch_size", 16)
        split = self.inputs.splits["train"]
        order = ref.epoch_order(len(split), seed, 0)
        cols = split.data(self.inputs.table)

        def steps(prec: str, half: bool = False):
            net = compare.model(spec, self.weights, dev)
            leaves = {k: p for k, p, _, _ in ref.jax_leaves(net)}
            keys = list(leaves)
            opt = ref.BertAdamW([leaves[k] for k in keys], [ref.decayed(k) for k in keys],
                                clip=tcfg.get("clip_norm", 1.0), wd=tcfg.get("weight_decay", 0.01))
            start = {k: p.detach().clone() for k, p in leaves.items()}
            losses, g1 = [], None
            with compare.precision(prec):
                for k in range(3):
                    sel = order[k * B:(k + 1) * B]
                    batch = ref.gather(cols, torch.from_numpy(sel[:B // 2] if half else sel)
                                       .to(dev), with_labels=True)
                    out = net(batch, self.inputs.word_vectors, batch["match_labels"],
                              rate=tcfg.get("droprate", 0.2),
                              gen=ref.generator(dev, seed + 17, k))
                    loss = ref.loss(out, batch)
                    grads = torch.autograd.grad(loss, [leaves[n] for n in keys],
                                                allow_unused=True, materialize_grads=True)
                    opt.step(grads, tcfg.get("lr", 1e-4))
                    losses.append(float(loss.detach()))
                    if k == 0:
                        g1 = {n: float(m.norm()) / (1 - B1) for n, m in zip(keys, opt.mu)}
            change = {k: float((leaves[k].detach() - start[k]).norm()) for k in keys}
            return losses, g1, change

        ref_losses, ref_g1, ref_change = steps("f32")
        if self.mode == "program":
            w = self.watch
            losses = w.losses[:3].cpu().tolist()
            g1 = {k: float(m.norm()) / (1 - B1) for k, m in w.mu1.items()}
            start = {k: p for k, p, _, _ in ref.jax_leaves(compare.model(spec, self.weights, dev))}
            change = {k: float((p - start[k].detach()).norm()) for k, p in w.after3.items()}
        elif self.mode == "control":
            losses, g1, change = steps("tf32")
        elif self.mode == "fault_half_batch":
            losses, g1, change = steps("f32", half=True)
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        median_g = float(np.median(list(ref_g1.values())))
        counted = {k for k, v in ref_g1.items() if v >= 1e-3 * median_g}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                "grad_gap": compare.leaf_gap(g1, ref_g1),
                "change_gap": compare.leaf_gap(change, ref_change, counted)}

