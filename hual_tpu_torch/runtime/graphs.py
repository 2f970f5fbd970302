"""The JAX package's scanned programs as CUDA graphs (counterpart of the
``make_*_indexed`` family in ``hual_tpu/runtime/steps.py``).

``hual_tpu`` runs a train epoch as one ``lax.scan`` dispatch and each sweep
as one scanned dispatch, so the host is out of the loop.  Here each step of
such a loop is captured once as a CUDA graph, with K1 and, in the fused
sweeps, K2 inside it, and replayed once per batch: the host's work a step
falls from a few thousand kernel launches to a copy of the batch's indices,
a reseed, one graph launch and a copy of the outputs.

* A *program* is a step over static buffers.  It reads its batch's indices
  from a ``sel`` buffer (B,) and gathers the batch on the device from the
  resident split, as the JAX package's indexed steps do; its outputs are
  the tensors its capture allocated, rewritten by every replay.  Inside it
  nothing waits for the host or copies from host memory.
* :class:`StepGraph` warms a step up on a side stream (a real step),
  captures it on that stream with its generators registered, and replays
  it.  A capture that fails raises: nothing falls back to the eager loop.
* :class:`Graphs` holds one Trainer's programs, built at first use and kept
  across epochs and sweeps: one per (step, split, batch size, options).
  A program whose objects changed (a new optimizer from
  ``Trainer.init_state`` or ``load_params``) is captured anew: the old
  graph would update the dead moments.  ``close()`` frees every graph.

Random streams are ``runtime/steps.py``'s: one generator per stream (the
train step's, the sweep's two MC streams), reseeded before each replay with
``steps.stream_seed`` of the words ``make_generator`` hashes.  A replay
draws from the generator's seed at offset 0, as a fresh generator does, so
a replayed step gives the eager step's bits.  The learning rate is the
optimizer's device buffer ``opt.lr``, set once an epoch before the
replays.  The fused sweeps repack the weights into their buffer in place at
each sweep's start (``pack_weights(out=)``): a graph reads the address it
captured, so a new buffer would replay the weights of its capture.

K1's and K2's launch counters tick in their wrappers, which a replay does
not call: each graph takes back the launches its capture counted and adds
them on every replay, so the counters still count launches on the card.

Under data parallelism (``mesh``, a ``parallel.Mesh`` on a process group)
each program is ``runtime/steps.py``'s sharded step: it reads the table by
the owned-rows gather, sums the gradients over the data group, and gathers
its outputs, so the collectives are captured inside the graph and every
rank replays the same graphs in the same order.  That needs NCCL, whose
collectives are captured on the capture stream after the warm-up step has
run them once (their communicators made).  Gloo copies through the host
and cannot be captured: the Trainer runs the eager loops of
``runtime/steps.py`` when its mesh's backend is not NCCL
(``capturable``), never by catching a failed capture.

With ``capture=False`` the programs run eagerly, each call as it is: the CPU
tests hold them against ``runtime/steps.py`` and the JAX package.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from hual_tpu_torch.ops.fused_forward import PackedWeights, pack_weights
from hual_tpu_torch.ops.kernels import fused_forward as k2
from hual_tpu_torch.ops.kernels import span_decode as k1
from hual_tpu_torch.parallel import Mesh
from hual_tpu_torch.runtime import steps

# the kernels' launch counters: K1, K2's f64 and bf16 product paths
_COUNTERS = ((k1.span_decode, "launches"), (k2.fused_forward, "launches"),
             (k2.fused_forward, "launches_bf16"))


def capturable(mesh: Optional[Mesh]) -> bool:
    """Whether the loops under ``mesh`` can be captured: on one device, or
    over NCCL.  Gloo's collectives copy through the host."""
    return mesh is None or not mesh.distributed or mesh.backend == "nccl"


def _launch_counts() -> list[int]:
    return [getattr(fn, name) for fn, name in _COUNTERS]


def _add_launches(counts: Sequence[int]) -> None:
    for (fn, name), n in zip(_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)


class StepGraph:
    """``body()``, a step over static buffers that returns a dict of
    tensors, captured as a CUDA graph on ``device`` and replayed.

    The first call runs ``body`` on a side stream, a real step that also
    does what a capture must not (library loads, cuBLAS workspaces, lazy
    module loading), then captures it on that stream with ``generators``
    registered, and returns the warm-up's outputs.  Every later call
    replays the graph and returns the captured outputs, which the next
    replay overwrites.  ``capture_seconds`` (capture and instantiation) and
    ``pool_bytes`` (what the capture reserved) describe the capture.
    """

    def __init__(self, body: Callable[[], dict], device,
                 generators: Sequence[torch.Generator] = ()):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"StepGraph: a CUDA graph needs a CUDA device, "
                             f"got {device}")
        self.body, self.device = body, device
        self.generators = list(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[dict] = None
        self.launches = [0] * len(_COUNTERS)
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def __call__(self) -> dict:
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        _add_launches(self.launches)
        self.replays += 1
        return self.outputs

    def _warm_up_and_capture(self) -> dict:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = self.body()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = _launch_counts()
        try:
            with torch.cuda.graph(graph, stream=side):
                outputs = self.body()
        finally:
            # the capture launched nothing: take back what it counted
            captured = [b - a for a, b in zip(before, _launch_counts())]
            _add_launches([-n for n in captured])
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.outputs, self.launches = graph, outputs, captured
        return warm

    def reset(self) -> None:
        """Free the graph and its outputs."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = None


class _Program:
    """A step over its static ``sel`` buffer and generators, replayed from a
    :class:`StepGraph` or, without capture, run as it is."""

    def __init__(self, name: str, make_body, sel: torch.Tensor,
                 generators: Sequence[torch.Generator], capture: bool):
        self.name, self.sel, self.generators = name, sel, list(generators)
        body = make_body(sel, self.generators)
        self.run = (StepGraph(body, sel.device, self.generators) if capture
                    else body)

    def __call__(self, sel: torch.Tensor, streams: Sequence[tuple] = ()) -> dict:
        """One step on the indices ``sel``, generator ``k`` reseeded with
        ``stream_seed(*streams[k])``."""
        self.sel.copy_(sel)
        for g, words in zip(self.generators, streams):
            g.manual_seed(steps.stream_seed(*words))
        return self.run()

    def reset(self) -> None:
        if isinstance(self.run, StepGraph):
            self.run.reset()


class Graphs:
    """One Trainer's captured programs on ``device``; ``capture=False`` runs
    them eagerly (the CPU's way, for the tests)."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture
        self._programs: dict[tuple, tuple[tuple, _Program]] = {}
        self._packs: dict[int, tuple[object, PackedWeights]] = {}

    def close(self) -> None:
        """Free every graph and packed buffer; later calls capture anew."""
        for _, program in self._programs.values():
            program.reset()
        self._programs.clear()
        self._packs.clear()

    def stats(self) -> list[dict]:
        """Per captured program: capture seconds, pool bytes, replays and
        the K1/K2 launches of one replay."""
        out = []
        for _, program in self._programs.values():
            g = program.run
            if isinstance(g, StepGraph) and g.graph is not None:
                out.append({"program": program.name,
                            "capture_seconds": g.capture_seconds,
                            "pool_bytes": g.pool_bytes, "replays": g.replays,
                            "launches_per_replay": dict(zip(
                                ("span_decode", "fused_forward",
                                 "fused_forward_bf16"), g.launches))})
        return out

    def _program(self, name: str, data: dict, refs: tuple, options: tuple,
                 batch_size: int, dtype: torch.dtype, n_generators: int,
                 body_of) -> _Program:
        """The program ``name`` over the split ``data`` at ``batch_size``
        and ``options``, built at first use and again when one of ``refs``
        (the other objects it captured) is not the one it was built on;
        ``body_of(sel, generators)`` makes its step."""
        key = (name, id(data), batch_size, *options)
        refs = (data, *refs)
        entry = self._programs.get(key)
        if entry is not None and all(a is b for a, b in zip(entry[0], refs)):
            return entry[1]
        if entry is not None:
            entry[1].reset()
        sel = torch.empty(batch_size, dtype=dtype, device=self.device)
        gens = [torch.Generator(device=self.device) for _ in range(n_generators)]
        program = _Program(f"{name}_b{batch_size}", body_of, sel, gens,
                           self.capture)
        self._programs[key] = (refs, program)
        return program

    def _pack(self, model) -> PackedWeights:
        """``model``'s K2 weights, packed into this cache's buffer in place."""
        entry = self._packs.get(id(model))
        if entry is not None and entry[0] is model:
            return pack_weights(model, out=entry[1])
        packed = pack_weights(model)
        self._packs[id(model)] = (model, packed)
        return packed

    # -- training ---------------------------------------------------------------
    def train_epoch(self, model, opt, data: dict, order: torch.Tensor,
                    batch_size: int, word_vectors: torch.Tensor, lr: float,
                    seed: int, step0: int, *, drop_rate: float,
                    match_lambda: float = 1.0, mesh: Optional[Mesh] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``steps.train_epoch`` with the full batches replayed from one
        captured train step (``make_train_epoch_indexed``'s scan) and the
        ragged rest, if any, as one eager step (``hual_tpu``'s extra
        per-step call).  ``lr`` goes into ``opt.lr`` first; step ``k``
        draws from ``(seed, step0 + k)``.  Returns (losses (n_steps,), ious
        (n,)), on the device; under ``mesh`` the global batches'."""
        opt.set_lr(lr)
        n = order.numel()
        n_full = n // batch_size
        losses = torch.empty(-(-n // batch_size), dtype=torch.float32,
                             device=order.device)
        ious = torch.empty(n, dtype=torch.float32, device=order.device)
        if n_full:
            rows = steps.batch_rows(mesh, batch_size)

            def body_of(sel, generators):
                def body():
                    batch = steps.gather_batch(data, sel, with_labels=True,
                                               rows=rows)
                    m = steps.train_step(model, opt, batch, word_vectors, opt.lr,
                                         generators[0], drop_rate=drop_rate,
                                         match_lambda=match_lambda, rows=rows)
                    return {"loss": m["loss"], "ious": m["ious"]}
                return body

            program = self._program("train_step", data,
                                    (model, opt, word_vectors),
                                    (drop_rate, match_lambda, rows), batch_size,
                                    order.dtype, 1, body_of)
            sels = order[:n_full * batch_size].view(n_full, batch_size)
            for i in range(n_full):
                out = program(sels[i], [(seed, step0 + i)])
                torch._foreach_copy_(
                    [losses[i], ious[i * batch_size:(i + 1) * batch_size]],
                    [out["loss"], out["ious"]])
        if n > n_full * batch_size:
            # not ``rows``: the program's step reads that name at each call
            rest = steps.batch_rows(mesh, n - n_full * batch_size)
            batch = steps.gather_batch(data, order[n_full * batch_size:],
                                       with_labels=True, rows=rest)
            metrics = steps.train_step(
                model, opt, batch, word_vectors, opt.lr,
                steps.make_generator(word_vectors.device, seed, step0 + n_full),
                drop_rate=drop_rate, match_lambda=match_lambda, rows=rest)
            losses[n_full].copy_(metrics["loss"])
            ious[n_full * batch_size:].copy_(metrics["ious"])
        return losses, ious

    # -- sweeps -----------------------------------------------------------------
    @staticmethod
    def _sweep(program: _Program, sels: torch.Tensor, n_valid, seed: int = 0
               ) -> dict:
        """One replay per row of ``sels``, batch ``i``'s generator ``k``
        seeded from ``(seed, i, k)``; the valid rows of each output,
        concatenated on the device."""
        stacked: Optional[dict] = None
        n_gen = len(program.generators)
        for i in range(sels.shape[0]):
            out = program(sels[i], [(seed, i, k) for k in range(n_gen)])
            if stacked is None:
                stacked = {k: torch.empty((sels.shape[0], *v.shape),
                                          dtype=v.dtype, device=v.device)
                           for k, v in out.items()}
            torch._foreach_copy_([stacked[k][i] for k in out], list(out.values()))
        if n_valid is None:
            n_valid = [sels.shape[1]] * sels.shape[0]
        return {k: torch.cat([v[i, :n] for i, n in enumerate(n_valid)])
                for k, v in stacked.items()}

    @torch.inference_mode()
    def eval_sweep(self, model, data: dict, sels: torch.Tensor, n_valid,
                   word_vectors: torch.Tensor, rows=None) -> torch.Tensor:
        """``steps.eval_sweep`` over the rows of ``sels`` (n_batches, B) of
        the resident split ``data``, ``n_valid`` valid rows each (all if
        None): ``make_eval_sweep_indexed``.  Returns the valid rows' IoUs.
        ``rows``: each batch runs this rank's rows of its row of ``sels``."""
        def body_of(sel, _):
            return lambda: {"ious": steps.eval_step(
                model, steps.gather_batch(data, sel, rows=rows), word_vectors,
                rows)["ious"]}

        program = self._program("eval_sweep", data, (model, word_vectors),
                                (rows,), sels.shape[1], sels.dtype, 0, body_of)
        return self._sweep(program, sels, n_valid)["ious"]

    @torch.inference_mode()
    def fused_eval_sweep(self, model, data: dict, sels: torch.Tensor, n_valid,
                         word_vectors: torch.Tensor,
                         mxu_bf16: bool = False, rows=None) -> torch.Tensor:
        """:meth:`eval_sweep` through K2 and K1
        (``make_fused_eval_sweep_indexed``)."""
        packed = self._pack(model)

        def body_of(sel, _):
            return lambda: {"ious": steps.fused_eval_step(
                model, packed, steps.gather_batch(data, sel, rows=rows),
                word_vectors, mxu_bf16, rows)}

        program = self._program("fused_eval_sweep", data,
                                (model, word_vectors, packed), (mxu_bf16, rows),
                                sels.shape[1], sels.dtype, 0, body_of)
        return self._sweep(program, sels, n_valid)["ious"]

    @torch.inference_mode()
    def infer_sweep(self, model, data: dict, sels: torch.Tensor, n_valid,
                    word_vectors: torch.Tensor, mc_droprate: float = 0.0,
                    seed: int = 0, mc_model=None, fold_mc: bool = False,
                    rows=None) -> dict:
        """``steps.infer_sweep`` over :meth:`eval_sweep`'s rows
        (``make_infer_sweep_indexed``): the clean pass and the MC passes,
        sequential, folded (``fold_mc``) or through ``mc_model``; batch
        ``i``'s streams are ``(seed, i, 0)`` and ``(seed, i, 1)``."""
        n_gen = 2 if steps._stochastic(model, mc_droprate) else 0

        def body_of(sel, generators):
            return lambda: steps.infer_step(
                model, steps.gather_batch(data, sel, rows=rows), word_vectors,
                mc_droprate, generators or None, mc_model, fold_mc, rows)

        program = self._program("infer_sweep", data,
                                (model, word_vectors, mc_model),
                                (mc_droprate, fold_mc, rows), sels.shape[1],
                                sels.dtype, n_gen, body_of)
        return self._sweep(program, sels, n_valid, seed)

    @torch.inference_mode()
    def fused_infer_sweep(self, model, data: dict, sels: torch.Tensor, n_valid,
                          word_vectors: torch.Tensor, mc_droprate: float = 0.0,
                          seed: int = 0, mc_model=None, mxu_bf16: bool = False,
                          rows=None) -> dict:
        """:meth:`infer_sweep` with the clean pass through K2 and K1
        (``make_fused_infer_sweep_indexed``); the same outputs and streams."""
        packed = self._pack(model)
        n_gen = 2 if steps._stochastic(model, mc_droprate) else 0

        def body_of(sel, generators):
            return lambda: steps.fused_infer_step(
                model, packed, steps.gather_batch(data, sel, rows=rows),
                word_vectors, mc_droprate, generators or None, mc_model,
                mxu_bf16, rows)

        program = self._program("fused_infer_sweep", data,
                                (model, word_vectors, packed, mc_model),
                                (mc_droprate, mxu_bf16, rows), sels.shape[1],
                                sels.dtype, n_gen, body_of)
        return self._sweep(program, sels, n_valid, seed)
