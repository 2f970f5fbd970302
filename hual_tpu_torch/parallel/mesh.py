"""The data-parallel layout on ``torch.distributed`` (counterpart of
``hual_tpu/parallel/mesh.py``).

``hual_tpu`` runs one SPMD program over a ``(data, model)`` device mesh and
lets XLA insert the collectives.  Here every rank is one process on one
device, the ranks are laid out as that grid (``rank = data_index * model +
model_index``), and the collectives are explicit:

* A batch is split over the ``data`` axis: data index ``d`` holds rows
  ``[d*b, (d+1)*b)`` of a global batch of ``B = D*b`` rows
  (:meth:`Mesh.batch_rows`, ``batch_sharding`` and, per batch of a sweep,
  ``scan_batch_sharding``).  A batch that ``D`` does not divide is whole on
  every rank, as ``hual_tpu``'s ``_put_sel`` replicates it.
* The parameters and optimizer state are replicated: every rank holds the
  same weights and takes the same update from the gradients summed over
  its data group.
* The feature table is row-sharded over every rank, its row count padded
  to a multiple of the world with :func:`pad_rows` (``feature_sharding``);
  the GloVe matrix over the ``model`` group when that axis is larger than
  one (``vocab_sharding``).  Each rank holds a :class:`RowShard`.  Any rows
  of it are read by an owned-rows gather: every rank of the shard's group
  asks for the same rows, takes those it holds and writes zeros for the
  rest, and one ``all_reduce`` over the group hands every rank all of
  them.
* A batch's outputs come back to every rank in batch order by the same
  kind of ``all_reduce`` (:func:`gather_rows`, :func:`gather_outputs`).

These ``all_reduce`` calls are exact: at every element at most one rank
contributes anything but zero, and the buffer's bytes are summed as int32
words (bytes when the size is not a multiple of 4), so any dtype arrives
bit for bit, ``-0.0`` and NaN included.  They are the only collective the
layout uses besides the float sums of gradients and losses, so it runs on
any backend: NCCL on the card, gloo on the CPU (or with CUDA tensors).

Without a process group :func:`make_mesh` returns the local one-device
mesh; nothing then calls a collective, and a ``Trainer`` given it takes its
unsharded path.  A mesh built on a group takes the sharded path at every
world size, one included.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Rows:
    """This rank's rows ``[lo, lo + n)`` of a global batch of ``total``
    rows, split over ``group``; with ``group`` None the rows are the whole
    batch, here and on every other rank, and nothing is reduced."""

    lo: int
    n: int
    total: int
    group: Optional[Any] = None


def whole(n: int) -> Rows:
    """The rows of a batch that is whole on this rank."""
    return Rows(0, n, n)


class Mesh:
    """``data`` x ``model`` ranks, this process's place among them and the
    process groups: the world (the feature table's), this rank's data
    group (the ranks that split its batches) and its model group (the
    ranks that hold its batch rows, over which the GloVe matrix is split).
    Without groups (``world`` None) it is the local one-device mesh."""

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0,
                 device: str | torch.device = "cpu", world=None,
                 data_group=None, model_group=None):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.size = data * model
        self.rank = rank
        self.device = torch.device(device)
        self.world, self.data_group, self.model_group = world, data_group, model_group

    @property
    def distributed(self) -> bool:
        """Built on a process group: the sharded path, at any world size."""
        return self.world is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[MODEL_AXIS]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[MODEL_AXIS]

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.world) if self.distributed else None

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files; the other ranks only read."""
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")

    def batch_rows(self, n: int) -> Rows:
        """This rank's rows of a global batch of ``n``: a data group's
        share, or the whole batch when the data axis does not divide it."""
        d = self.shape[DATA_AXIS]
        if not self.distributed or n % d:
            return whole(n)
        b = n // d
        return Rows(self.data_index * b, b, n, self.data_group)

    def shard_rows(self, table: np.ndarray, device=None):
        """``table`` row-sharded over every rank (``feature_sharding``): this
        rank's rows of the table padded to a multiple of the world, on
        ``device`` (the mesh's by default), as a :class:`RowShard`; the
        whole table as a tensor on the local mesh."""
        return _shard(table, self.rank, self.size, self.world,
                      device or self.device)

    def shard_vocab(self, vectors: np.ndarray, device=None):
        """The GloVe matrix row-sharded over the model group
        (``vocab_sharding``) when the model axis is larger than one, else
        whole on every rank."""
        m = self.shape[MODEL_AXIS]
        group = self.model_group if m > 1 else None
        return _shard(vectors, self.model_index, m, group, device or self.device)

    def barrier(self) -> None:
        if not self.distributed:
            return
        if self.backend == "nccl":
            dist.barrier(self.world, device_ids=[self.device.index])
        else:
            dist.barrier(self.world)

    @contextlib.contextmanager
    def writer_first(self) -> Iterator[None]:
        """Rank 0 runs the block, then the other ranks do: what rank 0
        writes there (a dataset cache, a built kernel) the others read."""
        if not self.is_writer:
            self.barrier()
        yield
        if self.is_writer:
            self.barrier()


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """The ``(data, model)`` mesh of ``hual_tpu``'s ``make_mesh``: the
    ranks of the initialized process group laid out as
    ``grid.reshape(n // model_parallel, model_parallel)``, with one data
    group per column and one model group per row (every rank calls
    ``new_group`` for each, in the same order).  Without a process group it
    is the local one-device mesh.  ``n_devices`` must be the world size (or
    1 without a group); ``device`` is this rank's (by default the current
    CUDA device under NCCL, else the CPU).
    """
    if not dist.is_initialized():
        n = 1 if n_devices is None else n_devices
        if n != 1:
            raise ValueError(f"{n} devices asked for without a process group")
        if n % model_parallel:
            raise ValueError(f"{n} devices not divisible by "
                             f"model_parallel={model_parallel}")
        return Mesh(device=device or "cpu")
    world_size, rank = dist.get_world_size(), dist.get_rank()
    n = world_size if n_devices is None else n_devices
    if n != world_size:
        raise ValueError(f"{n} devices asked for in a world of {world_size}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    grid = np.arange(n).reshape(n // model_parallel, model_parallel)
    data_groups = [_group(grid[:, m], world_size) for m in range(grid.shape[1])]
    model_groups = [_group(grid[d, :], world_size) for d in range(grid.shape[0])]
    d, m = divmod(rank, model_parallel)
    return Mesh(grid.shape[0], model_parallel, rank, device, dist.group.WORLD,
                data_groups[m], model_groups[d])


def _group(ranks: np.ndarray, world_size: int):
    if len(ranks) == world_size:
        return dist.group.WORLD
    return dist.new_group([int(r) for r in ranks])


def pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad axis 0 to a multiple of ``multiple`` (sharding
    divisibility).  Padding rows are never indexed: feature rows and word
    ids point below the original row count."""
    pad = (-arr.shape[0]) % multiple
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)], axis=0)


def _shard(table: np.ndarray, index: int, parts: int, group, device):
    if group is None:
        return torch.from_numpy(np.ascontiguousarray(table)).to(device)
    per = -(-table.shape[0] // parts)
    lo = index * per
    # this rank's slice, padded alone: the whole table is never copied
    local = pad_rows(table[lo:lo + per], per) if lo < table.shape[0] else \
        np.zeros((per,) + table.shape[1:], table.dtype)
    local = torch.from_numpy(np.ascontiguousarray(local)).to(device)
    return RowShard(local, lo, per * parts, group)


class RowShard:
    """Rows ``[lo, lo + local.shape[0])`` of a ``(total, ...)`` table whose
    other rows live on the other ranks of ``group``.  ``index_select(0,
    index)`` and ``shard[index]`` read any rows of the whole table by the
    owned-rows gather: a collective, so every rank of ``group`` asks for
    the same rows at the same point."""

    def __init__(self, local: torch.Tensor, lo: int, total: int, group):
        self.local, self.lo, self.total, self.group = local, lo, total, group

    @property
    def shape(self) -> tuple:
        return (self.total, *self.local.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        if dim != 0:
            raise ValueError(f"RowShard: rows are selected on dim 0, not {dim}")
        return owned_rows(self.local, index, self.lo, self.group)

    def __getitem__(self, index: torch.Tensor) -> torch.Tensor:
        rows = self.index_select(0, index.reshape(-1))
        return rows.reshape(*index.shape, *self.local.shape[1:])


def owned_rows(local: torch.Tensor, index: torch.Tensor, lo: int,
               group) -> torch.Tensor:
    """The rows ``index`` of the table that ``local`` (its rows ``[lo, lo +
    len(local))``) is one rank's part of: the rows this rank holds, zeros
    for the others, summed over ``group`` bit for bit."""
    n = local.shape[0]
    rel = index.long() - lo
    mine = (rel >= 0) & (rel < n)
    rows = local.index_select(0, rel.clamp(0, n - 1))
    rows = rows.masked_fill(~mine.view(-1, *[1] * (local.dim() - 1)), 0)
    return _sum_disjoint(rows, group)


def _sum_disjoint(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` where at most one rank holds a nonzero at
    every element: the bytes summed as int32 words (or bytes), in place."""
    x = x.contiguous()
    raw = x.view(-1).view(torch.uint8)
    dist.all_reduce(raw.view(torch.int32) if raw.numel() % 4 == 0 else raw,
                    group=group)
    return x


def _placed(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    out = x.new_zeros((rows.total, *x.shape[1:]))
    out[rows.lo:rows.lo + rows.n] = x
    return out


class _GatherRows(torch.autograd.Function):
    """This rank's rows in place in the global batch; the backward sums the
    gradient over the group and keeps this rank's rows.  Without a group it
    is the identity, with the same autograd node, so a sharded step at one
    rank sums its gradients in the order of the unsharded one."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        out = _placed(x, rows)
        return out if rows.group is None else _sum_disjoint(out, rows.group)

    @staticmethod
    def backward(ctx, grad):
        rows = ctx.rows
        if rows.group is not None:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=rows.group)
        return grad[rows.lo:rows.lo + rows.n], None


def gather_rows(x: torch.Tensor, rows: Optional[Rows]) -> torch.Tensor:
    """The global batch's rows of ``x`` (this rank's ``rows`` of it) on
    every rank, in batch order; differentiable."""
    return _GatherRows.apply(x, rows or whole(x.shape[0]))


def gather_outputs(outputs: Mapping[str, torch.Tensor],
                   rows: Optional[Rows]) -> dict:
    """Every output of a batch (this rank's rows of each) on every rank in
    batch order, through one ``all_reduce`` of their bytes."""
    if rows is None or rows.group is None:
        return dict(outputs)
    full = {k: _placed(v.detach(), rows) for k, v in outputs.items()}
    raw = _sum_disjoint(torch.cat([v.reshape(-1).view(torch.uint8)
                                   for v in full.values()]), rows.group)
    out, at = {}, 0
    for k, v in full.items():
        nbytes = v.numel() * v.element_size()
        out[k] = raw[at:at + nbytes].view(v.dtype).view(v.shape)
        at += nbytes
    return out


def sum_over(x: torch.Tensor, rows: Optional[Rows]) -> torch.Tensor:
    """``x`` summed over the rows' group (the per-rank shares of a loss, a
    count); ``x`` itself without one.  No gradient."""
    if rows is None or rows.group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=rows.group)
    return x


def sum_grads(grads: Sequence[torch.Tensor], rows: Optional[Rows]
              ) -> Sequence[torch.Tensor]:
    """The gradients summed over the data group, in one flat
    ``all_reduce``; unchanged for a batch that is whole on every rank."""
    if rows is None or rows.group is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=rows.group)
    return [part.view(g.shape) for part, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


class RowDraws:
    """A generator whose draws are this rank's rows of the global batch's:
    each ``torch.rand`` takes the global shape from ``generator`` on every
    rank and keeps the rows ``rows`` names, so a sharded pass draws the
    masks of the unsharded one.  A draw over ``k`` stacked copies of the
    batch (the folded MC passes' ``[clean, mc1, mc2]``) keeps the rows of
    each copy."""

    def __init__(self, generator: torch.Generator, rows: Rows):
        self.generator, self.rows = generator, rows

    def rand(self, shape: Sequence[int], device, dtype=torch.float32) -> torch.Tensor:
        r = self.rows
        n, rest = shape[0], tuple(shape[1:])
        if n % r.n:
            raise ValueError(f"RowDraws: {n} rows are not copies of {r.n}")
        k = n // r.n
        full = torch.rand((k * r.total, *rest), generator=self.generator,
                          device=device, dtype=dtype)
        return full.view(k, r.total, *rest)[:, r.lo:r.lo + r.n].reshape(n, *rest)


def row_draws(generator: Optional[torch.Generator], rows: Optional[Rows]):
    """``generator`` drawing this rank's rows of the global batch; itself
    when there is none or the batch is whole here."""
    if generator is None or rows is None or rows.n == rows.total:
        return generator
    return RowDraws(generator, rows)


def uniform(shape: Sequence[int], generator, device,
            dtype=torch.float32) -> torch.Tensor:
    """``torch.rand(shape)`` from a generator or a :class:`RowDraws`."""
    if isinstance(generator, RowDraws):
        return generator.rand(shape, device, dtype)
    return torch.rand(tuple(shape), generator=generator, device=device, dtype=dtype)
