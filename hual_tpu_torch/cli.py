"""Command-line entry point mirroring the reference surface (counterpart of
``hual_tpu/cli.py``; reference main.py:14-47).

    python -m hual_tpu_torch.cli --config configs/charades/SeqPAN.yaml \
        --mode {train,test,infer_trainset} [--suffix reI] [--seed 12345]

It runs on the CUDA card and raises without one.  ``--checkpoint`` is, in
``train`` mode, a full state file written by ``Trainer.save_state``
(``<model_dir>/state.pt``) and training continues at its epoch; in the
other modes, a best checkpoint (``best.npz``; ``<model_dir>/best.npz`` when
omitted).  The reference's ``--gpu_idx`` is accepted and ignored;
``--debug`` limits training to 1 epoch; ``--deterministic`` turns on
deterministic mode (``runtime/debug.enable_deterministic``), under which a
run resumed from ``--checkpoint`` replays the uninterrupted one bit for bit.

Data parallel on N cards, as ``hual_tpu`` runs on N chips:

    torchrun --nproc_per_node=N -m hual_tpu_torch.cli --config ... --mode train

Under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` in the
environment) every rank joins the process group (NCCL on
``cuda:LOCAL_RANK``; gloo when the caller asks for the CPU), builds the
``(data, model)`` mesh and gives it to its Trainer (``parallel/``); rank 0
builds the kernels and the dataset cache before the others read them, and
alone writes the logs and checkpoints.  The group is destroyed on exit.
Without those variables nothing of this happens.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hual_tpu_torch.config import Config, resolve_device
from hual_tpu_torch.data.datasets import gen_or_load_dataset
from hual_tpu_torch.data.features import FeatureStore
from hual_tpu_torch.ops.kernels import build
from hual_tpu_torch.parallel import Mesh, make_mesh
from hual_tpu_torch.runtime.debug import enable_deterministic
from hual_tpu_torch.runtime.logger import get_logger
from hual_tpu_torch.runtime.trainer import Trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="config file path")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="train: a state.pt to resume; test, "
                             "infer_trainset: a best.npz to restore")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "test", "infer_trainset"])
    parser.add_argument("--debug", action="store_true", help="1-epoch smoke run")
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--seed", default=12345, type=int)
    parser.add_argument("--gpu_idx", type=str, default="0",
                        help="accepted for reference-CLI compatibility; unused")
    parser.add_argument("--ckpt_dir", type=str, default="")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic algorithms, so a resumed run "
                             "replays the uninterrupted one bit for bit")
    return parser.parse_args(argv)


_LAUNCH_VARIABLES = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def init_distributed(device: str = "cuda",
                     init_method: Optional[str] = None) -> Optional[Mesh]:
    """Under ``torchrun`` (its launch variables in the environment): join
    the process group, NCCL on ``cuda:LOCAL_RANK`` or gloo when ``device``
    is the CPU, and return its mesh; None otherwise.  ``init_method`` is
    torchrun's ``env://`` unless given.  On the card, rank 0 builds the
    kernels before the other ranks load them."""
    if not all(k in os.environ for k in _LAUNCH_VARIABLES):
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
    mesh = make_mesh(device=dev)
    if dev.type == "cuda":
        with mesh.writer_first():
            build.build(build.names())
    return mesh


def writer_first(mesh: Optional[Mesh]):
    """``mesh.writer_first()``, or nothing to wait for without a mesh."""
    return contextlib.nullcontext() if mesh is None else mesh.writer_first()


def build_trainer(config: Config, features: FeatureStore | None = None,
                  device_features=None, base_dataset: dict | None = None,
                  device: str = "cuda", mesh: Optional[Mesh] = None) -> Trainer:
    """A Trainer for ``config`` on ``device``.

    ``features`` (a FeatureStore) and ``device_features`` (a Trainer's
    ``export_device_features()``) let a round loop reuse the round-invariant
    feature table, in host memory and on the card, instead of reading and
    uploading it every round; ``base_dataset`` (a previous round's dataset
    dict) takes the re-span fast path, since only the spans change between
    rounds.  Under ``mesh`` rank 0 writes the dataset cache before the
    other ranks read it, and only rank 0 logs to a file.
    """
    with writer_first(mesh):
        dataset = gen_or_load_dataset(config, base=base_dataset)
    config.model.num_chars = dataset["n_chars"]
    config.model.num_words = dataset["n_words"]
    if features is None:
        features = FeatureStore.from_dir(config.paths.feature_path,
                                         config.model.max_vlen)
    logger = get_logger(f"./logs/{config.task}", config.suffix or "run",
                        to_file=mesh is None or mesh.is_writer)
    logger.info(json.dumps(config.to_dict(), indent=4))
    return Trainer(config, dataset, features, logger=logger,
                   device_features=device_features, device=device, mesh=mesh)


def trainer_kwargs(mesh: Optional[Mesh], device: Optional[str]) -> dict:
    """``build_trainer``'s device and mesh for an entry point: the mesh's
    device under a mesh, else ``device`` when the caller named one."""
    if mesh is not None:
        return {"device": mesh.device, "mesh": mesh}
    return {} if device is None else {"device": device}


def main(argv=None, *, device: Optional[str] = None,
         init_method: Optional[str] = None) -> int:
    """The command line; ``device`` ("cpu" to run there, the card by
    default) and ``init_method`` (for the process group under a launch,
    ``env://`` by default) are for callers in Python."""
    args = parse_args(argv)
    if args.deterministic:
        enable_deterministic()
    mesh = init_distributed(device or "cuda", init_method)
    try:
        return _run(args, trainer_kwargs(mesh, device))
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(args, kwargs: dict) -> int:
    np.random.seed(args.seed)
    config = Config.load(args.config)
    config.suffix = args.suffix or config.suffix
    config.train.seed = args.seed
    if args.ckpt_dir:
        config.paths.ckpt_dir = args.ckpt_dir
    if args.debug:
        config.train.epochs = 1

    trainer = build_trainer(config, **kwargs)
    mode = args.mode.lower()
    if mode == "train":
        trainer.init_state(args.seed)
        if args.checkpoint:
            # the reference declared this flag and never read it (main.py:17)
            trainer.load_state(args.checkpoint)
        trainer.train()
    elif mode == "test":
        trainer.restore(args.checkpoint)
        m = trainer.test()
        trainer.logger.info(
            "TEST:\t{r1i3:.2f}\t{r1i5:.2f}\t{r1i7:.2f}\t{miou:.2f}\t".format(**m))
    elif mode == "infer_trainset":
        trainer.restore(args.checkpoint)
        trainer.infer_trainset(seed=args.seed)
    trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
