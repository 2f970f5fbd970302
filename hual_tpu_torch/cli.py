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
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from hual_tpu_torch.config import Config
from hual_tpu_torch.data.datasets import gen_or_load_dataset
from hual_tpu_torch.data.features import FeatureStore
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


def build_trainer(config: Config, features: FeatureStore | None = None,
                  device_features=None, base_dataset: dict | None = None,
                  device: str = "cuda") -> Trainer:
    """A Trainer for ``config`` on ``device``.

    ``features`` (a FeatureStore) and ``device_features`` (a Trainer's
    ``export_device_features()``) let a round loop reuse the round-invariant
    feature table, in host memory and on the card, instead of reading and
    uploading it every round; ``base_dataset`` (a previous round's dataset
    dict) takes the re-span fast path, since only the spans change between
    rounds.
    """
    dataset = gen_or_load_dataset(config, base=base_dataset)
    config.model.num_chars = dataset["n_chars"]
    config.model.num_words = dataset["n_words"]
    if features is None:
        features = FeatureStore.from_dir(config.paths.feature_path,
                                         config.model.max_vlen)
    logger = get_logger(f"./logs/{config.task}", config.suffix or "run")
    logger.info(json.dumps(config.to_dict(), indent=4))
    return Trainer(config, dataset, features, logger=logger,
                   device_features=device_features, device=device)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.deterministic:
        enable_deterministic()
    np.random.seed(args.seed)
    config = Config.load(args.config)
    config.suffix = args.suffix or config.suffix
    config.train.seed = args.seed
    if args.ckpt_dir:
        config.paths.ckpt_dir = args.ckpt_dir
    if args.debug:
        config.train.epochs = 1

    trainer = build_trainer(config)
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
