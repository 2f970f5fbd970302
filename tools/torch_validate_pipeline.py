#!/usr/bin/env python
"""The pipeline end to end at (scaled) reference shapes on the card, timed
per stage: synthetic Charades-shaped data -> train N epochs -> test ->
MC-dropout train-set inference -> one AL round.

The port's counterpart of tools/validate_pipeline.py.  The model is SeqPAN
at Charades width with ``span_decode: pallas`` (K1 in every train step and
sweep batch) and ``--sweep-backend`` (``fused`` by default: K2 in every
test and inference batch).  Reports each stage's host seconds (each ends
in a host fetch) and an extrapolation to the full Charades 3-round loop.

Writes results/torch_validate_pipeline.json (``--out``).

    python tools/torch_validate_pipeline.py --n-train 2000 --n-test 500 --epochs 3
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_synthetic_data import make_dataset  # noqa: E402
from torch_tool_common import (add_common_flags, device_info,  # noqa: E402
                               device_of, reset_launches, write_result)

from hual_tpu_torch.active.engine import update_labels  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402

MODEL = dict(dim=128, num_heads=8, char_dim=50, attn_layer=2)


def validate(root: str, a, device) -> dict:
    times = {}
    t0 = time.time()
    make_dataset(root, task="charades", n_train=a.n_train, n_test=a.n_test,
                 vdim=a.vdim, max_raw_len=128, seed=7)
    times["datagen_s"] = time.time() - t0

    cfg = Config.from_dict({
        "task": "charades", "suffix": "re0",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "train": {"epochs": a.epochs, "batch_size": a.batch_size, "lr": 1e-4,
                  "droprate": 0.2, "clip_norm": 1.0, "sweep_backend": a.sweep_backend},
        "model": {"max_vlen": a.max_vlen, "vdim": a.vdim, "span_decode": "pallas",
                  **MODEL}})

    t0 = time.time()
    dataset = gen_or_load_dataset(cfg)
    times["dataset_gen_s"] = time.time() - t0
    t0 = time.time()
    features = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    times["feature_load_s"] = time.time() - t0

    trainer = Trainer(cfg, dataset, features, device=device)
    trainer.init_state()
    t0 = time.time()
    best = trainer.train()
    times["train_total_s"] = time.time() - t0
    times["train_epoch_s"] = times["train_total_s"] / a.epochs
    times["train_pairs_per_sec"] = best.get("pairs_per_sec", 0.0)
    # the last epoch's cost: the first replays capture the graphs
    steady = trainer.last_epoch_wall
    times["steady_train_epoch_s"] = steady["train_s"]
    times["steady_eval_s"] = steady["eval_s"]

    trainer.restore()
    t0 = time.time()
    test = trainer.test()
    times["test_s"] = time.time() - t0
    pkl = os.path.join(root, "results/charades/re0.pkl")
    t0 = time.time()
    trainer.infer_trainset(save_path=pkl)
    times["infer_trainset_s"] = time.time() - t0
    t0 = time.time()
    trainer.infer_trainset(save_path=pkl)
    times["infer_trainset_steady_s"] = time.time() - t0
    trainer.close()

    t0 = time.time()
    stats = update_labels("charades", 1, data_root=os.path.join(root, "data"),
                          results_root=os.path.join(root, "results"))
    times["label_update_s"] = time.time() - t0

    # extrapolate from the last epoch: full Charades = 12,403 train / 3,720
    # test queries, 50 epochs a round, 3 rounds; the one-time costs (the
    # graphs' captures) once a round
    scale_train = 12403 / a.n_train
    scale_test = 3720 / a.n_test
    once = max(0.0, times["train_total_s"]
               - a.epochs * (times["steady_train_epoch_s"] + times["steady_eval_s"]))
    per_round = (once
                 + (times["steady_train_epoch_s"] * scale_train
                    + times["steady_eval_s"] * scale_test) * 50
                 + times["infer_trainset_steady_s"] * scale_train
                 + times["label_update_s"] * scale_train)
    times["one_time_s"] = once
    times["extrapolated_full_round_s"] = per_round
    times["extrapolated_3round_loop_min"] = per_round * 3 / 60
    times["best_r1i7"] = best["r1i7"]
    times["test_r1i7"] = test["r1i7"]
    times["pseudo_miou_new"] = stats["new_miou"]
    return times


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=None,
                   help="where the synthetic dataset goes (a temporary "
                        "directory by default)")
    p.add_argument("--n-train", type=int, default=2000)
    p.add_argument("--n-test", type=int, default=500)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--vdim", type=int, default=1024)
    p.add_argument("--max-vlen", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--sweep-backend", default="fused", choices=["fused", "flax"])
    add_common_flags(p, "validate_pipeline")
    a = p.parse_args(argv)
    device = device_of(a.device)
    reset_launches()
    if a.root is None:
        with tempfile.TemporaryDirectory(prefix="hual_torch_validate_") as root:
            times = validate(root, a, device)
    else:
        times = validate(a.root, a, device)
    write_result(a.out, {**device_info(device), "stages": times,
                         "sweep_backend": a.sweep_backend,
                         "timing": "host seconds; every stage ends in a host fetch"})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
