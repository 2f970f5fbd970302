#!/usr/bin/env python
"""Serving latency and throughput of the port's Predictor, on the card.

The port's counterpart of tools/bench_serve.py (hual_tpu_torch/serve.py).
A Trainer at Charades width (T=64, vdim 1024, D=128, ``span_decode:
pallas``, so every chunk's span decode is K1) on a synthetic dataset is
exported as a bundle and served by ``Predictor.from_bundle``:

* single-request latency: p50/p90 over ``--single`` calls at batch size 1;
* batched throughput: requests/s at batch sizes 8/32/96 over ``--chunks``
  chunks of raw requests (the full request path: host tokenization,
  downsampling and padding, the forward, the decode, the score, the copy
  back);
* the device-only part: one pre-encoded batch's forward and copy back, and
  its share of the end-to-end time a batch.

Protocol: every ``predict`` call ends on a device-to-host copy of the
indices and scores, so its host clock is the request's latency; the
device-only time is the host clock over 10 forwards, each ending on its
copy back.

Writes results/torch_bench_serve.json (``--out``).

    python tools/torch_bench_serve.py [--single 64] [--chunks 10]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_synthetic_data import make_dataset  # noqa: E402
from torch_tool_common import (CHARADES, add_common_flags,  # noqa: E402
                               device_info, device_of, reset_launches,
                               write_result)

from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.datasets import gen_or_load_dataset  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from hual_tpu_torch.serve import Predictor, export_bundle  # noqa: E402
from hual_tpu_torch.utils.io import load_json  # noqa: E402

WIDTHS: dict = {}      # SeqPAN's widths over Charades' (the tests narrow them)
DATA = dict(n_train=128, n_test=64, max_raw_len=120, min_raw_len=24, seed=5)


def build_trainer(root: str, device) -> Trainer:
    model = {**CHARADES, **WIDTHS}
    make_dataset(root, task="charades", vdim=model["vdim"], **DATA)
    cfg = Config.from_dict({
        "task": "charades", "suffix": "serve",
        "paths": {"ckpt_dir": os.path.join(root, "ckpt"),
                  "cache_dir": os.path.join(root, "data_pkl"),
                  "feature_path": os.path.join(root, "data/features/charades_i3d"),
                  "glove_path": os.path.join(root, "data/glove/glove.840B.300d.txt"),
                  "train_path": os.path.join(root, "data/charades_re0/train.json"),
                  "test_path": os.path.join(root, "data/charades_re0/test.json")},
        "train": {"epochs": 1, "batch_size": 16, "seed": 12345},
        "model": {"name": "SeqPAN", "max_tlen": 30, "span_decode": "pallas", **model},
        "loss": {"match_lambda": 1.0, "tau": 0.3, "no_gumbel": True}})
    dataset = gen_or_load_dataset(cfg)
    features = FeatureStore.from_dir(cfg.paths.feature_path, cfg.model.max_vlen)
    trainer = Trainer(cfg, dataset, features, device=device)
    trainer.init_state()
    return trainer


def requests_from(trainer: Trainer, n: int) -> list:
    recs = load_json(trainer.config.paths.test_path)
    feat_dir = trainer.config.paths.feature_path
    reqs = []
    while len(reqs) < n:
        for vid, duration, _gt, sentence in recs:
            reqs.append((np.load(os.path.join(feat_dir, f"{vid}.npy")), duration,
                         sentence))
            if len(reqs) == n:
                break
    return reqs


def bench(root: str, device, single: int, chunks: int, batch_sizes) -> dict:
    trainer = build_trainer(root, device)
    bundle = export_bundle(trainer, os.path.join(root, "bundle"))
    trainer.close()
    out = {"shapes": "SeqPAN at Charades width (T=64, vdim 1024, D=128), "
                     "span_decode: pallas"}

    p1 = Predictor.from_bundle(bundle, batch_size=1, device=device)
    t0 = time.perf_counter()
    p1.warmup()
    out["warmup_s_b1"] = time.perf_counter() - t0
    reqs = requests_from(trainer, single)
    for r in reqs[:3]:
        p1.predict(*r)
    lat = []
    for r in reqs:
        t0 = time.perf_counter()
        p1.predict(*r)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.array(lat)
    out["single_latency_ms"] = {"p50": float(np.percentile(lat, 50)),
                                "p90": float(np.percentile(lat, 90)),
                                "mean": float(lat.mean()), "n": len(lat)}

    out["batched"] = {}
    for bs in batch_sizes:
        p = Predictor.from_bundle(bundle, batch_size=bs, device=device)
        p.warmup()
        reqs = requests_from(trainer, bs * chunks)
        p.predict_batch(reqs[:bs])
        t0 = time.perf_counter()
        p.predict_batch(reqs)
        dt = time.perf_counter() - t0
        batch = p.encode_batch(reqs[:bs])
        [t.cpu() for t in p.forward(batch)]
        t1 = time.perf_counter()
        for _ in range(10):
            [t.cpu() for t in p.forward(batch)]
        dev = (time.perf_counter() - t1) / 10
        e2e = dt / chunks
        out["batched"][f"b{bs}"] = {"requests_per_s": len(reqs) / dt,
                                    "ms_per_batch_end_to_end": e2e * 1e3,
                                    "ms_per_batch_device_only": dev * 1e3,
                                    "device_only_share": dev / e2e}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--single", type=int, default=64,
                    help="requests timed one at a time at batch size 1")
    ap.add_argument("--chunks", type=int, default=10,
                    help="chunks of requests timed at each batch size")
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=[8, 32, 96])
    ap.add_argument("--root", default=None,
                    help="where the synthetic dataset and bundle go (a "
                         "temporary directory by default)")
    add_common_flags(ap, "bench_serve")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    reset_launches()
    if args.root is None:
        with tempfile.TemporaryDirectory(prefix="hual_torch_serve_") as root:
            res = bench(root, device, args.single, args.chunks, args.batch_sizes)
    else:
        os.makedirs(args.root, exist_ok=True)
        res = bench(args.root, device, args.single, args.chunks, args.batch_sizes)
    res["protocol"] = ("each predict ends on a device-to-host copy: its host clock "
                       "is the latency; device-only: host clock over 10 forwards of "
                       "one pre-encoded batch, each ending on its copy back")
    write_result(args.out, {**device_info(device), **res})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
