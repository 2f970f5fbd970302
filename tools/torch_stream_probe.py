#!/usr/bin/env python3
"""Host streaming at ActivityNet's size on one NVIDIA GPU: the port's
``Trainer`` with its feature table in host RAM against the same table on
the card.

The table is ActivityNet's at real shapes: ``--rows`` videos x T=100 x 1024
f32 (33,700 rows, 13.80 GB by default: the ~13.8 GB that
``docs/PROFILING.md`` gives for ActivityNet, over the default
``train.hbm_budget_gb`` of 12 GB), filled from a seeded normal block.
SeqPAN runs at ActivityNet width (``configs/anet/SeqPAN.yaml``: T=100,
D=128, 8 heads, 2 layers, char_dim 100) with random weights, the
reference's train section (batch 16, lr 1e-4, drop 0.2), ``span_decode:
pallas`` and ``sweep_backend: fused``.  ``--queries`` train queries (100
steps by default) and ``--test-queries`` test queries sit on random rows
of the whole table, so each streamed batch gathers from all of it.

It prints one JSON line:

* ``epochs_in_turns``: one ``Trainer.train()`` epoch at a time, in turns (resident,
  streamed, streamed, resident, then a streamed int8 epoch): ms a step
  (host clock of the epoch over its steps) and the test sweep's seconds
  (K2 + K1 resident; the eager model under streaming, the fallback);
* ``test_sweep_s_in_turns``: ``Trainer.test()`` alone in turns: resident fused, resident
  flax, streamed (flax), streamed, resident flax, resident fused;
* ``batch``: a streamed batch's pieces, medians over 20 batches: the NumPy
  gather from the host table and the int8 quantization (both on the
  prefetch thread in a run), the synchronous upload, and its bytes;
* ``table``: rows, GB and the seconds to fill it and to put it on the card.

Run from the repository root: ``python3 tools/torch_stream_probe.py``
(about 4 minutes on an H100, kernels built included; ~30 GB of host RAM).
``--device cpu`` with small ``--rows``/``--vdim``/``--queries`` rehearses
it on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hual_tpu_torch.config import Config  # noqa: E402
from hual_tpu_torch.data.features import FeatureStore, quantize_features  # noqa: E402
from hual_tpu_torch.data.loader import TrainLoader  # noqa: E402
from hual_tpu_torch.runtime import steps  # noqa: E402
from hual_tpu_torch.runtime.trainer import Trainer  # noqa: E402

T, N_WORDS, N_CHARS, MAX_WLEN, MAX_CLEN = 100, 1002, 60, 20, 12


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def host_table(rows: int, vdim: int, rng) -> FeatureStore:
    """A packed (rows, T, vdim) f32 table, each row's clips past its length
    zero, filled from one seeded 256-row normal block."""
    store = FeatureStore.__new__(FeatureStore)
    store.max_vlen = T
    store.packed = np.empty((rows, T, vdim), np.float32)
    store.lengths = rng.integers(T // 2, T + 1, rows).astype(np.int32)
    block = rng.standard_normal((min(rows, 256), T, vdim), dtype=np.float32)
    for lo in range(0, rows, len(block)):
        hi = min(rows, lo + len(block))
        store.packed[lo:hi] = block[:hi - lo]
    for n in np.unique(store.lengths):
        store.packed[store.lengths == n, n:] = 0.0
    store.vid_index = {f"v{i:05d}": i for i in range(rows)}
    return store


def records(n: int, store: FeatureStore, rng) -> list[dict]:
    out = []
    for row in rng.choice(len(store.lengths), n):
        v_len = int(store.lengths[row])
        s = int(rng.integers(0, v_len))
        e = min(v_len - 1, s + int(rng.integers(0, 20)))
        n_w = int(rng.integers(4, MAX_WLEN + 1))
        w_ids = [int(w) for w in rng.integers(2, N_WORDS, n_w)]
        out.append({"vid": f"v{row:05d}", "duration": float(rng.uniform(20, 200)),
                    "s_ind": s, "e_ind": e, "v_len": v_len, "w_ids": w_ids,
                    "c_ids": [[int(c) for c in rng.integers(1, N_CHARS,
                                                            rng.integers(2, MAX_CLEN))]
                              for _ in w_ids],
                    "words": [f"w{w}" for w in w_ids]})
    return out


def median_ms(fn, n: int, sync) -> float:
    times = []
    for i in range(n):
        sync()
        t0 = time.perf_counter()
        fn(i)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=33700)
    ap.add_argument("--vdim", type=int, default=1024)
    ap.add_argument("--queries", type=int, default=1600)
    ap.add_argument("--test-queries", type=int, default=960)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_stream_probe: no card")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(20261017)
    t0 = time.perf_counter()
    store = host_table(args.rows, args.vdim, rng)
    fill_s = time.perf_counter() - t0
    dataset = {"train_set": records(args.queries, store, rng),
               "test_set": records(args.test_queries, store, rng),
               "val_set": None, "max_wlen": MAX_WLEN, "max_clen": MAX_CLEN,
               "n_words": N_WORDS, "n_chars": N_CHARS,
               "word_vector": rng.normal(scale=0.3, size=(N_WORDS - 2, 300))
                                 .astype(np.float32)}
    log = logging.getLogger("torch_stream_probe")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    base = Config.from_dict({
        "task": "anet", "suffix": "probe", "paths": {"ckpt_dir": workdir},
        "train": {"epochs": 1, "batch_size": 16, "lr": 1e-4, "droprate": 0.2,
                  "clip_norm": 1.0, "weight_decay": 0.01, "seed": 7,
                  "sweep_backend": "fused"},
        "model": {"name": "SeqPAN", "max_vlen": T, "max_tlen": 30,
                  "vdim": args.vdim, "dim": 128, "num_heads": 8, "word_dim": 300,
                  "char_dim": 100, "attn_layer": 2, "span_decode": "pallas"}})

    def trainer(name, hs, dtype="float32", backend="fused", table=None):
        cfg = copy.deepcopy(base)
        cfg.suffix, cfg.model.feature_dtype = name, dtype
        cfg.train.host_streaming, cfg.train.sweep_backend = hs, backend
        return Trainer(cfg, dataset, store, logger=log, device_features=table,
                       device=device)

    t0 = time.perf_counter()
    resident = trainer("resident", False)
    sync()
    put_s = time.perf_counter() - t0
    table_gb = store.packed.nbytes / 1e9
    trainers = {"resident": resident,
                "resident_flax": trainer("resident_flax", False, backend="flax",
                                         table=resident.export_device_features()),
                "streamed": trainer("streamed", True),
                "streamed_int8": trainer("streamed_int8", True, "int8")}
    n_steps = -(-args.queries // 16)

    here = os.getcwd()
    os.chdir(workdir)                          # train() writes ./logs/<task>/
    epochs: dict[str, list] = {}
    try:
        for name in ("resident", "streamed", "streamed", "resident", "streamed_int8"):
            tr = trainers[name]
            tr.init_state()
            tr.train()
            wall = tr.last_epoch_wall
            epochs.setdefault(name, []).append(
                {"step_ms": wall["train_s"] * 1e3 / n_steps, "eval_s": wall["eval_s"]})
            tr.close()
    finally:
        os.chdir(here)

    sweeps: dict[str, list] = {}
    for tr in trainers.values():
        tr.init_state()
    for name in ("resident", "resident_flax", "streamed", "streamed",
                 "resident_flax", "resident"):
        sync()
        t0 = time.perf_counter()
        trainers[name].test()
        sweeps.setdefault(name, []).append(time.perf_counter() - t0)

    tr = trainers["streamed"]
    sels = list(TrainLoader(tr.train_set, 16, seed=7).index_iter(0))[:20]
    hosts = [tr.train_set.gather(s, with_labels=False) for s in sels]
    n = len(sels)
    batch = {
        "batches": n,
        "gather_ms": median_ms(lambda i: tr.train_set.gather(sels[i], False), n,
                               lambda: None),
        "quantize_ms": median_ms(lambda i: quantize_features(hosts[i]["video_features"]),
                                 n, lambda: None),
        "upload_ms": median_ms(lambda i: steps.upload_batch(hosts[i], device, True),
                               n, sync),
        "upload_bytes_f32": sum(int(v.nbytes) for v in hosts[0].values()),
    }
    q, scales = quantize_features(hosts[0]["video_features"])
    batch["upload_bytes_int8"] = (batch["upload_bytes_f32"]
                                  - hosts[0]["video_features"].nbytes
                                  + q.nbytes + scales.nbytes)
    print(json.dumps({"stream_probe": {
        "card": card(), "device": str(device),
        "table": {"rows": args.rows, "T": T, "vdim": args.vdim, "gb": table_gb,
                  "fill_s": fill_s, "put_on_card_s": put_s,
                  "auto_mode_streams": table_gb > base.train.hbm_budget_gb},
        "queries": args.queries, "steps_per_epoch": n_steps,
        "test_queries": args.test_queries, "epochs_in_turns": epochs,
        "test_sweep_s_in_turns": sweeps, "batch": batch}}))
    shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
