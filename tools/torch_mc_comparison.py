#!/usr/bin/env python
"""The true-MC path at loop scale on the card: the port's side of
tools/mc_comparison.py.

Runs the SAME synthetic Charades loop (``torch_full_loop_demo``'s dataset
and ``run_loop``, ``span_decode: pallas`` (K1), ``sweep_backend: fused``
(K2)) twice, in this process: ``mc_droprate 0.0`` (the reference's shipped
degenerate behavior: model uncertainty ≡ 0, annotated half = first ⌈N/2⌉
in dataset order) and ``mc_droprate 0.5`` (the paper's intended
MC-dropout), then reports:

  * per-video uncertainty statistics of each run's round-0 pickle,
  * the overlap and order agreement of the annotated halves,
  * pseudo-label mIoU and test R1@0.7 trajectories side by side.

Writes results/torch_mc_comparison.json (``--out``) and prints the K1/K2
launches of both loops.

    python tools/torch_mc_comparison.py --root /tmp/mccmp --n-train 2000 \\
        --n-test 500 --epochs 15 --rounds 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_full_loop_demo as loop_demo  # noqa: E402
from make_synthetic_data import make_dataset  # noqa: E402
from torch_tool_common import REPO, device_info, device_of  # noqa: E402

from hual_tpu_torch.active.coefficients import F_RENEW, get_coff  # noqa: E402
from hual_tpu_torch.active.engine import rank_uncertainty  # noqa: E402
from hual_tpu_torch.utils.io import load_json, load_pickle  # noqa: E402

OUT = os.path.join(REPO, "results", "torch_mc_comparison.json")


def loop(root: str, mc: float, args) -> dict:
    """``torch_full_loop_demo``'s Charades loop at ``mc`` under ``root``:
    its dataset (vdim 1024, raw lengths up to 128, seed 7), then
    ``run_loop``; returns the summary."""
    d = loop_demo.TASK_DEFAULTS["charades"]
    if not os.path.exists(os.path.join(root, "data", "charades_re0")):
        make_dataset(root, task="charades", n_train=args.n_train, n_test=args.n_test,
                     vdim=loop_demo.MODEL["vdim"], max_raw_len=2 * d["max_vlen"], seed=7,
                     queries_per_video=d["queries_per_video"])
    summary = os.path.join(os.path.abspath(root), "full_loop_summary.json")
    cwd = os.getcwd()
    try:
        loop_demo.run_loop(os.path.abspath(root), "charades", epochs=args.epochs,
                           rounds=args.rounds, max_vlen=d["max_vlen"], mc_droprate=mc,
                           summary_name=summary, train_kwargs={"sweep_backend": "fused"},
                           device=args.device)
    finally:
        os.chdir(cwd)      # run_loop works from inside root
    with open(summary) as f:
        return json.load(f)


def selection_order(root: str) -> tuple[list[int], np.ndarray]:
    """Annotated-half indices (in selection order) + per-video uncertainty
    from the round-0 pickle, reproducing the engine's ranking."""
    data_old = load_json(os.path.join(root, "data/charades_re0/train.json"))
    data_gt = load_json(os.path.join(root, "data/charades_gt/train.json"))
    prop = load_pickle(os.path.join(root, "results/charades/re0.pkl"))
    for rec in data_old:
        if len(rec) == 4:
            rec.append({"pos_idx": [], "neg_idx": []})
    ranking = rank_uncertainty(data_old, data_gt, prop,
                               get_coff(F_RENEW, "charades", 1))
    n_sel = int(np.ceil(len(ranking) / 2))
    order = [r["idx"] for r in ranking[:n_sel]]
    uv = np.asarray([r["uncert_video"] for r in ranking])
    return order, uv


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "mccmp"))
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--n-test", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default=OUT, help="the result's JSON file")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    summaries, orders, uncerts = {}, {}, {}
    launches = {"span_decode": 0, "fused_forward": 0, "fused_forward_bf16": 0}
    for mc in (0.0, 0.5):
        root = os.path.join(args.root, f"mc{str(mc).replace('.', '')}")
        summaries[mc] = loop(root, mc, args)
        orders[mc], uncerts[mc] = selection_order(root)
        for k in launches:
            launches[k] += summaries[mc]["launches"][k]

    o0, o5 = orders[0.0], orders[0.5]
    overlap = len(set(o0) & set(o5)) / len(o0)
    res = {
        **device_info(device),
        "config": vars(args),
        "uncert_video_mc0": {"max": float(uncerts[0.0].max()),
                             "nonzero_frac": float((uncerts[0.0] > 0).mean())},
        "uncert_video_mc5": {
            "min": float(uncerts[0.5].min()),
            "max": float(uncerts[0.5].max()),
            "mean": float(uncerts[0.5].mean()),
            "nonzero_frac": float((uncerts[0.5] > 0).mean()),
            "n_distinct": int(len(np.unique(np.round(uncerts[0.5], 6)))),
        },
        "selection": {
            "mc0_is_dataset_order": o0 == sorted(o0),
            "mc5_is_dataset_order": o5 == sorted(o5),
            "set_overlap_frac": overlap,
            "order_identical": o0 == o5,
        },
        "trajectories": {
            str(mc): {
                "re0_best_r1i7": summaries[mc]["re0_best"].get("r1i7"),
                "pseudo_miou": [r["pseudo_miou"]
                                for r in summaries[mc]["rounds"]],
                "r1i7": [r["best_r1i7"] for r in summaries[mc]["rounds"]],
                "total_loop_min": summaries[mc]["times"]["total_loop_min"],
            } for mc in (0.0, 0.5)
        },
        "launches": launches,
    }
    print(json.dumps({"launches": launches}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
