#!/usr/bin/env python
"""The paper's annotation axes end to end on the card: the port's side of
tools/strategy_ablation_loop.py.

Runs the port's full HUAL loop (``torch_full_loop_demo.run_loop``,
``span_decode: pallas`` (K1), ``sweep_backend: fused`` (K2)) once per
(point_strategy, selection) variant, each in its own workspace seeded with
an identical dataset, and records the quality trajectories side by side:

  * uncertainty/half  — the HUAL method (production default)
  * random/half       — ablation: random frame, same budget
  * dichotomy/half    — ablation: midpoint of largest unannotated segment
  * uncertainty/all   — the shipped ablation data's budget (every record
                        annotated every round)

The process runs in deterministic mode (``runtime/debug.
enable_deterministic``, as ``cli --deterministic``), the port's
counterpart of the JAX backend's reproducible runs: the variants share
round 0 bit for bit (``re0_pickle_sha256``, the re0 pickle's digest), and at
``--mc-droprate`` 0 the model-uncertainty term is zero, so uncertainty/half
and dichotomy/half are the same run (docs/PARITY.md).  ``bars`` records
those facts and the paper's ordering (uncertainty/all highest pseudo-mIoU
at every round, random/half lowest).

    python tools/torch_strategy_ablation_loop.py                     # mc 0
    python tools/torch_strategy_ablation_loop.py --mc-droprate 0.5 --hard
    python tools/torch_strategy_ablation_loop.py --device cpu --n-train 48 \\
        --n-test 24 --vdim 32 --epochs 1 --rounds 1

Writes results/torch_strategy_ablation_loops[_mc<rate>][_hard][_s<seed>].json
(``--out``) and prints the K1/K2 launches of all four loops.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_synthetic_data import make_dataset  # noqa: E402
from torch_full_loop_demo import run_loop  # noqa: E402
from torch_tool_common import REPO, device_info, device_of  # noqa: E402

from hual_tpu_torch.runtime.debug import enable_deterministic  # noqa: E402

VARIANTS = [
    ("uncertainty", "half"),
    ("random", "half"),
    ("dichotomy", "half"),
    ("uncertainty", "all"),
]
# what a variant's run must repeat to be "the same run" as another
SAME_RUN_KEYS = ("re0_pickle_sha256", "re0_best_r1i7", "pseudo_miou", "test_r1i7",
                 "n_pos", "n_neg", "n_selected")


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def bars(variants: list[dict], n_train: int) -> dict:
    """The ablation's facts: round 0 shared by every variant;
    uncertainty/half and dichotomy/half the same run (exact at mc 0);
    ``n_selected`` ⌈N/2⌉ for ``half`` and N for ``all``; uncertainty/all
    the highest pseudo-mIoU and random/half the lowest at every round."""
    by = {(v["point_strategy"], v["selection"]): v for v in variants}
    miou = [v["pseudo_miou"] for v in variants]
    rounds = range(len(miou[0]))
    want = {"half": math.ceil(n_train / 2), "all": n_train}
    return {
        "re0_shared": len({v["re0_pickle_sha256"] for v in variants}) == 1
        and len({v["re0_best_r1i7"] for v in variants}) == 1,
        "uncertainty_half_equals_dichotomy_half": all(
            by["uncertainty", "half"][k] == by["dichotomy", "half"][k]
            for k in SAME_RUN_KEYS),
        "n_selected_as_budgeted": all(n == want[v["selection"]] for v in variants
                                      for n in v["n_selected"]),
        "uncertainty_all_highest": all(
            by["uncertainty", "all"]["pseudo_miou"][r] == max(m[r] for m in miou)
            for r in rounds),
        "random_half_lowest": all(
            by["random", "half"]["pseudo_miou"][r] == min(m[r] for m in miou)
            for r in rounds),
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "hual_torch_strategy_abl"))
    p.add_argument("--n-train", type=int, default=2000)
    p.add_argument("--n-test", type=int, default=600)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--vdim", type=int, default=256,
                   help="synthetic feature dim (smaller than Charades' 1024: "
                        "this ablation compares AL dynamics, not kernels)")
    p.add_argument("--mc-droprate", type=float, default=0.0,
                   help="MC-dropout rate of the inference passes.  At the "
                        "shipped default 0.0 the model-uncertainty term is "
                        "identically zero and uncertainty placement "
                        "degenerates to the dichotomy midpoint "
                        "(docs/PARITY.md); a nonzero rate runs the true-MC "
                        "path where the strategies separate")
    p.add_argument("--hard", action="store_true",
                   help="hard-signal dataset (distractor moments, per-video "
                        "noise, weaker amplitudes — make_synthetic_data "
                        "--hard): real per-sample difficulty variation for "
                        "the acquisition term")
    p.add_argument("--seed", type=int, default=7,
                   help="dataset generator seed (non-default seeds get a "
                        "_s<seed> artifact suffix)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--out", default=None,
                   help="combined summary path (default: <repo>/results/"
                        "torch_strategy_ablation_loops.json)")
    a = p.parse_args(argv)
    device = device_of(a.device)
    enable_deterministic()

    default_name = ("torch_strategy_ablation_loops.json" if a.mc_droprate == 0.0
                    else f"torch_strategy_ablation_loops_mc"
                         f"{str(a.mc_droprate).replace('.', '')}.json")
    if a.hard:
        default_name = default_name.replace(".json", "_hard.json")
    if a.seed != 7:
        default_name = default_name.replace(".json", f"_s{a.seed}.json")
    out_path = a.out or os.path.join(REPO, "results", default_name)
    cwd0 = os.getcwd()

    combined = {
        **device_info(device),
        "workload": (f"charades-style synthetic loop, n_train={a.n_train} "
                     f"n_test={a.n_test} epochs={a.epochs} rounds={a.rounds} "
                     f"vdim={a.vdim} max_vlen=64, "
                     f"mc_droprate={a.mc_droprate}, hard={a.hard}, "
                     f"identical dataset per variant (seed {a.seed}); the "
                     f"port on {device.type}, deterministic mode, span_decode "
                     f"pallas, sweep_backend fused"),
        "variants": [],
    }
    launches = {"span_decode": 0, "fused_forward": 0, "fused_forward_bf16": 0}
    t_all = time.time()
    for strategy, selection in VARIANTS:
        name = f"{strategy}_{selection}"
        root = os.path.abspath(os.path.join(a.root, name))
        if os.path.exists(root):
            shutil.rmtree(root)
        make_dataset(root, task="charades", n_train=a.n_train,
                     n_test=a.n_test, vdim=a.vdim, max_raw_len=128,
                     seed=a.seed, hard=a.hard)
        t0 = time.time()
        summary_path = os.path.join(root, "full_loop_summary.json")
        try:
            rc = run_loop(root, "charades", epochs=a.epochs, rounds=a.rounds,
                          max_vlen=64, mc_droprate=a.mc_droprate,
                          model_kwargs={"vdim": a.vdim},
                          train_kwargs={"sweep_backend": "fused"},
                          point_strategy=strategy, selection=selection,
                          summary_name=summary_path, device=a.device)
        finally:
            os.chdir(cwd0)
        if rc != 0:
            raise RuntimeError(f"variant {name} failed (rc={rc})")
        with open(summary_path) as f:
            s = json.load(f)
        for k in launches:
            launches[k] += s["launches"][k]
        combined["variants"].append({
            "point_strategy": strategy,
            "selection": selection,
            "wall_s": round(time.time() - t0, 1),
            "re0_best_r1i7": s["re0_best"].get("r1i7"),
            "re0_pickle_sha256": sha256(os.path.join(root, "results", "charades",
                                                     "re0.pkl")),
            "pseudo_miou": [r["pseudo_miou"] for r in s["rounds"]],
            "test_r1i7": [r["best_r1i7"] for r in s["rounds"]],
            "n_pos": [r["diagnostics"].get("n_pos") for r in s["rounds"]],
            "n_neg": [r["diagnostics"].get("n_neg") for r in s["rounds"]],
            "n_selected": [r["diagnostics"].get("n_selected")
                           for r in s["rounds"]],
        })
        print(f"[{name}] done in {combined['variants'][-1]['wall_s']}s: "
              f"pseudo_miou={combined['variants'][-1]['pseudo_miou']}", flush=True)
    combined["total_wall_min"] = round((time.time() - t_all) / 60, 1)
    combined["bars"] = bars(combined["variants"], a.n_train)
    combined["launches"] = launches

    print(json.dumps({"launches": launches}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(combined, f, indent=2, default=float)
    print(json.dumps(combined, indent=2, default=float), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
