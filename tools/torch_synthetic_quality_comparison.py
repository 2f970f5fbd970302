#!/usr/bin/env python
"""The pseudo-label seed band on the card: the port's side of
tools/synthetic_quality_comparison.py.

The port's complete HUAL loop (``torch_full_loop_demo.run_loop``: re0
train + infer, then rounds of update -> train -> infer, ``span_decode:
pallas`` (K1), ``sweep_backend: fused`` (K2)) runs at each train seed on
the comparison's synthetic dataset (600 / 300 queries, vdim 128, seed 31;
15 epochs, re0 + 2 rounds, mc 0), each seed in a fresh copy of the data.
The other side is not run here: the reference's (TF1) and ``hual_tpu``'s
numbers are read from the committed results/synthetic_quality_comparison.json,
and the same sections are written with the port in the place of ``ours``:

  * ``comparison``: the reference's best-test R@1 trajectory inside the
    port's across-seed envelope widened by 2 binomial sd (printed, not
    checked: at 300 test queries it is training noise);
  * ``label_quality``: the train-set pseudo-label mIoU per round, the AL
    algorithm's own output, against the reference's;
  * ``spread_comparison``: the across-seed R@1@0.7 ranges of the
    reference's three seeds and of the port's overlap within 2 binomial sd
    at every round.

``hual_tpu``'s own ``ours`` and ``label_quality`` stay beside them
(``hual_tpu_ours``, ``hual_tpu_label_quality``).  On the comparison's
dataset and schedule the tool exits 1 when round 1's old pseudo-mIoU is not
0.5565 (then it is another dataset) or a seed's pseudo-mIoU lies outside
:data:`QUALITY_BANDS`.

    python tools/torch_synthetic_quality_comparison.py          # the card, 3 seeds
    python tools/torch_synthetic_quality_comparison.py --smoke --device cpu

Writes results/torch_synthetic_quality_comparison.json (``--out``;
``_smoke`` before ``.json`` with ``--smoke``).  Left out: the JAX tool's
``--ref-spread`` (it runs the reference), ``--augment`` and ``--resume``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_synthetic_data import make_dataset  # noqa: E402
from torch_full_loop_demo import run_loop  # noqa: E402
from torch_tool_common import REPO, add_common_flags, device_info, device_of  # noqa: E402

RECORDED = os.path.join(REPO, "results", "synthetic_quality_comparison.json")
OUT = os.path.join(REPO, "results", "torch_synthetic_quality_comparison.json")
# tools/synthetic_quality_comparison.py's dataset and schedule (its
# defaults), the only ones the bands below hold for
COMPARISON = dict(n_train=600, n_test=300, vdim=128, epochs=15)
# round 1's old pseudo-mIoU there (ref_initial_old in RECORDED): the same
# dataset gives it
QUALITY_OLD_MIOU = 0.5565
# the union of the reference's and hual_tpu's pseudo-mIoU over their seeds
# (RECORDED's label_quality and reference_spread), widened by 0.006, the
# widest across-seed spread at any round
QUALITY_BANDS = {1: (0.568, 0.590), 2: (0.588, 0.606)}


def label_quality_rows(ref_rounds: list, ours_summaries: list) -> dict:
    """The label-quality section (the JAX tool's ``label_quality_section``
    once it has read the reference's log) from the reference's per-round
    ``{"round", "old", "new"}`` and ours_summaries, a list of (train_seed,
    ``run_loop`` summary dict)."""
    ours = [{"train_seed": seed,
             "pseudo_miou": [r["pseudo_miou"] for r in s["rounds"]]}
            for seed, s in ours_summaries]
    rows = []
    for rr in ref_rounds:
        vals = [o["pseudo_miou"][rr["round"] - 1] for o in ours
                if len(o["pseudo_miou"]) >= rr["round"]]
        rows.append({"round": rr["round"], "ref": rr["new"],
                     "ours": vals,
                     "max_abs_delta": (round(max(abs(v - rr["new"])
                                               for v in vals), 4)
                                       if vals else None)})
    return {"contract": ("train-set pseudo-label mIoU after each AL round — "
                         "the algorithm's direct output, ~noise-free at "
                         "train-set size (vs several points of training "
                         "noise in best-test R@1)"),
            "ref_initial_old": ref_rounds[0]["old"] if ref_rounds else None,
            "rounds": rows}


def recorded_ref_rounds(recorded: dict) -> list:
    """The reference's pseudo-label mIoU per round as the committed
    comparison recorded it (its log is not in the repository)."""
    lq = recorded["label_quality"]
    return [{"round": r["round"], "new": r["ref"],
             "old": lq["ref_initial_old"] if r["round"] == 1 else None}
            for r in lq["rounds"]]


def envelope_row(rnd: int, ours: list, ref_rounds: list, n_test: int) -> dict:
    """Round ``rnd``'s row of the envelope comparison: per metric, the
    reference inside ours' across-seed range widened by 2 binomial sd of
    R@1 at their mean on n_test samples."""
    row = {"round": rnd}
    for metric in ("r1i5", "r1i7"):
        vals = [o["rounds"][rnd][metric] for o in ours
                if o["rounds"][rnd][metric] is not None]
        refv = next(r[metric] for r in ref_rounds if r["round"] == rnd)
        lo, hi = (min(vals), max(vals)) if vals else (None, None)
        p = (sum(vals) / len(vals) / 100.0) if vals else 0.5
        sd = 100.0 * (p * (1 - p) / n_test) ** 0.5
        inside = (lo is not None
                  and lo - 2 * sd <= refv <= hi + 2 * sd)
        row[metric] = {"ref": refv, "ours_min": lo, "ours_max": hi,
                       "ours": vals, "binomial_sd": round(sd, 2),
                       "ref_inside_envelope_2sd": inside}
    return row


def spread_section(comparison: list, all_ref: list, n_test: int) -> dict:
    """Spread against spread: per round, do the two frameworks' across-seed
    R1@0.7 ranges overlap (widened by 2 binomial sd)?  ``all_ref`` holds
    each reference seed's ``{"rounds": [...]}``."""
    rows = []
    for rnd_row in comparison:
        rnd = rnd_row["round"]
        refs = [next(r["r1i7"] for r in s["rounds"]
                     if r["round"] == rnd) for s in all_ref]
        ours = rnd_row["r1i7"]["ours"]
        sd_b = rnd_row["r1i7"]["binomial_sd"]
        overlap = (min(max(refs), max(ours)) + 2 * sd_b
                   >= max(min(refs), min(ours)) - 2 * sd_b)
        rows.append({"round": rnd, "ref_range": [min(refs), max(refs)],
                     "ours_range": [min(ours), max(ours)],
                     "binomial_sd": sd_b, "ranges_overlap_2sd": overlap})
    return {"contract": ("across-seed R1@0.7 ranges of the two frameworks "
                         "overlap (each widened by 2 binomial sd of "
                         f"n_test={n_test}) at every round"),
            "rounds": rows,
            "all_rounds_overlap": all(r["ranges_overlap_2sd"] for r in rows)}


def band_failures(old_miou: dict, pseudo: dict) -> list[str]:
    """What breaks the seed band: ``old_miou`` maps a seed to round 1's old
    pseudo-mIoU, ``pseudo`` a seed to its pseudo-mIoU per round."""
    out = [f"seed {seed}: round 1's old pseudo-mIoU {old}, not {QUALITY_OLD_MIOU}"
           for seed, old in old_miou.items() if round(old, 4) != QUALITY_OLD_MIOU]
    for seed, values in pseudo.items():
        for rnd, value in enumerate(values, start=1):
            lo, hi = QUALITY_BANDS.get(rnd, (-float("inf"), float("inf")))
            if not lo <= value <= hi:
                out.append(f"seed {seed}: round {rnd}'s pseudo-mIoU {value} "
                           f"outside [{lo}, {hi}]")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "hual_torch_synth_quality"))
    ap.add_argument("--n-train", type=int, default=COMPARISON["n_train"])
    ap.add_argument("--n-test", type=int, default=COMPARISON["n_test"])
    ap.add_argument("--vdim", type=int, default=COMPARISON["vdim"])
    ap.add_argument("--epochs", type=int, default=COMPARISON["epochs"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[12345, 777, 20260820],
                    help="the port's train seeds (the envelope); those of "
                         "the JAX tool")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny plumbing check: 48 / 24 queries, vdim 32, 2 "
                         "epochs, 1 round, the first seed (does not write the "
                         "default artifact)")
    add_common_flags(ap, "synthetic_quality_comparison")
    ap.set_defaults(out=None)
    a = ap.parse_args(argv)
    device = device_of(a.device)
    if a.smoke:
        a.n_train, a.n_test, a.vdim, a.epochs, a.rounds = 48, 24, 32, 2, 1
        a.seeds = a.seeds[:1]
    out_path = a.out or (OUT if not a.smoke else OUT.replace(".json", "_smoke.json"))
    with open(RECORDED) as f:
        recorded = json.load(f)

    cwd0 = os.getcwd()
    root = os.path.abspath(a.root)
    if os.path.exists(root):
        shutil.rmtree(root)
    synth = os.path.join(root, "synthetic_assets")
    make_dataset(synth, task="charades", n_train=a.n_train, n_test=a.n_test,
                 vdim=a.vdim, max_raw_len=64, seed=31)
    sd = os.path.join(synth, "data")

    # the port's loop at each seed (fresh staging per seed so round files
    # can never leak between runs)
    ours, ours_summaries, old_miou = [], [], {}
    launches = {"span_decode": 0, "fused_forward": 0, "fused_forward_bf16": 0}
    for seed in a.seeds:
        sroot = os.path.join(root, f"ours_{seed}")
        shutil.copytree(sd, os.path.join(sroot, "data"), symlinks=True)
        t0 = time.time()
        try:
            run_loop(sroot, "charades", epochs=a.epochs, rounds=a.rounds,
                     max_vlen=64, mc_droprate=0.0, model_kwargs={"vdim": a.vdim},
                     train_kwargs={"seed": seed, "sweep_backend": "fused"},
                     summary_name="loop_summary.json", device=a.device)
        finally:
            os.chdir(cwd0)
        with open(os.path.join(sroot, "loop_summary.json")) as f:
            s = json.load(f)
        with open(os.path.join(sroot, "results", "charades", "rounds_summary.json")) as f:
            old_miou[seed] = json.load(f)[0]["label_stats"]["old_miou"]
        for k in launches:
            launches[k] += s["launches"][k]
        ours_summaries.append((seed, s))
        re0 = s["re0_best"].get("test_metrics") or {}
        traj = [{"round": 0, "r1i5": re0.get("r1i5"), "r1i7": re0.get("r1i7")}]
        traj += [{"round": r["round"], "r1i5": r["test"].get("r1i5"),
                  "r1i7": r["test"].get("r1i7")} for r in s["rounds"]]
        ours.append({"train_seed": seed,
                     "wall_min": round((time.time() - t0) / 60, 1),
                     "rounds": traj})
        print(f"[ours seed={seed}] done in {ours[-1]['wall_min']} min: "
              f"{[r['r1i7'] for r in traj]}", flush=True)

    ref = recorded["reference"]
    comparison = [envelope_row(rnd, ours, ref["rounds"], a.n_test)
                  for rnd in range(a.rounds + 1)]
    verdict = all(row[m]["ref_inside_envelope_2sd"]
                  for row in comparison for m in ("r1i5", "r1i7"))
    pseudo = {seed: [r["pseudo_miou"] for r in s["rounds"]]
              for seed, s in ours_summaries}
    checked = {k: getattr(a, k) for k in COMPARISON} == COMPARISON
    failures = band_failures(old_miou, pseudo) if checked else []
    result = {
        **device_info(device),
        "workload": (f"the synthetic charades-style dataset of "
                     f"results/synthetic_quality_comparison.json "
                     f"(n_train={a.n_train}, n_test={a.n_test}, vdim={a.vdim}, "
                     f"max_vlen=64, seed 31); the port's complete HUAL loop on "
                     f"{device.type}: {a.epochs} epochs x re0+{a.rounds} rounds, "
                     f"batch 16, lr 1e-4, droprate 0.2, mc 0, span_decode pallas, "
                     f"sweep_backend fused; the reference's and hual_tpu's numbers "
                     f"read from the committed comparison"),
        "contract": recorded["contract"],
        "reference": ref,
        "reference_wall_min": recorded["reference_wall_min"],
        "ours": ours,
        "comparison": comparison,
        "ref_inside_envelope_all_rounds": verdict,
        "label_quality": label_quality_rows(recorded_ref_rounds(recorded),
                                            ours_summaries),
        "reference_spread": recorded["reference_spread"],
        "spread_comparison": spread_section(
            comparison, [{"rounds": ref["rounds"]}]
            + [{"rounds": s["rounds"]} for s in recorded["reference_spread"]],
            a.n_test),
        "hual_tpu_ours": recorded["ours"],
        "hual_tpu_label_quality": recorded["label_quality"],
        "seed_band": {"bands": QUALITY_BANDS, "old_miou_round1": old_miou,
                      "pseudo_miou": pseudo, "checked": checked,
                      "failures": failures},
        "launches": launches,
    }
    print(json.dumps({"launches": launches}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, default=float)
    print(json.dumps({"comparison": comparison, "verdict": verdict,
                      "spread_comparison": result["spread_comparison"],
                      "seed_band": result["seed_band"]}, indent=1, default=float))
    print(f"wrote {out_path}", flush=True)
    if failures:
        print("SEED BAND FAILED:\n  " + "\n  ".join(failures), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
