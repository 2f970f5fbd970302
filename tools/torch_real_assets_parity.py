#!/usr/bin/env python
"""The real-assets quality-parity kit on the card: the R@1 comparison
against the reference, push-button once the assets exist.

The port's counterpart of tools/real_assets_parity.py.  The target "R@1 at
IoU 0.5 and 0.7 within 0.3 points of the reference on fixed seeds"
(BASELINE.md) needs the real I3D features and GloVe, which are external
downloads (the reference's README).  Given them, the kit checks every
asset (``validate_assets``: errors that name the missing download), lays
out the reference's directory hierarchy under ``--root`` (``stage_root``:
record JSONs copied, features and GloVe linked), runs the reference
schedule (Charades: 50 epochs, re0 + 3 rounds; ActivityNet: 100 epochs,
re0 + 4 rounds; batch 16, lr 1e-4, drop 0.2) through the loop driver of
every measured run (``tools/torch_full_loop_demo.run_loop``, on the card,
with the ``fused`` sweeps: K2 and K1) and writes the per-round delta table
against ``--reference-summary`` (``delta_table``); without one the table
holds the port's numbers with status "pending".

    python tools/torch_real_assets_parity.py --task charades \\
        --features <i3d dir> --glove <glove.840B.300d.txt> \\
        --data-root <reference data dir> --gt-train <GT train spans> \\
        --reference-summary ref_numbers.json

``--dry-run`` runs the whole kit hermetically on synthetic assets
(``tools/make_synthetic_data.py``, ``--n-train`` / ``--n-test`` queries,
the JAX kit's small model: vdim 16, D=16, 2 heads, 1 layer), 2 epochs and
1 round unless ``--epochs`` / ``--rounds`` say otherwise.  The JAX kit's
``--run-reference`` runs the reference's own code, which this repository
does not hold: it is left out.  The loop prints and the report records the
launches of K1 and K2.

Writes results/torch_real_assets_parity_<task>[_dryrun].json (``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_full_loop_demo import TASK_DEFAULTS, run_loop  # noqa: E402
from torch_tool_common import REPO, device_of  # noqa: E402

# the reference schedule (BASELINE.md), from the loop driver the kit runs
SCHEDULE = {t: {k: d[k] for k in ("epochs", "rounds", "max_vlen")}
            for t, d in TASK_DEFAULTS.items()}
# the dry run: the JAX kit's synthetic assets and model (the tests narrow it)
DRY_RUN = dict(vdim=16, max_raw_len=24, seed=11, max_vlen=16,
               model=dict(vdim=16, dim=16, num_heads=2, attn_layer=1, char_dim=8,
                          max_tlen=10))


def validate_assets(task: str, features: str, glove: str, data_root: str,
                    gt_train: str | None = None,
                    re0_train: str | None = None) -> dict:
    """Resolve and check every asset; raise ``FileNotFoundError`` naming the
    missing download otherwise."""
    problems = []
    resolved = {"features": features, "glove": glove}

    if not os.path.isdir(features):
        problems.append(f"--features {features}: not a directory (download the "
                        "I3D features named in the reference's README)")
    else:
        n_npy = sum(1 for f in os.listdir(features) if f.endswith(".npy"))
        if n_npy == 0:
            problems.append(f"--features {features}: contains no .npy files")
        resolved["n_feature_files"] = n_npy

    if not os.path.isfile(glove):
        problems.append(f"--glove {glove}: not a file (download "
                        "glove.840B.300d.txt, the reference's README)")
    else:
        with open(glove, encoding="utf-8", errors="ignore") as f:
            first = f.readline().split()
        try:
            [float(x) for x in first[-4:]]
            ok_line = len(first) > 4
        except ValueError:
            ok_line = False
        if not ok_line:
            problems.append(f"--glove {glove}: first line does not look like "
                            "'<token> <floats...>'")

    def _json(kind: str, override: str | None, default_rel: str, hint: str) -> None:
        path = override or os.path.join(data_root, default_rel)
        if not os.path.isfile(path):
            problems.append(f"{kind}: {path} missing ({hint})")
        resolved[kind] = path

    _json("gt_train", gt_train, f"{task}_gt/train.json",
          "pass --gt-train with the GT train spans" if task == "charades"
          else "reference data")
    _json("gt_test", None, f"{task}_gt/test.json", "reference data")
    _json("re0_train", re0_train, f"{task}_re0/train.json",
          "pass --re0-train with the initial pseudo labels" if task == "anet"
          else "reference data")
    _json("re0_test", None, f"{task}_re0/test.json", "reference data")

    if problems:
        raise FileNotFoundError("real-assets parity cannot run; missing or invalid "
                                "assets:\n  - " + "\n  - ".join(problems))
    return resolved


def _ensure_link(link: str, target: str) -> None:
    """Symlink ``link`` -> ``target``, replacing a stale or dangling link."""
    target = os.path.abspath(target)
    if os.path.lexists(link):
        if os.path.islink(link) and os.readlink(link) == target:
            return
        os.remove(link)
    os.symlink(target, link)


def stage_root(root: str, task: str, resolved: dict) -> None:
    """Lay out the reference's directory hierarchy under ``root``: the record
    JSONs copied (rounds write beside them), features and GloVe linked.
    Staging again refreshes every copy and link."""
    data = os.path.join(root, "data")
    for kind, rel in (("gt_train", f"{task}_gt/train.json"),
                      ("gt_test", f"{task}_gt/test.json"),
                      ("re0_train", f"{task}_re0/train.json"),
                      ("re0_test", f"{task}_re0/test.json")):
        dst = os.path.join(data, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.abspath(resolved[kind]) != os.path.abspath(dst):
            shutil.copyfile(resolved[kind], dst)
    feat_link = os.path.join(data, "features", f"{task}_i3d")
    os.makedirs(os.path.dirname(feat_link), exist_ok=True)
    _ensure_link(feat_link, resolved["features"])
    glove_link = os.path.join(data, "glove", "glove.840B.300d.txt")
    os.makedirs(os.path.dirname(glove_link), exist_ok=True)
    _ensure_link(glove_link, resolved["glove"])


def delta_table(summary: dict, reference_summary: dict | None,
                bar: float = 0.3) -> dict:
    """Per round, the port's R@1 at IoU 0.5 and 0.7 against the reference's,
    each delta against ``bar``: {"rounds", "bar", "all_within_bar" (None
    while any round is pending), "markdown"}.  A round without its own
    metrics (a best record may carry empty test metrics) is pending."""
    def _fmt(x, signed=False):
        return "—" if x is None else ("%+.2f" if signed else "%.2f") % x

    re0_metrics = summary["re0_best"].get("test_metrics") or {}
    ours = [{"round": 0, "r1i5": re0_metrics.get("r1i5"),
             "r1i7": re0_metrics.get("r1i7")}]
    ours += [{"round": r["round"], "r1i5": (r["test"] or {}).get("r1i5"),
              "r1i7": (r["test"] or {}).get("r1i7")} for r in summary["rounds"]]
    ref_by_round = {}
    if reference_summary is not None:
        ref_by_round = {int(r["round"]): r for r in reference_summary["rounds"]}

    rows, verdicts = [], []
    lines = ["| round | ours R1@0.5 | ref R1@0.5 | Δ0.5 | ours R1@0.7 | "
             "ref R1@0.7 | Δ0.7 | within ±%.1f |" % bar,
             "|---|---|---|---|---|---|---|---|"]
    for o in ours:
        ref = ref_by_round.get(o["round"])
        row = {"round": o["round"], "ours_r1i5": o["r1i5"], "ours_r1i7": o["r1i7"]}
        if ref is None or o["r1i5"] is None or o["r1i7"] is None:
            row.update(ref_r1i5=None, ref_r1i7=None, delta_r1i5=None,
                       delta_r1i7=None, within_bar=None)
            lines.append("| re%d | %s | %s | — | %s | %s | — | pending |"
                         % (o["round"], _fmt(o["r1i5"]),
                            _fmt(None if ref is None else ref.get("r1i5")),
                            _fmt(o["r1i7"]),
                            _fmt(None if ref is None else ref.get("r1i7"))))
        else:
            d5 = o["r1i5"] - float(ref["r1i5"])
            d7 = o["r1i7"] - float(ref["r1i7"])
            # a delta of exactly the bar is within it, whatever the rounding
            within = abs(d5) <= bar + 1e-9 and abs(d7) <= bar + 1e-9
            verdicts.append(within)
            row.update(ref_r1i5=float(ref["r1i5"]), ref_r1i7=float(ref["r1i7"]),
                       delta_r1i5=round(d5, 3), delta_r1i7=round(d7, 3),
                       within_bar=within)
            lines.append("| re%d | %.2f | %.2f | %+.2f | %.2f | %.2f | %+.2f | %s |"
                         % (o["round"], o["r1i5"], row["ref_r1i5"], d5, o["r1i7"],
                            row["ref_r1i7"], d7, "yes" if within else "NO"))
        rows.append(row)
    return {"rounds": rows, "bar": bar, "markdown": "\n".join(lines),
            "all_within_bar": (all(verdicts) if len(verdicts) == len(ours)
                               else None)}


def run_kit(root: str, task: str, resolved: dict, epochs: int, rounds: int,
            max_vlen: int, reference_summary: dict | None, bar: float, out: str,
            mc_droprate: float = 0.0, feature_dtype: str = "float32",
            model_kwargs: dict | None = None, train_kwargs: dict | None = None,
            dry_run: bool = False, device: str = "cuda") -> dict:
    """Stage ``root``, run the loop on ``device``, print the K1/K2
    launches it caused, write the report to ``out`` and return it."""
    stage_root(root, task, resolved)
    summary_name = os.path.join(root, "real_assets_loop_summary.json")
    cwd = os.getcwd()
    try:
        run_loop(root, task, epochs=epochs, rounds=rounds, max_vlen=max_vlen,
                 mc_droprate=mc_droprate, feature_dtype=feature_dtype,
                 summary_name=summary_name, model_kwargs=model_kwargs,
                 train_kwargs=train_kwargs, device=device,
                 extra={"assets": {k: str(v) for k, v in resolved.items()},
                        "dry_run": dry_run})
    finally:
        os.chdir(cwd)      # run_loop works from inside root
    with open(summary_name) as f:
        summary = json.load(f)
    print(json.dumps({"launches": summary["launches"]}), flush=True)
    table = delta_table(summary, reference_summary, bar=bar)
    report = {"task": task, "schedule": {"epochs": epochs, "rounds": rounds},
              "dry_run": dry_run, "device": summary["device"],
              "card": summary["card"], "table": table,
              "launches": summary["launches"], "loop_summary": summary}
    print(table["markdown"])
    status = {True: "PARITY: all rounds within the bar",
              False: "PARITY FAILED: some round exceeds the bar",
              None: "reference numbers pending (--reference-summary)"}
    print(status[table["all_within_bar"]])
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(f"report -> {out}", flush=True)
    return report


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="charades", choices=list(SCHEDULE))
    p.add_argument("--features", help="I3D feature directory (.npy per video)")
    p.add_argument("--glove", help="glove.840B.300d.txt path")
    p.add_argument("--gt-train", default=None,
                   help="GT train.json override (Charades: the reference's "
                        "data omits it)")
    p.add_argument("--re0-train", default=None,
                   help="re0 train.json override (ActivityNet: the reference's "
                        "data omits it)")
    p.add_argument("--data-root", default=None,
                   help="the reference's data directory (<task>_gt/, <task>_re0/)")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "hual_torch_real_assets"))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--mc-droprate", type=float, default=0.0)
    p.add_argument("--feature-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"])
    p.add_argument("--reference-summary", default=None,
                   help="JSON with the reference's numbers per round ({'rounds': "
                        "[{'round', 'r1i5', 'r1i7'}]}); without it the table is "
                        "pending")
    p.add_argument("--bar", type=float, default=0.3,
                   help="parity bar in R@1 points (BASELINE.md)")
    p.add_argument("--dry-run", action="store_true",
                   help="the whole kit on synthetic assets")
    p.add_argument("--n-train", type=int, default=48, help="dry run: train queries")
    p.add_argument("--n-test", type=int, default=16, help="dry run: test queries")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--out", default=None,
                   help="the report (default results/torch_real_assets_parity_"
                        "<task>[_dryrun].json)")
    a = p.parse_args(argv)
    device_of(a.device)
    out = os.path.abspath(a.out or os.path.join(
        REPO, "results", f"torch_real_assets_parity_{a.task}"
        + ("_dryrun" if a.dry_run else "") + ".json"))
    ref_summary = None
    if a.reference_summary:
        with open(a.reference_summary) as f:
            ref_summary = json.load(f)
    train_kwargs = dict(batch_size=16, sweep_backend="fused")
    common = dict(reference_summary=ref_summary, bar=a.bar, out=out,
                  mc_droprate=a.mc_droprate, feature_dtype=a.feature_dtype,
                  train_kwargs=train_kwargs, device=a.device)

    if a.dry_run:
        from make_synthetic_data import make_dataset

        synth = os.path.join(a.root, "synthetic_assets")
        if not os.path.exists(os.path.join(synth, "data", f"{a.task}_re0")):
            make_dataset(synth, task=a.task, n_train=a.n_train, n_test=a.n_test,
                         vdim=DRY_RUN["vdim"], max_raw_len=DRY_RUN["max_raw_len"],
                         seed=DRY_RUN["seed"])
        sd = os.path.join(synth, "data")
        resolved = validate_assets(
            a.task, features=os.path.join(sd, "features", f"{a.task}_i3d"),
            glove=os.path.join(sd, "glove", "glove.840B.300d.txt"), data_root=sd)
        run_kit(os.path.join(a.root, "staged"), a.task, resolved,
                epochs=a.epochs or 2, rounds=a.rounds or 1,
                max_vlen=DRY_RUN["max_vlen"], model_kwargs=DRY_RUN["model"],
                dry_run=True, **common)
        return 0

    if not (a.features and a.glove and a.data_root):
        p.error("--features, --glove and --data-root are required (or --dry-run)")
    sched = SCHEDULE[a.task]
    resolved = validate_assets(a.task, a.features, a.glove, a.data_root,
                               gt_train=a.gt_train, re0_train=a.re0_train)
    run_kit(a.root, a.task, resolved, epochs=a.epochs or sched["epochs"],
            rounds=a.rounds or sched["rounds"], max_vlen=sched["max_vlen"], **common)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
