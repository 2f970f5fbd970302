#!/usr/bin/env python
"""The full HUAL loop at exact reference scale on synthetic data, on the card.

The port's counterpart of tools/full_loop_demo.py: the reference's whole
workflow end to end (reference run_charades.py / run_anet.py: re0 train +
infer, then rounds of update-labels -> train -> infer) at the real dataset
scale with synthetic features, through ``hual_tpu_torch.cli`` and
``hual_tpu_torch.orchestrate.run_rounds``, with per-stage wall times: the
direct measurement of the "full Charades loop < 1 h" target.  SeqPAN runs
with ``span_decode: pallas`` (K1) and ``--sweep-backend`` (``fused`` by
default: K2 in every test and inference batch).

Writes results/torch_full_loop_demo.json (``--out``).

    python tools/torch_full_loop_demo.py --root /tmp/fullscale            # charades
    python tools/torch_full_loop_demo.py --task anet --root /tmp/anetscale
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_synthetic_data import make_dataset  # noqa: E402
from torch_tool_common import (add_common_flags, device_info,  # noqa: E402
                               device_of, launches, reset_launches)

from hual_tpu_torch import cli, orchestrate  # noqa: E402
from hual_tpu_torch.config import Config  # noqa: E402

# reference scales: dataset sizes counted from data/*_gt (SURVEY.md §6),
# train budgets from configs/{charades,anet}/SeqPAN.yaml:11-18, round counts
# from run_charades.py:9 / run_anet.py:9.  ActivityNet Captions averages
# several moments per video, hence queries_per_video=3.
TASK_DEFAULTS = {
    "charades": dict(n_train=12403, n_test=3720, epochs=50, rounds=3,
                     max_vlen=64, queries_per_video=1),
    "anet": dict(n_train=33721, n_test=17031, epochs=100, rounds=4,
                 max_vlen=100, queries_per_video=3),
}
# SeqPAN's widths (configs/charades/SeqPAN.yaml; the tests narrow them)
MODEL = dict(max_tlen=30, vdim=1024, dim=128, num_heads=8, word_dim=300,
             char_dim=50, attn_layer=2)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "hual_torch_fullscale"))
    p.add_argument("--task", default="charades", choices=list(TASK_DEFAULTS))
    p.add_argument("--n-train", type=int, default=None)
    p.add_argument("--n-test", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--mc-droprate", type=float, default=0.0,
                   help="MC-dropout rate of the inference passes (0.0 = "
                        "reference-shipped behavior; 0.5 = the paper's "
                        "intended true-MC uncertainty)")
    p.add_argument("--feature-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="storage dtype of the device-resident feature table")
    p.add_argument("--point-strategy", default="uncertainty",
                   choices=["uncertainty", "random", "dichotomy"],
                   help="observation-point strategy (the paper's ablation)")
    p.add_argument("--selection", default="half", choices=["half", "all"],
                   help="per-round annotation budget")
    p.add_argument("--sweep-backend", default="fused", choices=["fused", "flax"])
    add_common_flags(p, "full_loop_demo")
    a = p.parse_args(argv)
    device_of(a.device)
    d = TASK_DEFAULTS[a.task]
    n_train = a.n_train if a.n_train is not None else d["n_train"]
    n_test = a.n_test if a.n_test is not None else d["n_test"]
    epochs = a.epochs if a.epochs is not None else d["epochs"]
    rounds = a.rounds if a.rounds is not None else d["rounds"]

    times = {}
    t0 = time.time()
    if not os.path.exists(os.path.join(a.root, "data", f"{a.task}_re0")):
        make_dataset(a.root, task=a.task, n_train=n_train, n_test=n_test,
                     vdim=MODEL["vdim"], max_raw_len=2 * d["max_vlen"], seed=7,
                     queries_per_video=d["queries_per_video"])
    times["datagen_s"] = time.time() - t0

    rc = run_loop(a.root, a.task, epochs=epochs, rounds=rounds,
                  max_vlen=d["max_vlen"], mc_droprate=a.mc_droprate,
                  feature_dtype=a.feature_dtype, times=times,
                  summary_name=os.path.abspath(a.out),
                  point_strategy=a.point_strategy, selection=a.selection,
                  train_kwargs={"sweep_backend": a.sweep_backend},
                  device=a.device)
    print(json.dumps({"launches": launches()}), flush=True)
    return rc


@contextlib.contextmanager
def stage_timer(stages: list):
    """Within the block, each round ``run_rounds`` drives appends
    ``{"update_s", "train_s", "infer_s"}`` and the launches each stage
    caused to ``stages``."""
    real_update, real_build = orchestrate.update_labels, cli.build_trainer

    def timed(name, fn):
        def run(*args, **kw):
            before, t0 = launches(), time.time()
            out = fn(*args, **kw)
            if name == "update":
                stages.append({})
            stages[-1][f"{name}_s"] = time.time() - t0
            stages[-1][f"{name}_launches"] = {k: v - before[k]
                                              for k, v in launches().items()}
            return out
        return run

    def build(*args, **kw):
        tr = real_build(*args, **kw)
        tr.train = timed("train", tr.train)
        tr.infer_trainset = timed("infer", tr.infer_trainset)
        return tr

    orchestrate.update_labels = timed("update", real_update)
    cli.build_trainer = build
    try:
        yield stages
    finally:
        orchestrate.update_labels, cli.build_trainer = real_update, real_build


def run_loop(root: str, task: str, epochs: int, rounds: int, max_vlen: int,
             mc_droprate: float = 0.0, feature_dtype: str = "float32",
             times: dict | None = None,
             summary_name: str = "torch_full_loop_summary.json",
             extra: dict | None = None,
             model_kwargs: dict | None = None,
             train_kwargs: dict | None = None,
             point_strategy: str = "uncertainty",
             selection: str = "half",
             strategy_seed: int = 12345,
             device: str = "cuda") -> int:
    """Run the complete HUAL loop (re0 train+infer, then ``rounds`` rounds
    of update -> train -> infer) over the dataset laid out under
    ``<root>/data``, on ``device``.  ``model_kwargs``/``train_kwargs``
    override individual ModelConfig/TrainConfig fields;
    ``point_strategy``/``selection`` are the paper's ablation axes
    (orchestrate.run_rounds); ``summary_name`` is the summary's JSON file
    (relative to ``root`` unless absolute).  The launch counters are reset
    at the start, so the summary's ``launches`` are this loop's alone; the
    caller prints its tool's one ``{"launches": ...}`` line."""
    times = {} if times is None else times
    device = str(device_of(device))
    reset_launches()
    t_all = time.time()
    os.chdir(root)
    train_cfg = dict(epochs=epochs, batch_size=16, lr=1e-4, droprate=0.2,
                     clip_norm=1.0, mc_droprate=mc_droprate)
    train_cfg.update(train_kwargs or {})
    model_cfg = dict(max_vlen=max_vlen, **MODEL, feature_dtype=feature_dtype,
                     span_decode="pallas")
    model_cfg.update(model_kwargs or {})
    base = Config.from_dict({
        "task": task,
        "paths": {"ckpt_dir": "./ckpt", "cache_dir": "./data_pkl/",
                  "feature_path": f"./data/features/{task}_i3d",
                  "glove_path": "./data/glove/glove.840B.300d.txt",
                  "train_path": f"./data/{task}_gt/train.json",
                  "test_path": f"./data/{task}_gt/test.json"},
        "train": train_cfg, "model": model_cfg})
    base_path = f"configs/{task}/SeqPAN.yaml"
    base.save(base_path)

    # --- round 0: train on the initial pseudo labels + infer the train set
    t0 = time.time()
    trainer = cli.build_trainer(base.derive_round(0), device=device)
    trainer.init_state()
    best0 = trainer.train()
    times["re0_train_s"] = time.time() - t0
    t0 = time.time()
    trainer.restore()
    infer0 = trainer.infer_trainset(save_path=f"./results/{task}/re0.pkl")
    times["re0_infer_s"] = time.time() - t0
    re0_launches = launches()
    warm = {"features": trainer.features,
            "device_features": trainer.export_device_features(),
            "dataset": trainer.dataset}
    trainer.close()
    del trainer

    # --- rounds 1..N (reuse round 0's feature table + tokenized corpus)
    t0 = time.time()
    with stage_timer([]) as stages:
        history = orchestrate.run_rounds(task, rounds=rounds,
                                         base_config_path=base_path,
                                         warm_start=warm,
                                         point_strategy=point_strategy,
                                         selection=selection,
                                         strategy_seed=strategy_seed,
                                         device=device)
    times["rounds_1_to_N_s"] = time.time() - t0
    times["total_loop_s"] = time.time() - t_all
    times["total_loop_min"] = times["total_loop_s"] / 60

    summary = {
        **device_info(device_of(device)),
        "task": task,
        "point_strategy": point_strategy,
        "selection": selection,
        "sweep_backend": train_cfg.get("sweep_backend", "flax"),
        "times": times,
        "round_stages": stages,
        "re0_launches": re0_launches,
        "re0_best": {k: v for k, v in best0.items() if not k.endswith("_line")},
        "re0_infer": infer0,
        "rounds": [
            {"round": h["round"],
             "pseudo_miou": h["label_stats"]["new_miou"],
             "best_r1i7": h["best"].get("r1i7"),
             "test": h["best"].get("test_metrics"),
             # AL-selection diagnostics (engine.renew_dataset/update_labels)
             "diagnostics": {k: h["label_stats"][k]
                             for k in ("n_selected", "n_pos", "n_neg",
                                       "new_miou_annotated",
                                       "new_miou_untouched",
                                       "miou_selected_before",
                                       "miou_selected_after",
                                       "miou_pos_idx", "miou_neg_idx",
                                       "miou_pos_idx_before",
                                       "miou_neg_idx_before",
                                       "n_improved", "n_worsened",
                                       "selection_overlap_prev")
                             if k in h["label_stats"]}}
            for h in history
        ],
        "launches": launches(),
    }
    if extra:
        summary.update(extra)
    print(json.dumps(summary, indent=2, default=float), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(summary_name)), exist_ok=True)
    with open(summary_name, "w") as f:
        json.dump(summary, f, indent=2, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
