"""In-process HUAL round loop (counterpart of ``hual_tpu/orchestrate.py``).

For each round I, as plain function calls on the CUDA card: update the
labels from round I-1's pickle, derive round I's config, train, restore the
best checkpoint and infer the train set into round I's pickle.  It resumes
at round granularity (``start_round``) and at epoch granularity (the
trainer's ``<model_dir>/state.pt``), and reuses the feature table on the
card across rounds.  Round 0 (train and infer on the initial pseudo
labels) is the CLI's ``--suffix re0`` train and infer_trainset.

    python -m hual_tpu_torch.orchestrate charades            # rounds 1..3
    python -m hual_tpu_torch.orchestrate anet --rounds 4
    python -m hual_tpu_torch.orchestrate charades --deterministic

``--deterministic`` turns on deterministic mode
(``runtime/debug.enable_deterministic``), under which a round resumed from
its ``state.pt`` replays the uninterrupted one bit for bit.

Data parallel under ``torchrun`` (see ``cli``):

    torchrun --nproc_per_node=N -m hual_tpu_torch.orchestrate charades

Every rank trains and infers on its rows of each batch (``parallel/``);
rank 0 alone updates the labels (``train.json``) and writes the round's
YAML, the summary and the checkpoints, the other ranks waiting at a
barrier and then reading them.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch.distributed as dist

from hual_tpu_torch import cli
from hual_tpu_torch.active.engine import update_labels
from hual_tpu_torch.config import Config
from hual_tpu_torch.parallel import Mesh
from hual_tpu_torch.runtime.debug import enable_deterministic
from hual_tpu_torch.runtime.logger import get_logger

DEFAULT_ROUNDS = {"charades": 3, "anet": 4}
DEFAULT_CONFIGS = {
    "charades": "./configs/charades/SeqPAN.yaml",
    "anet": "./configs/anet/SeqPAN.yaml",
}


def run_rounds(task: str, rounds: int | None = None,
               base_config_path: str | None = None,
               start_round: int = 1, data_root: str = "./data",
               results_root: str = "./results",
               max_retries: int = 1,
               warm_start: dict | None = None,
               point_strategy: str = "uncertainty",
               selection: str = "half",
               strategy_seed: int = 12345,
               device: str = "cuda",
               mesh: Optional[Mesh] = None) -> list[dict]:
    """The HUAL loop from ``start_round`` to ``rounds``; returns per-round
    label stats and metrics, also written to
    ``<results_root>/<task>/rounds_summary.json``.

    ``point_strategy`` / ``selection`` are the paper's ablation axes
    (uncertainty|random|dichotomy x half|all); the defaults are the
    reference method.  ``strategy_seed`` seeds the 'random' strategy only.

    A round that raises is retried up to ``max_retries`` times, then the
    loop stops; completed rounds stay on disk, so a stopped loop resumes
    with ``start_round=<next>`` and keeps the earlier rounds' summary
    records.  With ``train.save_state_every > 0`` a retry (or a fresh
    process) resumes the round from its last saved epoch, on the
    uninterrupted run's trajectory.

    ``warm_start`` seeds the cross-round reuse from a round-0 trainer:
    ``{"features": t.features, "device_features":
    t.export_device_features(), "dataset": t.dataset}``, so round 1 neither
    uploads the table again nor re-tokenizes the corpus.

    Under ``mesh`` (a ``parallel.Mesh`` on a process group) every rank runs
    the loop; rank 0 alone writes the labels, the configs, the summary and
    the checkpoints, and every rank returns the same history.
    """
    rounds = rounds or DEFAULT_ROUNDS.get(task, 3)
    base_config_path = base_config_path or DEFAULT_CONFIGS[task]
    base = Config.load(base_config_path)
    writer = mesh is None or mesh.is_writer
    logger = get_logger(f"./logs/{task}", "rounds", to_file=writer)
    summary_path = os.path.join(results_root, task, "rounds_summary.json")
    history = []
    if start_round > 1 and os.path.exists(summary_path):
        # the summary is rewritten whole after each round: keep the records
        # of the rounds done before the resume
        with open(summary_path) as f:
            history = [h for h in json.load(f)
                       if h.get("round", 0) < start_round]
    shared: dict = dict(warm_start) if warm_start else {}

    for round_idx in range(start_round, rounds + 1):
        for attempt in range(max_retries + 1):
            try:
                _run_one_round(task, round_idx, base, base_config_path,
                               data_root, results_root, logger, history,
                               shared, point_strategy=point_strategy,
                               selection=selection, strategy_seed=strategy_seed,
                               device=device, mesh=mesh)
                break
            except Exception:
                logger.exception(f"round re{round_idx} attempt {attempt} failed")
                if attempt == max_retries:
                    raise
        if writer:
            os.makedirs(os.path.dirname(summary_path), exist_ok=True)
            with open(summary_path, "w") as f:
                json.dump(history, f, indent=2)
    return history


def _run_one_round(task, round_idx, base, base_config_path, data_root,
                   results_root, logger, history, shared=None,
                   point_strategy: str = "uncertainty",
                   selection: str = "half",
                   strategy_seed: int = 12345,
                   device: str = "cuda", mesh: Optional[Mesh] = None) -> None:
    shared = {} if shared is None else shared
    writer = mesh is None or mesh.is_writer

    logger.info(f"=== round re{round_idx}: update labels "
                f"({point_strategy}/{selection}) ===")
    cfg = base.derive_round(round_idx, data_root=data_root)
    stem, ext = os.path.splitext(base_config_path)
    with cli.writer_first(mesh):
        # rank 0 writes the labels (train.json) and the derived config next
        # to the base one (reference generate_configs writes
        # SeqPAN_re<I>.yaml); every rank reads them after
        stats = (update_labels(task, round_idx, data_root=data_root,
                               results_root=results_root,
                               point_strategy=point_strategy,
                               selection=selection, seed=strategy_seed)
                 if writer else None)
        if writer:
            cfg.save(f"{stem}_re{round_idx}{ext}")
    if mesh is not None:
        box = [stats]
        dist.broadcast_object_list(box, src=0)
        stats = box[0]
    logger.info(f"pseudo-label mIoU {stats['old_miou']:.4f} -> "
                f"{stats['new_miou']:.4f}")
    # the share of this round's annotated records that round I-1 annotated
    # too; history keeps the share, not the index list
    selected = stats.pop("selected_idx", None)
    if selected is not None:
        selected = set(selected)
        prev = shared.get("prev_selected_idx")
        if prev is not None and selected:
            stats["selection_overlap_prev"] = round(
                len(selected & prev) / len(selected), 4)
        # committed to `shared` only at the end of the round, so a retry
        # compares against round I-1, not against its own first attempt

    logger.info(f"=== round re{round_idx}: train ===")
    # the reused table and tokenized dataset hold for one feature set and
    # padding bound only: drop them when (feature_path, max_vlen) changes
    feat_key = (cfg.paths.feature_path, cfg.model.max_vlen)
    if shared.get("feat_key") not in (None, feat_key):
        shared.pop("features", None)
        shared.pop("device_features", None)
        shared.pop("dataset", None)
    trainer = cli.build_trainer(cfg, features=shared.get("features"),
                                device_features=shared.get("device_features"),
                                base_dataset=shared.get("dataset"),
                                device=device,
                                **({} if mesh is None else {"mesh": mesh}))
    shared["features"] = trainer.features
    shared["device_features"] = trainer.export_device_features()
    shared["dataset"] = trainer.dataset
    shared["feat_key"] = feat_key
    trainer.init_state()
    # epoch resume: an attempt that stopped left train()'s periodic state
    # save under this round's model_dir (per suffix, so it can only be this
    # round's); it is removed once the round completes
    state_path = os.path.join(os.path.abspath(cfg.model_dir()), "state.pt")
    if os.path.exists(state_path):
        trainer.load_state(state_path)
        logger.info(f"resuming re{round_idx} from {state_path} "
                    f"(epoch {trainer.state.epoch})")
    best = trainer.train()
    if writer and os.path.exists(state_path):
        os.remove(state_path)

    logger.info(f"=== round re{round_idx}: infer train set ===")
    trainer.restore()
    infer_metrics = trainer.infer_trainset(
        save_path=os.path.join(results_root, task, f"re{round_idx}.pkl"))
    trainer.close()

    history.append({"round": round_idx, "label_stats": stats,
                    "best": {k: v for k, v in best.items()
                             if not k.endswith("_line")},
                    "infer": infer_metrics})
    if selected is not None:
        shared["prev_selected_idx"] = selected


def main(argv=None, *, device: Optional[str] = None,
         init_method: Optional[str] = None) -> int:
    """The command line; ``device`` and ``init_method`` as ``cli.main``'s."""
    parser = argparse.ArgumentParser()
    parser.add_argument("task", choices=["charades", "anet"])
    parser.add_argument("--rounds", type=int, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--start-round", type=int, default=1)
    parser.add_argument("--point-strategy", type=str, default="uncertainty",
                        choices=["uncertainty", "random", "dichotomy"],
                        help="ablation axis: which frame to ask the expert about")
    parser.add_argument("--selection", type=str, default="half",
                        choices=["half", "all"],
                        help="ablation axis: annotate the uncertain half "
                             "(reference) or every sample")
    parser.add_argument("--strategy-seed", type=int, default=12345,
                        help="seed for the 'random' point strategy")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic algorithms, so a resumed round "
                             "replays the uninterrupted one bit for bit")
    args = parser.parse_args(argv)
    if args.deterministic:
        enable_deterministic()
    mesh = cli.init_distributed(device or "cuda", init_method)
    try:
        run_rounds(args.task, rounds=args.rounds, base_config_path=args.config,
                   start_round=args.start_round,
                   point_strategy=args.point_strategy, selection=args.selection,
                   strategy_seed=args.strategy_seed,
                   **cli.trainer_kwargs(mesh, device))
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
