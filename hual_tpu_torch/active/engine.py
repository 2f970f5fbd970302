"""The HUAL round engine (counterpart of ``hual_tpu/active/engine.py``;
reference update_label.py:125-238): rank uncertainty, simulate one binary
annotation for the selected half, regenerate pseudo labels.

Host NumPy, as in the counterpart: given the same records and round
pickle it writes the same ``train.json``, byte for byte.  As there:

  * model uncertainty is one array op over the whole train set;
  * the ranking is stable-sorted once (the reference re-sorted inside its
    append loop, with the same result);
  * the ascending-uncertainty selection of ceil(N/2) samples
    (update_label.py:185), the argmax-uncertainty observation point, the
    oracle's answer and the renewal math are the reference's.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from hual_tpu_torch.active.coefficients import F_RENEW, RoundCoeffs, get_coff
from hual_tpu_torch.active.renew import append_annotation, renew_label
from hual_tpu_torch.active.uncertainty import (distance_score, fill_isactivate,
                                               model_uncertainty_batch,
                                               sigmoid, zero_runs)
from hual_tpu_torch.utils.io import load_json, load_pickle, save_json
from hual_tpu_torch.utils.metrics import (calculate_iou, index_to_time_al,
                                          miou_two_record_lists,
                                          time_to_index_al)


def _stack_padded(rows: list) -> np.ndarray:
    """Rows of one pickle field as an (N, max width) array.  Reference-written
    pickles pad logits to each batch's max v_len (reference
    utils/data_utils.py:158-172), so rows can be ragged; zeros past a row's
    width never count, because the uncertainty is zeroed past each v_len and
    both MC passes pad alike."""
    rows = [np.asarray(r) for r in rows]
    width = max(r.shape[0] for r in rows)
    # one dtype argument per distinct dtype: NumPy 1.x caps result_type at
    # 32 arguments
    out = np.zeros((len(rows), width),
                   dtype=np.result_type(*{r.dtype for r in rows}))
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def rank_uncertainty(data_old: list, data_gt: list, last_prop: list,
                     coff: RoundCoeffs) -> list[dict]:
    """Per-sample acquisition records sorted ascending by video uncertainty
    (reference get_uncert_rank, update_label.py:125-169)."""
    n = len(data_old)
    if len(last_prop) != n or len(data_gt) != n:
        raise ValueError(f"{n} records, {len(data_gt)} GT records and "
                         f"{len(last_prop)} pickle rows")

    s1 = _stack_padded([p["prop_logits1"][0] for p in last_prop])
    e1 = _stack_padded([p["prop_logits1"][1] for p in last_prop])
    s2 = _stack_padded([p["prop_logits2"][0] for p in last_prop])
    e2 = _stack_padded([p["prop_logits2"][1] for p in last_prop])
    vlens = np.asarray([p["v_len"] for p in last_prop])
    uncert_model = model_uncertainty_batch(s1, e1, s2, e2, vlens)   # (N, T)
    uncert_video = uncert_model.sum(axis=1)                          # (N,)

    res = []
    for idx, sample in enumerate(data_old):
        vid, duration = sample[0], sample[1]
        old_ap = sample[4]
        if not vid == last_prop[idx]["vid"] == data_gt[idx][0]:
            raise ValueError(f"record {idx}: vid {vid!r}, pickle "
                             f"{last_prop[idx]['vid']!r}, GT {data_gt[idx][0]!r}")
        vlen = int(last_prop[idx]["v_len"])

        sprob_raw, eprob_raw = last_prop[idx]["prop_logits"]
        sprob = sigmoid(np.asarray(sprob_raw))
        eprob = sigmoid(np.asarray(eprob_raw))
        max_vlen = len(sprob)

        gt_idx = time_to_index_al(list(data_gt[idx][2]), duration, vlen)
        old_idx = time_to_index_al(list(sample[2]), duration, vlen)

        uncert_dist = distance_score(old_ap["pos_idx"], old_ap["neg_idx"],
                                     vlen=vlen, max_vlen=max_vlen)
        uncert_frame = uncert_dist + uncert_model[idx][:max_vlen] * coff.uncert

        res.append({
            "idx": idx, "gt_idx": gt_idx, "old_idx": old_idx, "old_ap": old_ap,
            "vlen": vlen, "max_vlen": max_vlen, "duration": duration,
            "uncert_frame": uncert_frame,
            "uncert_video": float(uncert_video[idx]),
            "sprob": sprob, "eprob": eprob,
        })
    res.sort(key=lambda r: r["uncert_video"])  # ascending, stable
    return res


def choose_observation_point(record: dict, strategy: str,
                             rng: np.random.Generator | None) -> int:
    """Which frame to ask the expert about.

    * ``uncertainty``: argmax of the per-frame acquisition score (the HUAL
      method, reference update_label.py:197);
    * ``random`` / ``dichotomy``: the paper's ablation strategies, whose
      code the reference does not ship: random = a uniform frame in
      [0, vlen) from NumPy's generator (a torch generator would pick other
      frames); dichotomy = the midpoint of the largest unannotated segment.
    """
    if strategy == "uncertainty":
        return int(np.argmax(record["uncert_frame"]))
    if strategy == "random":
        if rng is None:
            raise ValueError("the random strategy needs a generator")
        return int(rng.integers(0, record["vlen"]))
    if strategy == "dichotomy":
        ap = record["old_ap"]
        segs = zero_runs(fill_isactivate(ap["pos_idx"], ap["neg_idx"],
                                         record["vlen"], record["max_vlen"]))
        if not segs:
            return int(record["vlen"] // 2)
        s, e = max(segs, key=lambda se: se[1] - se[0])
        return int((s + e) // 2)
    raise ValueError(f"unknown point strategy '{strategy}'")


def renew_dataset(data_old: list, data_gt: list, last_prop: list,
                  coff: RoundCoeffs, selection: str = "half",
                  point_strategy: str = "uncertainty",
                  seed: int | list = 12345) -> tuple[list, dict]:
    """One full label-update pass; mutates and returns data_old
    (reference update_label.py main, :173-208).

    ``selection``: 'half' annotates the first ceil(N/2) of the
    ascending-uncertainty ranking (reference behavior); 'all' annotates every
    sample each round.
    """
    # first round: attach empty annotation state as the 5th field
    if len(data_old[0]) == 4:
        for rec in data_old:
            rec.append({"pos_idx": [], "neg_idx": []})

    ranking = rank_uncertainty(data_old, data_gt, last_prop, coff)
    rng = np.random.default_rng(seed) if point_strategy == "random" else None
    iou_pos, iou_neg = [], []
    iou_before, iou_after = [], []
    iou_before_pos, iou_before_neg = [], []
    selected_idx = []
    if selection == "half":
        n_select = int(np.ceil(len(ranking) / 2))
    elif selection == "all":
        n_select = len(ranking)
    else:
        raise ValueError(f"unknown selection '{selection}'")
    for record in ranking[:n_select]:
        idx = record["idx"]
        observe_point = choose_observation_point(record, point_strategy, rng)
        new_ap = append_annotation(observe_point, record["old_ap"],
                                   record["gt_idx"])
        new_idx = renew_label(record["old_idx"], new_ap, record["sprob"],
                              record["eprob"], record["vlen"],
                              record["max_vlen"], coff)
        new_time = index_to_time_al(new_idx, record["duration"], record["vlen"])
        data_old[idx][2] = new_time
        data_old[idx][4] = new_ap
        iou = calculate_iou(new_idx, record["gt_idx"])
        (iou_pos if new_ap["pos_idx"] else iou_neg).append(iou)
        selected_idx.append(idx)
        before = calculate_iou(record["old_idx"], record["gt_idx"])
        iou_before.append(before)
        iou_after.append(iou)
        (iou_before_pos if new_ap["pos_idx"]
         else iou_before_neg).append(before)
    # round diagnostics (index granularity, AL convention): did renewal help
    # the records it touched?  n_pos/n_neg split by whether the expert's
    # answers left any positive point
    iou_before = np.asarray(iou_before)
    iou_after = np.asarray(iou_after)
    stats = {
        "n_selected": n_select,
        "n_pos": len(iou_pos), "n_neg": len(iou_neg),
        "miou_pos_idx": float(np.mean(iou_pos)) if iou_pos else 0.0,
        "miou_neg_idx": float(np.mean(iou_neg)) if iou_neg else 0.0,
        "miou_pos_idx_before": (float(np.mean(iou_before_pos))
                                if iou_before_pos else 0.0),
        "miou_neg_idx_before": (float(np.mean(iou_before_neg))
                                if iou_before_neg else 0.0),
        "selected_idx": selected_idx,
        "miou_selected_before": (float(iou_before.mean()) if n_select else 0.0),
        "miou_selected_after": (float(iou_after.mean()) if n_select else 0.0),
        "n_improved": int(np.sum(iou_after > iou_before + 1e-9)),
        "n_worsened": int(np.sum(iou_after < iou_before - 1e-9)),
    }
    return data_old, stats


def update_labels(task: str, round_idx: int, data_root: str = "./data",
                  results_root: str = "./results",
                  table: dict = F_RENEW, selection: str = "half",
                  point_strategy: str = "uncertainty",
                  seed: int = 12345) -> dict:
    """File-level round driver (reference update_label.py:220-238): reads the
    previous round's train.json + prediction pickle + GT, writes the next
    round's train.json, copies GT test.json, reports pseudo-label mIoU."""
    coff = get_coff(table, task, round_idx)
    old_path = os.path.join(data_root, f"{task}_re{round_idx - 1}", "train.json")
    new_path = os.path.join(data_root, f"{task}_re{round_idx}", "train.json")
    prop_path = os.path.join(results_root, task, f"re{round_idx - 1}.pkl")
    gt_path = os.path.join(data_root, f"{task}_gt", "train.json")

    data_old = load_json(old_path)
    data_gt = load_json(gt_path)
    last_prop = load_pickle(prop_path)

    old_miou = miou_two_record_lists(data_gt, data_old)
    # the round index is folded into the random strategy's seed: at
    # mc_droprate 0 the ranking keeps the dataset order, and one seed for
    # every round would draw the same frames again (duplicate points)
    data_new, stats = renew_dataset(data_old, data_gt, last_prop, coff,
                                    selection=selection,
                                    point_strategy=point_strategy,
                                    seed=[seed, round_idx])

    os.makedirs(os.path.dirname(new_path), exist_ok=True)
    save_json(data_new, new_path)
    # the GT test.json goes into the round dir (reference cp_testjson,
    # utils/utils_hual.py:174-177)
    shutil.copy(os.path.join(os.path.dirname(gt_path), "test.json"),
                os.path.join(os.path.dirname(new_path), "test.json"))

    new_miou = miou_two_record_lists(data_gt, data_new)
    # pseudo-mIoU of this round's annotated and untouched records (time
    # granularity, as old/new_miou): how much of a round's move the renewal
    # itself made
    sel = set(stats["selected_idx"])
    annotated = [i for i in range(len(data_new)) if i in sel]
    untouched = [i for i in range(len(data_new)) if i not in sel]
    stats.update(
        old_miou=old_miou, new_miou=new_miou,
        new_miou_annotated=(miou_two_record_lists(
            [data_gt[i] for i in annotated], [data_new[i] for i in annotated])
            if annotated else 0.0),
        new_miou_untouched=(miou_two_record_lists(
            [data_gt[i] for i in untouched], [data_new[i] for i in untouched])
            if untouched else 0.0),
        old_path=old_path, new_path=new_path)
    print(f"mIoU[GT, pseudo]:\n{old_miou:.4f} -> {new_miou:.4f}")
    return stats
