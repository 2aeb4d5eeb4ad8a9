"""Score a folder of predicted masks against ground-truth masks, ported
from ``ddti_tpu/eval/folder_eval.py`` (host numpy, PIL and scipy; the same
rules, line for line).

Powers ``cli/infer --mask_dir``: after the infer CLI writes
``<stem>_pred.png`` masks, this evaluates them against
``<mask_dir>/<stem>_mask.*``, so any checkpoint the infer CLI runs is
scorable on any labeled folder without a Trainer or run directory.

Conventions: predictions binarize at >127 of the 0-255 PNG (the infer
CLI's binary masks are 0/255; ``--prob`` maps score at the operating
threshold, ``--threshold`` x 255, upstream), ground truth at >127 (i.e.
0.5, not the training harness's ``> 0``, which would count JPEG
compression noise as foreground on raw mask files). Global metrics
micro-average over all pixels (the reference test() formula); HD95/ASSD
use the medpy conventions of ``eval/surface.py`` through its scipy oracle,
because each file may have its own shape.
"""

from __future__ import annotations

import math
import os


def evaluate_predictions(pred_dir: str, mask_dir: str,
                         surface: bool = True,
                         pred_thresh255: float = 127.0) -> tuple[dict, list]:
    """Returns (summary, per_image_rows). Pairs ``<stem>_pred.png`` in
    ``pred_dir`` with ``<stem>_mask.*`` in ``mask_dir``; unmatched or
    shape-mismatched files are reported in ``summary['skipped']``.
    ``pred_thresh255`` is the prediction binarization point on the 0-255
    PNG scale (soft ``--prob`` maps score at their operating threshold)."""
    import numpy as np
    from PIL import Image

    from ddti_tpu_torch.eval.metrics import metrics_from_counts

    masks = {}
    for f in sorted(os.listdir(mask_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in (".jpg", ".jpeg", ".png", ".bmp") and \
                stem.endswith("_mask"):
            masks[stem[:-len("_mask")]] = f

    rows, skipped = [], []
    tot = dict(tp=0, fp=0, fn=0, tn=0)
    for f in sorted(os.listdir(pred_dir)):
        if not f.endswith("_pred.png"):
            continue
        stem = f[:-len("_pred.png")]
        if stem not in masks:
            skipped.append((f, "no mask"))
            continue
        pred = np.asarray(Image.open(os.path.join(pred_dir, f))
                          .convert("L")) > pred_thresh255
        gt = np.asarray(Image.open(os.path.join(mask_dir, masks[stem]))
                        .convert("L")) > 127
        if pred.shape != gt.shape:
            skipped.append((f, f"shape {pred.shape} vs {gt.shape}"))
            continue
        tp = int(np.sum(pred & gt))
        fp = int(np.sum(pred & ~gt))
        fn = int(np.sum(~pred & gt))
        tn = int(np.sum(~pred & ~gt))
        union = tp + fp + fn
        row = {
            "name": stem,
            "iou": tp / union if union else float("nan"),
            "dice": 2 * tp / (2 * tp + fp + fn) if union else float("nan"),
            "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        }
        if surface:
            from ddti_tpu_torch.eval.surface import (
                surface_distance_stats_oracle,
            )
            sd = surface_distance_stats_oracle(pred, gt)
            row["hd95"], row["assd"] = sd["hd95"], sd["assd"]
        for k in tot:
            tot[k] += row[k]
        rows.append(row)

    summary = {"images": len(rows), "skipped": skipped}
    if rows:
        summary.update(metrics_from_counts(**tot))
        ious = [r["iou"] for r in rows if not math.isnan(r["iou"])]
        if ious:
            summary["iou_per_image_mean"] = float(np.mean(ious))
            summary["iou_per_image_median"] = float(np.median(ious))
        if surface:
            sds = [(r["hd95"], r["assd"]) for r in rows
                   if not math.isnan(r["hd95"])]
            if sds:
                summary["hd95_mean"] = float(np.mean([s[0] for s in sds]))
                summary["assd_mean"] = float(np.mean([s[1] for s in sds]))
                summary["surface_valid_images"] = len(sds)
    rows.sort(key=lambda r: (math.isnan(r["iou"]), r["iou"]))
    return summary, rows


def write_eval_artifacts(out_dir: str, summary: dict, rows: list) -> str:
    """``eval_metrics.json`` + ``per_image_metrics.csv`` into ``out_dir``;
    returns a one-line human summary."""
    import csv
    import json

    with open(os.path.join(out_dir, "eval_metrics.json"), "w") as f:
        json.dump({k: v for k, v in summary.items() if k != "skipped"},
                  f, indent=1)
    if rows:
        with open(os.path.join(out_dir, "per_image_metrics.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    line = (f"eval vs {summary['images']} masks: "
            f"IoU={summary.get('iou', float('nan')):.4f} "
            f"F1={summary.get('f1', float('nan')):.4f}")
    if "hd95_mean" in summary:
        line += (f" HD95={summary['hd95_mean']:.2f} "
                 f"ASSD={summary['assd_mean']:.2f}")
    if summary["skipped"]:
        line += f" ({len(summary['skipped'])} skipped)"
    return line
