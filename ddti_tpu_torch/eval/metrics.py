"""Segmentation metrics, ported from ``ddti_tpu/eval/metrics.py``.

Device side: per-batch confusion counts, so only six numbers per step
reach the host. Host side: the reference's IoU / accuracy / P / R / F1
formulas, with its two sets of zero guards (test vs epoch metrics).

Counts are float64 tensors: exact integers far beyond the 2^24 pixels at
which a float32 count stops being exact (64 frames of 512^2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ConfusionCounts(NamedTuple):
    """Pixel confusion counts under the reference's TWO target-binarization
    conventions (they differ once targets are soft, QUIRKS #9):

    - ``tp/fp/fn/tn``: **int truncation** (numpy ``astype(int)``): a target
      pixel is positive iff t >= 1. The epoch acc/P/R/F1 and every test()
      metric use it.
    - ``inter/union``: **bool** (numpy ``astype(bool)``): positive iff
      t > 0. The epoch IoU (the model-selection metric) uses it.
    """

    tp: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    tn: torch.Tensor
    inter: torch.Tensor
    union: torch.Tensor

    def __add__(self, other):
        return ConfusionCounts(*(a + b for a, b in zip(self, other)))


def confusion_counts(logits: torch.Tensor, targets: torch.Tensor,
                     threshold: float = 0.5,
                     per_image: bool = False) -> ConfusionCounts:
    """pred = sigmoid(logits) > threshold. ``per_image=True`` reduces over
    the non-batch axes only, so each count is an (N,) vector whose sum is
    the global count."""
    dims = tuple(range(1, logits.dim())) if per_image else None
    pred = torch.sigmoid(logits.to(torch.float32)) > threshold
    t = targets.to(torch.float32)
    pos_i = t >= 1.0   # astype(int) truncation semantics on [0, 1] floats
    pos_b = t > 0.0    # astype(bool) semantics

    def count(x):
        if dims is None:
            return x.sum(dtype=torch.float64)
        return x.sum(dim=dims, dtype=torch.float64)

    return ConfusionCounts(
        count(pred & pos_i), count(pred & ~pos_i), count(~pred & pos_i),
        count(~pred & ~pos_i), count(pred & pos_b), count(pred | pos_b))


def metrics_from_counts(tp, fp, fn, tn, eps: float = 1e-8) -> dict:
    """Global micro-averaged pixel metrics (reference test() formulas)."""
    tp, fp, fn, tn = (float(x) for x in (tp, fp, fn, tn))
    acc = (tp + tn) / (tp + tn + fp + fn + eps)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    iou = tp / (tp + fp + fn + eps)
    return {"acc": acc, "precision": precision, "recall": recall,
            "f1": f1, "iou": iou, "tp": tp, "fp": fp, "fn": fn, "tn": tn}


def epoch_metrics_from_counts(counts: ConfusionCounts) -> dict:
    """Train/val epoch metrics from accumulated counts, with the reference's
    guards: acc/P/R/F1 from the int-truncation counts (0.0 on empty
    denominators), IoU from the bool inter/union (NaN when empty)."""
    tp, fp, fn, tn, inter, union = (float(x) for x in counts)
    total = tp + fp + fn + tn
    acc = (tp + tn) / total if total > 0 else 0.0
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    iou = inter / union if union > 0 else float("nan")
    return {"acc": acc, "precision": precision, "recall": recall,
            "f1": f1, "iou": iou}
