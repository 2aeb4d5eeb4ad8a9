"""Confusion-matrix heatmap, a copy of ``ddti_tpu/eval/confusion.py`` (a
working version of the reference's dead ``save_confusion_matrix``): for
binary segmentation a 2 x 2 matrix over pixel classes (background,
nodule). Needs matplotlib; the Trainer's periodic call, like the JAX
Trainer's, skips the plot where that fails."""

from __future__ import annotations

import os

import numpy as np


def save_confusion_matrix(tp: float, fp: float, fn: float, tn: float,
                          result_dir: str, epoch: int,
                          class_names=("background", "nodule")) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.array([[tn, fp], [fn, tp]], dtype=np.int64)
    fig, ax = plt.subplots(figsize=(5, 5))
    im = ax.imshow(cm, cmap="Blues")
    for i in range(2):
        for j in range(2):
            ax.text(j, i, f"{cm[i, j]:,}", ha="center", va="center",
                    color="black" if cm[i, j] < cm.max() / 2 else "white")
    ax.set_xticks([0, 1], [f"pred {c}" for c in class_names])
    ax.set_yticks([0, 1], [f"true {c}" for c in class_names])
    ax.set_title("Confusion Matrix")
    fig.colorbar(im, ax=ax, shrink=0.8)
    path = os.path.join(result_dir, f"epoch_{epoch + 1}_confusion_matrix.png")
    fig.savefig(path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path
