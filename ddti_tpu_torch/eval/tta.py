"""Flip test-time augmentation (TTA), ported from ``ddti_tpu/eval/tta.py``.

The model's sigmoid probabilities are averaged over the four axis-flip
variants of each image (identity, horizontal, vertical, both) and folded
back into one logit map. Flips are exact symmetries of the ultrasound
geometry; 90-degree rotations are not (they would turn the probe axis).

Four forwards, one per flip, as JAX runs them; a TransUNet launches the
flash forward once per encoder layer in each. Layouts at the public
functions are NHWC, as everywhere in the port; the mean is float32.
"""

from __future__ import annotations

from typing import Callable

import torch

# NHWC: axis 1 flips vertically (H), axis 2 horizontally (W).
FLIP_AXES = ((), (2,), (1,), (1, 2))
# the clamp of tta_logits (and of the infer CLI's ensemble): a +/-16.1
# logit bound that keeps saturated probabilities finite
PROB_EPS = 1e-7


def tta_probs(forward: Callable[[torch.Tensor], torch.Tensor],
              images: torch.Tensor, flip=torch.flip) -> torch.Tensor:
    """Mean sigmoid probability over the 4 flip variants.

    ``forward(images_nhwc) -> logits_nhwc`` is the model's logit map;
    outputs are un-flipped back to the input frame before averaging.
    ``flip(x, axes)`` flips (``parallel.spatial.flip`` on bands of rows).
    Returns float32 probabilities in [0, 1]."""
    total = None
    for axes in FLIP_AXES:
        x = flip(images, axes) if axes else images
        p = torch.sigmoid(forward(x).to(torch.float32))
        p = flip(p, axes) if axes else p
        total = p if total is None else total + p
    return total / len(FLIP_AXES)


def logit_of_mean(p: torch.Tensor) -> torch.Tensor:
    """log(p / (1 - p)) of probabilities clamped to [PROB_EPS, 1 -
    PROB_EPS], so a saturated pixel keeps a finite logit: the
    sliding-window blend averages these, and an infinity there would
    override every overlapping tile (inf - inf is NaN)."""
    p = torch.clamp(p, PROB_EPS, 1.0 - PROB_EPS)
    return torch.log(p) - torch.log1p(-p)


def tta_logits(forward: Callable[[torch.Tensor], torch.Tensor],
               images: torch.Tensor, flip=torch.flip) -> torch.Tensor:
    """The flip ensemble as a logit map, logit(mean probability).

    ``sigmoid(tta_logits(...)) == tta_probs(...)`` up to the clamp, so any
    consumer that thresholds ``sigmoid(logits)`` (confusion counts,
    ``serve_body``, the sliding-window blend) gets the ensembled
    prediction unchanged."""
    return logit_of_mean(tta_probs(forward, images, flip))
