"""Train / eval / inference steps, ported from ``ddti_tpu/train/steps.py``.

One train step: uint8 -> float, the augmentation chain, mixup, the forward
pass (under bf16 autocast with ``use_amp_autocast``), all four loss terms
(the boundary term's EDT is the CUDA kernel on the card), backward (a
TransUNet's flash attention through the CUDA backward kernels), the AdamW
update and the confusion counts. The host feeds the batch and the
draws and reads nothing back: the returned metrics stay on the device
until the epoch's end.

A deep-supervision model (ImprovedVNet with ``deep_supervision=True``)
adds the auxiliary heads' loss, weighted by ``config.alpha``
(``_ds_aux_loss``). Only the one-shot step is ported; ``grad_accum``, the
nan-guard, EMA, QAT and distillation raise where the config asks for them
(ROADMAP.md Queue 1 items 9 and 11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddti_tpu_torch.data.augment import (
    AugmentConfig,
    AugmentDraws,
    MixupDraws,
    augment_batch,
    eval_preprocess,
    mixup,
)
from ddti_tpu_torch.eval.metrics import ConfusionCounts, confusion_counts
from ddti_tpu_torch.eval.tta import tta_logits
from ddti_tpu_torch.losses.losses import weighted_loss
from ddti_tpu_torch.ops.resample import resize_bilinear_hw

from .state import TrainState


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    bce: torch.Tensor
    dice: torch.Tensor
    focal: torch.Tensor
    boundary: torch.Tensor
    counts: ConfusionCounts
    n: torch.Tensor


def _to_float(images, masks):
    """uint8 [0, 255] -> float32 [0, 1]; float inputs pass through."""

    def f(x):
        if x.dtype == torch.uint8:
            return x.to(torch.float32) / 255.0
        return x.to(torch.float32)

    return f(images), f(masks)


def _loss_kw(config) -> dict:
    return dict(bce_ratio=config.bce_ratio, dice_ratio=config.dice_ratio,
                focal_ratio=config.focal_ratio,
                boundary_ratio=config.boundary_ratio,
                compute_unused=config.compute_unused_losses)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _forward(model, images, amp: bool):
    """NHWC images -> NHWC logits under bf16 autocast when ``amp``; a
    deep-supervision model's ``(logits, [head logits])`` keeps its form."""
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=amp):
        out = model(images.permute(0, 3, 1, 2))
    if isinstance(out, tuple):
        logits, heads = out
        return _nhwc(logits), [_nhwc(h) for h in heads]
    return _nhwc(out)


def _main_logits(out):
    return out[0] if isinstance(out, tuple) else out


def _ds_aux_loss(out, masks, loss_kw: dict, ds_weight: float):
    """Deep-supervision auxiliary loss (JAX ``_ds_aux_loss``): the same
    weighted loss on each head against the target downscaled to the head's
    size (bilinear, antialiased), the boundary term and the unused terms
    off, so the heads launch no EDT; averaged over the heads and scaled by
    ``ds_weight`` (``--alpha``)."""
    _, heads = out
    kw = dict(loss_kw, boundary_ratio=0.0, compute_unused=False)
    total = masks.new_zeros((), dtype=torch.float32)
    for head in heads:
        m = masks
        if head.shape[1:3] != masks.shape[1:3]:
            m = resize_bilinear_hw(masks[..., 0], head.shape[1],
                                   head.shape[2])[..., None]
        total = total + weighted_loss(head, m, **kw).total
    return ds_weight * total / max(len(heads), 1)


def _check_ported(config) -> None:
    unported = [name for name, on in (
        ("grad_accum", int(getattr(config, "grad_accum", 1) or 1) != 1),
        ("nan_guard", bool(getattr(config, "nan_guard", False))),
        ("ema_decay", float(getattr(config, "ema_decay", 0.0) or 0.0) > 0),
        ("qat", bool(getattr(config, "qat", False))),
        ("distill_checkpoint", bool(getattr(config, "distill_checkpoint",
                                            "")))) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)} is not ported yet (ROADMAP.md Queue 1)")


def make_train_step(config, aug_cfg: AugmentConfig):
    """Build ``step(state, images, masks, draws, mix_draws) ->
    StepMetrics``: uint8 (or float) NHWC batches, the chain's draws, and
    the mixup draws (ignored unless ``config.use_mixup``). Updates
    ``state`` in place."""
    _check_ported(config)
    loss_kw = _loss_kw(config)
    amp = bool(config.use_amp_autocast)
    use_mixup = bool(config.use_mixup)
    ds_weight = float(getattr(config, "alpha", 0.0) or 0.0)

    def step(state: TrainState, images_u8, masks_u8, draws: AugmentDraws,
             mix: MixupDraws | None) -> StepMetrics:
        images, masks = _to_float(images_u8, masks_u8)
        images, masks = augment_batch(images, masks, draws, aug_cfg)
        if use_mixup:
            images, masks = mixup(images, masks, mix)
        model = state.model
        model.train()
        out = _forward(model, images, amp)
        logits = _main_logits(out)
        terms = weighted_loss(logits, masks, **loss_kw)
        if isinstance(out, tuple) and ds_weight > 0:
            terms = terms._replace(total=terms.total + _ds_aux_loss(
                out, masks, loss_kw, ds_weight))
        state.optimizer.zero_grad(set_to_none=True)
        terms.total.backward()
        state.apply_gradients()
        with torch.no_grad():
            counts = confusion_counts(logits, masks)
        n = images.new_full((), float(images.shape[0]))
        return StepMetrics(*(t.detach() for t in terms), counts, n)

    return step


def make_eval_step(config):
    """``step(state, images, masks, valid=None) -> StepMetrics`` (no
    update). ``valid`` (B,) {0, 1} marks the images that are not
    wraparound padding: the counts weight each image by it and ``n`` is
    its sum, so val metrics count every image once; the loss terms stay
    means over the padded batch (QUIRKS #22)."""
    _check_ported(config)
    loss_kw = _loss_kw(config)
    amp = bool(config.use_amp_autocast)
    size = (config.image_size, config.image_size)

    @torch.no_grad()
    def step(state: TrainState, images_u8, masks_u8, valid=None):
        images, masks = _to_float(images_u8, masks_u8)
        images, masks = eval_preprocess(images, masks, size)
        state.model.eval()
        logits = _main_logits(_forward(state.model, images, amp))
        terms = weighted_loss(logits, masks, **loss_kw)
        if valid is None:
            counts = confusion_counts(logits, masks)
            n = images.new_full((), float(images.shape[0]))
        else:
            per_img = confusion_counts(logits, masks, per_image=True)
            counts = ConfusionCounts(*((v * valid).sum() for v in per_img))
            n = valid.sum()
        return StepMetrics(*terms, counts, n)

    return step


def make_infer_step(config, threshold: float = 0.5):
    """``step(state, images, masks) -> (images_f, masks_f, preds_u8,
    counts, per_img)`` for the test routine: NHWC float images and masks at
    ``image_size``, uint8 {0, 1} predictions, the global confusion counts
    and their per-image vectors. With ``config.tta`` the logits are the
    4-way flip ensemble (``eval/tta.py``: four forwards, logit of the mean
    probability); validation stays without it, as in JAX."""
    _check_ported(config)
    amp = bool(config.use_amp_autocast)
    size = (config.image_size, config.image_size)
    use_tta = bool(getattr(config, "tta", False))

    @torch.no_grad()
    def step(state: TrainState, images_u8, masks_u8):
        images, masks = _to_float(images_u8, masks_u8)
        images, masks = eval_preprocess(images, masks, size)
        state.model.eval()

        def fwd(x):
            return _main_logits(_forward(state.model, x, amp))

        logits = tta_logits(fwd, images) if use_tta else fwd(images)
        preds = (torch.sigmoid(logits.to(torch.float32)) > threshold
                 ).to(torch.uint8)
        per_img = confusion_counts(logits, masks, threshold=threshold,
                                   per_image=True)
        counts = ConfusionCounts(*(x.sum() for x in per_img))
        return images, masks, preds, counts, per_img

    return step


def accumulate(total: StepMetrics | None, m: StepMetrics) -> StepMetrics:
    """Running sums of per-batch metrics, weighted by n (on the device)."""
    if total is None:
        return StepMetrics(m.loss * m.n, m.bce * m.n, m.dice * m.n,
                           m.focal * m.n, m.boundary * m.n, m.counts, m.n)
    return StepMetrics(
        total.loss + m.loss * m.n, total.bce + m.bce * m.n,
        total.dice + m.dice * m.n, total.focal + m.focal * m.n,
        total.boundary + m.boundary * m.n,
        total.counts + m.counts, total.n + m.n)
