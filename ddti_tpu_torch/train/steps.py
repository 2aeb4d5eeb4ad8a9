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
(``_ds_aux_loss``). The step's options, as ``_build_train_step_impl``:
``grad_accum`` (microbatches of the augmented and mixed batch, BatchNorm
per microbatch with its statistics chained, one update of the mean
gradient: the loss, so the EDT, runs once a microbatch), ``nan_guard``
(a step whose loss or any gradient is non-finite keeps the whole state:
parameters, AdamW's moments and step, BatchNorm statistics, the EMA and the
schedule position; its metrics are zeros and ``skipped`` 1; it is the one
option that reads the device every step), ``clip_grad_norm`` and
``freeze`` (``state.py``), ``freeze_bn_stats`` (the frozen modules'
running statistics keep their values from the start of the step) and
``ema_decay`` (the shadow updated after every applied step; eval and
inference use it) and a distillation ``teacher`` (``distill.py``: the
frozen teacher's tempered probabilities of the post-mixup batch, per
microbatch, blended into the loss as ``(1 - w) total + w kd_bce``). With
``device_guard`` the nan_guard decides on the device, as JAX's does: the
step snapshots the whole state first and keeps the snapshot where the
loss or a gradient is not finite, reading nothing back, so a CUDA graph
can capture it (``--fused_epoch``). ``qat`` (``qat.py``) runs every
tracked conv fake-quantized in the forward and its recomputation, collects
the batch ranges (maxed over the microbatches) and folds them into
``state.qstats``' EMA after an applied update, on the device; a rejected
step leaves the ranges as they were; a teacher is never fake-quantized.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

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

from .distill import kd_bce, soft_targets
from .qat import qat_forwards, update_qstats
from .quantize import swapped_forwards
from .state import TrainState


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    bce: torch.Tensor
    dice: torch.Tensor
    focal: torch.Tensor
    boundary: torch.Tensor
    counts: ConfusionCounts
    n: torch.Tensor
    # 1.0 when --nan_guard rejected the step (its other fields are zeros);
    # always 0.0 with the guard off
    skipped: torch.Tensor | float = 0.0


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


def _forward(model, images, amp: bool, weights: dict | None = None):
    """NHWC images -> NHWC logits under bf16 autocast when ``amp``, with
    ``weights`` (the EMA shadow) in place of the model's parameters where
    given; a deep-supervision model's ``(logits, [head logits])`` keeps its
    form."""
    x = images.permute(0, 3, 1, 2)
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=amp):
        out = (model(x) if weights is None
               else functional_call(model, weights, (x,)))
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


def _ema_decay(config) -> float:
    return float(getattr(config, "ema_decay", 0.0) or 0.0)


def _bn_buffers(model, names) -> dict:
    return {k: v for k, v in model.named_buffers() if k in names}


def _snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


@torch.no_grad()
def _restore(tensors: dict, saved: dict) -> None:
    for k, v in saved.items():
        tensors[k].copy_(v)


def _finite(loss, model) -> torch.Tensor:
    """Device bool: the loss and every gradient element are finite."""
    ok = torch.isfinite(loss)
    for p in model.parameters():
        if p.grad is not None:
            ok = ok & torch.isfinite(p.grad).all()
    return ok


def make_train_step(config, aug_cfg: AugmentConfig | None,
                    augment: bool = True, teacher=None,
                    device_guard: bool = False):
    """Build ``step(state, images, masks, draws, mix_draws) ->
    StepMetrics``: uint8 (or float) NHWC batches, the chain's draws, and
    the mixup draws (ignored unless ``config.use_mixup``). Updates
    ``state`` in place. A batch that ``config.grad_accum`` does not divide
    raises. ``augment=False`` skips the device chain (``draws`` unused):
    ``make_host_train_step``'s body. ``teacher`` (``distill.Teacher``)
    turns distillation on; ``device_guard`` makes ``config.nan_guard``'s
    decision on the device (the state's optimizer moments must exist:
    ``TrainState.init_optimizer_state``). ``config.qat`` needs
    ``state.qstats`` (``qat.init_qstats``)."""
    loss_kw = _loss_kw(config)
    amp = bool(config.use_amp_autocast)
    use_mixup = bool(config.use_mixup)
    ds_weight = float(getattr(config, "alpha", 0.0) or 0.0)
    grad_accum = int(getattr(config, "grad_accum", 1) or 1)
    ema_decay = _ema_decay(config)
    nan_guard = bool(getattr(config, "nan_guard", False))
    pin_bn = bool(getattr(config, "freeze_bn_stats", False))
    # 0.0 is a valid weight: no `or` (JAX's rule)
    kd_w = (float(getattr(config, "distill_weight", 0.5))
            if teacher is not None else 0.0)
    kd_t = float(getattr(config, "distill_temperature", 2.0) or 2.0)
    qat = bool(getattr(config, "qat", False))
    # 0.0 is a valid decay (the latest batch's range only): no `or`
    qat_decay = float(getattr(config, "qat_ema_decay", 0.99))

    def forward_backward(model, images, masks, qstats=None, observed=None):
        """Loss terms, counts and (accumulated) gradients of one batch;
        with ``qstats`` the forward, and the backward's recomputation, are
        QAT's (``observed`` collects the ranges)."""
        soft = (soft_targets(teacher, images, kd_t) if teacher is not None
                else None)
        with swapped_forwards(qat_forwards(model, qstats, observed)
                              if qstats is not None else {}):
            out = _forward(model, images, amp)
            logits = _main_logits(out)
            terms = weighted_loss(logits, masks, **loss_kw)
            if isinstance(out, tuple) and ds_weight > 0:
                terms = terms._replace(total=terms.total + _ds_aux_loss(
                    out, masks, loss_kw, ds_weight))
            if soft is not None:
                terms = terms._replace(total=(1.0 - kd_w) * terms.total
                                       + kd_w * kd_bce(logits, soft, kd_t))
            terms.total.backward()
        with torch.no_grad():
            counts = confusion_counts(logits, masks)
        return [t.detach() for t in terms], counts

    def step(state: TrainState, images_u8, masks_u8, draws: AugmentDraws,
             mix: MixupDraws | None) -> StepMetrics:
        images, masks = _to_float(images_u8, masks_u8)
        if augment:
            images, masks = augment_batch(images, masks, draws, aug_cfg)
        if use_mixup:
            images, masks = mixup(images, masks, mix)
        n_img = images.shape[0]
        if n_img % grad_accum:
            raise ValueError(f"batch_size {n_img} not divisible by "
                             f"grad_accum {grad_accum}")
        model = state.model
        model.train()
        pinned = _bn_buffers(model, state.frozen_buffers if pin_bn else ())
        kept = _snapshot(pinned)
        if nan_guard and device_guard:  # the whole state, kept on device
            live = state.state_tensors()
            start = [t.detach().clone() for t in live]
        elif nan_guard:  # the forward moves them; a rejected step restores
            bn_all = dict(model.named_buffers())
            bn_start = _snapshot(bn_all)
        model.zero_grad(set_to_none=True)
        qstats = state.qstats if qat else None
        observed = None
        if qat:  # JAX's scan starts every range at 0 and maxes them
            observed = ({} if grad_accum == 1 else
                        {p: torch.zeros_like(v) for p, v in qstats.items()})
        # microbatches of the augmented, mixed batch: BatchNorm normalises
        # each alone and chains its statistics; .grad sums their gradients
        micro = n_img // grad_accum
        terms = counts = None
        for i in range(grad_accum):
            sl = slice(i * micro, (i + 1) * micro)
            t, c = forward_backward(model, images[sl], masks[sl], qstats,
                                    observed)
            terms = t if terms is None else [a + b for a, b in zip(terms, t)]
            counts = c if counts is None else counts + c
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(inv)
            terms = [t * inv for t in terms]
        _restore(pinned, kept)
        n = images.new_full((), float(n_img))
        if nan_guard and device_guard:
            return _guarded_update(state, model, terms, counts, n, live,
                                   start, ema_decay, observed, qat_decay)
        if nan_guard and not bool(_finite(terms[0], model)):
            _restore(bn_all, bn_start)
            zero = images.new_zeros(())
            return StepMetrics(
                *(zero for _ in terms),
                ConfusionCounts(*(torch.zeros_like(c) for c in counts)),
                zero, images.new_ones(()))
        state.apply_gradients()
        if ema_decay:
            state.update_ema(ema_decay)
        if qat:
            update_qstats(state.qstats, observed, qat_decay)
        return StepMetrics(*terms, counts, n,
                           images.new_zeros(()) if nan_guard else 0.0)

    return step


@torch.no_grad()
def _guarded_update(state: TrainState, model, terms, counts, n, live, start,
                    ema_decay: float, observed=None,
                    qat_decay: float = 0.99) -> StepMetrics:
    """The update of JAX's ``guarded_update``, decided on the device: the
    AdamW update, the EMA and the QAT ranges are applied, then every state
    tensor takes its snapshot ``start`` back unless the loss and every
    gradient are finite; a rejected step's metrics are zeros and
    ``skipped`` 1."""
    ok = _finite(terms[0], model)
    state.apply_gradients()
    if ema_decay:
        state.update_ema(ema_decay)
    if observed is not None:
        update_qstats(state.qstats, observed, qat_decay)
    for t, s in zip(live, start):
        t.copy_(torch.where(ok, t, s))

    def kept(t):  # zeros where rejected: a NaN loss times 0 stays NaN
        return torch.where(ok, t, torch.zeros_like(t))

    return StepMetrics(*map(kept, terms), ConfusionCounts(*map(kept, counts)),
                       kept(n), 1.0 - ok.to(torch.float32))


def make_host_train_step(config, teacher=None):
    """The train step of ``--host_augment`` (JAX ``make_host_train_step``):
    ``step(state, images_f, masks_f, mix_draws=None) -> StepMetrics`` on
    float32 NHWC batches that the host chain already augmented and resized,
    so the device runs mixup, forward/backward and the update only: the
    shared step body with the device chain off (grad_accum, deep
    supervision, clipping, EMA, freeze, nan_guard and the teacher as in
    ``make_train_step``)."""
    body = make_train_step(config, None, augment=False, teacher=teacher)

    def step(state: TrainState, images, masks,
             mix: MixupDraws | None = None) -> StepMetrics:
        return body(state, images, masks, None, mix)

    return step


def _eval_weights(state: TrainState, use_ema: bool):
    """The model in eval mode and the weights it predicts with: the EMA
    shadow where ``use_ema`` and the state keeps one (JAX
    ``_eval_variables``), else its own (None)."""
    state.model.eval()
    return state.ema if use_ema else None


def make_eval_step(config):
    """``step(state, images, masks, valid=None) -> StepMetrics`` (no
    update). ``valid`` (B,) {0, 1} marks the images that are not
    wraparound padding: the counts weight each image by it and ``n`` is
    its sum, so val metrics count every image once; the loss terms stay
    means over the padded batch (QUIRKS #22)."""
    loss_kw = _loss_kw(config)
    amp = bool(config.use_amp_autocast)
    size = (config.image_size, config.image_size)
    use_ema = _ema_decay(config) > 0

    @torch.no_grad()
    def step(state: TrainState, images_u8, masks_u8, valid=None):
        images, masks = _to_float(images_u8, masks_u8)
        images, masks = eval_preprocess(images, masks, size)
        logits = _main_logits(_forward(state.model, images, amp,
                                       _eval_weights(state, use_ema)))
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
    probability); validation stays without it, as in JAX. The eval weights
    (the EMA shadow under --ema_decay) predict."""
    amp = bool(config.use_amp_autocast)
    size = (config.image_size, config.image_size)
    use_tta = bool(getattr(config, "tta", False))
    use_ema = _ema_decay(config) > 0

    @torch.no_grad()
    def step(state: TrainState, images_u8, masks_u8):
        images, masks = _to_float(images_u8, masks_u8)
        images, masks = eval_preprocess(images, masks, size)

        weights = _eval_weights(state, use_ema)

        def fwd(x):
            return _main_logits(_forward(state.model, x, amp, weights))

        logits = tta_logits(fwd, images) if use_tta else fwd(images)
        preds = (torch.sigmoid(logits.to(torch.float32)) > threshold
                 ).to(torch.uint8)
        per_img = confusion_counts(logits, masks, threshold=threshold,
                                   per_image=True)
        counts = ConfusionCounts(*(x.sum() for x in per_img))
        return images, masks, preds, counts, per_img

    return step


def make_threshold_sweep_step(config, thresholds):
    """``step(state, images, masks, valid=None) -> ConfusionCounts`` whose
    counts have a leading thresholds axis (JAX
    ``make_threshold_sweep_step``, --tune_threshold): one forward scores
    every candidate, compared at once on the device. The logits are the
    test path's (the EMA shadow under --ema_decay, the flip ensemble
    under --tta); ``valid`` (B,) {0, 1} weights out wraparound-padded
    duplicates, as validate() does (QUIRKS #22)."""
    amp = bool(config.use_amp_autocast)
    size = (config.image_size, config.image_size)
    use_tta = bool(getattr(config, "tta", False))
    use_ema = _ema_decay(config) > 0
    grid = torch.as_tensor(thresholds, dtype=torch.float32)

    @torch.no_grad()
    def step(state: TrainState, images_u8, masks_u8, valid=None):
        images, masks = _to_float(images_u8, masks_u8)
        images, masks = eval_preprocess(images, masks, size)
        weights = _eval_weights(state, use_ema)

        def fwd(x):
            return _main_logits(_forward(state.model, x, amp, weights))

        logits = tta_logits(fwd, images) if use_tta else fwd(images)
        n = logits.shape[0]
        prob = torch.sigmoid(logits.to(torch.float32)).reshape(1, n, -1)
        ts = grid.to(prob.device).reshape(-1, 1, 1)
        pred = prob > ts                                  # (T, B, pixels)
        t = masks.to(torch.float32).reshape(1, n, -1)
        pos_i, pos_b = t >= 1.0, t > 0.0  # confusion_counts' conventions

        def count(x):  # (T, B): per image, summed with the valid weights
            c = x.sum(dim=2, dtype=torch.float64)
            return c.sum(dim=1) if valid is None else (c * valid).sum(dim=1)

        return ConfusionCounts(
            count(pred & pos_i), count(pred & ~pos_i), count(~pred & pos_i),
            count(~pred & ~pos_i), count(pred & pos_b), count(pred | pos_b))

    return step


def accumulate(total: StepMetrics | None, m: StepMetrics) -> StepMetrics:
    """Running sums of per-batch metrics, weighted by n (on the device);
    ``skipped`` is an unweighted step count."""
    if total is None:
        return StepMetrics(m.loss * m.n, m.bce * m.n, m.dice * m.n,
                           m.focal * m.n, m.boundary * m.n, m.counts, m.n,
                           m.skipped)
    return StepMetrics(
        total.loss + m.loss * m.n, total.bce + m.bce * m.n,
        total.dice + m.dice * m.n, total.focal + m.focal * m.n,
        total.boundary + m.boundary * m.n,
        total.counts + m.counts, total.n + m.n, total.skipped + m.skipped)
