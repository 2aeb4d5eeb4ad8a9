"""The library API, ported from ``ddti_tpu/api.py``: the script and
notebook facade over the Trainer and the serving bundles.

    import ddti_tpu_torch.api as ddti

    model = ddti.fit(images, masks, model_type="ResUNet",
                     base_filters=32, depth=4, epochs=20)
    masks_pred = model.predict(new_images)          # uint8 masks
    probs = model.predict(new_images, prob=True)    # probabilities
    model.save("run1")                              # .npz weights
    model.export_serving("run1", dtype="int8")      # a .pt2 bundle
    model = ddti.load("run1.npz", model_type="ResUNet",
                      base_filters=32, depth=4)

Arrays in, arrays out: numpy or torch, uint8 [0, 255] or float [0, 1],
(N, H, W) or (N, H, W, 1). Every further keyword of ``fit`` is a Config
field, as the training CLI's flags are (``use_mixup=True``, ``qat=True``,
``distill_checkpoint=...``, ``freeze="encoders"``, ...). ``device``
is the card (``"cuda"``, which raises where there is none) unless the
caller passes ``device="cpu"``. ``fit(mesh=...)`` raises: the mesh is
ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import fields as _dc_fields
from typing import Any, Optional

import numpy as np


def _as_nhwc_u8(arr, name: str) -> np.ndarray:
    """(N, H, W) or (N, H, W, 1), uint8 [0, 255] or float [0, 1] ->
    (N, H, W, 1) uint8."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr)
    if a.ndim == 3:
        a = a[..., None]
    if a.ndim != 4 or a.shape[-1] != 1:
        raise ValueError(f"{name}: expected (N,H,W) or (N,H,W,1) "
                         f"grayscale, got shape {a.shape}")
    if a.dtype != np.uint8:
        a = (np.clip(a.astype(np.float32), 0.0, 1.0) * 255.0 + 0.5
             ).astype(np.uint8)
    return a


class Model:
    """A trained (or loaded) segmentation model: ``predict``,
    ``evaluate``, ``save`` and ``export_serving``."""

    def __init__(self, module, config, qstats=None):
        self.module = module.eval()
        self.config = config
        self.qstats = qstats

    @property
    def device(self):
        return next(self.module.parameters()).device

    @property
    def bf16(self) -> bool:
        return bool(self.config.use_amp_autocast)

    # -- inference ------------------------------------------------------

    def predict(self, images, batch_size: int = 32, prob: bool = False,
                threshold: float = 0.5, tta: bool = False) -> np.ndarray:
        """Masks of ``images`` at the model's training resolution: uint8
        {0, 1} maps (float32 probabilities with ``prob=True``), (N, H, W).
        A partial last batch is padded, as JAX keeps one compiled
        shape."""
        import torch

        from ddti_tpu_torch.data.augment import eval_preprocess
        from ddti_tpu_torch.eval.tta import tta_logits
        from ddti_tpu_torch.train.export import nhwc_logits

        x = _as_nhwc_u8(images, "images")
        size = int(self.config.image_size)

        def fwd(im):
            return nhwc_logits(self.module, im, self.bf16)

        outs = []
        with torch.inference_mode():
            for i in range(0, len(x), batch_size):
                chunk = x[i:i + batch_size]
                n = len(chunk)
                if n < batch_size:
                    chunk = np.concatenate([chunk, np.zeros(
                        (batch_size - n,) + chunk.shape[1:], np.uint8)])
                xb = torch.from_numpy(chunk).to(self.device)
                xb = xb.to(torch.float32) / 255.0
                xb, _ = eval_preprocess(xb, xb, (size, size))
                lg = tta_logits(fwd, xb) if tta else fwd(xb)
                outs.append(torch.sigmoid(lg.float())[:n].cpu().numpy())
        probs = np.concatenate(outs)[..., 0]
        return probs if prob else (probs > threshold).astype(np.uint8)

    def evaluate(self, images, masks, batch_size: int = 32,
                 threshold: float = 0.5) -> dict:
        """Pixel metrics of ``predict(images)`` against ``masks``: iou,
        f1, precision, recall, acc (micro-averaged, the reference's
        test() convention)."""
        pred = self.predict(images, batch_size=batch_size,
                            threshold=threshold).astype(bool)
        gt = _as_nhwc_u8(masks, "masks")[..., 0] > 127
        tp = float(np.logical_and(pred, gt).sum())
        fp = float(np.logical_and(pred, ~gt).sum())
        fn = float(np.logical_and(~pred, gt).sum())
        tn = float(np.logical_and(~pred, ~gt).sum())
        eps = 1e-8
        prec = tp / (tp + fp + eps)
        rec = tp / (tp + fn + eps)
        return {"iou": tp / (tp + fp + fn + eps),
                "f1": 2 * prec * rec / (prec + rec + eps),
                "precision": prec, "recall": rec,
                "acc": (tp + tn) / (tp + fp + fn + tn + eps)}

    # -- persistence and deployment ---------------------------------------

    def save(self, path: str) -> str:
        """Write ``<path>.npz`` (weights and BN statistics, with the QAT
        ranges of a ``qat=True`` model): loadable by ``load``, the infer,
        quantize and export CLIs, and ``--checkpoint_path``."""
        from ddti_tpu_torch.train.checkpoint import save_params_npz

        if not path.endswith(".npz"):
            path = path + ".npz"
        save_params_npz(path, self.config.model_type,
                        self.module.state_dict(), qstats=self.qstats)
        return path

    def export_serving(self, path: str, batch: int = 32,
                       dtype: str = "bf16", tta: bool = False,
                       threshold: float = 0.5,
                       min_channels: int = 0) -> str:
        """Write a serving bundle (``<path>_serving_program.pt2`` + .npz,
        uint8 input), ``dtype`` f32, bf16 (weights) or int8 (the QAT
        ranges where the model has them, else calibration on synthetic
        frames); servable by the infer CLI, the daemon and
        ``load_serving_bundle``. ``min_channels`` (int8): quantize only
        the channel-heavy convs."""
        import torch

        from ddti_tpu_torch.train.export import (
            PROGRAM_SUFFIX,
            export_serving_program,
            save_bundle,
        )

        size = int(self.config.image_size)
        mt = self.config.model_type
        if not path.endswith(PROGRAM_SUFFIX):
            path = path + PROGRAM_SUFFIX
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if dtype == "int8":
            from ddti_tpu_torch.train.qat import qstats_amax
            from ddti_tpu_torch.train.quantize import export_serving_int8

            amax = qstats_amax(self.qstats) or None
            calib = None
            if amax is None:
                from ddti_tpu_torch.data.synthetic import generate_ddti_like

                im, _ = generate_ddti_like(min(batch, 32), (size, size), 0)
                calib = torch.from_numpy(np.asarray(im, np.float32) / 255.0
                                         ).to(self.device)
            program, svars = export_serving_int8(
                self.module, batch, size, calib_images=calib, amax=amax,
                threshold=threshold, input_dtype=torch.uint8, tta=tta,
                min_channels=min_channels, bf16=self.bf16, model_type=mt)
        elif dtype in ("f32", "bf16"):
            program, svars = export_serving_program(
                self.module, batch, size, threshold=threshold, fold_bn=True,
                input_dtype=torch.uint8,
                weights_dtype=torch.bfloat16 if dtype == "bf16" else None,
                tta=tta, bf16=self.bf16, model_type=mt)
        else:
            raise ValueError(f"dtype {dtype!r}: f32, bf16 or int8")
        save_bundle(path, program, svars)
        return path


def _make_model(model_type: str, image_size: int, **model_kwargs):
    from ddti_tpu_torch.models import create_model

    kwargs = dict(in_channels=1, out_channels=1)
    kwargs.update(model_kwargs)
    if model_type == "TransUNet":
        kwargs.setdefault("image_size", image_size)
    return create_model(model_type, **kwargs)


def fit(images, masks, *, val_images=None, val_masks=None,
        model_type: str = "ResUNet", base_filters: int = 32,
        depth: int = 4, image_size: Optional[int] = None,
        epochs: int = 20, batch_size: int = 16, lr: float = 3e-4,
        bf16: bool = True, val_fraction: float = 0.15,
        run_dir: Optional[str] = None, verbose: bool = True,
        seed: int = 42, mesh: Optional[str] = None, device="cuda",
        **config_overrides: Any) -> Model:
    """Train a model on arrays (N, H, W[, 1]), uint8 or float [0, 1].
    Without a val set the last ``val_fraction`` of the shuffled data
    validates. Further keywords are Config fields. Returns the
    best-val-IoU weights (with their QAT ranges under ``qat=True``)."""
    if mesh:
        raise NotImplementedError(
            "fit(mesh=...): data-parallel and spatial meshes are not ported "
            "yet (ROADMAP.md Queue 1 item 12)")
    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.core.logging import create_logger
    from ddti_tpu_torch.core.prng import set_seed
    from ddti_tpu_torch.data.dataset import DeviceDataSource
    from ddti_tpu_torch.train.checkpoint import (
        load_checkpoint_into,
        load_qstats,
    )
    from ddti_tpu_torch.train.engine import Trainer
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    dev = resolve_device(str(device))
    x = _as_nhwc_u8(images, "images")
    y = _as_nhwc_u8(masks, "masks")
    if len(x) != len(y):
        raise ValueError(f"{len(x)} images vs {len(y)} masks")
    size = int(image_size or x.shape[1])
    if val_images is None:
        order = np.random.default_rng(seed).permutation(len(x))
        n_val = max(1, int(round(len(x) * val_fraction)))
        xv, yv = x[order[:n_val]], y[order[:n_val]]
        x, y = x[order[n_val:]], y[order[n_val:]]
    else:
        xv = _as_nhwc_u8(val_images, "val_images")
        yv = _as_nhwc_u8(val_masks, "val_masks")

    own_tmp = run_dir is None
    base_dir = run_dir or tempfile.mkdtemp(prefix="ddti_fit_")
    valid = {f.name for f in _dc_fields(Config)}
    bad = sorted(set(config_overrides) - valid)
    if bad:
        raise TypeError(f"unknown fit() keyword(s): {bad} "
                        "(must be Config fields)")
    cfg = Config(model_type=model_type, epochs=epochs,
                 batch_size=min(batch_size, len(x)), lr=lr,
                 image_size=size, store_size=x.shape[1],
                 use_amp_autocast=bf16, base_dir=base_dir, seed=seed,
                 **config_overrides)
    cfg.model_kwargs = dict(base_filters=base_filters, depth=depth)
    set_seed(seed)
    cfg.make_dirs()
    logger = create_logger(os.path.join(cfg.log_dir, "train_log.log"),
                           console=verbose)
    module = init_like_flax(_make_model(model_type, size,
                                        base_filters=base_filters,
                                        depth=depth), seed).to(dev)
    trainer = Trainer(cfg, (DeviceDataSource(x, y, dev),
                            DeviceDataSource(xv, yv, dev),
                            DeviceDataSource(xv, yv, dev)), logger, module)
    trainer.train()

    # the best-val-IoU weights (saved at every improvement); the live
    # eval weights where no epoch improved
    best = os.path.join(cfg.model_dir, f"{model_type}_best.npz")
    module.load_state_dict(trainer.state.eval_state_dict())
    qstats = trainer.state.qstats
    if qstats is not None:
        qstats = {k: float(v) for k, v in qstats.items()}
    if os.path.exists(best):
        load_checkpoint_into(best, model_type, module)
        module.to(dev)
        if qstats is not None:
            qstats = load_qstats(best) or qstats
    result = Model(module, cfg, qstats=qstats)
    if own_tmp and not verbose:
        import shutil

        shutil.rmtree(base_dir, ignore_errors=True)
    return result


def load(checkpoint: str, *, model_type: str = "ResUNet",
         base_filters: int = 32, depth: int = 4, image_size: int = 256,
         bf16: bool = True, device="cuda", **model_kwargs) -> Model:
    """Any checkpoint form (``.npz``, ``.pth``, a full-state directory)
    as a ``Model`` ready to predict, evaluate or export; the architecture
    arguments must match it. The QAT ranges it carries come along."""
    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.train.checkpoint import (
        load_checkpoint_into,
        load_qstats,
    )

    dev = resolve_device(str(device))
    module = _make_model(model_type, image_size, base_filters=base_filters,
                         depth=depth, **model_kwargs)
    load_checkpoint_into(checkpoint, model_type, module)
    cfg = Config(model_type=model_type, image_size=image_size,
                 store_size=image_size, use_amp_autocast=bf16)
    cfg.model_kwargs = dict(base_filters=base_filters, depth=depth)
    try:
        qstats = load_qstats(checkpoint)
    except Exception:
        qstats = None
    return Model(module.to(dev), cfg, qstats=qstats)
