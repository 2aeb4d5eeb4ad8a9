"""The training engine, ported from ``ddti_tpu/train/engine.py``:
``Trainer`` with stepwise train epochs, validation, best-by-val-IoU and
last saves, early stopping and the test phase (global and per-image
metrics, HD95/ASSD surface distances, and with ``config.tta`` the 4-way
flip ensemble in the test phase, as ``test_metrics.json`` records).

Data are device-resident uint8 stores (``data/dataset.py``); each step
gathers its batch on the device and returns its metrics there, so the host
reads scalars once an epoch (and every ``log_every`` steps; every step
under ``--nan_guard``, whose per-step bookkeeping stops the run, its
checkpoints intact, after ``--nan_guard_patience`` consecutive rejected
steps). Batch order comes from ``numpy.random.default_rng((seed,
epoch))`` as in the JAX package; the augmentation's per-image draws from a
CPU ``torch.Generator`` and its frame-sized fields from one on the
training device, both seeded from (seed, epoch), so a run's randomness
depends on its epoch alone. The train state carries ``--clip_grad_norm``,
``--freeze`` (logged as the JAX Trainer logs it) and ``--ema_decay``.

Weights are saved as ``<model_dir>/<Model>_best`` / ``_last`` in two
formats: ``.npz`` (the JAX package's ``save_params_npz`` layout) and
``.pth`` (the reference's ``state_dict``); under ``--ema_decay`` both hold
the EMA shadow with the live BatchNorm statistics, as the JAX Trainer's
``_eval_weights``. Still to port (ROADMAP.md): overlay images, Orbax
full-state checkpoints and resume, periodic checkpoints,
``--fused_epoch``, the threshold sweep, serving exports, QAT and
distillation.
"""

from __future__ import annotations

import csv
import json
import math
import os
import time

import numpy as np
import torch

from ddti_tpu_torch.core.logging import ScalarWriter
from ddti_tpu_torch.data.augment import (
    AugmentConfig,
    sample_draws,
    sample_mixup,
)
from ddti_tpu_torch.eval.metrics import (
    epoch_metrics_from_counts,
    metrics_from_counts,
)
from ddti_tpu_torch.eval.surface import surface_metrics_batch
from ddti_tpu_torch.utils.early_stopping import EarlyStopping

from .checkpoint import save_weights
from .state import TrainState, describe_freeze, parse_freeze
from .steps import accumulate, make_eval_step, make_infer_step, make_train_step


def aug_config_from(config) -> AugmentConfig:
    return AugmentConfig(
        use_elastic=bool(config.use_elastic),
        use_speckle=bool(config.use_speckle), use_tgc=bool(config.use_tgc),
        use_clahe=bool(config.use_clahe), p_crop=float(config.p_crop),
        shared_geometry=bool(config.aug_shared_geometry),
        fast_warp=bool(config.aug_fast_warp),
        out_size=(config.image_size, config.image_size))


class Trainer:
    """Train/validate/test over (train, val, test) ``DeviceDataSource``s
    that live on the model's device."""

    def __init__(self, config, data, logger, model):
        self.config = config
        self.logger = logger
        self.model = model
        self.train_src, self.val_src, self.test_src = data
        self.steps_per_epoch = max(
            self.train_src.num_batches(config.batch_size), 1)
        freeze = parse_freeze(config)
        self.state = TrainState(
            model, config.lr, self.steps_per_epoch, config.weight_decay,
            model_type=config.model_type, freeze=freeze,
            clip_norm=config.clip_grad_norm, ema=config.ema_decay > 0,
            nan_guard=bool(config.nan_guard))
        if freeze:
            logger.info(
                f"Freezing {','.join(freeze)}: "
                f"{describe_freeze(config.model_type, model, freeze)} "
                f"params fixed" + (", BN stats pinned too"
                                   if config.freeze_bn_stats
                                   else " (BN stats keep adapting)"))
        self.aug_cfg = aug_config_from(config)
        self.train_step = make_train_step(config, self.aug_cfg)
        self.eval_step = make_eval_step(config)
        self.infer_step = make_infer_step(config)
        self.early_stopping = EarlyStopping(
            logger=logger, patience=config.early_stop_patience, delta=0)
        self.writer = ScalarWriter(config.result_dir)
        # drives the test split's shuffle (the reference's quirk #10)
        self.rng = np.random.default_rng(config.seed)
        self.best_val_iou = -np.inf
        self._gen = self._field_gen = None
        self._frame_hw = tuple(self.train_src.images.shape[1:3])
        # --nan_guard: consecutive rejected steps; the run stops, its
        # checkpoints intact, once the patience is spent
        self._nan_guard = bool(config.nan_guard)
        self._nan_patience = int(config.nan_guard_patience or 5)
        self._consecutive_skips = 0
        self._diverged = False

    # ------------------------------------------------------------------

    def _log_epoch(self, phase: str, epoch: int, avgs: dict, em: dict):
        lg = self.logger
        lg.info(f"{phase} Epoch: {epoch + 1}, Avg Loss: {avgs['loss']:.4f}")
        lg.info(f"BCE Loss: {avgs['bce']:.4f}, Dice Loss: {avgs['dice']:.4f}"
                f", Focal Loss: {avgs['focal']:.4f}, Boundary Loss: "
                f"{avgs['boundary']:.4f}")
        lg.info(f"acc: {em['acc']:.4f}, precision: {em['precision']:.4f}, "
                f"recall: {em['recall']:.4f}, f1: {em['f1']:.4f}, "
                f"IoU: {em['iou']:.4f}")
        for tag, v in (("BCE Loss", avgs["bce"]), ("Dice Loss", avgs["dice"]),
                       ("Focal Loss", avgs["focal"]),
                       ("Boundary Loss", avgs["boundary"]),
                       ("Acc", em["acc"]), ("Precision", em["precision"]),
                       ("Recall", em["recall"]), ("F1", em["f1"]),
                       ("IoU", em["iou"])):
            self.writer.add_scalar(f"{tag}/{phase}", v, epoch)

    @staticmethod
    def _avgs(total) -> dict:
        n = float(total.n)
        return {k: float(getattr(total, k)) / max(n, 1.0)
                for k in ("loss", "bce", "dice", "focal", "boundary")}

    def _epoch_rng(self, epoch: int) -> np.random.Generator:
        """Batch order of one train epoch, from (seed, epoch) alone."""
        return np.random.default_rng((self.config.seed, epoch))

    def _epoch_generator(self, epoch: int, device="cpu") -> torch.Generator:
        """The augmentation draws' generator for one train epoch: the
        per-image draws' on the CPU, the fields' on ``device``."""
        seed = np.random.SeedSequence((self.config.seed, epoch))
        state = seed.generate_state(2)
        dev = torch.device(device)
        return torch.Generator(device=dev).manual_seed(
            int(state[0] if dev.type == "cpu" else state[1]))

    def _draws(self, epoch: int, step: int, n: int):
        """The chain's and mixup's draws for one train step, from the
        epoch's generators in step order; (epoch, step) name the step for
        a substitute that derives its draws from them (the tests feed JAX's
        draws this way)."""
        cfg = self.config
        mix = (sample_mixup(self._gen, n, cfg.mixup_alpha, cfg.mixup_prob)
               if cfg.use_mixup else None)
        return sample_draws(self._gen, n, self.aug_cfg, self._frame_hw,
                            self._field_gen), mix

    def _batches(self, src, shuffle: bool, rng: np.random.Generator):
        for idx in src.epoch_batches(rng, self.config.batch_size,
                                     shuffle=shuffle):
            yield (idx, *src.gather(idx))

    # ------------------------------------------------------------------

    def train_one_epoch(self, epoch: int):
        total = None
        self._gen = self._epoch_generator(epoch)
        self._field_gen = self._epoch_generator(
            epoch, self.train_src.images.device)
        log_every = int(self.config.log_every or 0)
        t0 = time.perf_counter()
        n_imgs = 0
        for i, (_, images, masks) in enumerate(
                self._batches(self.train_src, True, self._epoch_rng(epoch))):
            draws, mix = self._draws(epoch, i, images.shape[0])
            dev = images.device
            m = self.train_step(self.state, images, masks, draws.to(dev),
                                None if mix is None else mix.to(dev))
            total = accumulate(total, m)
            n_imgs += int(images.shape[0])
            if self._nan_guard and not self._note_skip(
                    float(m.skipped), epoch, i):
                break  # patience spent: stop the epoch and the run
            if log_every and (i + 1) % log_every == 0:
                ips = n_imgs / max(time.perf_counter() - t0, 1e-9)
                self.logger.info(f"Epoch {epoch + 1} step {i + 1}: "
                                 f"loss {float(m.loss):.4f} — {ips:.1f} "
                                 f"img/s")
            else:
                self.logger.debug(f"Epoch {epoch + 1} step {i + 1} done "
                                  f"({n_imgs} imgs)")
        em = epoch_metrics_from_counts(total.counts)
        self._log_epoch("Train", epoch, self._avgs(total), em)
        self._log_skips(epoch, float(total.skipped))

    def _note_skip(self, skipped: float, epoch: int, step: int) -> bool:
        """Per-step --nan_guard accounting; False once the consecutive
        skips reach the patience (training should stop)."""
        if skipped > 0:
            self._consecutive_skips += 1
            self.logger.warning(
                f"--nan_guard: non-finite loss/gradients at epoch "
                f"{epoch + 1} step {step + 1} — update skipped "
                f"({self._consecutive_skips} consecutive)")
            if self._consecutive_skips >= self._nan_patience:
                self.logger.error(
                    f"--nan_guard: {self._consecutive_skips} consecutive "
                    f"non-finite steps — training has diverged; stopping "
                    f"(best/last checkpoints are intact)")
                self._diverged = True
                return False
        else:
            self._consecutive_skips = 0
        return True

    def _log_skips(self, epoch: int, skipped: float) -> None:
        if self._nan_guard:
            self.writer.add_scalar("SkippedSteps/Train", skipped, epoch)
            if skipped:
                self.logger.warning(f"--nan_guard: {int(skipped)} step(s) "
                                    f"skipped in epoch {epoch + 1}")

    def _save(self, suffix: str) -> None:
        """``<Model>_<suffix>.{npz,pth}`` of the eval weights (the EMA
        shadow under --ema_decay)."""
        cfg = self.config
        save_weights(os.path.join(cfg.model_dir,
                                  f"{cfg.model_type}_{suffix}"),
                     cfg.model_type, self.model,
                     self.state.eval_state_dict())

    @staticmethod
    def _first_occurrence_mask(idx, seen: set, device) -> torch.Tensor:
        """(B,) float32 {0, 1}: 0 for wraparound-padded duplicates, so
        metrics count every image once (QUIRKS #22)."""
        mask = []
        for i in np.asarray(idx):
            mask.append(0.0 if int(i) in seen else 1.0)
            seen.add(int(i))
        return torch.tensor(mask, dtype=torch.float32, device=device)

    def validate(self, epoch: int):
        total = None
        seen = set()
        for idx, images, masks in self._batches(self.val_src, False,
                                                self.rng):
            m = self.eval_step(self.state, images, masks,
                               self._first_occurrence_mask(idx, seen,
                                                           images.device))
            total = accumulate(total, m)
        em = epoch_metrics_from_counts(total.counts)
        avgs = self._avgs(total)
        self._log_epoch("Validate", epoch, avgs, em)
        return avgs["loss"], em["iou"]

    def train(self):
        cfg = self.config
        for epoch in range(cfg.epochs):
            self.train_one_epoch(epoch)
            if self._diverged:  # --nan_guard patience spent; the last
                break           # weights below are still saved
            _, val_iou = self.validate(epoch)
            if val_iou > self.best_val_iou:
                self.best_val_iou = val_iou
                self._save("best")
                self.logger.info(f"--Best model saved at epoch {epoch + 1} "
                                 f"with IoU: {val_iou:.4f}")
            self.early_stopping(-val_iou)
            if self.early_stopping.early_stop:
                self.logger.info("--Early stopping triggered")
                break
        self._save("last")
        self.writer.close()

    # ------------------------------------------------------------------

    def test(self) -> dict:
        """Global micro-averaged pixel metrics over the test split (shuffled
        by ``self.rng``, the reference's quirk), per-image audit rows with
        HD95/ASSD, ``result/test_metrics.json`` and
        ``result/per_image_metrics.csv``. The contour-overlay grids are not
        ported yet (ROADMAP.md)."""
        self.logger.info(
            "------------------Starting Testing Model------------------")
        rows, seen = [], set()
        for idx, images, masks in self._batches(self.test_src, True,
                                                self.rng):
            _, masks_f, preds, _, per_img = self.infer_step(
                self.state, images, masks)
            surf = (surface_metrics_batch(preds, masks_f)
                    if self.config.surface_metrics else None)
            self._collect_per_image(rows, seen, idx, per_img, surf)
        # wraparound-padded duplicates are dropped, so the global metrics
        # count every image once, as the reference's unpadded loader does
        m = metrics_from_counts(
            sum(r["tp"] for r in rows), sum(r["fp"] for r in rows),
            sum(r["fn"] for r in rows), sum(r["tn"] for r in rows))
        total = len(rows)
        if rows and "hd95" in rows[0]:
            sd = [(r["hd95"], r["assd"]) for r in rows
                  if not math.isnan(r["hd95"])]
            if sd:
                m["hd95_mean"] = float(np.mean([x[0] for x in sd]))
                m["hd95_median"] = float(np.median([x[0] for x in sd]))
                m["assd_mean"] = float(np.mean([x[1] for x in sd]))
                m["surface_valid_images"] = float(len(sd))
        msg = (f"Test Metrics  —  Total Images: {total}\n"
               f"  TP={int(m['tp'])}, FP={int(m['fp'])}, "
               f"FN={int(m['fn'])}, TN={int(m['tn'])}\n"
               f"  ACC={m['acc']:.4f}, Precision={m['precision']:.4f}, "
               f"Recall={m['recall']:.4f}, F1={m['f1']:.4f}, "
               f"IoU={m['iou']:.4f}")
        if "hd95_mean" in m:
            msg += (f"\n  Surface (px, over "
                    f"{int(m['surface_valid_images'])} defined images): "
                    f"HD95 mean={m['hd95_mean']:.2f} "
                    f"median={m['hd95_median']:.2f}, "
                    f"ASSD mean={m['assd_mean']:.2f}")
        print(msg)
        self.logger.info(msg)
        with open(os.path.join(self.config.result_dir,
                               "test_metrics.json"), "w") as f:
            json.dump({**{k: float(v) for k, v in m.items()},
                       "total_images": total,
                       "model_type": self.config.model_type,
                       "threshold": 0.5,
                       "tta": bool(self.config.tta)}, f, indent=1)
        if rows:
            self._write_per_image_csv(rows)
        return m

    def _collect_per_image(self, rows: list, seen: set, idx, per_img,
                           surf=None):
        """Audit rows of one test batch; padded duplicates are dropped."""
        c = [v.cpu().numpy() for v in per_img]
        tp_, fp_, fn_, tn_, inter_, union_ = c
        if surf is not None:
            surf = {k: v.cpu().numpy() for k, v in surf.items()}
        names = getattr(self.test_src, "names", None)
        for j, i in enumerate(np.asarray(idx)):
            i = int(i)
            if i in seen:
                continue
            seen.add(i)
            tp, fp, fn = float(tp_[j]), float(fp_[j]), float(fn_[j])
            inter, union = float(inter_[j]), float(union_[j])
            row = {
                "index": i,
                "name": names[i] if names is not None else "",
                # per-image IoU under the reference's bool convention
                "iou": inter / union if union > 0 else float("nan"),
                "dice": (2 * tp / (2 * tp + fp + fn)
                         if (2 * tp + fp + fn) > 0 else float("nan")),
                "tp": int(tp), "fp": int(fp), "fn": int(fn),
                "tn": int(tn_[j]),
            }
            if surf is not None:
                row["hd95"] = float(surf["hd95"][j])
                row["assd"] = float(surf["assd"][j])
            rows.append(row)

    def _write_per_image_csv(self, rows: list) -> None:
        """``result/per_image_metrics.csv``, worst IoU first, and a summary
        log line."""
        rows = sorted(rows, key=lambda r: (math.isnan(r["iou"]), r["iou"]))
        path = os.path.join(self.config.result_dir, "per_image_metrics.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        ious = [r["iou"] for r in rows if not math.isnan(r["iou"])]
        if ious:
            worst = ", ".join(
                f"{r['name'] or r['index']}={r['iou']:.3f}"
                for r in rows[:3] if not math.isnan(r["iou"]))
            self.logger.info(
                f"Per-image IoU: median {float(np.median(ious)):.4f}, min "
                f"{min(ious):.4f} (worst: {worst}) — {path}")
