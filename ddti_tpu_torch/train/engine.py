"""The training engine, ported from ``ddti_tpu/train/engine.py``:
``Trainer`` with stepwise train epochs, validation, best-by-val-IoU and
last saves, early stopping and the test phase (global and per-image
metrics, HD95/ASSD surface distances, and with ``config.tta`` the 4-way
flip ensemble in the test phase, as ``test_metrics.json`` records).

Data come from a device-resident uint8 store (``data/dataset.py``), where
each step gathers its batch on the device, or from a streaming source, as
the JAX Trainer takes them: the native C++ loader's uint8 batches
(``runtime.NativeSource``, ``--native_loader``) go to the device
augmentation step like a store's, and the host chain's float32 batches
(``HostBatchIterator``, ``--host_augment``) to ``make_host_train_step``
(mixup and the update only); streamed batches reach the card through
pinned memory (``to_device``), and their per-image audit rows carry
running positions, no file names. Each step returns its metrics on the
device, so the host reads scalars once an epoch (and every ``log_every``
steps; every step under ``--nan_guard``, whose per-step bookkeeping stops the run, its
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
``_eval_weights``. The run lifecycle is the JAX Trainer's: ``_last`` is
also a full-state directory (``checkpoint.py``) that ``--resume``
continues from at ``start_epoch``; SIGTERM or SIGINT stops the run at the
next step (or after validation) with that state saved, and a second signal
aborts; every ``save_interval`` epochs a rotated full state and the
confusion plot; best-epoch writes on a background thread from on-device
copies (``_AsyncBestSaver``), with ``--best_full_state`` the full state
too; ``--tune_threshold`` picks test()'s threshold on val; test() draws
the contour-overlay grids. As in JAX, a resumed run starts
``best_val_iou`` and early stopping afresh. Still to port (ROADMAP.md):
``--fused_epoch``, serving exports, QAT and distillation.
"""

from __future__ import annotations

import csv
import json
import math
import os
import signal
import threading
import time

import numpy as np
import torch

from ddti_tpu_torch.core.logging import ScalarWriter
from ddti_tpu_torch.data.augment import (
    AugmentConfig,
    sample_draws,
    sample_mixup,
)
from ddti_tpu_torch.data.dataset import to_device
from ddti_tpu_torch.eval.metrics import (
    epoch_metrics_from_counts,
    metrics_from_counts,
)
from ddti_tpu_torch.eval.surface import surface_metrics_batch
from ddti_tpu_torch.eval.visualize import save_boundary_grids
from ddti_tpu_torch.utils.early_stopping import EarlyStopping

from .checkpoint import (
    ManagedCheckpointer,
    map_tensors,
    save_checkpoint,
    save_weights,
    to_host,
)
from .state import TrainState, describe_freeze, parse_freeze
from .steps import (
    accumulate,
    make_eval_step,
    make_host_train_step,
    make_infer_step,
    make_threshold_sweep_step,
    make_train_step,
)


class _DeviceSnapshot:
    """Copies of a tree of tensors, made on the training stream when
    constructed: the optimizer updates the parameters in place, so what a
    background save reads must be copied before the next step is
    enqueued. ``to_host`` (from any thread) reads the copies on a side
    stream of its own once they are made, so only that device-to-host
    copy overlaps training, and frees them (JAX ``_snapshot``)."""

    def __init__(self, tree):
        self._tree = map_tensors(tree, lambda t: t.detach().clone())
        self._event = None
        devices = set()
        map_tensors(self._tree, lambda t: devices.add(t.device))
        cuda = [d for d in devices if d.type == "cuda"]
        if cuda:
            self._device = cuda[0]
            self._event = torch.cuda.Event()
            self._event.record()

    def to_host(self):
        tree, self._tree = self._tree, None
        if self._event is None:  # CPU tensors: the copies are the host's
            return tree
        with torch.cuda.device(self._device):
            side = torch.cuda.Stream()
            side.wait_event(self._event)
            with torch.cuda.stream(side):
                return to_host(tree)  # each copy waits for its stream


class _AsyncBestSaver:
    """Background writer for best-epoch artifacts (JAX ``_AsyncBestSaver``):
    the device-to-host copy and the file writes overlap the next epochs
    instead of blocking the step loop. Latest-wins: a newer best that lands
    while one is being written replaces the pending one. A failed write is
    logged at once, as in JAX, and raised by ``close()`` once training
    has ended, so no save error goes unseen."""

    def __init__(self, logger):
        self._logger = logger
        self._cond = threading.Condition()
        self._pending = None
        self._writing = False
        self._stop = False
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="best-saver")
        self._thread.start()

    def submit(self, write_fn, label: str) -> None:
        with self._cond:
            if self._pending is not None:
                self._logger.info(
                    f"--Best-save superseded before writing ({label} "
                    f"replaces it)")
            self._pending = (write_fn, label)
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None and self._stop:
                    return
                write_fn, label = self._pending
                self._pending = None
                self._writing = True
            try:
                write_fn()
                self._logger.info(label)
            except Exception as e:  # never kill training from the writer
                self._logger.warning(f"--Best-save failed: {e}")
                self._error = self._error or e
            finally:
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()

    def join(self) -> None:
        """Block until every submitted save has been written."""
        with self._cond:
            while self._pending is not None or self._writing:
                self._cond.wait()

    def close(self) -> None:
        self.join()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=60)
        if self._error is not None:
            raise RuntimeError("a best-epoch save failed") from self._error


def aug_config_from(config) -> AugmentConfig:
    return AugmentConfig(
        use_elastic=bool(config.use_elastic),
        use_speckle=bool(config.use_speckle), use_tgc=bool(config.use_tgc),
        use_clahe=bool(config.use_clahe), p_crop=float(config.p_crop),
        shared_geometry=bool(config.aug_shared_geometry),
        fast_warp=bool(config.aug_fast_warp),
        out_size=(config.image_size, config.image_size))


class Trainer:
    """Train/validate/test over (train, val, test) sources:
    ``DeviceDataSource``s on the model's device, or streaming sources that
    yield host batches."""

    def __init__(self, config, data, logger, model):
        self.config = config
        self.logger = logger
        self.model = model
        self.device = next(model.parameters()).device
        self.train_src, self.val_src, self.test_src = data
        if hasattr(self.train_src, "num_batches"):
            steps = self.train_src.num_batches(config.batch_size)
        else:  # a host-streaming source
            n = len(getattr(self.train_src, "dataset", []) or [])
            steps = -(-n // config.batch_size)
        self.steps_per_epoch = max(steps, 1)
        # the first epoch train() runs; a full --resume sets it to
        # restored_step // steps_per_epoch, so the run completes the
        # ORIGINAL --epochs budget instead of training that many more
        self.start_epoch = 0
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
        self.host_train_step = make_host_train_step(config)
        self.eval_step = make_eval_step(config)
        self.infer_step = make_infer_step(config)
        self.early_stopping = EarlyStopping(
            logger=logger, patience=config.early_stop_patience, delta=0)
        self.writer = ScalarWriter(config.result_dir)
        # drives the test split's shuffle (the reference's quirk #10)
        self.rng = np.random.default_rng(config.seed)
        self.best_val_iou = -np.inf
        self._gen = self._field_gen = None
        # the stored frames' size, which the device chain's fields take (a
        # host-chain source feeds no device chain)
        src = self.train_src
        self._frame_hw = (
            tuple(src.images.shape[1:3]) if self._is_device_src(src)
            else (src.loader.h, src.loader.w) if hasattr(src, "loader")
            else None)
        # --nan_guard: consecutive rejected steps; the run stops, its
        # checkpoints intact, once the patience is spent
        self._nan_guard = bool(config.nan_guard)
        self._nan_patience = int(config.nan_guard_patience or 5)
        self._consecutive_skips = 0
        self._diverged = False
        self._ckpt_manager = None  # lazy ManagedCheckpointer (rotation)
        self._best_saver = None    # lazy _AsyncBestSaver (async_best_save)
        self._tuned_threshold = None  # the --tune_threshold sweep's pick
        self._last_val_counts = None  # for the periodic confusion plot
        # SIGTERM/SIGINT during train() checkpoints and stops cleanly
        self._preempted = False

    @property
    def preempted(self) -> bool:
        """True when train() stopped on SIGTERM/SIGINT (checkpoints saved;
        resume with --resume --checkpoint_path <run>/models/<Model>_last)."""
        return self._preempted

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

    @staticmethod
    def _is_device_src(src) -> bool:
        return hasattr(src, "epoch_batches")

    def _mix_draws(self, n: int):
        """The mixup draws of a host-augmented step (None without
        --use_mixup), from the epoch's CPU generator."""
        cfg = self.config
        return (sample_mixup(self._gen, n, cfg.mixup_alpha, cfg.mixup_prob)
                if cfg.use_mixup else None)

    def _batches(self, src, shuffle: bool, rng: np.random.Generator):
        """``(idx, images, masks)`` on the Trainer's device: a store's
        gathers, or a streaming source's host batches (idx None: they
        shuffle by themselves and yield the short last batch as it is)."""
        if self._is_device_src(src):
            for idx in src.epoch_batches(rng, self.config.batch_size,
                                         shuffle=shuffle):
                yield (idx, *src.gather(idx))
            return
        for images, masks in src:
            yield (None, *(to_device(torch.from_numpy(x), self.device)
                           for x in (images, masks)))

    # ------------------------------------------------------------------

    def train_one_epoch(self, epoch: int):
        total = None
        self._gen = self._epoch_generator(epoch)
        self._field_gen = self._epoch_generator(epoch, self.device)
        log_every = int(self.config.log_every or 0)
        t0 = time.perf_counter()
        n_imgs = 0
        if hasattr(self.train_src, "set_epoch"):  # a host-streaming
            self.train_src.set_epoch(epoch)       # source: resume-stable
        for i, (_, images, masks) in enumerate(
                self._batches(self.train_src, True, self._epoch_rng(epoch))):
            dev = images.device
            if images.dtype == torch.uint8:
                # raw store data: the device augmentation chain
                draws, mix = self._draws(epoch, i, images.shape[0])
                m = self.train_step(self.state, images, masks, draws.to(dev),
                                    None if mix is None else mix.to(dev))
            else:  # augmented by the host chain: mixup and the update
                mix = self._mix_draws(images.shape[0])
                m = self.host_train_step(self.state, images, masks,
                                         None if mix is None else mix.to(dev))
            total = accumulate(total, m)
            n_imgs += int(images.shape[0])
            if self._nan_guard and not self._note_skip(
                    float(m.skipped), epoch, i):
                break  # patience spent: stop the epoch and the run
            if self._preempted:
                # the step just taken is kept; train() saves and stops
                break
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
    def _first_occurrence_mask(idx, seen: set, device):
        """(B,) float32 {0, 1}: 0 for wraparound-padded duplicates, so
        metrics count every image once (QUIRKS #22). None for a streaming
        source (idx None), whose batches are not padded."""
        if idx is None:
            return None
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
        self._last_val_counts = total.counts
        return avgs["loss"], em["iou"]

    def _on_preempt_signal(self, signum, frame):
        """SIGTERM/SIGINT during train(): finish the step under way, then
        checkpoint and stop. A second signal aborts at once."""
        if self._preempted:
            raise KeyboardInterrupt(f"second signal {signum}: aborting")
        self._preempted = True
        self.logger.warning(
            f"received signal {signum}: will checkpoint and stop at the "
            f"next step boundary (send again to abort without saving)")

    def _install_preempt_handlers(self):
        """The graceful handlers; returns the previous ones (None outside
        the main thread, where signal.signal raises: a Trainer driven from
        a worker thread installs none)."""
        prev = {}
        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                prev[s] = signal.signal(s, self._on_preempt_signal)
        except ValueError:
            return None
        return prev

    def train(self):
        prev_handlers = self._install_preempt_handlers()
        try:
            self._train_loop(self.config)
        finally:
            if prev_handlers is not None:
                for s, h in prev_handlers.items():
                    signal.signal(s, h)

    def _log_preempted(self, when: str, epoch: int) -> None:
        cfg = self.config
        last = os.path.join(cfg.model_dir, f"{cfg.model_type}_last")
        self.logger.warning(
            f"preempted {when} epoch {epoch + 1}: saving checkpoints and "
            f"stopping — resume with --resume --checkpoint_path {last}")

    def _train_loop(self, cfg):
        if self.start_epoch:
            self.logger.info(
                f"Resuming at epoch {self.start_epoch + 1}/{cfg.epochs} "
                f"(restored step {int(self.state.step)})")
        for epoch in range(self.start_epoch, cfg.epochs):
            self.train_one_epoch(epoch)
            if self._diverged:  # --nan_guard patience spent; the last
                break           # weights below are still saved
            if self._preempted:
                self._log_preempted("at", epoch)
                break
            _, val_iou = self.validate(epoch)

            # rotated full states and the confusion plot every
            # save_interval epochs
            if cfg.save_interval and (epoch + 1) % cfg.save_interval == 0:
                if self._ckpt_manager is None:
                    self._ckpt_manager = ManagedCheckpointer(
                        os.path.join(cfg.model_dir, "periodic"),
                        max_to_keep=cfg.max_keep_checkpoints)
                self._ckpt_manager.save(epoch + 1, self.state,
                                        metrics={"val_iou": float(val_iou)})
                try:
                    from ddti_tpu_torch.eval.confusion import (
                        save_confusion_matrix,
                    )
                    c = self._last_val_counts
                    save_confusion_matrix(float(c.tp), float(c.fp),
                                          float(c.fn), float(c.tn),
                                          cfg.result_dir, epoch)
                except Exception:
                    pass

            if val_iou > self.best_val_iou:
                self.best_val_iou = val_iou
                self._save_best(epoch, val_iou)
            self.early_stopping(-val_iou)
            if self.early_stopping.early_stop:
                self.logger.info("--Early stopping triggered")
                break
            if self._preempted:  # the signal came during validate or saves
                self._log_preempted("after", epoch)
                break

        last = os.path.join(cfg.model_dir, f"{cfg.model_type}_last")
        save_checkpoint(last, self.state)
        self._save("last")
        if self._best_saver is not None:
            # every best artifact is on disk before anything reads it
            self._best_saver.close()
            self._best_saver = None
        if self._ckpt_manager is not None:
            self._ckpt_manager.close()
            self._ckpt_manager = None
        self.writer.close()

    def _save_best(self, epoch: int, val_iou: float) -> None:
        """The best-epoch artifacts: ``.npz`` and ``.pth`` of the eval
        weights, and under --best_full_state the full state in
        ``<Model>_best/``. By default on a background thread from
        on-device copies, while training goes on; train() joins it before
        anything reads the files. --async_best_save false writes them
        here."""
        cfg = self.config
        best = os.path.join(cfg.model_dir, f"{cfg.model_type}_best")
        label = (f"--Best model saved at epoch {epoch + 1} "
                 f"with IoU: {val_iou:.4f}")
        full = bool(cfg.best_full_state)
        if not cfg.async_best_save:
            if full:
                save_checkpoint(best, self.state)
            self._save("best")
            self.logger.info(label)
            return
        snap = _DeviceSnapshot({
            "weights": self.state.eval_state_dict(),
            "full": self.state.full_state_dict() if full else {}})

        def write():
            host = snap.to_host()
            if host["full"]:
                save_checkpoint(best, host["full"])
            save_weights(best, cfg.model_type, self.model, host["weights"])

        if self._best_saver is None:
            self._best_saver = _AsyncBestSaver(self.logger)
        self._best_saver.submit(write, label)

    # ------------------------------------------------------------------

    def tune_threshold(self, grid=None) -> float:
        """Sweep the binarization threshold over the VAL split, every
        candidate scored from one forward a batch, and return the
        argmax-IoU one (JAX ``tune_threshold``; the reference hardcodes
        0.5)."""
        grid = (np.round(np.arange(0.05, 0.951, 0.05), 2)
                if grid is None else np.asarray(grid))
        sweep = make_threshold_sweep_step(self.config, grid)
        total = None
        seen = set()
        for idx, images, masks in self._batches(self.val_src, False,
                                                self.rng):
            # validate()'s per-image accounting (QUIRKS #22)
            c = sweep(self.state, images, masks,
                      self._first_occurrence_mask(idx, seen, images.device))
            total = c if total is None else total + c
        inter = total.inter.cpu().numpy()
        union = total.union.cpu().numpy()
        ious = inter / np.maximum(union, 1e-8)
        t = float(grid[int(np.argmax(ious))])
        self.logger.info(
            "Threshold sweep (val IoU): "
            + ", ".join(f"{g:.2f}:{i:.4f}" for g, i in zip(grid, ious))
            + f" -> using {t:.2f}")
        self._tuned_threshold = t
        return t

    # ------------------------------------------------------------------

    def test(self, visualize: bool = True) -> dict:
        """Global micro-averaged pixel metrics over the test split (shuffled
        by ``self.rng``, the reference's quirk), per-image audit rows with
        HD95/ASSD, ``result/test_metrics.json``,
        ``result/per_image_metrics.csv`` and, with ``visualize``, the
        contour-overlay grids (``test_boundaries_<k>.png``). Under
        --tune_threshold at the val split's tuned threshold."""
        self.logger.info(
            "------------------Starting Testing Model------------------")
        threshold = 0.5
        if self.config.tune_threshold:
            threshold = (self._tuned_threshold
                         if self._tuned_threshold is not None
                         else self.tune_threshold())
            if threshold != 0.5:
                self.infer_step = make_infer_step(self.config, threshold)
        rows, seen = [], set()
        frames = ([], [], [])  # images, masks, predictions for the grids
        for idx, images, masks in self._batches(self.test_src, True,
                                                self.rng):
            imgs_f, masks_f, preds, _, per_img = self.infer_step(
                self.state, images, masks)
            surf = (surface_metrics_batch(preds, masks_f)
                    if self.config.surface_metrics else None)
            self._collect_per_image(rows, seen, idx, per_img, surf)
            if visualize:
                for acc, x in zip(frames, (imgs_f, masks_f.to(torch.uint8),
                                           preds)):
                    acc.append(x[..., 0].cpu().numpy())
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
                       "threshold": threshold,
                       "tta": bool(self.config.tta)}, f, indent=1)
        if rows:
            self._write_per_image_csv(rows)
        if visualize and frames[0]:
            t0 = time.perf_counter()
            paths = save_boundary_grids(
                *(np.concatenate(x) for x in frames), self.config.result_dir)
            n = sum(len(x) for x in frames[0])
            self.logger.info(
                f"Contour grids: {n} frames in "
                f"{time.perf_counter() - t0:.3f} s -> "
                + ", ".join(os.path.basename(p) for p in paths))
        return m

    def _collect_per_image(self, rows: list, seen: set, idx, per_img,
                           surf=None):
        """Audit rows of one test batch; padded duplicates are dropped. A
        streaming source's rows (idx None) carry running positions and no
        names."""
        c = [v.cpu().numpy() for v in per_img]
        tp_, fp_, fn_, tn_, inter_, union_ = c
        if surf is not None:
            surf = {k: v.cpu().numpy() for k, v in surf.items()}
        names = (getattr(self.test_src, "names", None)
                 if idx is not None else None)
        ids = (np.asarray(idx) if idx is not None
               else np.arange(len(rows), len(rows) + len(tp_)))
        for j, i in enumerate(ids):
            i = int(i)
            if idx is not None:
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
