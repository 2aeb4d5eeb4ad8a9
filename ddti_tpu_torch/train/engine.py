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
``best_val_iou`` and early stopping afresh.

The Trainer also sets its model's BatchNorm variance (flax's one pass by
default, two with ``--bn_exact_variance``: ``models/blocks.py``), builds
the ``--distill_checkpoint`` teacher (``distill.py``) into every train
step, traces the first ``--profile N`` steps of epoch 1 with
``torch.profiler`` into ``<result_dir>/trace`` and, with ``--fused_epoch``
and a device store, runs each train epoch as one CUDA graph
(``_train_one_epoch_fused``). With ``--qat`` every tracked conv trains
fake-quantized (``qat.py``) and the activation ranges ride the state, the
full-state checkpoints and the best and last ``.npz`` (``qstats/``).
``--export_serving`` writes the serving bundles after training
(``_export_serving_artifacts``, skipped after a preemption): f32, bf16 or
int8 (``--serving_dtype``; int8 from the QAT ranges, else one calibration
batch), one program per ``--serving_batches`` entry, and the baked
program. Still to port (ROADMAP.md Queue 1 item 12): the mesh and its
sharded exports.
"""

from __future__ import annotations

import copy
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
    dense_draws,
    sample_draws,
    sample_mixup,
)
from ddti_tpu_torch.data.dataset import to_device
from ddti_tpu_torch.eval.metrics import (
    epoch_metrics_from_counts,
    metrics_from_counts,
)
from ddti_tpu_torch.eval.surface import surface_metrics_batch
from ddti_tpu_torch.eval.metrics import ConfusionCounts
from ddti_tpu_torch.eval.visualize import save_boundary_grids
from ddti_tpu_torch.models.blocks import set_bn_exact_variance
from ddti_tpu_torch.utils.early_stopping import EarlyStopping

from .checkpoint import (
    ManagedCheckpointer,
    map_tensors,
    save_checkpoint,
    save_weights,
    to_host,
)
from .distill import describe_teacher, teacher_from_config
from .state import TrainState, describe_freeze, parse_freeze
from .steps import (
    StepMetrics,
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


def zero_metrics(device) -> StepMetrics:
    """A ``StepMetrics`` of zeros to sum steps into in place
    (``accumulate_``)."""
    def z(dtype=torch.float32):
        return torch.zeros((), dtype=dtype, device=device)

    return StepMetrics(z(), z(), z(), z(), z(),
                       ConfusionCounts(*(z(torch.float64) for _ in range(6))),
                       z(), z())


def accumulate_(total: StepMetrics, m: StepMetrics) -> None:
    """``accumulate`` in place, into ``zero_metrics``' tensors (a captured
    step adds to the same tensors at every replay); the same values as
    ``accumulate``'s, bit for bit."""
    for name in ("loss", "bce", "dice", "focal", "boundary"):
        getattr(total, name).add_(getattr(m, name) * m.n)
    for a, b in zip(total.counts, m.counts):
        a.add_(b)
    total.n.add_(m.n)
    total.skipped.add_(m.skipped)


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
        # the BatchNorm variance, set both ways on this model's modules, as
        # the JAX Trainer sets its process-wide one
        exact = bool(getattr(config, "bn_exact_variance", False))
        set_bn_exact_variance(model, exact)
        if exact:
            logger.info("--bn_exact_variance: two-pass BatchNorm variance "
                        "(torch numerics)")
        # --fused_epoch applies to a device store; a streaming source keeps
        # the stepwise loop, as in JAX
        self.fused = (bool(getattr(config, "fused_epoch", False))
                      and self._is_device_src(self.train_src))
        freeze = parse_freeze(config)
        self.state = TrainState(
            model, config.lr, self.steps_per_epoch, config.weight_decay,
            model_type=config.model_type, freeze=freeze,
            clip_norm=config.clip_grad_norm, ema=config.ema_decay > 0,
            nan_guard=bool(config.nan_guard))
        if bool(getattr(config, "qat", False)):
            from .qat import init_qstats

            side = int(config.image_size)
            self.state.qstats = init_qstats(
                model, (1, int(getattr(model, "in_channels", 1)), side, side),
                int(getattr(config, "quant_min_channels", 0) or 0),
                config.model_type)
            logger.info(f"--qat: {len(self.state.qstats)} convs "
                        f"fake-quantized, activation-range EMA decay "
                        f"{float(getattr(config, 'qat_ema_decay', 0.99))}")
        if freeze:
            logger.info(
                f"Freezing {','.join(freeze)}: "
                f"{describe_freeze(config.model_type, model, freeze)} "
                f"params fixed" + (", BN stats pinned too"
                                   if config.freeze_bn_stats
                                   else " (BN stats keep adapting)"))
        # --distill_checkpoint: the frozen teacher inside every train step
        self.teacher = teacher_from_config(config, self.device)
        if self.teacher is not None:
            logger.info(describe_teacher(config, self.teacher))
        self.aug_cfg = aug_config_from(config)
        # under --fused_epoch the nan_guard decides on the device, so that
        # the step can be captured
        device_guard = self.fused and bool(config.nan_guard)
        if device_guard:
            self.state.init_optimizer_state()
        self.train_step = make_train_step(config, self.aug_cfg,
                                          teacher=self.teacher,
                                          device_guard=device_guard)
        self.host_train_step = make_host_train_step(config, self.teacher)
        # the last fused epoch: the steps captured and the graph replays
        self.fused_stats = None
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
        if self.fused:
            if epoch == 0 and getattr(self.config, "profile_steps", 0):
                self.logger.warning(
                    "--profile is ignored under --fused_epoch (the epoch "
                    "is one CUDA graph replayed: there are no per-step "
                    "trace boundaries); rerun without --fused_epoch to "
                    "trace")
            if epoch == 0 and self._nan_guard:
                self.logger.warning(
                    "--nan_guard under --fused_epoch degrades to EPOCH "
                    "granularity: rejected steps are still skipped on the "
                    "device, but the patience counter only sees the "
                    "per-epoch skip total (training stops when a whole "
                    "epoch is rejected, not after %s bad steps)",
                    self._nan_patience)
            return self._train_one_epoch_fused(epoch)
        total = None
        self._gen = self._epoch_generator(epoch)
        self._field_gen = self._epoch_generator(epoch, self.device)
        log_every = int(self.config.log_every or 0)
        # --profile N: a torch.profiler trace of epoch 1's first N steps;
        # a tracing failure never fails the run
        prof_n = (int(getattr(self.config, "profile_steps", 0) or 0)
                  if epoch == 0 else 0)
        prof = None
        t0 = time.perf_counter()
        n_imgs = 0
        if hasattr(self.train_src, "set_epoch"):  # a host-streaming
            self.train_src.set_epoch(epoch)       # source: resume-stable
        for i, (_, images, masks) in enumerate(
                self._batches(self.train_src, True, self._epoch_rng(epoch))):
            if prof_n and i == 0:
                prof = self._start_trace()
                prof_n = prof_n if prof is not None else 0
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
            if prof_n and i + 1 == prof_n:
                self._stop_trace(prof, f"--Trace of {prof_n} steps written")
                prof_n = 0
            if log_every and (i + 1) % log_every == 0:
                ips = n_imgs / max(time.perf_counter() - t0, 1e-9)
                self.logger.info(f"Epoch {epoch + 1} step {i + 1}: "
                                 f"loss {float(m.loss):.4f} — {ips:.1f} "
                                 f"img/s")
            else:
                self.logger.debug(f"Epoch {epoch + 1} step {i + 1} done "
                                  f"({n_imgs} imgs)")
        if prof_n:  # the epoch ended before step prof_n: close the trace
            self._stop_trace(prof, "--Trace written")
        em = epoch_metrics_from_counts(total.counts)
        self._log_epoch("Train", epoch, self._avgs(total), em)
        self._log_skips(epoch, float(total.skipped))

    def _trace_dir(self) -> str:
        return os.path.join(self.config.result_dir, "trace")

    def _start_trace(self):
        """A started ``torch.profiler`` (CPU, and the card's kernels on
        CUDA) writing a Chrome/TensorBoard trace into ``result/trace``
        when stopped; None, with JAX's warning, where it cannot start."""
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts,
                           on_trace_ready=tensorboard_trace_handler(
                               self._trace_dir()))
            prof.start()
            return prof
        except Exception as e:
            self.logger.warning(f"trace capture unavailable: {e}")
            return None

    def _stop_trace(self, prof, said: str) -> None:
        try:
            if self.device.type == "cuda":  # the steps' kernels into the
                torch.cuda.synchronize(self.device)  # trace window
            prof.stop()
            self.logger.info(f"{said} to {self._trace_dir()}")
        except Exception as e:
            self.logger.warning(f"trace capture failed: {e}")

    def _train_one_epoch_fused(self, epoch: int):
        """The epoch's batch indices and every step's draws made up front
        (the stepwise loop's generators, in its order, so both modes draw
        the same) and put on the device before the first step, each step's
        in the fixed-shape form a graph replays (``dense_draws``); the
        metrics summed on the device, read once. On CUDA, step 0 runs
        eagerly (the kernels' attributes, cuDNN's plans, AdamW's state, the
        epoch's learning rate), one step is captured as a CUDA graph and
        replayed for each later step after a device-side copy of that
        step's slice into its inputs; a failed capture raises. On the CPU
        the same loop runs without a graph. ``--nan_guard`` decides on the
        device and stops the run only when a whole epoch was rejected
        (JAX's fused rule)."""
        src, cfg = self.train_src, self.config
        idx = np.stack(list(src.epoch_batches(self._epoch_rng(epoch),
                                              cfg.batch_size)))
        steps, batch = idx.shape
        self._gen = self._epoch_generator(epoch)
        self._field_gen = self._epoch_generator(epoch, self.device)
        dev = self.device
        draws = []
        for i in range(steps):
            aug, mix = self._draws(epoch, i, batch)
            draws.append((aug.to(dev), None if mix is None else mix.to(dev)))
        idx = torch.from_numpy(idx.astype(np.int64)).to(dev)
        total = zero_metrics(dev)
        start_step = self.state.step
        if dev.type == "cuda":
            self._replay_epoch(src, idx, draws, total)
        else:
            for i, (aug, mix) in enumerate(draws):
                accumulate_(total, self.train_step(
                    self.state, src.images[idx[i]], src.masks[idx[i]],
                    dense_draws(aug, batch), mix))
        skipped = float(total.skipped)
        # the schedule's position counts the applied steps, as stepwise
        self.state.step = start_step + steps - int(skipped)
        em = epoch_metrics_from_counts(total.counts)
        self._log_epoch("Train", epoch, self._avgs(total), em)
        self._log_skips(epoch, skipped)
        if self._nan_guard and skipped >= steps:
            self.logger.error("--nan_guard: every step of the fused epoch "
                              "was non-finite — stopping")
            self._diverged = True

    def _replay_epoch(self, src, idx, draws, total) -> None:
        """The CUDA side of ``_train_one_epoch_fused``: step 0 eagerly, a
        capture of one step into a graph, a replay for each later step.
        ``fused_stats`` records the steps captured and the replays; a
        kernel wrapper counts the launches made in Python, the eager
        step's and the capture's, not a replay's."""
        steps, batch = idx.shape

        def inputs(i):
            aug, mix = draws[i]
            return [idx[i]] + [t for t in dense_draws(aug, batch)
                               if t is not None] + list(mix or ())

        static = [t.clone() for t in inputs(0)]
        s_idx = static[0]
        it = iter(static[1:])
        aug0, mix0 = dense_draws(draws[0][0], batch), draws[0][1]
        s_aug = type(aug0)(*(None if t is None else next(it) for t in aug0))
        s_mix = None if mix0 is None else type(mix0)(*it)

        def step():
            accumulate_(total, self.train_step(
                self.state, src.images[s_idx], src.masks[s_idx], s_aug,
                s_mix))

        step()  # step 0, eagerly
        if steps == 1:
            self.fused_stats = {"captured": 0, "replays": 0}
            return
        # the eager step's cached blocks are released, so the graph's
        # private memory pool can take them
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for i in range(1, steps):
            for a, b in zip(static, inputs(i)):
                a.copy_(b)
            graph.replay()
        # the graph's private pool back to the card before validation
        del graph
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        self.fused_stats = {"captured": 1, "replays": steps - 1}
        self.logger.info(f"Fused epoch: step 0 eager, 1 step captured, "
                         f"{steps - 1} graph replays")

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
                     self.state.eval_state_dict(), self.state.qstats)

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
        if getattr(cfg, "export_serving", False):
            if self._preempted:
                # the grace window is for checkpoints; the resumed run
                # exports when it completes (JAX's rule)
                self.logger.warning(
                    "preempted: --export_serving skipped (runs when the "
                    "resumed job completes)")
            else:
                self._export_serving_artifacts()
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
            "qstats": self.state.qstats or {},
            "full": self.state.full_state_dict() if full else {}})

        def write():
            host = snap.to_host()
            if host["full"]:
                save_checkpoint(best, host["full"])
            save_weights(best, cfg.model_type, self.model, host["weights"],
                         host["qstats"] or None)

        if self._best_saver is None:
            self._best_saver = _AsyncBestSaver(self.logger)
        self._best_saver.submit(write, label)

    # ------------------------------------------------------------------

    def _serving_model(self):
        """A copy of the model holding the eval weights (the EMA shadow
        under --ema_decay), in eval mode: what the serving exports
        trace."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(self.state.eval_state_dict())
        return model.eval()

    def _calibration_batch(self) -> torch.Tensor:
        """One validation batch in serving-input form (NHWC float32 [0, 1]
        at image_size): the int8 activation calibration's input."""
        from ddti_tpu_torch.data.augment import eval_preprocess

        size = self.config.image_size
        for _, images, _ in self._batches(self.val_src, False, self.rng):
            if images.dtype == torch.uint8:
                images = images.to(torch.float32) / 255.0
            images, _ = eval_preprocess(images, images, (size, size))
            return images
        raise ValueError("empty validation source; cannot calibrate int8")

    def _serving_threshold(self) -> float:
        """The threshold baked into serving exports: the val-tuned one
        under --tune_threshold (the sweep test() reuses), else 0.5; a
        failed sweep exports at 0.5 (the export never fails the run)."""
        if not getattr(self.config, "tune_threshold", False):
            return 0.5
        if self._tuned_threshold is None:
            try:
                self.tune_threshold()
            except Exception as e:
                self.logger.warning(
                    f"threshold sweep failed ({e}); exporting at 0.5")
                return 0.5
        return self._tuned_threshold

    def _export_serving_artifacts(self) -> None:
        """Write the serving bundles (JAX ``_export_serving_artifacts``
        without its mesh branch): one weights-as-arguments program a
        ``--serving_batches`` entry (``<Model>_serving_program.pt2`` + .npz,
        ``<Model>_b<N>_serving_program.pt2`` when several) in
        ``--serving_dtype``, then the baked ``<Model>_serving.pt2``. An int8
        export quantizes once, from the QAT ranges under --qat, else from
        one validation batch, honouring --quant_min_channels. Each artifact
        is guarded on its own: an export never fails the run."""
        from .export import (
            PROGRAM_SUFFIX,
            export_program,
            export_serving_program,
            save_bundle,
            save_serving,
        )

        cfg = self.config
        sd = getattr(cfg, "serving_dtype", "f32") or "f32"
        tta = bool(getattr(cfg, "tta", False))
        bf16 = bool(cfg.use_amp_autocast)
        thr = self._serving_threshold()
        mt = cfg.model_type
        model = self._serving_model()
        batches = [int(b) for b in str(
            getattr(cfg, "serving_batches", "") or cfg.batch_size
        ).split(",") if b]
        variables_q = None
        if sd == "int8":
            try:
                from .quantize import quantize_serving

                mc = int(getattr(cfg, "quant_min_channels", 0) or 0)
                if self.state.qstats:
                    from .qat import qstats_amax

                    variables_q = quantize_serving(
                        model, amax=qstats_amax(self.state.qstats),
                        min_channels=mc, model_type=mt, bf16=bf16)
                else:
                    variables_q = quantize_serving(
                        model, self._calibration_batch(), min_channels=mc,
                        model_type=mt, bf16=bf16)
            except Exception as e:
                self.logger.warning(f"serving quantization failed: {e}")
        written = []
        for bn in (batches if sd != "int8" or variables_q is not None
                   else []):
            out = os.path.join(cfg.model_dir, f"{mt}{PROGRAM_SUFFIX}"
                               if len(batches) == 1
                               else f"{mt}_b{bn}{PROGRAM_SUFFIX}")
            try:
                if sd == "int8":
                    variables = variables_q
                    program = export_program(
                        model, variables_q, bn, cfg.image_size,
                        threshold=thr, tta=tta, bf16=bf16, quantized=True,
                        model_type=mt)
                else:
                    program, variables = export_serving_program(
                        model, bn, cfg.image_size, threshold=thr,
                        weights_dtype=(torch.bfloat16 if sd == "bf16"
                                       else None),
                        tta=tta, bf16=bf16, model_type=mt)
                save_bundle(out, program, variables)
                written.append(out)
            except Exception as e:
                self.logger.warning(
                    f"serving export failed at batch {bn}: {e}")
        if written:
            self.logger.info("--Serving artifacts exported to "
                             + ",".join(written))
        try:
            path = os.path.join(cfg.model_dir, f"{mt}_serving.pt2")
            save_serving(path, model, cfg.batch_size, cfg.image_size,
                         threshold=thr, tta=tta, bf16=bf16, model_type=mt)
            self.logger.info(f"--Baked serving artifact: {path}")
        except Exception as e:
            self.logger.warning(f"baked serving export failed: {e}")

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
