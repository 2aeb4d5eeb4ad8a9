"""Learning-rate range test, ported from ``ddti_tpu/train/lr_finder.py``
(Smith, "Cyclical Learning Rates", 2015/17).

``--lr_find N`` runs the range test instead of training: N AdamW steps of
the Trainer's own train step (the teacher under distillation) on its own
train source, the learning rate ramped geometrically from
``--lr_find_min`` to ``--lr_find_max``, the loss recorded at each step. The
steps train a disposable copy of the model and its BatchNorm statistics
with a fresh AdamW (the run's --freeze mask and clipping), and draw their
batches and augmentation from generators of their own, so the Trainer's
state is untouched afterwards.

Outputs into the run's ``result/``: ``lr_find.csv`` (step, lr, loss,
smoothed) and ``lr_find.png`` (skipped with a warning where matplotlib is
absent). Two suggestions are logged: the steepest descent of the smoothed
curve and the minimum-loss lr / 10 (the fastai heuristics).
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch

from .state import TrainState, parse_freeze

# the range test's stream of batches and draws, apart from every epoch's
# (JAX folds the same constant into its key)
LR_FIND_STREAM = 0x1F


def run_lr_finder(trainer, num_steps: int = 100, min_lr: float = 1e-7,
                  max_lr: float = 1.0, smooth_beta: float = 0.98,
                  diverge_factor: float = 4.0) -> dict:
    """Run the range test on ``trainer``'s train source. Returns
    ``{"lr_steepest", "lr_min_over_10", "history", "stop_reason", "csv",
    "png"}`` as JAX's does."""
    cfg = trainer.config
    num_steps = max(int(num_steps), 2)
    ratio = max_lr / min_lr

    def ramp(step):
        return min_lr * ratio ** (min(step, num_steps - 1) / (num_steps - 1))

    # the disposable state: a copy of the run's current weights (a warm
    # start probes around them), one lr a step (steps_per_epoch 1)
    src_state = trainer.state
    state = TrainState(
        copy.deepcopy(src_state.model), min_lr, 1, cfg.weight_decay,
        model_type=src_state.model_type, freeze=parse_freeze(cfg),
        clip_norm=float(getattr(cfg, "clip_grad_norm", 0.0) or 0.0),
        nan_guard=bool(getattr(cfg, "nan_guard", False)))
    state.schedule = ramp
    if getattr(cfg, "nan_guard", False):  # a device-guarded step's
        state.init_optimizer_state()      # snapshot needs them
    seed = np.random.SeedSequence((int(cfg.seed), LR_FIND_STREAM))
    s0, s1 = (int(v) for v in seed.generate_state(2))
    rng = np.random.default_rng((int(cfg.seed), LR_FIND_STREAM))
    kept = trainer._gen, trainer._field_gen
    trainer._gen = torch.Generator().manual_seed(s0)
    trainer._field_gen = torch.Generator(
        device=trainer.device).manual_seed(s1)

    history = []  # (lr, loss, smoothed)
    ema = 0.0
    best = math.inf
    stop_reason = "completed"
    i = 0
    try:
        while i < num_steps and stop_reason == "completed":
            made_progress = False
            for _, images, masks in trainer._batches(trainer.train_src, True,
                                                     rng):
                made_progress = True
                m = trainer._train_on(-1, i, images, masks, state=state)
                loss = float(m.loss)
                lr = min_lr * ratio ** (i / (num_steps - 1))
                if not math.isfinite(loss):
                    stop_reason = f"non-finite loss at lr={lr:.3g}"
                    break
                ema = smooth_beta * ema + (1 - smooth_beta) * loss
                sm = ema / (1 - smooth_beta ** (i + 1))
                history.append((lr, loss, sm))
                best = min(best, sm)
                i += 1
                if sm > diverge_factor * best and i > 10:
                    stop_reason = f"diverged at lr={lr:.3g}"
                    break
                if i >= num_steps:
                    break
            if not made_progress:
                raise RuntimeError("empty train source; cannot run lr_find")
    finally:
        trainer._gen, trainer._field_gen = kept

    if len(history) < 5:
        raise RuntimeError(
            f"lr_find collected only {len(history)} finite steps "
            f"({stop_reason}); lower --lr_find_max")
    return _report(trainer, history, stop_reason)


def _report(trainer, history: list, stop_reason: str) -> dict:
    """The suggestions, ``lr_find.csv``, ``lr_find.png`` and the log line,
    JAX's to the byte."""
    lrs = np.array([h[0] for h in history])
    sms = np.array([h[2] for h in history])
    # steepest descent of the smoothed curve in log-lr space (central
    # differences); the edges, where the EMA is still biased, skipped
    grad = np.gradient(sms, np.log(lrs))
    lo = min(5, len(grad) // 4)
    core = slice(lo, len(grad) - 1)
    lr_steepest = float(lrs[core][np.argmin(grad[core])])
    lr_min_over_10 = float(lrs[np.argmin(sms)] / 10.0)

    rd = trainer.config.result_dir or "."
    csv_path = os.path.join(rd, "lr_find.csv")
    png_path = os.path.join(rd, "lr_find.png")
    out = {"lr_steepest": lr_steepest, "lr_min_over_10": lr_min_over_10,
           "history": history, "stop_reason": stop_reason,
           "csv": csv_path, "png": png_path}
    if not trainer.is_writer:  # a data-parallel rank other than 0
        return out
    os.makedirs(rd, exist_ok=True)
    with open(csv_path, "w") as f:
        f.write("step,lr,loss,smoothed\n")
        for j, (lr, loss, sm) in enumerate(history):
            f.write(f"{j},{lr:.6g},{loss:.6g},{sm:.6g}\n")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot(lrs, [h[1] for h in history], alpha=0.3, label="loss")
        ax.plot(lrs, sms, label="smoothed")
        ax.axvline(lr_steepest, color="tab:green", ls="--",
                   label=f"steepest {lr_steepest:.2g}")
        ax.axvline(lr_min_over_10, color="tab:red", ls=":",
                   label=f"min/10 {lr_min_over_10:.2g}")
        ax.set_xscale("log")
        ax.set_xlabel("learning rate")
        ax.set_ylabel("loss")
        ax.set_title(f"LR range test ({len(history)} steps, {stop_reason})")
        ax.legend()
        fig.tight_layout()
        fig.savefig(png_path, dpi=110)
        plt.close(fig)
    except Exception as e:  # the plot must never sink the sweep
        trainer.logger.warning(f"lr_find plot skipped: {e}")
        out["png"] = None

    trainer.logger.info(
        f"LR range test: {len(history)} steps ({stop_reason}); "
        f"suggested --lr {lr_steepest:.3g} (steepest descent) or "
        f"{lr_min_over_10:.3g} (min-loss/10) — curve in {csv_path}")
    return out
