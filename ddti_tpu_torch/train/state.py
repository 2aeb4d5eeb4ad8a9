"""Train state and optimizer, ported from ``ddti_tpu/train/state.py``.

AdamW with the reference's effective settings (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-2 on every parameter, as optax ``adamw`` without a mask),
its learning rate set before every step from the per-epoch cosine warm
restarts of ``schedule.py``: step s trains at ``schedule(s //
steps_per_epoch)``, as the JAX package's optax schedule does. Freezing and
gradient clipping are still to port (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import torch
from torch import nn

from .schedule import cosine_warm_restarts


def make_optimizer(params, lr: float, weight_decay: float = 1e-2,
                   t_0: int = 20, t_mult: int = 2):
    """Returns (AdamW, schedule: epoch -> lr)."""
    sched = cosine_warm_restarts(lr, t_0, t_mult)
    opt = torch.optim.AdamW(params, lr=sched(0), betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    return opt, sched


class TrainState:
    """The model, its optimizer and the step count (JAX ``TrainState``,
    which is immutable; here the train step updates this one in place)."""

    def __init__(self, model: nn.Module, lr: float, steps_per_epoch: int,
                 weight_decay: float = 1e-2):
        self.model = model
        self.optimizer, self.schedule = make_optimizer(
            model.parameters(), lr, weight_decay)
        self.steps_per_epoch = steps_per_epoch
        self.step = 0

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at this step's
        scheduled learning rate; advances the step."""
        lr = self.schedule(self.step // self.steps_per_epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
