"""Patience-based early stopping on a minimized score, copied from
``ddti_tpu/utils/early_stopping.py`` (plain Python).

Same contract as the reference's utils/utils.py:173-202: call with the value
to minimize (the Trainer passes ``-val_iou``); after ``patience`` calls
without improvement ``early_stop`` flips. The reference logs the metric as
"Validation loss" even when fed IoU — we label it neutrally.
"""

from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, logger=None, patience: int = 10, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.logger = logger
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.metric_min = math.inf

    def _log(self, msg: str):
        if self.logger is not None:
            self.logger.info(msg)

    def __call__(self, metric: float) -> None:
        score = -metric
        if self.best_score is None or score >= self.best_score + self.delta:
            self._log(f"--Monitored metric improved "
                      f"({self.metric_min:.6f} --> {metric:.6f}).")
            self.best_score = score
            self.metric_min = metric
            self.counter = 0
        else:
            self.counter += 1
            self._log(f"--EarlyStopping counter: {self.counter} "
                      f"out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
