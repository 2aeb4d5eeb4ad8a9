"""Learning-rate schedule, ported from ``ddti_tpu/train/schedule.py``.

``cosine_warm_restarts``: closed-form torch
CosineAnnealingWarmRestarts(T_0=20, T_mult=2, eta_min=0) stepped once per
epoch, as the reference uses it. For T_mult=2 the cycle holding epoch e has
index i = floor(log2(e/T_0 + 1)), start T_0*(2^i - 1), length T_0*2^i.
Computed in float32 with the JAX package's order of operations, so both
packages train with the same learning rates.
"""

from __future__ import annotations

import numpy as np


def cosine_warm_restarts(base_lr: float, t_0: int = 20, t_mult: int = 2,
                         eta_min: float = 0.0):
    """Returns ``schedule(epoch) -> lr`` (a Python float)."""
    if t_mult < 1:
        raise ValueError("t_mult must be >= 1")
    f32 = np.float32

    def schedule(epoch: int) -> float:
        e = f32(epoch)
        if t_mult == 1:
            t_cur = np.mod(e, f32(t_0))
            t_i = f32(t_0)
        else:
            ratio = e / f32(t_0) * f32(t_mult - 1) + f32(1)
            i = np.floor(np.log(ratio) / np.log(f32(t_mult)))
            start = (f32(t_0) * (np.power(f32(t_mult), i) - f32(1))
                     / f32(t_mult - 1))
            t_i = f32(t_0) * np.power(f32(t_mult), i)
            t_cur = e - start
        # the cosine rounded from float64: within an ulp of XLA's float32 one
        cos = f32(0.5) * (f32(1) + f32(np.cos(np.float64(
            f32(np.pi) * t_cur / t_i))))
        return float(f32(eta_min) + (f32(base_lr) - f32(eta_min)) * cos)

    return schedule
