"""Seeding, ported from ``ddti_tpu/core/prng.py``: seeds the host-side
Python, numpy and torch generators and returns an explicit
``torch.Generator`` (where the JAX package returns its root key)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
