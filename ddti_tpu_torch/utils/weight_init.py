"""Weight initialisers, ported from ``ddti_tpu/utils/weight_init.py``: the
working equivalent of the reference's never-called ``init_weights``, plus
the flax default the JAX Trainer's models start from.

- ``kaiming_conv_``: Kaiming-normal (fan_out, relu) for conv kernels, a
  plain (untruncated) normal like flax's ``variance_scaling(2, "fan_out",
  "normal")`` and ``nn.init.kaiming_normal_``.
- ``xavier_dense_``: flax's ``xavier_normal()`` is ``variance_scaling(1,
  "fan_avg", "truncated_normal")``, a normal truncated at two standard
  deviations and rescaled to keep the variance, unlike torch's untruncated
  ``xavier_normal_``; this matches flax.
- ``lecun_normal_``: flax's default kernel initialiser
  (``variance_scaling(1, "fan_in", "truncated_normal")``), which every
  ``nn.Conv`` / ``nn.ConvTranspose`` of the JAX zoo starts from, biases at
  zero. ``init_like_flax`` applies it to a port model.

Fans follow flax's reading of its own layouts: a conv kernel's receptive
field times its input (fan_in) or output (fan_out) channels; torch's
``ConvTranspose2d`` weight is (in, out, kh, kw).
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling
# divides by it so the truncated draw keeps the requested variance)
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor, transposed: bool = False) -> tuple[int, int]:
    receptive = w[0, 0].numel() if w.dim() > 2 else 1
    cout, cin = w.shape[0], w.shape[1]
    if transposed:
        cout, cin = cin, cout
    return cin * receptive, cout * receptive


def _truncated_normal_(w, std, generator=None):
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(std / _TRUNC_STD)


def kaiming_conv_(w: torch.Tensor, transposed: bool = False,
                  generator=None) -> torch.Tensor:
    """Kaiming-normal (mode fan_out, relu gain) for a conv kernel."""
    _, fan_out = _fans(w, transposed)
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def xavier_dense_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``xavier_normal()`` for an (out, in) dense kernel."""
    fan_in, fan_out = _fans(w)
    return _truncated_normal_(w, math.sqrt(2.0 / (fan_in + fan_out)),
                              generator)


def lecun_normal_(w: torch.Tensor, transposed: bool = False,
                  generator=None) -> torch.Tensor:
    """flax's default kernel initialiser."""
    fan_in, _ = _fans(w, transposed)
    return _truncated_normal_(w, math.sqrt(1.0 / fan_in), generator)


def init_like_flax(model: nn.Module, seed: int) -> nn.Module:
    """Initialise every conv, transposed conv and linear of ``model`` as
    flax initialises the JAX zoo (lecun-normal kernels, zero biases), from
    a ``torch.Generator`` seeded with ``seed``. BatchNorm keeps (1, 0)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = torch.empty(m.weight.shape)
            lecun_normal_(w, isinstance(m, nn.ConvTranspose2d), g)
            with torch.no_grad():
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def apply_init(model: nn.Module, seed: int) -> nn.Module:
    """Re-initialise every conv kernel (transposed ones included) with
    Kaiming-normal and every dense kernel with flax's Xavier-normal; biases,
    norms and other parameters stay (JAX ``apply_init``)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = torch.empty(m.weight.shape)
            if isinstance(m, nn.Linear):
                xavier_dense_(w, g)
            else:
                kaiming_conv_(w, isinstance(m, nn.ConvTranspose2d), g)
            with torch.no_grad():
                m.weight.copy_(w)
    return model
