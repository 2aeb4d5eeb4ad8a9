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
  ``nn.Conv`` / ``nn.ConvTranspose`` / ``nn.Dense`` of the JAX zoo starts
  from, biases at zero. ``init_like_flax`` applies it to a port model:
  every conv (ASPP's dilated branches, the 1x1 convs of the attention
  gates, projections and heads, the strided down-convs), transposed conv
  and linear, the packed attention projection ``in_proj_weight`` (flax's
  ``qkv`` Dense) included, and draws TransUNet's and MoresTransUNet's
  ``pos_emb`` from a standard normal (flax ``normal(1.0)``); PReLU slopes
  keep their 0.25. The fixed architectures' kinds are among these: the SE
  gates' biased 1x1 convs, the strided 3x3 and 2x2 down-convs, the
  transposed convs with and without bias.

Fans follow flax's reading of its own layouts: a conv kernel's receptive
field times its input (fan_in) or output (fan_out) channels; torch's
``ConvTranspose2d`` weight is (in, out, kh, kw).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ddti_tpu_torch.models.blocks import SelfAttention
from ddti_tpu_torch.models.mores import MoresTrans
from ddti_tpu_torch.models.zoo import TransEncoder

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


def _set_(param: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(value)


def init_like_flax(model: nn.Module, seed: int) -> nn.Module:
    """Initialise every conv, transposed conv, linear and packed attention
    projection of ``model`` as flax initialises the JAX zoo (lecun-normal
    kernels, zero biases) and the positional embedding of TransUNet and
    MoresTransUNet as a standard normal, all from one ``torch.Generator``
    seeded with ``seed``. BatchNorm and LayerNorm keep (1, 0), PReLU
    slopes 0.25 (flax ``negative_slope_init``)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            weight, bias = m.weight, m.bias
            transposed = isinstance(m, nn.ConvTranspose2d)
        elif isinstance(m, SelfAttention):
            # (3E, E): fan_in E, as flax's (E, 3E) qkv kernel
            weight, bias, transposed = m.in_proj_weight, m.in_proj_bias, False
        elif isinstance(m, (TransEncoder, MoresTrans)):
            _set_(m.pos_emb, torch.randn(m.pos_emb.shape, generator=g))
            continue
        else:
            continue
        _set_(weight, lecun_normal_(torch.empty(weight.shape), transposed, g))
        if bias is not None:
            _set_(bias, torch.zeros(bias.shape))
    return model


def apply_init(model: nn.Module, seed: int) -> nn.Module:
    """Re-initialise every conv kernel (transposed ones included) with
    Kaiming-normal and every dense kernel (the packed attention projection
    included) with flax's Xavier-normal; biases, norms, PReLU slopes, the
    positional embedding and other parameters stay (JAX ``apply_init``,
    which touches only leaves named ``kernel``)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, SelfAttention)):
            weight = (m.in_proj_weight if isinstance(m, SelfAttention)
                      else m.weight)
            _set_(weight, xavier_dense_(torch.empty(weight.shape), g))
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            _set_(m.weight, kaiming_conv_(torch.empty(m.weight.shape),
                                          isinstance(m, nn.ConvTranspose2d),
                                          g))
    return model
