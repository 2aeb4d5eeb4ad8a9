"""Shared building blocks, ported from ``ddti_tpu/models/blocks.py``.

PyTorch idiom: NCHW ``nn.Module``s; bf16 compute comes from
``torch.autocast`` while parameters and BatchNorm statistics stay float32.
Submodule names follow the torch reference's attribute layout, so the
``state_dict`` keys are exactly those of
``ddti_tpu.train.torch_interop.export_state_dict``.

Dropout (the transformer layer's, and the attention probabilities' on the
plain path in training) draws from torch's global generator, as
``nn.Dropout`` does; the JAX package's draws come from its ``dropout`` key,
so the two agree in distribution, not in bits.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ddti_tpu_torch.ops.attention import attention_reference, flash_attention

# torch BatchNorm2d defaults (the JAX package's flax momentum 0.9 is the
# retention factor of the same update)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """True inside a rematerialised block's recomputation (the backward
    pass of ``torch.utils.checkpoint``), which runs in the thread that
    entered ``recompute_context``'s second manager."""
    return getattr(_RECOMPUTE, "on", False)


@contextlib.contextmanager
def _recomputation():
    prev = recomputing()
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def recompute_context():
    """``context_fn`` of ``torch.utils.checkpoint``: nothing around the
    forward, ``recomputing()`` around the recomputation, so BatchNorm
    updates its running statistics once a step, as under flax's
    ``nn.remat``."""
    return contextlib.nullcontext(), _recomputation()


class BatchNorm2d(nn.Module):
    """BatchNorm with the JAX package's numerics and without the
    ``num_batches_tracked`` buffer, which the JAX package's export does not
    carry (it only feeds momentum=None averaging, unused here). Reference
    ``.pth`` files that do carry it load all the same: the entry is dropped
    on load.

    Train mode normalises with the batch's statistics (two-pass variance,
    flax's ``use_fast_variance=False``) and updates the running statistics
    as flax ``nn.BatchNorm`` does: ``new = 0.9 old + 0.1 batch`` with the
    **biased** batch variance. torch's own train-mode update would store
    the unbiased n/(n-1) variance instead. The statistics are reduced in
    float32 whatever the autocast dtype of ``x``. A recomputation under
    ``--remat`` normalises alike and leaves the statistics alone."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        if recomputing():
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(
                mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(
                var, alpha=BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            BN_EPS)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class PReLU(nn.PReLU):
    """torch's one shared learnable slope (initialised at 0.25), applied in
    the input's dtype as flax ``nn.PReLU`` does: under bf16 autocast the
    float32 slope is cast to bf16 before the product."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


def _act(act: str) -> nn.Module:
    if act == "relu":
        return nn.ReLU(inplace=True)
    if act == "prelu":
        return PReLU()
    raise ValueError(f"act {act!r}: expected 'relu' or 'prelu'")


class ConvBNAct(nn.Sequential):
    """(3x3 conv without bias -> BatchNorm -> activation) twice; indices 0,
    1, 3, 4 hold the weights, as in the reference's ``nn.Sequential``, and
    with ``act="prelu"`` (VNet2D) indices 2 and 5 the PReLU slopes."""

    def __init__(self, in_channels: int, features: int, act: str = "relu"):
        super().__init__(
            nn.Conv2d(in_channels, features, 3, padding=1, bias=False),
            BatchNorm2d(features), _act(act),
            nn.Conv2d(features, features, 3, padding=1, bias=False),
            BatchNorm2d(features), _act(act))


class ResidualBlock(nn.Module):
    """(3x3 conv -> BN -> ReLU -> 3x3 conv -> BN) + 1x1-conv shortcut, ReLU
    after the add; the reference's ``conv`` Sequential (indices 0, 1, 3, 4
    hold the weights) and ``skip`` names."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, features, 3, padding=1, bias=False),
            BatchNorm2d(features), nn.ReLU(inplace=True),
            nn.Conv2d(features, features, 3, padding=1, bias=False),
            BatchNorm2d(features))
        self.skip = nn.Conv2d(in_channels, features, 1, bias=False)

    def forward(self, x):
        return F.relu(self.conv(x) + self.skip(x))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling bottleneck: parallel dilated 3x3 convs
    without bias (``branches``, padding = dilation), concatenated, then
    ``project`` = (1x1 conv without bias, BatchNorm) and ReLU. Every tap is
    kept, also those of a dilation wider than the map, which read only
    padding (cuDNN and XLA both keep them)."""

    def __init__(self, in_channels: int, features: int,
                 dilations=(1, 6, 12, 18)):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Conv2d(in_channels, features, 3, padding=d, dilation=d,
                      bias=False) for d in dilations)
        self.project = nn.Sequential(
            nn.Conv2d(len(self.branches) * features, features, 1,
                      bias=False),
            BatchNorm2d(features))

    def forward(self, x):
        return F.relu(self.project(torch.cat([b(x) for b in self.branches],
                                             dim=1)))


class AttentionGate(nn.Module):
    """Additive attention gate on a skip connection: psi = sigmoid(BN(conv(
    relu(W_g g + W_x x)))), returns x * psi. ``W_g``, ``W_x`` and ``psi``
    are each (biased 1x1 conv, BatchNorm); the sigmoid and the product run
    in the compute dtype (bf16 under autocast), as in JAX. ``g`` and ``x``
    must share their spatial size: the sum broadcasts nothing."""

    def __init__(self, g_channels: int, x_channels: int, inter: int):
        super().__init__()
        self.W_g = nn.Sequential(nn.Conv2d(g_channels, inter, 1),
                                 BatchNorm2d(inter))
        self.W_x = nn.Sequential(nn.Conv2d(x_channels, inter, 1),
                                 BatchNorm2d(inter))
        self.psi = nn.Sequential(nn.Conv2d(inter, 1, 1), BatchNorm2d(1))

    def forward(self, g, x):
        psi = self.psi(F.relu(self.W_g(g) + self.W_x(x)))
        return x * torch.sigmoid(psi)


class DownConv2x2(nn.Conv2d):
    """2x2 stride-2 conv without bias with flax's ``"SAME"`` padding: an
    odd side is padded by one at the bottom or right, so it gives
    ceil(H / 2) where torch's own padding gives floor(H / 2)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 2, stride=2, bias=False)

    def forward(self, x):
        h, w = x.shape[-2:]
        if h % 2 or w % 2:
            x = F.pad(x, (0, w % 2, 0, h % 2))
        return super().forward(x)


def max_pool_2x2(x):
    return F.max_pool2d(x, 2, 2)


def up_conv(in_channels: int, features: int,
            use_bias: bool = True) -> nn.ConvTranspose2d:
    """2x2 stride-2 transposed conv (torch's own layout; the checkpoint
    loaders flip flax kernels into it); VNet2D and ImprovedVNet take it
    without bias."""
    return nn.ConvTranspose2d(in_channels, features, 2, stride=2,
                              bias=use_bias)


def resize_bilinear(x, h: int, w: int):
    """Bilinear resize on NCHW, half-pixel centres, antialiased where it
    shrinks a side: ``jax.image.resize(..., "linear")``, whose antialias
    widens the triangle filter by the downscale ratio and is the plain
    filter on upsample. The strided-conv models downsample here (VNet2D at
    36^2 matches a 10^2 map to a 9^2 skip)."""
    shrink = h < x.shape[-2] or w < x.shape[-1]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=shrink)


def match_spatial(x, skip):
    """Resize ``x`` to ``skip``'s spatial size if they differ."""
    if x.shape[-2:] != skip.shape[-2:]:
        x = resize_bilinear(x, skip.shape[-2], skip.shape[-1])
    return x


def attention_dropout(q, k, v, p: float):
    """Plain attention with dropout on the probabilities, in the JAX
    layer's order (``ddti_tpu/models/blocks.py:304-313``): float32 scaled
    scores, softmax cast to v's dtype, dropout at rate ``p``, then the PV
    product with float32 accumulation."""
    with torch.autocast(q.device.type, enabled=False):
        s = q.float() @ k.float().transpose(-1, -2)
        a = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1).to(v.dtype)
        a = F.dropout(a, p, training=True)
        return (a.float() @ v.float()).to(q.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch MHA's parameter names (packed
    ``in_proj_weight``/``in_proj_bias`` and ``out_proj``), whose attention
    goes through ``flash_attention`` or the plain path."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 use_flash_attention: bool | None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_flash_attention = use_flash_attention
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        b, s, e = x.shape
        h = self.num_heads
        hd = e // h
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        # q | k | v, then (b, s, h, hd) -> (b, h, s, hd)
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2).contiguous()
                   for t in qkv.chunk(3, dim=-1))
        use_flash = self.use_flash_attention
        if use_flash is None:
            # the JAX gate (blocks.py:291) as it is: flash never drops
            # attention probabilities, so a training step with dropout stays
            # on the plain path
            use_flash = (s >= 1024 and s % 256 == 0 and hd % 8 == 0
                         and (not self.training or self.dropout == 0.0))
        if use_flash:
            y = flash_attention(q, k, v)
        elif self.training and self.dropout:
            y = attention_dropout(q, k, v, self.dropout)
        else:
            y = attention_reference(q, k, v)
        y = y.transpose(1, 2).reshape(b, s, e)
        return self.out_proj(y)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with torch ``nn.TransformerEncoderLayer``'s
    parameter names: x = norm1(x + drop(attn(x))); x = norm2(x +
    drop(linear2(drop(relu(linear1(x)))))).

    ``attend_batch_axis`` reproduces the reference quirk of attending over
    the batch axis (see the JAX counterpart)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1,
                 attend_batch_axis: bool = False,
                 use_flash_attention: bool | None = None):
        super().__init__()
        self.attend_batch_axis = attend_batch_axis
        self.self_attn = SelfAttention(embed_dim, num_heads, dropout,
                                       use_flash_attention)
        self.linear1 = nn.Linear(embed_dim, 4 * embed_dim)
        self.linear2 = nn.Linear(4 * embed_dim, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        if self.attend_batch_axis:
            x = x.transpose(0, 1)
        x = self.norm1(x + self.dropout(self.self_attn(x)))
        y = self.linear2(self.dropout(F.relu(self.linear1(x))))
        x = self.norm2(x + self.dropout(y))
        if self.attend_batch_axis:
            x = x.transpose(0, 1)
        return x
