"""The model zoo, ported from ``ddti_tpu/models/zoo.py``: so far ResUNet
(the flagship) and TransUNet, both trained by ``cli/main.py``, TransUNet
also served.

Models map NCHW ``(N, in_channels, H, W)`` inputs to ``(N, out_channels, H,
W)`` logits (the JAX package is NHWC; ``train/export.py`` keeps NHWC at the
serving boundary). The rest of the zoo is still to port (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import (
    ConvBNAct,
    ResidualBlock,
    TransformerEncoderLayer,
    match_spatial,
    max_pool_2x2,
    up_conv,
)


class _EncoderDecoderBase(nn.Module):
    """Shared scaffold config for the pool-based UNet variants."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_filters = base_filters
        self.depth = depth

    @property
    def channels(self) -> list[int]:
        return [self.base_filters * (2 ** i) for i in range(self.depth)]


class ResUNet(_EncoderDecoderBase):
    """UNet topology with residual blocks everywhere: encoders, a bottleneck
    of twice the deepest width, transposed-conv upsampling, [skip, x]
    concatenation, a 1x1 head."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5):
        super().__init__(in_channels, out_channels, base_filters, depth)
        ch = self.channels
        self.encoders = nn.ModuleList(
            ResidualBlock(cin, c) for cin, c in zip([in_channels] + ch[:-1],
                                                    ch))
        self.bottleneck = ResidualBlock(ch[-1], 2 * ch[-1])
        rev = ch[::-1]
        self.upconvs = nn.ModuleList(
            up_conv(cin, c) for cin, c in zip([2 * ch[-1]] + rev[:-1], rev))
        self.decoders = nn.ModuleList(ResidualBlock(2 * c, c) for c in rev)
        self.final_conv = nn.Conv2d(ch[0], out_channels, 1)

    def forward(self, x):
        skips = []
        for enc in self.encoders:
            x = enc(x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bottleneck(x)
        for up, dec, skip in zip(self.upconvs, self.decoders,
                                 reversed(skips)):
            x = match_spatial(up(x), skip)
            x = dec(torch.cat([skip, x], dim=1))
        return self.final_conv(x)


class TransEncoder(nn.Module):
    """The transformer bottleneck's parameters under the reference's
    ``trans.*`` names: a 1x1 patchify conv to ``embed_dim``, a learned
    positional embedding over (image_size / 2**depth)^2 tokens, and the
    encoder layers."""

    def __init__(self, in_channels: int, tokens: int, embed_dim: int,
                 num_heads: int, num_layers: int, dropout: float,
                 attend_batch_axis: bool,
                 use_flash_attention: bool | None):
        super().__init__()
        self.patchify = nn.Conv2d(in_channels, embed_dim, 1, bias=False)
        self.pos_emb = nn.Parameter(torch.randn(1, tokens, embed_dim))
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, dropout=dropout,
                                    attend_batch_axis=attend_batch_axis,
                                    use_flash_attention=use_flash_attention)
            for _ in range(num_layers))


class TransUNet(_EncoderDecoderBase):
    """CNN encoder + transformer bottleneck + UNet decoder (see the JAX
    counterpart). ``image_size`` fixes the positional embedding's length."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5,
                 num_transformer_layers: int = 4, num_heads: int = 8,
                 embed_dim: int = 256, image_size: int = 512,
                 dropout_rate: float = 0.1,
                 batch_axis_attention: bool = False,
                 use_flash_attention: bool | None = None):
        super().__init__(in_channels, out_channels, base_filters, depth)
        ch = self.channels
        self.embed_dim = embed_dim
        self.encoders = nn.ModuleList(
            ConvBNAct(cin, c) for cin, c in zip([in_channels] + ch[:-1], ch))
        s = image_size // (2 ** depth)
        self.trans = TransEncoder(ch[-1], s * s, embed_dim, num_heads,
                                  num_transformer_layers, dropout_rate,
                                  batch_axis_attention, use_flash_attention)
        self.trans_proj = nn.Linear(embed_dim, ch[-1])
        self.in_dropout = nn.Dropout(dropout_rate)
        # decoder i: upsample to ch[-1-i], concat the skip of that width
        rev = ch[::-1]
        self.upconvs = nn.ModuleList(
            up_conv(cin, c) for cin, c in zip([ch[-1]] + rev[:-1], rev))
        self.decoders = nn.ModuleList(ConvBNAct(2 * c, c) for c in rev)
        self.final_conv = nn.Conv2d(ch[0], out_channels, 1)

    def forward(self, x):
        skips = []
        for enc in self.encoders:
            x = enc(x)
            skips.append(x)
            x = max_pool_2x2(x)
        n, _, h, w = x.shape
        # row-major token order over (h, w), as the JAX NHWC reshape
        x = self.trans.patchify(x).flatten(2).transpose(1, 2)
        x = self.in_dropout(x + self.trans.pos_emb)
        for layer in self.trans.layers:
            x = layer(x)
        x = self.trans_proj(x).transpose(1, 2).reshape(n, -1, h, w)
        for up, dec, skip in zip(self.upconvs, self.decoders,
                                 reversed(skips)):
            x = match_spatial(up(x), skip)
            x = dec(torch.cat([skip, x], dim=1))
        return self.final_conv(x)


MODEL_REGISTRY = {"ResUNet": ResUNet, "TransUNet": TransUNet}


def create_model(model_type: str, **kwargs) -> nn.Module:
    """Instantiate a ported zoo model by name."""
    if model_type not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported to ddti_tpu_torch yet "
            f"(ported: {sorted(MODEL_REGISTRY)}); ROADMAP.md Queue 1 lists "
            f"the rest of the zoo")
    return MODEL_REGISTRY[model_type](**kwargs)
