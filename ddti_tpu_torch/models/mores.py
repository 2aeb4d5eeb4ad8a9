"""The reference's ``features=[...]`` zoo (its ``models/mores.py``), ported
from ``ddti_tpu/models/mores.py``: architectures that differ from the
parametric zoo of ``models/zoo.py`` in structure, not only in width.

- ``MoresUNet``: the fixed 64..1024 UNet, as ``LegacyUNet``
  (Conv(bias) -> ReLU -> BN blocks, decoder block THEN transposed conv,
  ``cat([x, skip])``).
- ``MoresVNet2D``: strided 2x2 down-convs that KEEP the channel count (the
  next block widens), PReLU blocks, ``cat([x, skip])`` in the decoder.
- ``MoresAttentionUNet``: gates of inner width ``f // 2``, ``cat([skip,
  x])``.
- ``MoresResUNet``, ``MoresASPPUNet``: the pool encoder-decoder with
  residual blocks, or an ASPP bottleneck; biased transposed convs,
  ``cat([skip, x])``.
- ``MoresTransUNet``: a CNN encoder and a transformer bottleneck whose
  forward is the JAX package's repair of the reference's (QUIRKS #18): the
  transformer's projection is concatenated with its own input, the pooled
  deepest map, to feed the declared ``2 * features[-1]``-wide decoder. Its
  positional embedding covers ``(image_size // 2**len(features))**2``
  tokens and is sliced to the map's h * w. Dropout 0.1 is fixed in the
  embedding and in every encoder layer, as in JAX.
- ``MoresImprovedVNet``: the triple-branch encoder fusion with 1x1-conv SE
  gates (reduction 4) and dropout blocks, distinct from the vnet.py net of
  ``models/legacy.py`` only in its names (``conv0..``, ``dec6..9``).

No model here resizes a decoder input to its skip: a side that leaves the
two apart fails the concatenation, as JAX's does. The ``state_dict`` keys
are those the JAX package's ``torch_interop.export_state_dict`` writes: the
flax module names joined by dots (``enc0.conv1.weight``), a bottleneck
block by the torch ``nn.Sequential`` indices (``bottleneck.0.weight``),
MoresVNet2D and MoresUNet by the reference's own layout. The blocks are
the zoo's own (``blocks.py``), built under those names.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import (
    ASPP,
    FLAX_LAYER_NAMES,
    FLAX_NAMES,
    AttentionGate,
    ConvBNAct,
    DownConv2x2,
    ResidualBlock,
    TransformerEncoderLayer,
    max_pool_2x2,
    up_conv,
)
from .legacy import LegacyUNet, TripleBranchEncoderFusion

# a residual block's children under flax's names, and under the torch
# Sequential indices the JAX export gives a ``bottleneck`` block
FLAX_RES_NAMES = FLAX_NAMES[:5] + ("skip",)
SEQ_RES_NAMES = ("0", "1", "2", "3", "4", "skip")
FLAX_ASPP_NAMES = ("branch{}", "project", "project_bn")
FLAX_GATE_NAMES = ("w_g", "w_g_bn", "w_x", "w_x_bn", "psi", "psi_bn")


class MoresUNet(LegacyUNet):
    """The reference's mores.py UNet: LegacyUNet's architecture, keys and
    forward."""


class MoresVNet2D(nn.Module):
    """PReLU ConvBNAct blocks (``enc_blocks``, ``bottleneck`` of twice the
    deepest width, ``dec_blocks``), channel-keeping 2x2 stride-2 down-convs
    without bias with flax's SAME padding (``down_convs``), transposed convs
    without bias (``up_convs``) and ``cat([x, skip])``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 features=(16, 32, 64, 128, 256)):
        super().__init__()
        self.in_channels = in_channels
        self.features = tuple(features)
        f = self.features
        self.enc_blocks = nn.ModuleList(
            ConvBNAct(cin, c, "prelu")
            for cin, c in zip((in_channels,) + f[:-1], f))
        self.down_convs = nn.ModuleList(DownConv2x2(c, c) for c in f)
        self.bottleneck = ConvBNAct(f[-1], 2 * f[-1], "prelu")
        rev = f[::-1]
        self.up_convs = nn.ModuleList(
            up_conv(cin, c, use_bias=False)
            for cin, c in zip((2 * f[-1],) + rev[:-1], rev))
        self.dec_blocks = nn.ModuleList(ConvBNAct(2 * c, c, "prelu")
                                        for c in rev)
        self.final_conv = nn.Conv2d(f[0], out_channels, 1)

    def forward(self, x):
        skips = []
        for enc, down in zip(self.enc_blocks, self.down_convs):
            x = enc(x)
            skips.append(x)
            x = down(x)
        x = self.bottleneck(x)
        for up, dec, skip in zip(self.up_convs, self.dec_blocks,
                                 reversed(skips)):
            x = dec(torch.cat([up(x), skip], dim=1))
        return self.final_conv(x)


class PoolEncDecUNet(nn.Module):
    """The mores Attention/ASPP/Res UNets' skeleton: ``enc{i}`` blocks with
    max-pool, a ``bottleneck`` of twice the deepest width, biased
    transposed convs ``up{i}``, an optional gate ``att{i}`` on the skip,
    ``cat([skip, x])`` and ``dec{i}`` blocks, a 1x1 head."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 features=(64, 128, 256, 512)):
        super().__init__()
        self.in_channels = in_channels
        self.features = tuple(features)
        f = self.features
        for i, (cin, c) in enumerate(zip((in_channels,) + f[:-1], f)):
            self.add_module(f"enc{i}", self._block(cin, c))
        self.bottleneck = self._bottleneck(f[-1])
        for i, (cin, c) in enumerate(zip((2 * f[-1],) + f[::-1][:-1],
                                         f[::-1])):
            self.add_module(f"up{i}", up_conv(cin, c))
            gate = self._gate(c)
            if gate is not None:
                self.add_module(f"att{i}", gate)
            self.add_module(f"dec{i}", self._block(2 * c, c))
        self.final_conv = nn.Conv2d(f[0], out_channels, 1)

    def _block(self, cin: int, c: int) -> nn.Module:
        return ConvBNAct(cin, c, names=FLAX_NAMES)

    def _bottleneck(self, c: int) -> nn.Module:
        return ConvBNAct(c, 2 * c)

    def _gate(self, c: int):
        return None

    def forward(self, x):
        m = self._modules
        skips = []
        for i in range(len(self.features)):
            x = m[f"enc{i}"](x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bottleneck(x)
        for i, skip in enumerate(reversed(skips)):
            x = m[f"up{i}"](x)
            if f"att{i}" in m:
                skip = m[f"att{i}"](x, skip)
            x = m[f"dec{i}"](torch.cat([skip, x], dim=1))
        return self.final_conv(x)


class MoresAttentionUNet(PoolEncDecUNet):
    """Attention gates of inner width max(f // 2, 1) on every skip."""

    def _gate(self, c: int):
        return AttentionGate(c, c, max(c // 2, 1), FLAX_GATE_NAMES)


class MoresResUNet(PoolEncDecUNet):
    """Residual blocks everywhere, the bottleneck's too."""

    def _block(self, cin: int, c: int) -> nn.Module:
        return ResidualBlock(cin, c, FLAX_RES_NAMES)

    def _bottleneck(self, c: int) -> nn.Module:
        return ResidualBlock(c, 2 * c, SEQ_RES_NAMES)


class MoresASPPUNet(PoolEncDecUNet):
    """An ASPP bottleneck (dilations 1, 6, 12, 18)."""

    def _bottleneck(self, c: int) -> nn.Module:
        return ASPP(c, 2 * c, names=FLAX_ASPP_NAMES)


class MoresTrans(nn.Module):
    """The parameters that the JAX export keys under ``trans.``: the 1x1
    ``patchify`` conv and ``pos_emb``."""

    def __init__(self, in_channels: int, tokens: int, trans_dim: int):
        super().__init__()
        self.patchify = nn.Conv2d(in_channels, trans_dim, 1, bias=False)
        self.pos_emb = nn.Parameter(torch.randn(1, tokens, trans_dim))


class MoresTransUNet(nn.Module):
    """CNN encoder (``enc{i}`` ConvBNAct, max-pool), a transformer
    bottleneck (``trans`` patchify + ``pos_emb``, ``trans{i}`` layers,
    ``trans_proj``), the repaired concatenation with the pooled map, then
    ``up{i}`` (biased) / ``cat([skip, x])`` / ``dec{i}``.
    ``use_flash_attention`` (None: the gate) is the port's switch, as
    TransUNet's is."""

    DROPOUT = 0.1  # fixed in the reference and in JAX

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 features=(64, 128, 256, 512), trans_dim: int = 256,
                 num_heads: int = 8, num_layers: int = 4,
                 image_size: int = 512, batch_axis_attention: bool = False,
                 use_flash_attention: bool | None = None):
        super().__init__()
        self.in_channels = in_channels
        self.features = tuple(features)
        self.image_size = image_size
        f = self.features
        for i, (cin, c) in enumerate(zip((in_channels,) + f[:-1], f)):
            self.add_module(f"enc{i}", ConvBNAct(cin, c, names=FLAX_NAMES))
        side = image_size // 2 ** len(f)
        self.trans = MoresTrans(f[-1], side * side, trans_dim)
        self.in_dropout = nn.Dropout(self.DROPOUT)
        for i in range(num_layers):
            self.add_module(f"trans{i}", TransformerEncoderLayer(
                trans_dim, num_heads, self.DROPOUT, batch_axis_attention,
                use_flash_attention, FLAX_LAYER_NAMES))
        self.num_layers = num_layers
        self.trans_proj = nn.Linear(trans_dim, f[-1])
        for i, (cin, c) in enumerate(zip((2 * f[-1],) + f[::-1][:-1],
                                         f[::-1])):
            self.add_module(f"up{i}", up_conv(cin, c))
            self.add_module(f"dec{i}", ConvBNAct(2 * c, c, names=FLAX_NAMES))
        self.final_conv = nn.Conv2d(f[0], out_channels, 1)

    def forward(self, x):
        m = self._modules
        skips = []
        for i in range(len(self.features)):
            x = m[f"enc{i}"](x)
            skips.append(x)
            x = max_pool_2x2(x)
        trans_in = x
        n, _, h, w = x.shape
        # row-major token order over (h, w), as the JAX NHWC reshape
        t = self.trans.patchify(x).flatten(2).transpose(1, 2)
        t = self.in_dropout(t + self.trans.pos_emb[:, :h * w])
        for i in range(self.num_layers):
            t = m[f"trans{i}"](t)
        t = self.trans_proj(t).transpose(1, 2).reshape(n, -1, h, w)
        x = torch.cat([t, trans_in], dim=1)
        for i, skip in enumerate(reversed(skips)):
            x = m[f"dec{i}"](torch.cat([skip, m[f"up{i}"](x)], dim=1))
        return self.final_conv(x)


class MoresImprovedVNet(TripleBranchEncoderFusion):
    """The mores.py triple-branch net: ``conv0..`` / ``bn0..`` blocks and
    ``dec6..9`` decoder blocks, the zoo's argument names."""

    dec_prefix = "dec"
    first_conv = 0

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, dropout_rate: float = 0.05,
                 se_reduction: int = 4, num_branches: int = 3):
        super().__init__(in_channels, out_channels, base_filters,
                         dropout_rate, se_reduction, num_branches)


MORES_REGISTRY = {
    "MoresUNet": MoresUNet,
    "MoresVNet2D": MoresVNet2D,
    "MoresAttentionUNet": MoresAttentionUNet,
    "MoresResUNet": MoresResUNet,
    "MoresASPPUNet": MoresASPPUNet,
    "MoresTransUNet": MoresTransUNet,
    "MoresImprovedVNet": MoresImprovedVNet,
}
