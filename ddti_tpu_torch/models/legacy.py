"""The legacy fixed-architecture models, ported from
``ddti_tpu/models/legacy.py`` (the reference's ``models/model.py`` UNet and
``models/vnet.py`` triple-branch VNet):

- ``LegacyUNet``: the fixed-depth-4 UNet (64..1024 channels): blocks of
  Conv(bias) -> ReLU -> BN twice (BN after the activation), a "middle"
  stage of pool -> block -> transposed conv, decoders of block THEN
  transposed conv, and ``cat([x, skip])`` concatenation.
- ``TripleBranchImprovedVNet``: three independent 5-level encoder branches
  (conv blocks of 2/2/3/3/3 convs with dropout, a residual 1x1 projection
  at level 0, an SE gate of 1x1 convs a level, strided 3x3 down-convs),
  the branches concatenated at every skip and at the bottom, one shared
  decoder ``up6..up9`` / ``dec_block6..9`` and a final SE and 1x1 head.

NCHW ``nn.Module``s whose ``state_dict`` keys are those the JAX package's
``torch_interop.export_state_dict`` writes for them (the reference's
``nn.Sequential`` indices for LegacyUNet, the flax module names for the
triple-branch net), so its ``.pth`` files load strictly.
``TripleBranchImprovedVNet`` keeps the reference's own argument names,
``num_classes`` and ``base_num_filters``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddti_tpu_torch.parallel.mesh import sum_over_ranks

from .blocks import BatchNorm2d, Conv2d, max_pool_2x2, up_conv


def conv_relu_bn(in_channels: int, features: int) -> nn.Sequential:
    """(3x3 conv with bias -> ReLU -> BatchNorm) twice: indices 0 and 3 hold
    the convs, 2 and 5 the BatchNorms (the reference's ``conv_block``)."""
    return nn.Sequential(
        Conv2d(in_channels, features, 3, padding=1), nn.ReLU(),
        BatchNorm2d(features),
        Conv2d(features, features, 3, padding=1), nn.ReLU(),
        BatchNorm2d(features))


class LegacyUNet(nn.Module):
    """The reference's fixed UNet; ``middle`` = (pool, block, up),
    ``decoderN`` = (block, up), ``final`` = (block, 1x1 conv)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.encoder1 = conv_relu_bn(in_channels, 64)
        self.encoder2 = conv_relu_bn(64, 128)
        self.encoder3 = conv_relu_bn(128, 256)
        self.encoder4 = conv_relu_bn(256, 512)
        self.middle = nn.Sequential(nn.MaxPool2d(2, 2),
                                    conv_relu_bn(512, 1024),
                                    up_conv(1024, 512))
        self.decoder3 = nn.Sequential(conv_relu_bn(1024, 512),
                                      up_conv(512, 256))
        self.decoder2 = nn.Sequential(conv_relu_bn(512, 256),
                                      up_conv(256, 128))
        self.decoder1 = nn.Sequential(conv_relu_bn(256, 128),
                                      up_conv(128, 64))
        self.final = nn.Sequential(conv_relu_bn(128, 64),
                                   nn.Conv2d(64, out_channels, 1))

    def forward(self, x):
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(max_pool_2x2(enc1))
        enc3 = self.encoder3(max_pool_2x2(enc2))
        enc4 = self.encoder4(max_pool_2x2(enc3))
        d = self.middle(enc4)
        for dec, skip in ((self.decoder3, enc4), (self.decoder2, enc3),
                          (self.decoder1, enc2)):
            d = dec(torch.cat([d, skip], dim=1))
        return self.final(torch.cat([d, enc1], dim=1))


class SEConv(nn.Module):
    """Squeeze-and-excitation with 1x1-conv excitation (``fc1`` to
    features // reduction, ReLU, ``fc2``, sigmoid), both biased: the
    reference's SE block of vnet.py and of mores.py alike. On bands of
    rows (``band_mesh``) the frame's mean is the model group's sum over
    the whole frame's pixels."""

    band_mesh = None

    def __init__(self, features: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Conv2d(features, features // reduction, 1)
        self.fc2 = nn.Conv2d(features // reduction, features, 1)

    def forward(self, x):
        mesh = self.band_mesh
        if mesh is None:
            s = x.mean(dim=(2, 3), keepdim=True)
        else:
            h, w = x.shape[2] * mesh.model, x.shape[3]
            dt = torch.promote_types(x.dtype, torch.float32)
            s = (sum_over_ranks(x.sum(dim=(2, 3), keepdim=True, dtype=dt),
                                mesh, "model") / (h * w)).to(x.dtype)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class DropConvBlock(nn.Module):
    """n x (3x3 conv with bias -> BN -> ReLU -> dropout), plus the input,
    through a biased 1x1 projection ``res_proj`` where ``project``. The
    convs and BatchNorms are ``conv{i}`` / ``bn{i}`` from ``first``
    (vnet.py counts from 1, mores.py from 0)."""

    def __init__(self, in_channels: int, features: int, num_convs: int,
                 dropout_rate: float, project: bool, first: int = 1):
        super().__init__()
        self.names = [(f"conv{first + i}", f"bn{first + i}")
                      for i in range(num_convs)]
        for i, (conv, bn) in enumerate(self.names):
            self.add_module(conv, Conv2d(in_channels if i == 0
                                         else features, features, 3,
                                         padding=1))
            self.add_module(bn, BatchNorm2d(features))
        self.dropout = nn.Dropout(dropout_rate)
        if project:
            self.res_proj = nn.Conv2d(in_channels, features, 1)
        self.project = project

    def forward(self, x):
        res = self.res_proj(x) if self.project else x
        for conv, bn in self.names:
            x = self.dropout(F.relu(self._modules[bn](self._modules[conv](
                x))))
        return x + res


class TripleBranchEncoderFusion(nn.Module):
    """The triple-branch encoder-fusion topology shared by the vnet.py and
    mores.py nets: ``num_branches`` encoders of 5 levels (``enc_b{b}_l{i}``
    blocks, ``se_b{b}_l{i}`` gates, ``down_b{b}_l{i}`` strided 3x3
    convs), concatenated per level, and a decoder ``up{6+j}`` /
    ``{dec_prefix}{6+j}`` with a final SE ``dec_se_final`` and 1x1 head.
    The subclasses name the decoder blocks and the first conv index."""

    dec_prefix = "dec_block"
    first_conv = 1

    def __init__(self, in_channels: int, out_channels: int,
                 base_filters: int, dropout_rate: float, se_reduction: int,
                 num_branches: int):
        super().__init__()
        self.in_channels = in_channels
        self.num_branches = num_branches
        f = [base_filters * 2 ** i for i in range(5)]
        counts = [2, 2, 3, 3, 3]
        for b in range(num_branches):
            cin = in_channels
            for i in range(5):
                # level i > 0 keeps the width its down-conv widened to, so
                # only level 0 projects the residual
                self.add_module(f"enc_b{b}_l{i}", DropConvBlock(
                    cin, f[i], counts[i], dropout_rate, i == 0,
                    self.first_conv))
                self.add_module(f"se_b{b}_l{i}", SEConv(f[i], se_reduction))
                if i < 4:
                    self.add_module(f"down_b{b}_l{i}", Conv2d(
                        f[i], f[i + 1], 3, stride=2, padding=1))
                    cin = f[i + 1]
        cin = num_branches * f[4]
        for j, (lvl, ncv) in enumerate(zip((3, 2, 1, 0), (3, 3, 2, 2))):
            self.add_module(f"up{6 + j}", up_conv(cin, f[lvl]))
            self.add_module(f"{self.dec_prefix}{6 + j}", DropConvBlock(
                (num_branches + 1) * f[lvl], f[lvl], ncv, dropout_rate,
                True, self.first_conv))
            cin = f[lvl]
        self.dec_se_final = SEConv(f[0], se_reduction)
        self.final_conv = nn.Conv2d(f[0], out_channels, 1)

    def forward(self, x):
        m = self._modules
        feats = []
        for b in range(self.num_branches):
            e, branch = x, []
            for i in range(5):
                e = m[f"se_b{b}_l{i}"](m[f"enc_b{b}_l{i}"](e))
                branch.append(e)
                if i < 4:
                    e = m[f"down_b{b}_l{i}"](e)
            feats.append(branch)
        d = torch.cat([br[4] for br in feats], dim=1)
        for j, lvl in enumerate((3, 2, 1, 0)):
            d = m[f"up{6 + j}"](d)
            d = torch.cat([d, *(br[lvl] for br in feats)], dim=1)
            d = m[f"{self.dec_prefix}{6 + j}"](d)
        return self.final_conv(self.dec_se_final(d))


class TripleBranchImprovedVNet(TripleBranchEncoderFusion):
    """The reference's vnet.py triple-branch net, its arguments named as
    there (``num_classes``, ``base_num_filters``)."""

    def __init__(self, in_channels: int = 1, num_classes: int = 1,
                 base_num_filters: int = 64, dropout_rate: float = 0.05,
                 se_reduction: int = 4, num_branches: int = 3):
        super().__init__(in_channels, num_classes, base_num_filters,
                         dropout_rate, se_reduction, num_branches)
