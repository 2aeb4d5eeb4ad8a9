"""The model zoo, ported from ``ddti_tpu/models/zoo.py``: its seven active
architectures (UNet, ResUNet, ASPPUNet, AttentionUNet, TransUNet, VNet2D,
ImprovedVNet), each trained by ``cli/main.py`` and served by
``cli/serve.py``.

Models map NCHW ``(N, in_channels, H, W)`` inputs to ``(N, out_channels, H,
W)`` logits (the JAX package is NHWC; ``train/export.py`` keeps NHWC at the
serving boundary); ImprovedVNet with ``deep_supervision=True`` returns
``(logits, [head logits, deepest first])``, as in JAX. Attribute names are
the JAX modules' (``encoders``, ``enc_blocks``, ``attn_gates``, ``aspp``,
``ds_heads``, ...), so ``train/torch_interop.py`` maps every flax path onto
a ``state_dict`` key. ``create_model`` also builds the fixed-architecture
models of ``models/legacy.py`` and ``models/mores.py``.
"""

from __future__ import annotations

import inspect
import warnings

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import (
    ASPP,
    AttentionGate,
    ConvBNAct,
    DownConv2x2,
    ResidualBlock,
    TransformerEncoderLayer,
    match_spatial,
    max_pool_2x2,
    recompute_context,
    up_conv,
)
from ddti_tpu_torch.parallel.spatial import band, gather_band

from .legacy import LegacyUNet, TripleBranchImprovedVNet
from .mores import MORES_REGISTRY


def remat_levels(remat, depth: int) -> frozenset:
    """The levels whose encoder and decoder blocks recompute (JAX
    ``_remat_on``): a bool or int (a YAML ``remat: 1`` too) is every level
    or none; a tuple or list selects levels, each in 0..depth-1."""
    if isinstance(remat, (bool, int)):
        return frozenset(range(depth)) if remat else frozenset()
    if not remat:
        return frozenset()
    levels = tuple(int(v) for v in remat)
    bad = [v for v in levels if not 0 <= v < depth]
    if bad:
        raise ValueError(
            f"remat level(s) {bad} out of range for depth {depth} "
            f"(valid: 0..{depth - 1}); an out-of-range level would "
            f"silently rematerialize nothing")
    return frozenset(levels)


class _EncoderDecoderBase(nn.Module):
    """Shared scaffold config for the pool-based UNet variants."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5, remat=False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_filters = base_filters
        self.depth = depth
        self.remat = remat
        self._remat = remat_levels(remat, depth)

    @property
    def channels(self) -> list[int]:
        return [self.base_filters * (2 ** i) for i in range(self.depth)]

    def _block(self, block: nn.Module, level: int, x):
        """``block(x)``, recomputed in the backward pass where ``level`` is
        rematerialised and a gradient is being recorded."""
        if level in self._remat and torch.is_grad_enabled():
            # the blocks draw no random numbers, so there is no generator
            # state to keep (and a CUDA graph capture cannot read it)
            return checkpoint(block, x, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=recompute_context)
        return block(x)

    def _decoder_level(self, i: int) -> int:
        """Decoder ``i`` (deepest first) works at level depth - 1 - i."""
        return self.depth - 1 - i


class _PoolUNet(_EncoderDecoderBase):
    """The max-pool UNet topology: encoder blocks, a bottleneck of twice the
    deepest width, transposed-conv upsampling, [skip, x] concatenation and
    a 1x1 head. ``block`` builds every encoder, bottleneck and decoder
    block; ``_bottleneck`` may replace the bottleneck (ASPPUNet)."""

    block = ConvBNAct

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5, remat=False):
        super().__init__(in_channels, out_channels, base_filters, depth,
                         remat)
        ch = self.channels
        self.encoders = nn.ModuleList(
            self.block(cin, c) for cin, c in zip([in_channels] + ch[:-1],
                                                 ch))
        self._bottleneck(ch[-1])
        rev = ch[::-1]
        self.upconvs = nn.ModuleList(
            up_conv(cin, c) for cin, c in zip([2 * ch[-1]] + rev[:-1], rev))
        self.decoders = nn.ModuleList(self.block(2 * c, c) for c in rev)
        self.final_conv = nn.Conv2d(ch[0], out_channels, 1)

    def _bottleneck(self, c: int) -> None:
        self.bottleneck = self.block(c, 2 * c)

    def _middle(self, x):
        return self.bottleneck(x)

    def _skip(self, i: int, x, skip):
        """The skip connection of decoder ``i`` given the upsampled ``x``."""
        return skip

    def forward(self, x):
        skips = []
        for level, enc in enumerate(self.encoders):
            x = self._block(enc, level, x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self._middle(x)
        for i, (up, dec, skip) in enumerate(zip(self.upconvs, self.decoders,
                                                reversed(skips))):
            x = match_spatial(up(x), skip)
            x = self._block(dec, self._decoder_level(i),
                            torch.cat([self._skip(i, x, skip), x], dim=1))
        return self.final_conv(x)


class UNet(_PoolUNet):
    """Plain parametric UNet: double-conv (ConvBNAct) blocks."""


class ResUNet(_PoolUNet):
    """UNet topology with residual blocks everywhere."""

    block = ResidualBlock


class ASPPUNet(_PoolUNet):
    """UNet with an atrous-spatial-pyramid-pooling bottleneck (``aspp``) of
    twice the deepest width."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5,
                 aspp_dilations=(1, 6, 12, 18), remat=False):
        self.aspp_dilations = tuple(aspp_dilations)
        super().__init__(in_channels, out_channels, base_filters, depth,
                         remat)

    def _bottleneck(self, c: int) -> None:
        self.aspp = ASPP(c, 2 * c, self.aspp_dilations)

    def _middle(self, x):
        return self.aspp(x)


class AttentionUNet(_PoolUNet):
    """UNet with additive attention gates (``attn_gates``, inner width half
    the level's) on the skip connections, gated by the upsampled map."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5, remat=False):
        super().__init__(in_channels, out_channels, base_filters, depth,
                         remat)
        self.attn_gates = nn.ModuleList(
            AttentionGate(c, c, c // 2) for c in self.channels[::-1])

    def _skip(self, i: int, x, skip):
        return self.attn_gates[i](x, skip)


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
    counterpart). ``image_size`` fixes the positional embedding's length.
    On bands of rows (``band_mesh``) the token path takes the whole
    bottleneck (``gather_band``): every model rank runs the encoder layers
    on the frame's whole sequence, then keeps its band after
    ``trans_proj``."""

    band_mesh = None

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, depth: int = 5,
                 num_transformer_layers: int = 4, num_heads: int = 8,
                 embed_dim: int = 256, image_size: int = 512,
                 dropout_rate: float = 0.1,
                 batch_axis_attention: bool = False,
                 use_flash_attention: bool | None = None, remat=False):
        super().__init__(in_channels, out_channels, base_filters, depth,
                         remat)
        ch = self.channels
        self.embed_dim = embed_dim
        self.image_size = image_size
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
        for level, enc in enumerate(self.encoders):
            x = self._block(enc, level, x)
            skips.append(x)
            x = max_pool_2x2(x)
        mesh = self.band_mesh
        if mesh is not None:
            x = gather_band(x, mesh)
        n, _, h, w = x.shape
        # row-major token order over (h, w), as the JAX NHWC reshape
        x = self.trans.patchify(x).flatten(2).transpose(1, 2)
        x = self.in_dropout(x + self.trans.pos_emb)
        for layer in self.trans.layers:
            x = layer(x)
        x = self.trans_proj(x).transpose(1, 2).reshape(n, -1, h, w)
        if mesh is not None:
            x = band(x, mesh, 2)
        for i, (up, dec, skip) in enumerate(zip(self.upconvs, self.decoders,
                                                reversed(skips))):
            x = match_spatial(up(x), skip)
            x = self._block(dec, self._decoder_level(i),
                            torch.cat([skip, x], dim=1))
        return self.final_conv(x)


class VNet2D(_EncoderDecoderBase):
    """UNet topology with PReLU blocks, strided 2x2 conv downsampling
    (``down_convs``, flax ``"SAME"`` padding) and transposed convs without
    bias (``up_convs``); ``enc_blocks``, ``dec_blocks``."""

    act = "prelu"

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 16, depth: int = 5, remat=False):
        super().__init__(in_channels, out_channels, base_filters, depth,
                         remat)
        ch = self.channels
        self.enc_blocks = nn.ModuleList(
            ConvBNAct(cin, c, self.act)
            for cin, c in zip([in_channels] + ch[:-1], ch))
        self.down_convs = nn.ModuleList(DownConv2x2(c, c) for c in ch)
        self.bottleneck = ConvBNAct(ch[-1], 2 * ch[-1], self.act)
        rev = ch[::-1]
        self.up_convs = nn.ModuleList(
            up_conv(cin, c, use_bias=False)
            for cin, c in zip([2 * ch[-1]] + rev[:-1], rev))
        self.dec_blocks = nn.ModuleList(ConvBNAct(2 * c, c, self.act)
                                        for c in rev)
        self.final_conv = nn.Conv2d(ch[0], out_channels, 1)

    def _encode(self, x):
        skips = []
        for level, (enc, down) in enumerate(zip(self.enc_blocks,
                                                self.down_convs)):
            x = self._block(enc, level, x)
            skips.append(x)
            x = down(x)
        return self.bottleneck(x), skips

    def forward(self, x):
        x, skips = self._encode(x)
        for i, (up, dec, skip) in enumerate(zip(self.up_convs,
                                                self.dec_blocks,
                                                reversed(skips))):
            x = match_spatial(up(x), skip)
            x = self._block(dec, self._decoder_level(i),
                            torch.cat([skip, x], dim=1))
        return self.final_conv(x)


class ImprovedVNet(VNet2D):
    """VNet2D's topology with ReLU blocks, optional attention gates on the
    skips (``use_attention``) and optional deep-supervision heads
    (``deep_supervision``): a 1x1 head on every decoder output,
    ``ds_heads[i]`` taking decoder i's width (the deepest first), and then
    ``(logits, [head logits])`` is returned.

    The gate runs before the sizes are matched (JAX ``zoo.py:387-389``), so
    where an odd side leaves the upsampled map a pixel larger than its skip
    the gate's sum fails, as JAX's broadcast does."""

    act = "relu"

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 16, depth: int = 5,
                 use_attention: bool = True,
                 deep_supervision: bool = False, remat=False):
        super().__init__(in_channels, out_channels, base_filters, depth,
                         remat)
        self.use_attention = use_attention
        self.deep_supervision = deep_supervision
        rev = self.channels[::-1]
        if use_attention:
            self.attn_gates = nn.ModuleList(AttentionGate(c, c, c // 2)
                                            for c in rev)
        if deep_supervision:
            self.ds_heads = nn.ModuleList(nn.Conv2d(c, out_channels, 1)
                                          for c in rev)

    def forward(self, x):
        x, skips = self._encode(x)
        ds_outs = []
        for i, (up, dec) in enumerate(zip(self.up_convs, self.dec_blocks)):
            x = up(x)
            skip = skips[-1 - i]
            if self.use_attention:
                skip = self.attn_gates[i](x, skip)
            x = match_spatial(x, skip)
            x = self._block(dec, self._decoder_level(i),
                            torch.cat([skip, x], dim=1))
            if self.deep_supervision:
                ds_outs.append(self.ds_heads[i](x))
        out = self.final_conv(x)
        if self.deep_supervision:
            return out, ds_outs
        return out


MODEL_REGISTRY = {
    "UNet": UNet,
    "ResUNet": ResUNet,
    "ASPPUNet": ASPPUNet,
    "AttentionUNet": AttentionUNet,
    "TransUNet": TransUNet,
    "VNet2D": VNet2D,
    "ImprovedVNet": ImprovedVNet,
}
# every name create_model resolves: the active zoo and the fixed
# architectures of models/legacy.py and models/mores.py
ALL_MODELS = {**MODEL_REGISTRY, "LegacyUNet": LegacyUNet,
              "TripleBranchImprovedVNet": TripleBranchImprovedVNet,
              **MORES_REGISTRY}


def create_model(model_type: str, **kwargs) -> nn.Module:
    """Instantiate a model by name, with the JAX package's rules
    (``ddti_tpu/models/zoo.py:create_model``): the active zoo, the legacy
    models and the ``Mores*`` zoo all resolve.

    A ``features=[...]`` kwarg passes through as a tuple to a ``Mores*``
    model; for the other names it is the adapter onto the parametric zoo
    (a doubling schedule -> base_filters = features[0], depth =
    len(features)). The reference's ctor aliases ``num_classes`` /
    ``base_num_filters`` become ``out_channels`` / ``base_filters`` only
    where the class has no field of the alias's name and has the canonical
    one: ``TripleBranchImprovedVNet``'s own fields are ``num_classes`` and
    ``base_num_filters``. Kwargs the class does not take are dropped with
    a warning: a fixed architecture ignores ``base_filters``, ``depth``
    and ``remat``, so ``--remat`` on one trains without recomputation, as
    the JAX CLI does."""
    try:
        cls = ALL_MODELS[model_type]
    except KeyError:
        raise NotImplementedError(
            f"Unknown model_type {model_type!r}; choose from "
            f"{sorted(ALL_MODELS)}") from None
    features = kwargs.pop("features", None)
    if model_type in MORES_REGISTRY and features is not None:
        kwargs["features"] = tuple(features)
    elif features is not None:
        feats = list(features)
        if any(feats[i + 1] != feats[i] * 2 for i in range(len(feats) - 1)):
            raise ValueError(
                f"features list {feats} is not a doubling schedule; the "
                f"parametric zoo expects base_filters * 2**i channels")
        kwargs.setdefault("base_filters", feats[0])
        kwargs.setdefault("depth", len(feats))
    valid = set(inspect.signature(cls).parameters)
    for alias, canon in (("num_classes", "out_channels"),
                         ("base_num_filters", "base_filters")):
        if alias in kwargs and alias not in valid and canon in valid:
            kwargs.setdefault(canon, kwargs.pop(alias))
    dropped = sorted(k for k in kwargs if k not in valid)
    if dropped:
        warnings.warn(f"{model_type} ignores kwargs {dropped} "
                      f"(fixed architecture)", stacklevel=2)
    return cls(**{k: v for k, v in kwargs.items() if k in valid})
