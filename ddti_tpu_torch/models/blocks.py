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
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ddti_tpu_torch.ops.attention import attention_reference, flash_attention
from ddti_tpu_torch.parallel.spatial import edges, halo

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


def one_pass_stats(x):
    """flax's ``use_fast_variance=True`` statistics of NCHW ``x`` over (N,
    H, W), reduced in at least float32 whatever the dtype of ``x`` (flax
    promotes to float32; float64 stays): ``mean = E[x]`` and ``var = max(0,
    E[x^2] - E[x]^2)``, the biased variance. Two reductions that read ``x``
    as it is (on CUDA a bf16 ``x`` is widened in the reduction, not
    copied); ``E[x^2]`` as the squared 2-norm over the count."""
    dims = (0, 2, 3)
    dt = torch.promote_types(x.dtype, torch.float32)
    with torch.no_grad():
        mean = torch.mean(x, dim=dims, dtype=dt)
        sq = torch.linalg.vector_norm(x, 2, dim=dims, dtype=dt)
        var = torch.clamp_min(sq * sq / (x.numel() // x.shape[1])
                              - mean * mean, 0.0)
    return mean, var


class _OnePassNorm(torch.autograd.Function):
    """Train-mode normalisation by given batch statistics (``mean``,
    ``var`` of ``x`` itself): the forward is the eval-mode kernel with
    them, the backward ATen's train-mode BatchNorm backward with
    ``save_mean = mean`` and ``save_invstd = rsqrt(var + eps)``, which is
    the gradient of the one-pass formula in exact arithmetic (both
    variances are the same function of ``x``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var):
        invstd = torch.rsqrt(var + BN_EPS)
        ctx.save_for_backward(x, weight, mean, invstd)
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, BN_EPS)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, invstd = ctx.saved_tensors
        # the gradient in the input's layout: channels-last activations
        # (cuDNN's bf16 convolutions) take ATen's channels-last kernels only
        # when both are
        fmt = (torch.channels_last
               if x.dim() == 4 and not x.is_contiguous()
               and x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            gy.contiguous(memory_format=fmt), x, weight, None, None, mean,
            invstd, True, BN_EPS, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None, None


def global_stats(x, mesh, exact: bool = False):
    """The batch statistics of NCHW ``x`` over every rank's rows (JAX's
    BatchNorm under a ``data`` mesh: GSPMD reduces the batch axis across
    replicas): the sums of the ranks' rows all-reduced, in float32 or
    wider as ``one_pass_stats``. One pass: ``sum x``, ``sum x^2`` and the
    count in one collective, ``var = max(0, E[x^2] - E[x]^2)``; with
    ``exact`` two: the global mean first, then ``sum (x - mean)^2``."""
    from ddti_tpu_torch.parallel.mesh import all_reduce_

    dims = (0, 2, 3)
    dt = torch.promote_types(x.dtype, torch.float32)
    with torch.no_grad():
        count = x.new_full((1,), x.numel() // x.shape[1], dtype=dt)
        s = torch.sum(x, dim=dims, dtype=dt)
        if exact:
            buf = torch.cat([s, count])
            all_reduce_([buf], mesh)
            n = buf[-1]
            mean = buf[:-1] / n
            dev = torch.linalg.vector_norm(
                x.to(dt) - mean[None, :, None, None], 2, dim=dims)
            sq = dev * dev
            all_reduce_([sq], mesh)
            return mean, sq / n
        norm = torch.linalg.vector_norm(x, 2, dim=dims, dtype=dt)
        buf = torch.cat([s, norm * norm, count])
        all_reduce_([buf], mesh)
        c = x.shape[1]
        n = buf[-1]
        mean = buf[:c] / n
        var = torch.clamp_min(buf[c:2 * c] / n - mean * mean, 0.0)
    return mean, var


class _GlobalNorm(torch.autograd.Function):
    """Train-mode normalisation by the global statistics ``mean``, ``var``
    (``global_stats``) under a mesh. The forward is ``_OnePassNorm``'s;
    the backward is BatchNorm's with the batch sums taken over every rank:
    ``gx = w invstd (gy - sum(gy) / n - xhat sum(gy xhat) / n)`` with both
    sums and the count all-reduced in one collective, while ``gw`` and
    ``gb`` stay this rank's sums (the gradient average adds the ranks'
    parts)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, mesh):
        invstd = torch.rsqrt(var + BN_EPS)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh = mesh
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, BN_EPS)

    @staticmethod
    def backward(ctx, gy):
        from ddti_tpu_torch.parallel.mesh import all_reduce_

        x, weight, mean, invstd = ctx.saved_tensors
        dims = (0, 2, 3)
        dt = mean.dtype

        def per_channel(t):
            return t[None, :, None, None]

        xhat = (x.to(dt) - per_channel(mean)) * per_channel(invstd)
        g = gy.to(dt)
        sum_g = g.sum(dim=dims)
        sum_gx = (g * xhat).sum(dim=dims)
        count = sum_g.new_full((1,), x.numel() // x.shape[1])
        buf = torch.cat([sum_g, sum_gx, count])
        all_reduce_([buf], ctx.mesh)
        c = x.shape[1]
        n = buf[-1]
        gx = None
        if ctx.needs_input_grad[0]:
            gx = ((g - per_channel(buf[:c] / n)
                   - xhat * per_channel(buf[c:2 * c] / n))
                  * per_channel(weight.to(dt) * invstd)).to(x.dtype)
        gw = sum_gx.to(weight.dtype) if ctx.needs_input_grad[1] else None
        gb = sum_g.to(weight.dtype) if ctx.needs_input_grad[2] else None
        return gx, gw, gb, None, None, None


class BatchNorm2d(nn.Module):
    """BatchNorm with the JAX package's numerics and without the
    ``num_batches_tracked`` buffer, which the JAX package's export does not
    carry (it only feeds momentum=None averaging, unused here). Reference
    ``.pth`` files that do carry it load all the same: the entry is dropped
    on load.

    Train mode normalises with the batch's statistics and updates the
    running statistics as flax ``nn.BatchNorm`` does: ``new = 0.9 old +
    0.1 batch`` with the **biased** batch variance. torch's own train-mode
    update would store the unbiased n/(n-1) variance instead. The
    statistics are reduced in float32 whatever the autocast dtype of
    ``x``. By default in one pass, flax's ``use_fast_variance=True`` (the
    JAX package's default, ``one_pass_stats``); with ``exact_variance``
    in two passes, ``E[(x - mean)^2]`` (``--bn_exact_variance``, torch's
    numerics). ``exact_variance`` is a per-module attribute: the Trainer
    sets it on every BatchNorm of its model (``set_bn_exact_variance``);
    a module nobody set follows the class attribute, False. A
    recomputation under ``--remat`` normalises alike and leaves the
    statistics alone. ``mesh`` (``set_bn_mesh``, the Trainer's
    data-parallel mesh) makes train-mode statistics those of the global
    batch, every rank's rows, in either mode, and the backward's batch
    sums global too (``global_stats``, ``_GlobalNorm``): the statistics
    and gradients of one device on the same global batch."""

    exact_variance = False
    mesh = None

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
        if self.mesh is not None:
            mean, var = global_stats(x, self.mesh, self.exact_variance)
            if not recomputing():
                self._update_running(mean, var)
            return _GlobalNorm.apply(x, self.weight, self.bias, mean, var,
                                     self.mesh)
        if self.exact_variance:
            if recomputing():
                return F.batch_norm(x, None, None, self.weight, self.bias,
                                    True, 0.0, BN_EPS)
            with torch.no_grad():
                var, mean = torch.var_mean(
                    x.to(torch.promote_types(x.dtype, torch.float32)),
                    dim=(0, 2, 3), correction=0)
                self._update_running(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, BN_EPS)
        mean, var = one_pass_stats(x)
        if not recomputing():
            self._update_running(mean, var)
        return _OnePassNorm.apply(x, self.weight, self.bias, mean, var)

    @torch.no_grad()
    def _update_running(self, mean, var):
        self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean,
                                                       alpha=BN_MOMENTUM)
        self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def set_bn_exact_variance(model: nn.Module, exact: bool) -> int:
    """Set ``exact_variance`` on every ``BatchNorm2d`` of ``model`` (the
    JAX Trainer's ``set_bn_fast_variance(not exact)``, per module here);
    returns how many it set."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.exact_variance = bool(exact)
    return len(bns)


def set_bn_mesh(model: nn.Module, mesh) -> int:
    """Set ``mesh`` on every ``BatchNorm2d`` of ``model`` (None: local
    statistics again); returns how many it set."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.mesh = mesh
    return len(bns)


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


def attach(owner: nn.Module, path: str, child: nn.Module) -> None:
    """Register ``child`` at the dotted ``path`` under ``owner``, making
    ``nn.Sequential`` containers on the way (``"W_g.0"``). The blocks below
    take their children's paths as ``names``: one block's arithmetic then
    carries either the reference's key layout (the default) or the flax
    names of the JAX package's export (``models/mores.py``)."""
    *parents, leaf = path.split(".")
    for p in parents:
        if p not in owner._modules:
            owner.add_module(p, nn.Sequential())
        owner = owner._modules[p]
    owner.add_module(leaf, child)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that also runs on bands of rows (``band_mesh``,
    ``parallel/spatial.py``). The conv runs on the band with its own
    padding, and its first and last output rows, which read rows of the
    bands above and below, are computed again from thin windows of the
    band's edge rows and the neighbours' (``edges``): the band is kept
    for the backward once, as on one device, where a conv of the haloed
    band would keep a second copy of it. At an even band height a stride-2
    3x3 conv reads one row above its band and none below; a band thinner
    than its kernel's reach takes the haloed band (``band_input``)."""

    band_mesh = None

    def forward(self, x):
        if self.band_mesh is None:
            return super().forward(x)
        split = self._band_split(x.shape[2])
        if split is None:
            x, padding = self.band_input(x)
            return F.conv2d(x, self.weight, self.bias, self.stride, padding,
                            self.dilation, self.groups)
        top, bottom, jt, nt, jb, r0 = split
        above, below = edges(x, top, bottom, self.band_mesh)
        y = super().forward(x)  # zero rows beyond the band's edges

        def window(rows):
            return F.conv2d(rows, self.weight, self.bias, self.stride,
                            (0, self.padding[1]), self.dilation, self.groups)

        parts = [y[:, :, jt:jb]]
        if jt:
            parts.insert(0, window(torch.cat([above, x[:, :, :nt]], 2)))
        if jb < y.shape[2]:
            parts.append(window(torch.cat([x[:, :, r0:], below], 2)))
        return torch.cat(parts, 2)

    def _geometry(self, hb: int):
        """(halo rows above, below) of a band of ``hb`` rows."""
        (kh, _), (sh, _), (dh, _) = self.kernel_size, self.stride, \
            self.dilation
        ph = self.padding[0]
        bottom = (kh - 1) * dh - ph - sh + 1
        if hb % sh or bottom < 0:
            raise ValueError(f"conv k {self.kernel_size} s {self.stride} p "
                             f"{self.padding} on a band of {hb} rows: not a "
                             f"band-local geometry")
        return ph, bottom

    def _band_split(self, hb: int):
        """(top, bottom, jt, nt, jb, r0): output rows [0, jt) read the
        ``top`` rows above and band rows [0, nt), rows [jb, hb / s) band
        rows [r0, hb) and the ``bottom`` rows below; None where those
        windows overlap or outreach the band."""
        top, bottom = self._geometry(hb)
        reach = (self.kernel_size[0] - 1) * self.dilation[0]
        s = self.stride[0]
        jt = -(-top // s)
        nt = (jt - 1) * s - top + reach + 1 if jt else 0
        jb = max(jt, -(-(hb - reach + top) // s))
        r0 = jb * s - top
        if (top > hb or bottom > hb or nt > hb or r0 < 0
                or jb > hb // s):
            return None
        return top, bottom, jt, nt, jb, r0

    def band_input(self, x):
        """(the band ``x`` with its halo rows, the conv's padding on it)."""
        top, bottom = self._geometry(x.shape[2])
        return halo(x, top, bottom, self.band_mesh), (0, self.padding[1])


# (conv, BN, act, conv, BN, act): the reference's nn.Sequential indices,
# and flax's child names
SEQ_NAMES = ("0", "1", "2", "3", "4", "5")
FLAX_NAMES = ("conv1", "bn1", "act1", "conv2", "bn2", "act2")


class ConvBNAct(nn.Sequential):
    """(3x3 conv without bias -> BatchNorm -> activation) twice under
    ``names``; by default indices 0, 1, 3, 4 hold the weights, as in the
    reference's ``nn.Sequential``, and with ``act="prelu"`` (VNet2D)
    indices 2 and 5 the PReLU slopes."""

    def __init__(self, in_channels: int, features: int, act: str = "relu",
                 names=SEQ_NAMES):
        super().__init__(OrderedDict(zip(names, (
            Conv2d(in_channels, features, 3, padding=1, bias=False),
            BatchNorm2d(features), _act(act),
            Conv2d(features, features, 3, padding=1, bias=False),
            BatchNorm2d(features), _act(act)))))


class ResidualBlock(nn.Module):
    """(3x3 conv -> BN -> ReLU -> 3x3 conv -> BN) + 1x1-conv shortcut, ReLU
    after the add. ``names`` are the six children's paths; by default the
    reference's ``conv`` Sequential (indices 0, 1, 3, 4 hold the weights)
    and ``skip``."""

    def __init__(self, in_channels: int, features: int,
                 names=tuple(f"conv.{i}" for i in range(5)) + ("skip",)):
        super().__init__()
        self.names = names
        for path, m in zip(names, (
                Conv2d(in_channels, features, 3, padding=1, bias=False),
                BatchNorm2d(features), nn.ReLU(inplace=True),
                Conv2d(features, features, 3, padding=1, bias=False),
                BatchNorm2d(features),
                nn.Conv2d(in_channels, features, 1, bias=False))):
            attach(self, path, m)

    def forward(self, x):
        y = x
        for path in self.names[:5]:
            y = self.get_submodule(path)(y)
        return F.relu(y + self.get_submodule(self.names[5])(x))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling bottleneck: parallel dilated 3x3 convs
    without bias (padding = dilation), concatenated, then a 1x1 conv
    without bias, BatchNorm and ReLU. ``names`` are the branches' path
    pattern and the projection's and its BatchNorm's paths; by default
    ``branches.{k}``, ``project.0`` and ``project.1``. Every tap is kept,
    also those of a dilation wider than the map, which read only padding
    (cuDNN and XLA both keep them)."""

    def __init__(self, in_channels: int, features: int,
                 dilations=(1, 6, 12, 18),
                 names=("branches.{}", "project.0", "project.1")):
        super().__init__()
        self.names = (tuple(names[0].format(k)
                            for k in range(len(dilations))),) + names[1:]
        for path, d in zip(self.names[0], dilations):
            attach(self, path, Conv2d(in_channels, features, 3, padding=d,
                                      dilation=d, bias=False))
        attach(self, names[1], nn.Conv2d(len(dilations) * features, features,
                                         1, bias=False))
        attach(self, names[2], BatchNorm2d(features))

    def forward(self, x):
        branches, project, bn = self.names
        y = torch.cat([self.get_submodule(b)(x) for b in branches], dim=1)
        return F.relu(self.get_submodule(bn)(self.get_submodule(project)(y)))


class AttentionGate(nn.Module):
    """Additive attention gate on a skip connection: psi = sigmoid(BN(conv(
    relu(W_g g + W_x x)))), returns x * psi. ``W_g``, ``W_x`` and ``psi``
    are each (biased 1x1 conv, BatchNorm), at the six paths of ``names``
    (by default ``W_g.0``, ``W_g.1``, ...); the sigmoid and the product run
    in the compute dtype (bf16 under autocast), as in JAX. ``g`` and ``x``
    must share their spatial size: the sum broadcasts nothing."""

    def __init__(self, g_channels: int, x_channels: int, inter: int,
                 names=("W_g.0", "W_g.1", "W_x.0", "W_x.1", "psi.0",
                        "psi.1")):
        super().__init__()
        self.names = names
        for path, m in zip(names, (
                nn.Conv2d(g_channels, inter, 1), BatchNorm2d(inter),
                nn.Conv2d(x_channels, inter, 1), BatchNorm2d(inter),
                nn.Conv2d(inter, 1, 1), BatchNorm2d(1))):
            attach(self, path, m)

    def forward(self, g, x):
        w_g, w_g_bn, w_x, w_x_bn, psi, psi_bn = map(self.get_submodule,
                                                    self.names)
        a = psi_bn(psi(F.relu(w_g_bn(w_g(g)) + w_x_bn(w_x(x)))))
        return x * torch.sigmoid(a)


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


def self_attention(x, weight, bias, out_proj, num_heads: int, *,
                   dropout: float, training: bool, use_flash: bool | None):
    """Multi-head self-attention of (b, s, e) tokens: the packed q | k | v
    projection (``weight``, ``bias``), the heads' attention through
    ``flash_attention`` or the plain path, then ``out_proj``.
    ``use_flash=None`` is the JAX gate (blocks.py:291) as it is: flash
    never drops attention probabilities, so a training step with dropout
    stays on the plain path."""
    b, s, e = x.shape
    hd = e // num_heads
    qkv = F.linear(x, weight, bias)
    # (b, s, h, hd) -> (b, h, s, hd)
    q, k, v = (t.reshape(b, s, num_heads, hd).transpose(1, 2).contiguous()
               for t in qkv.chunk(3, dim=-1))
    if use_flash is None:
        use_flash = (s >= 1024 and s % 256 == 0 and hd % 8 == 0
                     and (not training or dropout == 0.0))
    if use_flash:
        y = flash_attention(q, k, v)
    elif training and dropout:
        y = attention_dropout(q, k, v, dropout)
    else:
        y = attention_reference(q, k, v)
    return out_proj(y.transpose(1, 2).reshape(b, s, e))


def _attr(module: nn.Module, target: str):
    """The tensor at dotted ``target`` under ``module``."""
    owner, _, name = target.rpartition(".")
    return getattr(module.get_submodule(owner) if owner else module, name)


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch MHA's parameter names (packed
    ``in_proj_weight``/``in_proj_bias`` and ``out_proj``), whose attention
    goes through ``self_attention``."""

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
        return self_attention(x, self.in_proj_weight, self.in_proj_bias,
                              self.out_proj, self.num_heads,
                              dropout=self.dropout, training=self.training,
                              use_flash=self.use_flash_attention)


# (packed projection's weight and bias, out_proj, linear1, linear2, norm1,
# norm2): torch nn.TransformerEncoderLayer's names, and flax's
TORCH_LAYER_NAMES = ("self_attn.in_proj_weight", "self_attn.in_proj_bias",
                     "self_attn.out_proj", "linear1", "linear2", "norm1",
                     "norm2")
FLAX_LAYER_NAMES = ("qkv.weight", "qkv.bias", "out_proj", "fc1", "fc2",
                    "ln1", "ln2")


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: x = norm1(x + drop(attn(x))); x = norm2(x +
    drop(linear2(drop(relu(linear1(x)))))), dropout on the attention
    probabilities too (the plain path). ``names`` are the parameters'
    paths: by default torch ``nn.TransformerEncoderLayer``'s (a
    ``SelfAttention`` under ``self_attn``), or ``FLAX_LAYER_NAMES`` (a
    packed ``qkv`` Linear and ``out_proj`` on the layer).

    ``attend_batch_axis`` reproduces the reference quirk of attending over
    the batch axis (see the JAX counterpart)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1,
                 attend_batch_axis: bool = False,
                 use_flash_attention: bool | None = None,
                 names=TORCH_LAYER_NAMES):
        super().__init__()
        self.attend_batch_axis = attend_batch_axis
        self.num_heads = num_heads
        self.attn_dropout = dropout
        self.use_flash_attention = use_flash_attention
        self.names = names
        if names == TORCH_LAYER_NAMES:
            self.self_attn = SelfAttention(embed_dim, num_heads, dropout,
                                           use_flash_attention)
        else:
            attach(self, names[0].rpartition(".")[0],
                   nn.Linear(embed_dim, 3 * embed_dim))
            attach(self, names[2], nn.Linear(embed_dim, embed_dim))
        for path, m in zip(names[3:], (
                nn.Linear(embed_dim, 4 * embed_dim),
                nn.Linear(4 * embed_dim, embed_dim),
                nn.LayerNorm(embed_dim, eps=1e-5),
                nn.LayerNorm(embed_dim, eps=1e-5))):
            attach(self, path, m)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        w, b, out_proj, linear1, linear2, norm1, norm2 = self.names
        m = self.get_submodule
        if self.attend_batch_axis:
            x = x.transpose(0, 1)
        # getattr, not get_parameter: under functional_call (a serving
        # program's weights) the projection is a plain tensor
        y = self_attention(x, _attr(self, w), _attr(self, b),
                           m(out_proj), self.num_heads,
                           dropout=self.attn_dropout, training=self.training,
                           use_flash=self.use_flash_attention)
        x = m(norm1)(x + self.dropout(y))
        y = m(linear2)(self.dropout(F.relu(m(linear1)(x))))
        x = m(norm2)(x + self.dropout(y))
        if self.attend_batch_axis:
            x = x.transpose(0, 1)
        return x
