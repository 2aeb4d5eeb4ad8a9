"""Post-training int8 quantization for the serving path, ported from
``ddti_tpu/train/quantize.py``.

A trained model becomes an int8-conv serving graph:

- **Weights**: per-output-channel symmetric int8 (scale = amax / 127 over
  each kernel's (kh, kw, cin) slice in flax's HWIO layout), quantized once
  after BatchNorm folding (``train/fold_bn.py``).
- **Activations**: per-tensor symmetric int8, scales from one calibration
  batch (max |x| at every conv input) or from QAT's learned ranges
  (``amax=``, ``train/qat.py``).
- **Accumulation**: exact s32 in ``ops/conv_s8.py`` (the hand-written
  kernels of ``csrc/conv_s8.cu`` on the card, which quantize the float
  activation as they load it), dequantized with JAX's epilogue;
  BatchNorm, activations and everything else stay float.

JAX's flax method interceptor becomes a swap of ``forward`` on the
model's plain convs (``nn.Conv2d`` / ``nn.ConvTranspose2d``, groups 1,
zero padding: JAX's ``_is_plain_conv`` / ``_is_plain_convt``), for the
duration of one call: no model code changes. The ``"quant"`` tables are
keyed by each conv's '/'-joined flax module path
(``torch_interop.flax_key_from_torch``), so they compare with JAX's tree
entry for entry: ``wq`` int8 HWIO, ``sw`` float32 (cout,), ``sx`` float32
(). A model's serving ``variables`` are one flat dict of tensors: its
``state_dict`` (BN folded, quantized kernels stripped to (1,)
placeholders) and ``quant/<path>/{wq,sw,sx}``. Convs without a table run
the float path. A TransUNet's attention projections and the flash kernel
stay as they are, as JAX's interceptor matches convs only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ddti_tpu_torch.ops.conv_s8 import conv_geometry, conv_s8

from .torch_interop import flax_key_from_torch

QUANT = "quant/"
EPS = 1e-12
# x / 127 as XLA compiles it: a division by a constant becomes a product
# with its float32 reciprocal, which JAX's jitted calibrate_and_quantize
# and QAT forward compute; JAX's numpy build_quant_tree divides
RECIP_127 = float(np.float32(1) / np.float32(127))


def is_plain_conv(mod) -> bool:
    """The dense 2-D convs JAX quantizes: ``nn.Conv2d`` (and its
    subclasses, the SAME-padded ``DownConv2x2``) with groups 1, zero
    padding given as integers."""
    return (isinstance(mod, nn.Conv2d) and mod.groups == 1
            and mod.padding_mode == "zeros"
            and not isinstance(mod.padding, str))


def is_plain_convt(mod) -> bool:
    """The decoders' transposed convs: ``nn.ConvTranspose2d`` with groups
    1, no dilation or padding (flax's VALID)."""
    return (isinstance(mod, nn.ConvTranspose2d) and mod.groups == 1
            and tuple(mod.dilation) == (1, 1)
            and tuple(mod.padding) == (0, 0)
            and tuple(mod.output_padding) == (0, 0))


def is_quantizable(mod) -> bool:
    return is_plain_conv(mod) or is_plain_convt(mod)


def model_type_of(model: nn.Module, model_type: str | None = None) -> str:
    return model_type or type(model).__name__


def conv_modules(model: nn.Module, model_type: str | None = None) -> dict:
    """``{flax path: (module name, module)}`` of every quantizable conv,
    the path '/'-joined as JAX's ``qstats`` keys are."""
    mt = model_type_of(model, model_type)
    out = {}
    for name, m in model.named_modules():
        if is_quantizable(m):
            key = flax_key_from_torch(mt, f"{name}.weight")
            out[key.split("/", 1)[1].rsplit("/", 1)[0]] = (name, m)
    return out


def flax_kernel(mod: nn.Module, weight: torch.Tensor) -> torch.Tensor:
    """A conv's torch weight -> its flax HWIO kernel in float32 (the
    transposed conv's weight is also flipped back)."""
    w = weight.to(torch.float32)
    if isinstance(mod, nn.ConvTranspose2d):
        return w.flip(2, 3).permute(2, 3, 0, 1).contiguous()
    return w.permute(2, 3, 1, 0).contiguous()


def quantize_kernel(kernel: torch.Tensor, eps: float = EPS,
                    compiled: bool = True):
    """(wq int8, sw float32 (cout,)): per-output-channel symmetric int8 of
    an HWIO float32 kernel, round half to even (JAX's ``jnp.round`` and
    ``np.rint``). ``compiled``: the scale as JAX's jitted quantizer
    computes it (times RECIP_127), else as its numpy one (/ 127)."""
    amax = kernel.abs().amax(dim=(0, 1, 2))
    sw = amax * RECIP_127 if compiled else amax / 127.0
    sw = torch.where(sw < eps, torch.ones_like(sw), sw)
    wq = torch.clamp(torch.round(kernel / sw), -127, 127).to(torch.int8)
    return wq, sw


def activation_scale(amax, eps: float = EPS) -> torch.Tensor:
    """sx from a range: a float32 tensor (calibration) as JAX's jitted
    ``calibrate_and_quantize`` computes it, a Python float (QAT ranges) in
    float64, rounded once, as its numpy ``build_quant_tree`` does."""
    if isinstance(amax, torch.Tensor):
        return torch.clamp_min(amax.to(torch.float32) * RECIP_127, eps)
    return torch.tensor(max(float(amax) / 127.0, eps), dtype=torch.float32)


def _autocast_bf16(device_type: str) -> bool:
    return (torch.is_autocast_enabled(device_type)
            and torch.get_autocast_dtype(device_type) == torch.bfloat16)


def _geometry(mod: nn.Module, h: int, w: int) -> tuple:
    """(stride, dilation, pad_top, pad_left, out_h, out_w, transpose) of a
    plain conv on an h x w input, as flax pads it."""
    if isinstance(mod, nn.ConvTranspose2d):
        if tuple(mod.kernel_size) != (2, 2) or tuple(mod.stride) != (2, 2):
            raise ValueError(f"transposed conv k = {mod.kernel_size}, s = "
                             f"{mod.stride}: conv_s8 takes k = 2, s = 2")
        return (2, 1, *conv_geometry(h, w, 2, 2, 1, "T"), True)
    from ddti_tpu_torch.models.blocks import DownConv2x2

    k, s, d = mod.kernel_size, mod.stride, mod.dilation
    if len({*k}) != 1 or len({*s}) != 1 or len({*d}) != 1 or \
            mod.padding[0] != mod.padding[1]:
        raise ValueError(f"conv k = {k}, s = {s}, d = {d}, p = "
                         f"{mod.padding}: conv_s8 takes square geometries")
    pad = "SAME" if isinstance(mod, DownConv2x2) else mod.padding[0]
    return (s[0], d[0], *conv_geometry(h, w, k[0], s[0], d[0], pad), False)


def quant_forward(mod: nn.Module, wq, sw, sx):
    """The int8 forward of one conv (JAX ``_quant_interceptor``): x as the
    NHWC view ``x.permute(0, 2, 3, 1)``, copied only where x is not
    channels-last (``quant_forward.layout_copies`` counts the copies), and
    ``ops.conv_s8`` on it with ``sx``, which quantizes it, clip(rint(x /
    sx)), as its kernel loads it, and the module's bias (the tensor in
    place under ``functional_call``); NCHW again. x in another float type
    than bf16 or float32 is cast to float32 first, as JAX casts it. The
    output is bf16 under bf16 autocast (a bf16 model's module dtype), else
    x's dtype."""

    def forward(x):
        xf = x if x.dtype in (torch.bfloat16, torch.float32) \
            else x.to(torch.float32)
        xh = xf.permute(0, 2, 3, 1)
        if not xh.is_contiguous():
            xh = xh.contiguous()
            quant_forward.layout_copies += 1
        bf16 = _autocast_bf16(x.device.type)
        y = conv_s8(xh, wq, sx, sw, mod.bias,
                    *_geometry(mod, x.shape[-2], x.shape[-1]),
                    bf16 or x.dtype == torch.bfloat16)
        y = y.permute(0, 3, 1, 2)
        return y if bf16 or y.dtype == x.dtype else y.to(x.dtype)

    return forward


quant_forward.layout_copies = 0


@contextlib.contextmanager
def swapped_forwards(forwards: dict):
    """Each module of ``{module: forward}`` runs ``forward`` instead of its
    own inside the block."""
    for m, f in forwards.items():
        m.forward = f
    try:
        yield
    finally:
        for m in forwards:
            m.__dict__.pop("forward", None)


def quant_tables(variables: dict) -> dict:
    """``{path: {"wq", "sw", "sx"}}`` of a serving ``variables`` dict."""
    out: dict = {}
    for k, v in variables.items():
        if k.startswith(QUANT):
            path, leaf = k[len(QUANT):].rsplit("/", 1)
            out.setdefault(path, {})[leaf] = v
    return out


def model_weights(variables: dict) -> dict:
    """The ``state_dict`` part of a serving ``variables`` dict."""
    return {k: v for k, v in variables.items() if not k.startswith(QUANT)}


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@torch.no_grad()
def calibrate_conv_amax(model: nn.Module, images: torch.Tensor, *,
                        bf16: bool = False, model_type: str | None = None,
                        weights: dict | None = None) -> dict:
    """One eval-mode forward of NHWC float ``images`` recording max |input|
    at every quantizable conv that runs: ``{path: float32 tensor}`` on the
    device (no host read per conv). ``bf16``: under bf16 autocast, the
    compute of a bf16 model. ``weights``: a ``state_dict`` to run with
    (``functional_call``) instead of the model's own."""
    amax: dict = {}
    hooks = []
    for path, (_, m) in conv_modules(model, model_type).items():
        def pre(mod, args, path=path):
            a = args[0].detach().to(torch.float32).abs().amax()
            amax[path] = a if path not in amax else torch.maximum(
                amax[path], a)
        hooks.append(m.register_forward_pre_hook(pre))
    was_training = model.training
    model.eval()
    try:
        x = images.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            if weights is None:
                model(x)
            else:
                functional_call(model, weights, (x,))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return amax


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------


def build_quant_tree(model: nn.Module, weights: dict, amax: dict, *,
                     model_type: str | None = None,
                     eps: float = EPS) -> dict:
    """``{"quant/<path>/wq" | "sw" | "sx": tensor}`` for every path of
    ``amax``: the kernels read from ``weights`` (a ``state_dict``)."""
    mods = conv_modules(model, model_type)
    out = {}
    for path, a in amax.items():
        name, m = mods[path]
        # calibrated ranges (tensors) take JAX's jitted arithmetic, learned
        # ones (floats) its numpy build_quant_tree's
        wq, sw = quantize_kernel(flax_kernel(m, weights[f"{name}.weight"]),
                                 eps, compiled=isinstance(a, torch.Tensor))
        sx = activation_scale(a, eps).to(sw.device)
        out.update({f"{QUANT}{path}/wq": wq, f"{QUANT}{path}/sw": sw,
                    f"{QUANT}{path}/sx": sx})
    return out


def strip_quantized_kernels(model: nn.Module, weights: dict, paths, *,
                            model_type: str | None = None) -> dict:
    """A copy of ``weights`` with each quantized conv's float kernel
    replaced by a (1,) placeholder: the int8 graph never reads it."""
    mods = conv_modules(model, model_type)
    out = dict(weights)
    for path in paths:
        key = f"{mods[path][0]}.weight"
        out[key] = torch.zeros((1,), dtype=torch.float32,
                               device=weights[key].device)
    return out


def quantized_apply(model: nn.Module, variables: dict, x: torch.Tensor, *,
                    model_type: str | None = None):
    """``model(x)`` (NCHW) with every tabled conv running as int8 x int8 ->
    s32 (``ops.conv_s8``), the weights of ``variables`` in place
    (``functional_call``); convs without a table and all other modules
    run unchanged."""
    mods = conv_modules(model, model_type)
    swaps = {}
    for path, t in quant_tables(variables).items():
        m = mods[path][1]
        swaps[m] = quant_forward(m, t["wq"], t["sw"], t["sx"])
    with swapped_forwards(swaps):
        return functional_call(model, model_weights(variables), (x,))


# ---------------------------------------------------------------------------
# end to end: trained weights -> int8 serving variables
# ---------------------------------------------------------------------------


def quantize_serving(model: nn.Module, calib_images=None, *,
                     fold_bn: bool = True, strip: bool = True,
                     min_channels: int = 0, amax: dict | None = None,
                     model_type: str | None = None,
                     bf16: bool = False) -> dict:
    """Fold BN, calibrate on NHWC float ``calib_images`` (under bf16
    autocast where ``bf16``) or take QAT ranges ``amax`` ({path: float}),
    quantize the weights; returns the serving ``variables`` for
    ``quantized_apply`` / ``export_serving_int8``. Exactly one of the two
    must be given. ``min_channels``: mixed precision, only convs with
    max(cin, cout) >= it get tables. A model whose BatchNorms cannot fold
    (LegacyUNet's Conv -> ReLU -> BN) is quantized unfolded: eval-mode BN
    is a float affine after the dequantized conv."""
    if (calib_images is None) == (amax is None):
        raise ValueError(
            "quantize_serving needs exactly one of calib_images (PTQ "
            "calibration) or amax (QAT-learned ranges)")
    mt = model_type_of(model, model_type)
    net = model
    if fold_bn:
        from .fold_bn import fold_batchnorm
        try:
            net = fold_batchnorm(model, mt)
        except ValueError:
            pass
    weights = {k: v.detach() for k, v in net.state_dict().items()}
    mods = conv_modules(net, mt)
    if amax is None:
        amax = calibrate_conv_amax(net, calib_images, bf16=bf16,
                                   model_type=mt)
    else:  # learned ranges of convs this model does not have are dropped
        amax = {p: a for p, a in amax.items() if p in mods}
    if min_channels:
        amax = {p: a for p, a in amax.items()
                if max(flax_kernel(mods[p][1], weights[
                    f"{mods[p][0]}.weight"]).shape[2:]) >= min_channels}
    tables = build_quant_tree(net, weights, amax, model_type=mt)
    if strip:
        weights = strip_quantized_kernels(net, weights, amax, model_type=mt)
    return {**weights, **tables}


def export_quantized_program(model: nn.Module, variables: dict, batch: int,
                             size: int, in_channels: int = 1,
                             threshold: float = 0.5,
                             input_dtype=torch.float32, tta: bool = False,
                             bf16: bool = False,
                             model_type: str | None = None):
    """An already-quantized ``variables`` dict (``quantize_serving``) as a
    weights-as-arguments serving program (``train/export.py``): every
    tabled conv a ``ddti::conv_s8`` call. Returns the ExportedProgram."""
    from .export import export_program

    return export_program(model, variables, batch, size, in_channels,
                          threshold, input_dtype, tta=tta, bf16=bf16,
                          quantized=True, model_type=model_type)


def export_serving_int8(model: nn.Module, batch: int, size: int,
                        calib_images=None, in_channels: int = 1,
                        threshold: float = 0.5, input_dtype=torch.float32,
                        min_channels: int = 0, tta: bool = False,
                        amax: dict | None = None, bf16: bool = False,
                        model_type: str | None = None):
    """Quantize and export in one call: returns ``(program, variables)``;
    ``save_bundle`` writes the pair."""
    variables = quantize_serving(model, calib_images,
                                 min_channels=min_channels, amax=amax,
                                 model_type=model_type, bf16=bf16)
    program = export_quantized_program(model, variables, batch, size,
                                       in_channels, threshold, input_dtype,
                                       tta=tta, bf16=bf16,
                                       model_type=model_type)
    return program, variables


def export_serving_int8_sharded(model: nn.Module, nr_devices: int,
                                batch: int, size: int, calib_images=None,
                                in_channels: int = 1,
                                threshold: float = 0.5,
                                input_dtype=torch.float32,
                                min_channels: int = 0, tta: bool = False,
                                amax: dict | None = None, bf16: bool = False,
                                model_type: str | None = None):
    """Int8 quantization and the scale-out form in one artifact (JAX
    ``export_serving_int8_sharded``): ``batch`` is the GLOBAL batch, the
    program traced at the per-device batch (``export.per_device_batch``).
    Returns ``(program, variables)``; ``save_bundle(...,
    nr_devices=nr_devices)`` writes the pair. A caller that writes the
    plain and the sharded bundle quantizes once and passes the tables to
    ``export_quantized_program`` twice, as the Trainer does."""
    from .export import per_device_batch

    return export_serving_int8(
        model, per_device_batch(batch, nr_devices), size, calib_images,
        in_channels, threshold, input_dtype, min_channels, tta, amax, bf16,
        model_type)
