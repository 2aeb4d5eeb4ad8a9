"""Inference-time BatchNorm folding, ported from ``ddti_tpu/train/fold_bn.py``.

Every Conv -> BatchNorm pair is folded into the conv's weight: the weight
absorbs ``gamma / sqrt(var + eps)`` per output channel and the BatchNorm
becomes a per-channel bias add (scale 1, mean 0, var 1 - eps). A conv bias
passes through the factor into the BatchNorm's bias and is then zeroed.
The module keeps its structure and ``state_dict`` keys, so a folded model
saves with ``save_weights`` and loads with ``load_state_dict(strict=True)``.

The pairs are exactly the JAX package's: the flax names of the model's
``state_dict`` keys (``train/torch_interop.py:flax_key_from_torch``) go
through this module's copy of JAX's naming rule (``convN``/``bnN``,
``<name>``/``<name>_bn``: ``project_bn``, ``w_g_bn``, ``w_x_bn``,
``psi_bn``). Where that adjacency does not hold (a Conv -> ReLU -> BN
block, as the JAX package's LegacyUNet has) folding is invalid, so
``fold_batchnorm`` runs the folded model against the original on one
example and raises ``ValueError`` if they diverge.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ddti_tpu_torch.models.blocks import BN_EPS

from .torch_interop import flax_key_from_torch


def _bn_partner(name: str) -> str | None:
    """Conv sibling name for a BatchNorm child name, per zoo convention."""
    if name.startswith("bn") and name[2:].isdigit():
        return "conv" + name[2:]
    if name.endswith("_bn"):
        return name[: -len("_bn")]
    return None


def _classify(params: dict, stats: dict, name: str) -> tuple[str, str | None]:
    """JAX's one pairing predicate over a flax-named tree whose leaves are
    the port's tensors. Returns ("fold", conv_name) for a BN whose partner
    conv exists and has a 4-D kernel, ("skip", None) for a BN without one
    (left intact) and ("recurse", None) for any other module."""
    child = params[name]
    is_bn = ("scale" in child and "bias" in child
             and isinstance(stats.get(name), dict)
             and "mean" in stats[name] and "var" in stats[name])
    if not is_bn:
        return "recurse", None
    conv_name = _bn_partner(name)
    conv = params.get(conv_name) if conv_name else None
    if conv is None or "kernel" not in conv or conv["kernel"].dim() != 4:
        return "skip", None
    return "fold", conv_name


def _flax_tree(sd: dict, model_type: str) -> dict:
    """``{"params": {...}, "batch_stats": {...}}``: the tensors of the
    ``state_dict`` ``sd``, nested by the flax path of each key."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        collection, *path = flax_key_from_torch(model_type, key).split("/")
        node = tree[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    return tree


def fold_pairs(model: nn.Module, model_type: str | None = None) -> list:
    """``[(conv module name, BatchNorm module name), ...]`` in torch naming,
    for every pair ``fold_batchnorm`` folds: a walk over the flax-named
    tree with JAX's ``_classify``. ``model_type`` picks the key rules
    (default: the model's class name)."""
    sd = model.state_dict()
    tree = _flax_tree(sd, model_type or type(model).__name__)
    owner = {id(t): k.rsplit(".", 1)[0] for k, t in sd.items()}
    out: list = []

    def walk(p: dict, s: dict) -> None:
        for name, child in p.items():
            if not isinstance(child, dict):
                continue
            kind, conv_name = _classify(p, s, name)
            if kind == "fold":
                out.append((owner[id(p[conv_name]["kernel"])],
                            owner[id(child["scale"])]))
            elif kind == "recurse":
                sub = s.get(name)
                walk(child, sub if isinstance(sub, dict) else {})

    walk(tree["params"], tree["batch_stats"])
    return out


@torch.no_grad()
def _fold(model: nn.Module, pairs: list, eps: float) -> None:
    """Fold each (conv, bn) pair of ``model`` in place, in float32."""
    for conv_name, bn_name in pairs:
        conv = model.get_submodule(conv_name)
        bn = model.get_submodule(bn_name)
        # the correctly rounded float32 square root, as XLA's: torch's
        # vectorised CPU sqrt is an ulp off on some inputs, which would move
        # a folded kernel off JAX's bits (and its int8 rounding with it)
        root = torch.sqrt((bn.running_var.float() + eps).double()).float()
        factor = bn.weight.float() / root
        # the output channel: dim 0 of a Conv2d weight (O, I, kH, kW), dim 1
        # of a ConvTranspose2d weight (I, O, kH, kW)
        shape = [1] * conv.weight.dim()
        shape[1 if isinstance(conv, nn.ConvTranspose2d) else 0] = -1
        conv.weight.copy_(conv.weight.float() * factor.view(shape))
        bias = bn.bias.float() - bn.running_mean.float() * factor
        if conv.bias is not None:  # a conv bias rides through BN's map
            bias = bias + conv.bias.float() * factor
            conv.bias.zero_()
        # the BN becomes identity plus bias: (x - 0) / sqrt(1 - eps + eps)
        bn.weight.fill_(1.0)
        bn.bias.copy_(bias)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - eps)


@torch.no_grad()
def _logits(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    with torch.autocast(x.device.type, enabled=False):
        out = model(x)
    return (out[0] if isinstance(out, tuple) else out).float()


def fold_batchnorm(model: nn.Module, model_type: str | None = None, *,
                   example: torch.Tensor | None = None, eps: float = BN_EPS,
                   atol: float = 1e-3, rtol: float = 0.01) -> nn.Module:
    """A copy of ``model`` with every Conv -> BatchNorm pair folded (the
    model itself when it has none), on the model's device.

    The folded copy is checked against ``model`` in eval mode, in float32
    with TF32 off in cuDNN and matmuls (JAX runs the check at "highest"
    precision), on ``example`` (NCHW) or by default one uniform frame of
    32², or of ``image_size`` for a model with a fixed input size
    (TransUNet's positional embedding). ``ValueError`` when the largest
    logit difference exceeds ``atol + rtol * max|logit|`` or is not
    finite: that model's BatchNorms do not directly follow their convs."""
    pairs = fold_pairs(model, model_type)
    if not pairs:
        return model
    folded = copy.deepcopy(model)
    _fold(folded, pairs, eps)

    param = next(model.parameters())
    if example is None:
        side = int(getattr(model, "image_size", 0) or 32)
        g = torch.Generator().manual_seed(0)
        example = torch.rand((1, int(getattr(model, "in_channels", 1)),
                              side, side), generator=g)
    example = example.to(param.device, torch.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    modes = (model.training, folded.training)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = _logits(model.eval(), example)
        got = _logits(folded.eval(), example)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        model.train(modes[0])
        folded.train(modes[1])
    err = float((want - got).abs().max())
    tol = atol + rtol * float(want.abs().max())
    if not err <= tol:  # NaN fails too
        raise ValueError(
            f"BatchNorm folding changed the model output (max abs err "
            f"{err:.3e} > tol {tol:.3e}); this model's BN layers do not "
            f"directly follow their convs (e.g. a Conv->ReLU->BN block) "
            f"and cannot be folded.")
    return folded
