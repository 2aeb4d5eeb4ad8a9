"""The serving computation and its bundles, ported from
``ddti_tpu/train/export.py``: ``serve_body`` and ``make_serve_fn`` (uint8
NHWC frames in, uint8 NHWC {0, 1} masks out, as in JAX, with ``tta``), and
the deployable artifacts.

The torch counterpart of JAX's StableHLO artifact is a ``torch.export``
``ExportedProgram`` written with ``torch.export.save`` (``.pt2``). Its
weights-as-arguments form, the production split JAX writes as
``<model>_serving_program.stablehlo`` + ``.npz``, is a program
``serve(variables, images) -> masks`` written as
``<model>_serving_program.pt2`` with a sibling ``.npz`` of the tensors it
takes, by name (``save_variables_npz``: bf16 tensors as raw bits under
JAX's ``::bf16`` marker). ``variables`` is a flat dict of tensors: the
model's ``state_dict`` (fed through ``torch.func.functional_call``) and,
in an int8 program, the ``quant/<path>/{wq,sw,sx}`` tables
(``train/quantize.py``), whose convs are ``ddti::conv_s8`` calls in the
graph. A TransUNet's attention is a ``ddti::flash_fwd`` call. The baked
form (``export_serving``, the Trainer's ``<model>_serving.pt2``) holds its
weights inside the program. A K-member ensemble (``export_serving_ensemble``)
takes each tensor stacked on a leading member axis and loops over the
members inside the program: probability mean, then threshold.

Loading (``load_serving_bundle``) needs no model code: it imports the
custom ops of ``ddti_tpu_torch.ops`` (building the kernels at first use on
the card) and runs the graph. A program is traced on one device type
(bf16 autocast is recorded for it) and runs there only: loading it for
another device type raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ddti_tpu_torch.eval.tta import tta_probs

PROGRAM_SUFFIX = "_serving_program.pt2"


def nhwc_logits(model: nn.Module, images: torch.Tensor, bf16: bool = False,
                apply_fn=None) -> torch.Tensor:
    """NHWC float images -> the model's NHWC float32 logits, under bf16
    autocast when ``bf16`` (parameters stay float32); a deep-supervision
    model's heads are dropped, its main logits returned. ``apply_fn``
    (NCHW -> output) replaces ``model``'s own call (``functional_call``
    with a program's weights, the int8 graph)."""
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=bf16):
        x = images.permute(0, 3, 1, 2)
        out = model(x) if apply_fn is None else apply_fn(x)
    if isinstance(out, tuple):
        out = out[0]
    return out.permute(0, 2, 3, 1).float()


def _as_compute(images: torch.Tensor, compute_dtype) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return images.to(compute_dtype) / 255.0
    return images


def serve_body(model: nn.Module, images: torch.Tensor,
               threshold: float = 0.5,
               compute_dtype: torch.dtype = torch.float32,
               tta: bool = False, apply_fn=None) -> torch.Tensor:
    """``images``: (B, S, S, C) uint8 in [0, 255] or float in [0, 1], on the
    model's device. Returns (B, S, S, out_channels) uint8 masks. With
    ``compute_dtype=torch.bfloat16`` the model runs under bf16 autocast:
    parameters and BatchNorm statistics stay float32, as in JAX. A
    deep-supervision model's heads are dropped inside each forward: its
    main logits decide. ``tta=True`` thresholds the mean probability of the
    4-way flip ensemble (``eval/tta.py``, four forwards). ``apply_fn`` as
    in ``nhwc_logits``."""
    images = _as_compute(images, compute_dtype)

    def fwd(x):
        return nhwc_logits(model, x, compute_dtype == torch.bfloat16,
                           apply_fn)

    probs = tta_probs(fwd, images) if tta else torch.sigmoid(fwd(images))
    return (probs > threshold).to(torch.uint8)


def make_serve_fn(model: nn.Module, threshold: float = 0.5,
                  compute_dtype: torch.dtype = torch.float32,
                  tta: bool = False):
    """Closed-over inference function -> uint8 masks, run in eval mode
    under ``torch.inference_mode``."""
    model.eval()

    @torch.inference_mode()
    def serve(images: torch.Tensor) -> torch.Tensor:
        return serve_body(model, images, threshold, compute_dtype, tta)

    return serve


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def cast_floating(tensors: dict, dtype) -> dict:
    """Floating tensors cast to ``dtype`` (JAX ``_cast_floating``): a
    serving bundle needs no float32 master copies."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tensors.items()}


class ServeProgram(nn.Module):
    """``forward(variables, images) -> masks``: the weights-as-arguments
    serving computation of ``model``. Floating bf16 weights (a bundle
    exported with ``weights_dtype`` bf16) are widened to float32 at entry,
    exactly, so they were rounded once, where JAX rounds them. With
    ``members`` > 0 every tensor carries a leading member axis: the
    members' probabilities are averaged, then thresholded."""

    def __init__(self, model: nn.Module, threshold: float = 0.5,
                 bf16: bool = False, tta: bool = False,
                 quantized: bool = False, members: int = 0,
                 model_type: str | None = None):
        super().__init__()
        self.model = model
        self.threshold = float(threshold)
        self.compute_dtype = torch.bfloat16 if bf16 else torch.float32
        self.tta = bool(tta)
        self.quantized = bool(quantized)
        self.members = int(members)
        self.model_type = model_type

    def _apply_fn(self, variables: dict):
        if self.quantized:
            from .quantize import quantized_apply

            return lambda x: quantized_apply(self.model, variables, x,
                                             model_type=self.model_type)
        from torch.func import functional_call

        return lambda x: functional_call(self.model, variables, (x,))

    def _probs(self, variables: dict, images: torch.Tensor) -> torch.Tensor:
        apply_fn = self._apply_fn(variables)
        bf16 = self.compute_dtype == torch.bfloat16

        def fwd(x):
            return nhwc_logits(self.model, x, bf16, apply_fn)

        return tta_probs(fwd, images) if self.tta else torch.sigmoid(
            fwd(images))

    def forward(self, variables: dict, images: torch.Tensor):
        variables = {k: v.float() if v.dtype == torch.bfloat16 else v
                     for k, v in variables.items()}
        images = _as_compute(images, self.compute_dtype)
        if self.members:
            probs = sum(self._probs({k: v[i] for k, v in variables.items()},
                                    images)
                        for i in range(self.members)) / self.members
        else:
            probs = self._probs(variables, images)
        return (probs > self.threshold).to(torch.uint8)


class _BakedProgram(nn.Module):
    def __init__(self, model: nn.Module, threshold: float, bf16: bool,
                 tta: bool):
        super().__init__()
        self.model = model
        self.threshold = float(threshold)
        self.compute_dtype = torch.bfloat16 if bf16 else torch.float32
        self.tta = bool(tta)

    def forward(self, images: torch.Tensor):
        return serve_body(self.model, images, self.threshold,
                          self.compute_dtype, self.tta)


def _device_of(variables: dict) -> torch.device:
    return next(iter(variables.values())).device


def _export(program: nn.Module, args: tuple):
    program.eval()
    with torch.no_grad():
        return torch.export.export(program, args, strict=False)


def export_program(model: nn.Module, variables: dict, batch: int,
                   size: int, in_channels: int = 1, threshold: float = 0.5,
                   input_dtype=torch.float32, *, tta: bool = False,
                   bf16: bool = False, quantized: bool = False,
                   members: int = 0, model_type: str | None = None):
    """THE weights-as-arguments export tail (JAX ``export_program``),
    shared by every program exporter (plain, ensemble, int8 in
    ``train/quantize.py``): ``serve(variables, images)`` traced for images
    of shape (batch, size, size, in_channels) and ``input_dtype`` on the
    device of ``variables``. Returns the ExportedProgram."""
    model.eval()
    prog = ServeProgram(model, threshold, bf16, tta, quantized, members,
                        model_type)
    images = torch.zeros((batch, size, size, in_channels), dtype=input_dtype,
                         device=_device_of(variables))
    return _export(prog, (variables, images))


def serving_variables(model: nn.Module, fold_bn: bool = False,
                      weights_dtype=None, model_type: str | None = None
                      ) -> dict:
    """The tensors a weights-as-arguments program takes: ``model``'s
    ``state_dict``, BatchNorm folded first where ``fold_bn``, floating
    tensors cast to ``weights_dtype`` where given."""
    if fold_bn:
        from .fold_bn import fold_batchnorm

        model = fold_batchnorm(model, model_type)
    variables = {k: v.detach() for k, v in model.state_dict().items()}
    if weights_dtype is not None:
        variables = cast_floating(variables, weights_dtype)
    return variables


def export_serving_program(model: nn.Module, batch: int, size: int,
                           in_channels: int = 1, threshold: float = 0.5,
                           fold_bn: bool = False, input_dtype=torch.float32,
                           weights_dtype=None, tta: bool = False,
                           bf16: bool = False,
                           model_type: str | None = None):
    """Weights-as-arguments export of ``model``'s current weights: returns
    ``(program, variables)``; ``save_bundle`` writes the pair."""
    variables = serving_variables(model, fold_bn, weights_dtype, model_type)
    return export_program(model, variables, batch, size, in_channels,
                          threshold, input_dtype, tta=tta, bf16=bf16,
                          model_type=model_type), variables


def export_serving_ensemble(model: nn.Module, members: list, batch: int,
                            size: int, in_channels: int = 1,
                            threshold: float = 0.5, fold_bn: bool = False,
                            input_dtype=torch.float32, weights_dtype=None,
                            tta: bool = False, bf16: bool = False,
                            model_type: str | None = None):
    """A K-member ensemble bundle: ``members`` are ``state_dict``s of
    ``model``'s architecture; each tensor is stacked on a leading member
    axis (JAX's vmapped tree). Returns ``(program, stacked variables)``."""
    import copy

    trees = []
    for sd in members:
        m = copy.deepcopy(model)
        m.load_state_dict(sd, strict=True)
        trees.append(serving_variables(m, fold_bn, weights_dtype,
                                       model_type))
    variables = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    return export_program(model, variables, batch, size, in_channels,
                          threshold, input_dtype, tta=tta, bf16=bf16,
                          members=len(trees), model_type=model_type
                          ), variables


def export_serving(model: nn.Module, batch: int, size: int,
                   in_channels: int = 1, threshold: float = 0.5,
                   fold_bn: bool = False, input_dtype=torch.float32,
                   tta: bool = False, bf16: bool = False,
                   model_type: str | None = None):
    """The baked-weights program: ``serve(images) -> masks`` with the
    weights held inside (self-contained, for small models). Returns the
    ExportedProgram."""
    if fold_bn:
        from .fold_bn import fold_batchnorm

        model = fold_batchnorm(model, model_type)
    model.eval()
    dev = next(model.parameters()).device
    images = torch.zeros((batch, size, size, in_channels), dtype=input_dtype,
                         device=dev)
    return _export(_BakedProgram(model, threshold, bf16, tta), (images,))


def save_serving(path: str, model: nn.Module, batch: int, size: int,
                 **kw) -> None:
    """Write ``export_serving``'s program to ``path``."""
    torch.export.save(export_serving(model, batch, size, **kw), path)


def weights_path_for(program_path: str) -> str:
    """The sibling ``.npz`` of a program: ``.pt2`` -> ``.npz``."""
    return os.path.splitext(program_path)[0] + ".npz"


def save_bundle(program_path: str, program, variables: dict) -> None:
    """Write a weights-as-arguments bundle: the program at
    ``program_path`` and its tensors beside it (``.npz``)."""
    from .checkpoint import save_variables_npz

    torch.export.save(program, program_path)
    save_variables_npz(weights_path_for(program_path), variables)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def program_inputs(program) -> tuple[dict | None, object]:
    """(variables template {name: fake tensor} or None for a baked
    program, the images' fake tensor) of an ExportedProgram."""
    from torch.export.graph_signature import InputKind
    from torch.utils._pytree import tree_unflatten

    nodes = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    vals = [nodes[s.arg.name].meta["val"]
            for s in program.graph_signature.input_specs
            if s.kind == InputKind.USER_INPUT]
    args, _ = tree_unflatten(vals, program.call_spec.in_spec)
    if len(args) == 1:
        return None, args[0]
    return args[0], args[1]


def _register_ops() -> None:
    """Import the port's custom ops so a loaded graph can call them."""
    import ddti_tpu_torch.ops.attention  # noqa: F401
    import ddti_tpu_torch.ops.conv_s8  # noqa: F401


def _matches(template: dict, variables: dict | None) -> bool:
    return (variables is not None and set(template) == set(variables)
            and all(tuple(t.shape) == tuple(variables[k].shape)
                    and t.dtype == variables[k].dtype
                    for k, t in template.items()))


def load_serving_bundle(program_path: str, weights_path: str | None = None,
                        shared_variables: dict | None = None,
                        device="cuda"):
    """Rehydrate a serving bundle (JAX ``load_serving_bundle``) into
    ``(fn, batch, size, in_dtype)``: ``fn(images[batch, size, size, C])``
    (numpy or torch; uint8 frames given to a float program are scaled to
    [0, 1]) returns the uint8 masks as a tensor on ``device`` (the card
    unless the caller passes "cpu"), no model code involved. A program
    runs on the device type it was exported on: its bf16 autocast region
    was recorded for that device, so another device type raises. A weights-as-arguments program reads ``weights_path``
    (default: the program's sibling ``.npz``) onto ``device``;
    ``shared_variables``, the ``fn.variables`` of a bundle loaded before,
    is used instead where its names, shapes and dtypes match this
    program's, so a multi-batch set holds one copy of the weights.
    ``fn.variables`` is None for a baked program."""
    from ddti_tpu_torch.core.device import resolve_device

    _register_ops()
    device = resolve_device(str(device))
    program = torch.export.load(program_path)
    template, image = program_inputs(program)
    if image.device.type != device.type:
        raise ValueError(
            f"{program_path} was exported on {image.device.type}, not "
            f"{device.type}: re-export it with --device {device.type} "
            f"(cli/export.py or cli/quantize.py)")
    module = program.module()
    in_dtype = image.dtype

    def as_input(images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        images = images.to(device)
        if images.dtype == torch.uint8 and in_dtype != torch.uint8:
            return images.to(in_dtype) / 255.0  # a float program's [0, 1]
        return images.to(in_dtype)

    if template is None:
        @torch.inference_mode()
        def fn(images):
            return module(as_input(images))

        fn.variables = None
    else:
        variables = (shared_variables if _matches(template, shared_variables)
                     else None)
        if variables is None:
            from .checkpoint import load_variables_npz

            loaded = load_variables_npz(weights_path
                                        or weights_path_for(program_path))
            if not _matches(template, loaded):
                raise ValueError(
                    f"{weights_path or weights_path_for(program_path)} does "
                    f"not hold the tensors {program_path} takes (names, "
                    f"shapes or dtypes differ)")
            variables = {k: v.to(device) for k, v in loaded.items()}

        @torch.inference_mode()
        def fn(images):
            return module(variables, as_input(images))

        fn.variables = variables
    return fn, int(image.shape[0]), int(image.shape[1]), in_dtype
