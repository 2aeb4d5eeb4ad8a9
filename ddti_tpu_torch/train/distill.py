"""Knowledge distillation, ported from ``ddti_tpu/train/distill.py``: a
small student trained under a frozen teacher.

The teacher (any checkpoint the port reads, ``.npz``, ``.pth`` or a
full-state directory, of any model ``create_model`` builds) runs an
eval-mode forward under ``torch.no_grad()`` on every augmented training
batch, inside the train step (per microbatch under ``--grad_accum``), in
bf16 autocast when the run uses ``--use_amp_autocast``, the JAX teacher's
dtype. The student's loss is ``(1 - w) * total + w * kd_bce`` (``w``
``--distill_weight``): the ground-truth composite blended with a
temperature-softened BCE against the teacher's per-pixel probabilities.
A comma list of checkpoints of one architecture is an ensemble teacher,
the target the mean of the members' tempered probabilities. Orbax
directories are refused, as everywhere in the port (ROADMAP.md).

    python -m ddti_tpu_torch.cli.main --model_type UNet --base_filters 32 \\
        --depth 4 --distill_checkpoint runs/ResUNet_best.npz \\
        --distill_model_type ResUNet --distill_base_filters 64 \\
        --distill_depth 5 --distill_weight 0.5 --distill_temperature 2
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F
from torch import nn


def kd_bce(student_logits: torch.Tensor, soft: torch.Tensor,
           temperature: float) -> torch.Tensor:
    """Temperature-scaled BCE of the student's logits against soft
    targets, in the softplus form (its gradient is exactly ``T *
    (sigmoid(s / T) - soft)``), times T^2 so the gradient's size does not
    depend on T (JAX ``kd_bce``)."""
    sl = student_logits.to(torch.float32) / temperature
    bce = soft * F.softplus(-sl) + (1.0 - soft) * F.softplus(sl)
    return (temperature * temperature) * bce.mean()


class Teacher(nn.Module):
    """One frozen eval-mode model, or the members of an ensemble (one
    architecture, several checkpoints); ``amp`` runs their forwards in
    bf16 autocast."""

    def __init__(self, members, amp: bool):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.amp = bool(amp)
        self.eval().requires_grad_(False)

    def train(self, mode: bool = True):
        return super().train(False)  # a teacher never leaves eval mode

    @torch.no_grad()
    def logits(self, images: torch.Tensor) -> list[torch.Tensor]:
        """NHWC images -> each member's NHWC main logits."""
        x = images.permute(0, 3, 1, 2)
        out = []
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            for m in self.members:
                y = m(x)
                y = y[0] if isinstance(y, tuple) else y
                out.append(y.permute(0, 2, 3, 1))
        return out


@torch.no_grad()
def soft_targets(teacher: Teacher, images: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """The teacher's tempered per-pixel probabilities of NHWC ``images``,
    float32; an ensemble's are the mean of its members' (JAX
    ``soft_targets``)."""
    probs = [torch.sigmoid(y.to(torch.float32) / temperature)
             for y in teacher.logits(images)]
    return probs[0] if len(probs) == 1 else torch.stack(probs).mean(dim=0)


def teacher_kwargs(config) -> tuple[str, dict]:
    """(model type, create_model kwargs) of the teacher: the student's
    architecture unless --distill_model_type / --distill_base_filters /
    --distill_depth override it, plus --distill_kwargs' JSON (JAX
    ``teacher_from_config``'s rules)."""
    mtype = (getattr(config, "distill_model_type", "") or ""
             ) or config.model_type
    kw = dict(
        in_channels=1, out_channels=1,
        base_filters=(int(getattr(config, "distill_base_filters", 0) or 0)
                      or int(config.model_kwargs.get("base_filters", 64))),
        depth=(int(getattr(config, "distill_depth", 0) or 0)
               or int(config.model_kwargs.get("depth", 5))))
    if mtype == "TransUNet":
        kw["image_size"] = config.image_size
    extra = getattr(config, "distill_kwargs", "") or ""
    if extra:
        # behaviour-only kwargs (num_heads, ...) leave the parameter shapes
        # alone: a mismatch would load and compute the wrong teacher
        kw.update(json.loads(extra))
    return mtype, kw


def teacher_from_config(config, device="cpu", load: bool = True):
    """The ``Teacher`` of ``config.distill_checkpoint`` on ``device``, or
    None when distillation is off. ``load=False`` keeps the members'
    random initial weights and reads no checkpoint (``--batch_size
    auto``'s probe, which needs the teacher's memory, not its values)."""
    from ddti_tpu_torch.models import create_model

    from .checkpoint import load_checkpoint_into

    paths = [p for p in (getattr(config, "distill_checkpoint", "") or ""
                         ).split(",") if p]
    if not paths:
        return None
    mtype, kw = teacher_kwargs(config)
    members = []
    for p in paths:
        m = create_model(mtype, **kw)
        if load:
            load_checkpoint_into(p, mtype, m)
        members.append(m)
    amp = bool(getattr(config, "use_amp_autocast", True))
    return Teacher(members, amp).to(device)


def describe_teacher(config, teacher: Teacher) -> str:
    """The Trainer's log line (JAX's wording; an ensemble counts every
    member's parameters)."""
    n = sum(p.numel() for p in teacher.parameters())
    return (f"Distilling from {config.distill_checkpoint} ({n / 1e6:.2f}M-"
            f"param teacher, weight={getattr(config, 'distill_weight', 0.5)}"
            f", T={getattr(config, 'distill_temperature', 2.0)})")
