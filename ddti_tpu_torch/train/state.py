"""Train state and optimizer, ported from ``ddti_tpu/train/state.py``.

AdamW with the reference's effective settings (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-2 on every trainable parameter, as optax ``adamw``), its
learning rate set before every step from the per-epoch cosine warm
restarts of ``schedule.py``: step s trains at ``schedule(s //
steps_per_epoch)``, as the JAX package's optax schedule does. Ported with
it: ``--clip_grad_norm`` (global-norm clipping ahead of AdamW, the norm
over the trainable gradients alone), ``--freeze`` (the JAX package's
parameter-path prefixes, mapped onto the port's tensors through the key
rules of ``torch_interop.py``; frozen tensors leave the optimizer: no
update, no weight decay, no moments) with ``--freeze_bn_stats``, and the
``--ema_decay`` shadow and, under ``--qat``, the activation ranges
(``qstats``, ``qat.py``). Frozen tensors take no gradient (XLA drops
theirs as dead code) unless ``--nan_guard``'s check, which counts every
gradient as JAX's does, needs them. The whole state saves and restores
as one tree (``full_state_dict`` / ``load_full_state_dict``, the
counterpart of JAX's checkpointed pytree), AdamW's moments keyed by
parameter name. ``train/state.py:flat_fused`` is an XLA layout choice and
is not ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .schedule import cosine_warm_restarts
from .torch_interop import flax_key_from_torch


def make_optimizer(params, lr: float, weight_decay: float = 1e-2,
                   t_0: int = 20, t_mult: int = 2):
    """Returns (AdamW, schedule: epoch -> lr). On a CUDA device the AdamW
    is the one a CUDA graph can capture (``--fused_epoch``):
    ``capturable=True`` with PyTorch's single-kernel ``fused`` update, its
    learning rate a 0-d tensor on that device, which the step fills
    outside the graph, and its step counts there too; every CUDA run
    takes it, so a fused epoch and a stepwise one do the same
    arithmetic."""
    params = list(params)
    sched = cosine_warm_restarts(lr, t_0, t_mult)
    lr0, kw = sched(0), {}
    dev = params[0].device if params else torch.device("cpu")
    if dev.type == "cuda":
        lr0 = torch.tensor(lr0, dtype=torch.float32, device=dev)
        kw = dict(capturable=True, fused=True)
    opt = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay, **kw)
    return opt, sched


def parse_freeze(config) -> tuple:
    """The --freeze prefixes as a tuple (JAX ``parse_freeze``)."""
    return tuple(p.strip() for p in
                 str(getattr(config, "freeze", "") or "").split(",")
                 if p.strip())


def _freeze_match(path: str, prefixes: tuple) -> bool:
    """True when the '/'-joined JAX path ``path`` is frozen by a prefix: at
    path-segment boundaries only, and a final prefix segment ``encoders``
    also matches ``encoders_<digits>`` (JAX ``_freeze_match``)."""
    segs = path.split("/")
    for p in prefixes:
        psegs = p.split("/")
        if len(psegs) > len(segs):
            continue
        if psegs[:-1] != segs[:len(psegs) - 1]:
            continue
        last, seg = psegs[-1], segs[len(psegs) - 1]
        if seg == last or (seg.startswith(last + "_")
                           and seg[len(last) + 1:].isdigit()):
            return True
    return False


def jax_path(model_type: str, key: str) -> str:
    """A ``state_dict`` key -> its JAX parameter or statistic path without
    the collection (``encoders.0.0.weight`` -> ``encoders_0/conv1/kernel``),
    the names --freeze prefixes match."""
    return flax_key_from_torch(model_type, key).split("/", 1)[1]


def frozen_names(model_type: str, model: nn.Module, prefixes: tuple,
                 buffers: bool = False) -> list[str]:
    """The parameters (or with ``buffers`` the BatchNorm statistics) whose
    JAX path a prefix matches."""
    named = model.named_buffers() if buffers else model.named_parameters()
    return [k for k, _ in named
            if prefixes and _freeze_match(jax_path(model_type, k), prefixes)]


def describe_freeze(model_type: str, model: nn.Module,
                    prefixes: tuple) -> str:
    """'<frozen>/<total>' parameter elements, for the engine's log line."""
    frozen = set(frozen_names(model_type, model, prefixes))
    sizes = [(p.numel(), k in frozen) for k, p in model.named_parameters()]
    n_f = sum(s for s, f in sizes if f)
    return f"{n_f:,}/{sum(s for s, _ in sizes):,}"


class TrainState:
    """The model, its optimizer, the step count and the EMA shadow (JAX
    ``TrainState``, which is immutable; here the train step updates this
    one in place).

    ``freeze`` (prefixes) keeps the matched parameters out of the
    optimizer and, unless ``nan_guard`` (whose finiteness check counts
    every gradient), out of autograd; ``clip_norm`` > 0 clips the trainable gradients to that
    global L2 norm (optax ``clip_by_global_norm``); ``ema`` keeps a
    float32 shadow of every parameter, seeded with their values here.
    On a CUDA device the AdamW is capturable (``make_optimizer``): its
    learning rate is filled at each step taken outside a capture, so a
    graph replays the rate of the epoch its eager step set."""

    def __init__(self, model: nn.Module, lr: float, steps_per_epoch: int,
                 weight_decay: float = 1e-2, *, model_type: str = "",
                 freeze: tuple = (), clip_norm: float = 0.0,
                 ema: bool = False, nan_guard: bool = False):
        self.model = model
        self.model_type = model_type
        frozen = set(frozen_names(model_type, model, freeze))
        if freeze and not frozen:
            raise ValueError(
                f"--freeze {','.join(freeze)} matched no parameters; "
                "prefixes are '/'-joined module paths like 'encoders' or "
                "'encoders_0/conv1'")
        self.frozen = frozen
        for k, p in model.named_parameters():
            p.requires_grad_(nan_guard or k not in frozen)
        # the BatchNorm statistics --freeze_bn_stats pins
        self.frozen_buffers = frozen_names(model_type, model, freeze,
                                           buffers=True)
        self.trainable = [p for k, p in model.named_parameters()
                          if k not in frozen]
        self.optimizer, self.schedule = make_optimizer(
            self.trainable, lr, weight_decay)
        self.capturable = bool(
            self.optimizer.defaults.get("capturable", False))
        self.clip_norm = float(clip_norm or 0.0)
        self.steps_per_epoch = steps_per_epoch
        self.step = 0
        self.ema = ({k: p.detach().clone()
                     for k, p in model.named_parameters()} if ema else None)
        # --qat: {flax path: float32 0-d amax EMA} (qat.init_qstats)
        self.qstats = None

    def clip_gradients(self) -> None:
        """optax ``clip_by_global_norm`` on the trainable gradients: where
        their global norm g reaches ``clip_norm``, each becomes
        grad / g * clip_norm (a device-side select, no host read)."""
        grads = [p.grad for p in self.trainable if p.grad is not None]
        if self.clip_norm <= 0 or not grads:
            return
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at this step's
        scheduled learning rate (after clipping); advances the step. Under
        a CUDA graph capture the capturable optimizer's rate stays what
        the last eager step filled in."""
        self.clip_gradients()
        lr = self.schedule(self.step // self.steps_per_epoch)
        for group in self.optimizer.param_groups:
            if not self.capturable:
                group["lr"] = lr
            elif not torch.cuda.is_current_stream_capturing():
                group["lr"].fill_(lr)
        self.optimizer.step()
        self.step += 1

    def init_optimizer_state(self) -> None:
        """AdamW's state of every trainable parameter made now, as its
        first ``step()`` would make it (zero moments, step 0), so that a
        step can snapshot and restore the whole state on the device
        (``--nan_guard`` under ``--fused_epoch``)."""
        for p in self.trainable:
            if self.optimizer.state.get(p):
                continue
            self.optimizer.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if self.capturable
                                    else "cpu"),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}

    def state_tensors(self) -> list:
        """Every tensor a step changes: the trainable parameters, the
        BatchNorm statistics, AdamW's state and the EMA shadow."""
        out = list(self.trainable) + list(self.model.buffers())
        for p in self.trainable:
            out += list(self.optimizer.state.get(p, {}).values())
        if self.ema is not None:
            out += list(self.ema.values())
        if self.qstats is not None:
            out += list(self.qstats.values())
        return out

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        """ema <- decay * ema + (1 - decay) * params (no-op without EMA),
        with JAX's float32 ``d`` and ``1 - d``. A frozen parameter's
        shadow stays its value: JAX's shadow of that constant wanders by
        float32 rounding, a few ulps a step."""
        if self.ema is None:
            return
        d = np.float32(decay)
        names = [k for k, _ in self.model.named_parameters()
                 if k not in self.frozen]
        live = dict(self.model.named_parameters())
        ema = [self.ema[k] for k in names]
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, [live[k].detach() for k in names],
                            alpha=float(np.float32(1) - d))

    def eval_state_dict(self) -> dict:
        """``state_dict`` with the eval weights, what best/last save: the
        EMA shadow's parameters under --ema_decay with the live BatchNorm
        statistics (JAX ``_eval_weights``), else the live model's."""
        sd = self.model.state_dict()
        if self.ema is not None:
            sd.update({k: v.detach() for k, v in self.ema.items()})
        return sd

    def _trainable_names(self) -> list[str]:
        return [k for k, _ in self.model.named_parameters()
                if k not in self.frozen]

    def full_state_dict(self) -> dict:
        """The whole train state (JAX ``checkpoint._tree_dict``): ``model``
        (parameters and BatchNorm statistics), ``adam`` (AdamW's state of
        each trainable parameter keyed by its name: ``exp_avg``,
        ``exp_avg_sq`` and its ``step``; empty before its first update),
        ``step``, under --ema_decay ``ema`` and under --qat ``qstats``. The
        tensors are the live ones: a caller that lets training go on
        copies them first."""
        params = dict(self.model.named_parameters())
        out = {"model": self.model.state_dict(), "step": int(self.step),
               "adam": {k: dict(self.optimizer.state.get(params[k], {}))
                        for k in self._trainable_names()}}
        if self.ema is not None:
            out["ema"] = {k: v.detach() for k, v in self.ema.items()}
        if self.qstats is not None:
            out["qstats"] = {k: v.detach() for k, v in self.qstats.items()}
        return out

    @torch.no_grad()
    def load_full_state_dict(self, full: dict) -> None:
        """Restore ``full_state_dict()``'s tree into this state, checked
        whole before anything changes (JAX ``restore_checkpoint``).
        AdamW's moments go to the parameters of the same name: a checkpoint
        whose trainable names or shapes differ from this state's (another
        --freeze) raises ValueError. A checkpoint without a shadow seeds
        this state's EMA from the restored parameters; with EMA off a saved
        shadow is dropped (JAX ``_merge_restored_ema``). QAT ranges are
        restored where both sides track the conv, new paths stay
        unobserved, and with --qat off saved ranges are dropped (JAX
        ``_merge_restored_qstats``)."""
        _check_like(full["model"], self.model.state_dict(), "model tensor")
        params = dict(self.model.named_parameters())
        names = self._trainable_names()
        saved = full["adam"]
        if set(saved) != set(names):
            only_ck = sorted(set(saved) - set(names))
            only_run = sorted(set(names) - set(saved))
            raise ValueError(
                f"the optimizer's parameters differ: {len(only_ck)} only in "
                f"the checkpoint {only_ck[:3]}, {len(only_run)} only in this "
                f"run {only_run[:3]}")
        for k in names:
            _check_like({m: v for m, v in saved[k].items() if m != "step"},
                        {m: params[k] for m in saved[k] if m != "step"},
                        f"AdamW state of {k}")
        ema = None
        if self.ema is not None:
            ema = full.get("ema") or {k: full["model"][k] for k in self.ema}
            _check_like(ema, self.ema, "EMA tensor")
        self.model.load_state_dict(full["model"], strict=True)
        for k in names:
            p = params[k]
            # the step goes where AdamW keeps it (a CPU scalar, on the
            # device for the capturable AdamW), the moments to the
            # parameter's device and dtype
            step_dev = p.device if self.capturable else "cpu"
            self.optimizer.state[p] = {
                m: (v.to(device=step_dev, copy=True) if m == "step"
                    else v.to(device=p.device, dtype=p.dtype, copy=True))
                for m, v in saved[k].items()}
        self.step = int(full["step"])
        if ema is not None:
            for k, v in self.ema.items():
                v.copy_(ema[k])
        saved_q = full.get("qstats") or {}
        for k, v in (self.qstats or {}).items():
            if k in saved_q:
                v.copy_(saved_q[k])


def _check_like(saved: dict, live: dict, what: str) -> None:
    """ValueError unless ``saved`` has ``live``'s keys and shapes."""
    if set(saved) != set(live):
        diff = sorted(set(saved) ^ set(live))
        raise ValueError(f"{what}s differ: {len(diff)} keys in one side "
                         f"only, e.g. {diff[:3]}")
    for k, v in live.items():
        if tuple(saved[k].shape) != tuple(v.shape):
            raise ValueError(f"{what} {k}: shape {tuple(saved[k].shape)} "
                             f"in the checkpoint, {tuple(v.shape)} here")


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
