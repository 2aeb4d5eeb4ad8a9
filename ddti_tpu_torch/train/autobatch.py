"""Automatic batch-size selection, ported from
``ddti_tpu/train/autobatch.py``: ``--batch_size auto``.

The JAX package reads each candidate's peak from XLA's compile-time memory
plan. Torch has no such plan, so the port measures it: one real train step
at the candidate batch, of zero batches, on a throwaway copy of the model
and a fresh optimizer state (the run's --freeze, EMA and clipping, and its
teacher under distillation), with ``torch.cuda.max_memory_allocated``
read after ``reset_peak_memory_stats``. The candidates, the 0.92 safety
share, the --grad_accum filter and the stop rule are JAX's: the largest
candidate whose peak fits ``safety`` of the card's budget, probing
upwards and stopping at the first that does not fit. A step's peak is
affine in its batch (the state, plus activations per image), so once two
candidates are measured the next one's peak is extrapolated first, and a
candidate extrapolated over the budget stops the probe without running
(a step that would only fill the card to fail). A
``torch.cuda.OutOfMemoryError`` after a fitting candidate is "over budget"; on
the first it is a real error. The CPU has no peak meter, so there
``--batch_size auto`` raises (a documented divergence: README, ROADMAP).
On a ``model`` axis a rank's step runs on its band of every frame, so the
probe is that step itself: the ranks of the mesh measure it together, a
candidate's peak the largest of theirs.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
from typing import Callable, Optional, Sequence

import torch

DEFAULT_CANDIDATES = (8, 16, 32, 64, 128, 256, 512)


def _cuda_device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise RuntimeError(
            "--batch_size auto measures a train step's peak memory on a "
            "CUDA card; the CPU has no peak meter, so pass an explicit "
            "--batch_size there")
    return dev


def device_budget_bytes(device=None) -> int:
    """The bytes this process may use on the card: what is free now plus
    what its own caching allocator already holds (other processes' memory
    is not ours to count)."""
    dev = _cuda_device(device)
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev))


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def measured_step_peak_bytes(config, model, batch: int,
                             host_augment: bool = False,
                             teacher=None, mesh=None) -> int:
    """Peak bytes of one train step at ``batch``: the step the run will
    take (uint8 store frames at ``store_size``, or with ``host_augment``
    float32 frames at ``image_size``), on a copy of ``model`` with a fresh
    optimizer state. ``model`` itself is not counted, so the state counts
    once, as in JAX's estimate; ``teacher``'s weights and activations
    count. Under ``--fused_epoch`` the step is also captured as the run
    captures it, and the peak is the larger of the eager step's and what
    the probe holds plus the memory the graph's private pool reserves,
    which is more than the step's own peak. On a ``mesh`` with a
    ``model`` axis it is a rank's step, ``batch`` its data group's whole
    frames and the network on its band of them, run with the mesh's
    collectives on every rank at once."""
    from ddti_tpu_torch.data.augment import (
        dense_draws,
        sample_draws,
        sample_mixup,
    )

    from ddti_tpu_torch.models.blocks import set_bn_mesh
    from ddti_tpu_torch.parallel.spatial import set_spatial_mesh

    from .engine import aug_config_from
    from .state import TrainState, parse_freeze
    from .steps import make_host_train_step, make_train_step

    dev = _cuda_device(next(model.parameters()).device)
    cfg = dataclasses.replace(config, batch_size=batch)
    probe = copy.deepcopy(model)
    if mesh is not None:
        set_bn_mesh(probe, mesh)
        set_spatial_mesh(probe, mesh)
    state = TrainState(
        probe, cfg.lr, 100, cfg.weight_decay,
        model_type=cfg.model_type, freeze=parse_freeze(cfg),
        clip_norm=float(getattr(cfg, "clip_grad_norm", 0.0) or 0.0),
        ema=float(getattr(cfg, "ema_decay", 0.0) or 0.0) > 0,
        nan_guard=bool(getattr(cfg, "nan_guard", False)))
    # --fused_epoch (a device store's) captures the step; its nan_guard
    # keeps a snapshot of the state on the card
    fused = not host_augment and bool(getattr(cfg, "fused_epoch", False))
    guard = fused and bool(getattr(cfg, "nan_guard", False))
    if guard:
        state.init_optimizer_state()
    in_ch = getattr(model, "in_channels", 1)
    aug = aug_config_from(cfg)
    g = torch.Generator().manual_seed(0)
    if host_augment:
        side, dt = cfg.image_size, torch.float32
    else:
        side, dt = cfg.store_size, torch.uint8
    images = torch.zeros((batch, side, side, in_ch), dtype=dt, device=dev)
    masks = torch.zeros((batch, side, side, 1), dtype=dt, device=dev)
    mix = (sample_mixup(g, batch, cfg.mixup_alpha, cfg.mixup_prob).to(dev)
           if cfg.use_mixup else None)
    own = _tensor_bytes(list(model.parameters()) + list(model.buffers()))
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if host_augment:
            make_host_train_step(cfg, teacher, mesh)(state, images, masks,
                                                     mix)
        else:
            draws = sample_draws(g, batch, aug, (side, side),
                                 torch.Generator(device=dev).manual_seed(0))
            if fused:
                draws = dense_draws(draws.to(dev), batch)
            step = make_train_step(cfg, aug, teacher=teacher,
                                   device_guard=guard, mesh=mesh)
            step(state, images, masks, draws.to(dev), mix)
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev)) - own
        if fused:
            torch.cuda.empty_cache()
            held = int(torch.cuda.memory_allocated(dev)) - own
            before = int(torch.cuda.memory_reserved(dev))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode=(
                    "thread_local" if mesh is not None else "global")):
                step(state, images, masks, draws, mix)
            pool = int(torch.cuda.memory_reserved(dev)) - before
            del graph
            peak = max(peak, held + pool)
        return peak
    finally:
        del state, images, masks
        gc.collect()
        torch.cuda.empty_cache()


def pick_batch_size(config, model, *,
                    candidates: Sequence[int] = DEFAULT_CANDIDATES,
                    budget_bytes: Optional[int] = None,
                    safety: float = 0.92,
                    data_parallel: int = 1,
                    host_augment: bool = False,
                    logger=None,
                    peak_fn: Optional[Callable] = None,
                    mesh=None) -> int:
    """The largest candidate whose measured step peak fits ``safety`` of
    the budget (JAX ``pick_batch_size``). Candidates are PER-DEVICE
    batches, probed ascending; the return value is the GLOBAL batch, the
    pick times ``data_parallel`` (each rank of a mesh holds the whole
    state and its share of the batch, so one device's step is the right
    proxy). ``peak_fn(config, model, batch, host_augment=...)``
    replaces the measurement (the tests' fake peaks); by default a real
    step on the card (``measured_step_peak_bytes``, with the run's teacher
    built from the config, random weights: its memory is what counts).
    ``mesh`` (one with a ``model`` axis, on every rank at once) makes it a
    rank's step at its band, each peak the ranks' largest, so that every
    rank takes the same decisions."""
    grad_accum = max(int(getattr(config, "grad_accum", 1) or 1), 1)
    usable = [b for b in sorted(set(candidates)) if b % grad_accum == 0]
    if not usable:
        raise ValueError(
            f"no batch-size candidate in {sorted(set(candidates))} is "
            f"divisible by --grad_accum {grad_accum}")
    if peak_fn is None:
        from .distill import teacher_from_config

        dev = next(model.parameters()).device
        teacher = teacher_from_config(config, dev, load=False)

        if mesh is not None and teacher is not None:
            from ddti_tpu_torch.parallel.spatial import set_spatial_mesh

            set_spatial_mesh(teacher, mesh)

        def peak_fn(cfg, m, b, host_augment=False):
            from ddti_tpu_torch.parallel.mesh import host_reduce

            return int(host_reduce(measured_step_peak_bytes(
                cfg, m, b, host_augment, teacher, mesh), mesh, "max"))
    budget = budget_bytes if budget_bytes is not None else (
        device_budget_bytes(next(model.parameters()).device))
    cap = int(budget * safety)
    best = None
    measured = []  # (batch, peak) of the candidates run
    for b in usable:
        if len(measured) >= 2:
            (b1, p1), (b2, p2) = measured[-2:]
            guess = p2 + (p2 - p1) * (b - b2) / (b2 - b1)
            if guess > cap:
                if logger is not None:
                    logger.info(
                        f"[autobatch] batch {b}/device: "
                        f"{guess / 2**30:.2f} GiB extrapolated from the "
                        f"measured peaks, over the budget "
                        f"{cap / 2**30:.2f} GiB (not run)")
                break
        refused = None
        try:
            peak = peak_fn(config, model, b, host_augment=host_augment)
        except torch.cuda.OutOfMemoryError as e:
            # the card refused the step: over budget once a smaller
            # candidate fitted; on the first candidate a real error
            if best is None:
                raise
            refused = str(e).splitlines()[0]
        if refused is not None:
            # the failed step's tensors died with its traceback
            gc.collect()
            torch.cuda.empty_cache()
            if logger is not None:
                logger.info(f"[autobatch] batch {b}/device: out of memory "
                            f"(over budget): {refused}")
            break
        fits = peak <= cap
        if logger is not None:
            logger.info(
                f"[autobatch] batch {b}/device: measured peak "
                f"{peak / 2**30:.2f} GiB vs budget {cap / 2**30:.2f} GiB "
                f"({'fits' if fits else 'over'}; {peak} B, cap {cap} B)")
        if not fits:
            break
        best = b
        measured.append((b, peak))
    if best is None:
        raise MemoryError(
            f"smallest candidate batch {usable[0]} is measured to exceed "
            f"{cap / 2**30:.2f} GiB on this device; lower the resolution, "
            f"enable --grad_accum, or pass an explicit --batch_size")
    return best * max(int(data_parallel), 1)
