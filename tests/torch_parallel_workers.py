"""Rank bodies of the port's data-parallel tests (``test_torch_parallel``,
``test_torch_multihost``), in a module of their own: the spawned ranks
import it by name, and it imports neither JAX nor the tests' JAX side.

Every body takes the rank's ``Mesh`` first (``parallel.launch_local``) and
writes what the test compares into files under a directory the test owns;
the inputs come from files the test wrote (``torch.save``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.data.augment import AugmentConfig, shard_draws
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.parallel.mesh import local_rows
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_eval_step, make_train_step

SMALL = dict(in_channels=1, out_channels=1, base_filters=8, depth=3)
SIZE, BATCH, SGD_LR = 32, 16, 1e-2
LAUNCH_S = 120  # a spawning test's bound


def bounded(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` cut at LAUNCH_S: SIGALRM raises in this
    (the main) thread, and ``launch_local``'s cleanup then ends its
    ranks."""
    import signal

    def expire(signum, frame):
        raise TimeoutError(f"{fn.__name__} ran past {LAUNCH_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LAUNCH_S)
    try:
        return fn(*args, **kwargs)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def port_model(state_dict, model_type="UNet"):
    m = create_model(model_type, **SMALL)
    m.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in state_dict.items()}, strict=True)
    return m


def port_config(**kw) -> Config:
    return Config(batch_size=BATCH, image_size=SIZE, store_size=SIZE,
                  lr=SGD_LR, model_type="UNet", **kw)


def sgd_state(model, cfg) -> TrainState:
    """A TrainState whose update is plain SGD at ``SGD_LR`` (the JAX
    tests' optax.sgd(1e-2): the parameter delta is the gradient)."""
    state = TrainState(model, cfg.lr, 10, 0.0, model_type="UNet")
    state.optimizer = torch.optim.SGD(state.trainable, lr=SGD_LR)
    state.capturable = False  # its rate is a float, filled every step
    return state


def run_step(case: dict, mesh=None) -> dict:
    """One train step of ``case`` (the weights, the uint8 global batch,
    the chain's and mixup's draws, the config's options) on the whole
    batch, or under ``mesh`` on this rank's rows; returns the metrics, the
    averaged gradients, the parameters and BatchNorm statistics after the
    SGD update and the QAT ranges."""
    cfg = port_config(**case["config"])
    model = port_model(case["weights"])
    blocks.set_bn_exact_variance(model, bool(cfg.bn_exact_variance))
    blocks.set_bn_mesh(model, mesh)
    state = sgd_state(model, cfg)
    if cfg.qat:
        from ddti_tpu_torch.train.qat import init_qstats

        state.qstats = init_qstats(model, (1, 1, SIZE, SIZE), 0, "UNet")
    images, masks = (torch.as_tensor(case[k]) for k in ("images", "masks"))
    draws, mix = case["draws"], case["mix"]
    if mesh is not None:
        keep, draws, mix = shard_draws(draws, mix, local_rows(
            images.shape[0], mesh, cfg.grad_accum))
        images, masks = images[keep], masks[keep]
    step = make_train_step(cfg, AugmentConfig(out_size=(SIZE, SIZE)),
                           mesh=mesh)
    m = step(state, images, masks, draws, mix)
    return {
        "terms": [float(getattr(m, k)) for k in ("loss", "bce", "dice",
                                                 "focal", "boundary")],
        "counts": [float(c) for c in m.counts], "n": float(m.n),
        "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "state": {k: v.clone() for k, v in model.state_dict().items()},
        "qstats": ({k: float(v) for k, v in state.qstats.items()}
                   if state.qstats else None)}


def run_eval(case: dict, mesh=None) -> dict:
    """The eval step's metrics on the global batch with its padding mask
    ``valid``, or under ``mesh`` on this rank's rows of both."""
    cfg = port_config()
    model = port_model(case["weights"])
    state = sgd_state(model, cfg)
    images, masks, valid = (torch.as_tensor(case[k])
                            for k in ("images", "masks", "valid"))
    if mesh is not None:
        rows = local_rows(images.shape[0], mesh)
        images, masks, valid = images[rows], masks[rows], valid[rows]
    m = make_eval_step(cfg, mesh=mesh)(state, images, masks, valid)
    return {"terms": [float(getattr(m, k)) for k in ("loss", "bce", "dice",
                                                     "focal", "boundary")],
            "counts": [float(c) for c in m.counts], "n": float(m.n)}


def steps_worker(mesh, in_path: str, out_dir: str) -> int:
    """Every case of ``in_path`` on this rank; ``out_dir/rank<r>.pt``."""
    cases = torch.load(in_path, weights_only=False)
    out = {}
    for name, case in cases.items():
        run = {"eval": run_eval, "grads64": run_grads64}.get(
            case.get("kind"), run_step)
        out[name] = run(case, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    return 0


def run_grads64(case: dict, mesh=None) -> dict:
    """The gradients of one batch's weighted loss with the network in
    float64 (the augmented, mixed batch in float32 as the step makes it,
    then widened; the loss terms reduce in float32, as ever), on the whole
    batch or under ``mesh`` on this rank's rows, averaged over the ranks.
    In float64 no ReLU, max-pool or rounding kink flips between the two
    summation orders, so the data-parallel arithmetic itself is held."""
    from ddti_tpu_torch.data.augment import augment_batch, mixup
    from ddti_tpu_torch.losses.losses import weighted_loss
    from ddti_tpu_torch.parallel.mesh import mean_gradients_

    cfg = port_config(**case["config"])
    model = port_model(case["weights"]).double().train()
    blocks.set_bn_exact_variance(model, bool(cfg.bn_exact_variance))
    blocks.set_bn_mesh(model, mesh)
    images, masks = (torch.as_tensor(case[k]).to(torch.float32) / 255.0
                     for k in ("images", "masks"))
    draws, mix = case["draws"], case["mix"]
    if mesh is not None:
        keep, draws, mix = shard_draws(draws, mix, local_rows(
            images.shape[0], mesh))
        images, masks = images[keep], masks[keep]
    x, y = augment_batch(images, masks, draws,
                         AugmentConfig(out_size=(SIZE, SIZE)))
    if mix is not None:
        x, y = mixup(x, y, mix)
    logits = model(x.double().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    weighted_loss(logits, y, bce_ratio=cfg.bce_ratio,
                  dice_ratio=cfg.dice_ratio, focal_ratio=cfg.focal_ratio,
                  boundary_ratio=cfg.boundary_ratio, mesh=mesh
                  ).total.backward()
    mean_gradients_(model.parameters(), mesh)
    return {"grads": {k: p.grad.clone()
                      for k, p in model.named_parameters()}}


def multihost_main(kind: str, run_dir: str) -> int:
    """One process of a two-process run joined through the multi-host
    path (``initialize_multihost(spec_from())``: the JAX environment
    variables the test sets), gloo on the CPU. ``kind`` "reduce": each
    process holds its rows of a global batch and a global sum is taken;
    "epoch": the Trainer's epoch, validation and test (JAX's
    ``test_two_process_trainer_epoch``), its val IoU checked against an
    exact host oracle over the 6 unique val images; "preempt": train()
    with a SIGTERM to rank 1 alone."""
    import torch.distributed as dist

    from ddti_tpu_torch.core.logging import create_logger
    from ddti_tpu_torch.data.dataset import DeviceDataSource
    from ddti_tpu_torch.data.synthetic import generate_ddti_like
    from ddti_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
        process_local_batch,
        spec_from,
    )
    from ddti_tpu_torch.parallel.mesh import all_reduce_
    from ddti_tpu_torch.train.engine import Trainer
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    assert initialize_multihost(spec_from(), device="cpu")
    mesh = make_mesh(device="cpu", multihost=True)
    assert (mesh.world, mesh.multihost) == (2, True)
    rank = mesh.rank
    if kind == "reduce":
        glob = np.concatenate([np.full((4, 8), 1.0, np.float32),
                               np.full((4, 8), 2.0, np.float32)])
        local = torch.from_numpy(process_local_batch(glob, mesh))
        assert float(local[0, 0]) == rank + 1
        total = local.sum().reshape(1)
        all_reduce_([total], mesh)
        print(f"RANK{rank} SUM {float(total[0])}", flush=True)
        dist.destroy_process_group()
        return 0
    cfg = Config(epochs=2, batch_size=8, image_size=SIZE, store_size=SIZE,
                 lr=1e-3, model_type="UNet",
                 base_dir=os.path.join(run_dir, f"run{rank}"))
    cfg.make_dirs()
    logger = create_logger(os.path.join(cfg.log_dir, "log.log"))
    # val split of 6 at batch 8: the single val batch carries 2
    # wraparound-padded duplicates, weighted out over the global indices
    srcs = tuple(DeviceDataSource(*generate_ddti_like(n, (SIZE, SIZE), s),
                                  device="cpu")
                 for n, s in ((16, 0), (6, 1), (8, 2)))
    model = init_like_flax(create_model("UNet", **SMALL), 0)
    tr = Trainer(cfg, srcs, logger, model, mesh=mesh)
    if kind == "preempt":
        # rank 1 alone takes a SIGTERM during epoch 2's first step: every
        # rank stops after that step, rank 0 saves the last state
        import signal

        step_on = tr._train_on

        def train_on(epoch, i, *args, **kw):
            out = step_on(epoch, i, *args, **kw)
            if rank == 1 and (epoch, i) == (1, 0):
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        tr._train_on = train_on
        tr.train()
        last = os.path.join(cfg.model_dir, "UNet_last")
        print(f"RANK{rank} PREEMPTED {tr.preempted} STEP {tr.state.step} "
              f"SAVED {os.path.isdir(last)}", flush=True)
        dist.destroy_process_group()
        return 0
    tr.train_one_epoch(0)
    _, iou = tr.validate(0)
    # exact-IoU oracle: the final weights, a host forward over the 6
    # unique val images (the epoch IoU's bool convention)
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(srcs[1].images.cpu().numpy()).float() / 255.0
        logits = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    pred = torch.sigmoid(logits).numpy() > 0.5
    gt = srcs[1].masks.cpu().numpy() / 255.0 > 0
    expect = np.logical_and(pred, gt).sum() / max(
        np.logical_or(pred, gt).sum(), 1e-8)
    assert abs(iou - expect) < 1e-5, (iou, expect)
    m = tr.test(visualize=True)
    print(f"RANK{rank} IOU {iou:.9f} TEST {m['iou']:.9f} "
          f"TN {m['tn']:.0f}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(multihost_main(*sys.argv[1:3]))
