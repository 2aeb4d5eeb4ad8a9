"""Rank bodies of the port's spatial-axis tests (``test_torch_spatial``),
in a module of their own: the spawned ranks import it by name, and it
imports neither JAX nor the tests' JAX side.

Every body takes the rank's ``Mesh`` first (``parallel.launch_local``)
and returns what the test compares; ``spatial_worker`` runs every case of
a file the test wrote (``torch.save``) and writes each rank's results
beside it. The same bodies with ``mesh=None`` are the single-device
references.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.data.augment import (
    AugmentConfig,
    augment_batch,
    mixup,
    shard_draws,
)
from ddti_tpu_torch.losses.losses import weighted_loss
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.parallel.mesh import local_rows, mean_gradients_
from ddti_tpu_torch.parallel.spatial import (
    band,
    flip,
    gather_band,
    halo,
    set_spatial_mesh,
)
from ddti_tpu_torch.train.distill import Teacher
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import (
    _ds_aux_loss,
    make_host_train_step,
    make_train_step,
)

SGD_LR = 1e-2
# the convs whose input is not a band: the token path's patchify takes the
# gathered frame, and an SE gate's 1x1 convs the frame's channel means
GATHERED = ("trans.patchify", ".fc1", ".fc2")


def port_model(case: dict, mesh=None, state=None):
    """The case's model with its weights, on bands of rows under a mesh
    with a ``model`` axis; with ``state`` (a config under --qat) its QAT
    ranges are made first, on a whole frame, as the Trainer makes them."""
    m = create_model(case["model_type"], **case["model_kw"])
    m.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in case["weights"].items()}, strict=True)
    qstats = None
    if state is not None:
        from ddti_tpu_torch.train.qat import init_qstats

        s = case["size"]
        qstats = init_qstats(m, (1, 1, s, s), 0, case["model_type"])
    blocks.set_bn_mesh(m, mesh)
    set_spatial_mesh(m, mesh)
    return m if state is None else (m, qstats)


def port_config(case: dict) -> Config:
    s = case["size"]
    return Config(batch_size=len(case["images"]), image_size=s,
                  store_size=s, lr=SGD_LR, model_type=case["model_type"],
                  **case["config"])


def _rows(case: dict, mesh):
    """The batch, the chain's and mixup's draws: the rank's share (its
    data group's rows and partners, each microbatch's piece under
    --grad_accum) under a mesh."""
    images, masks = (torch.as_tensor(case[k]) for k in ("images", "masks"))
    draws, mix = case["draws"], case["mix"]
    if mesh is not None:
        keep, draws, mix = shard_draws(draws, mix, local_rows(
            images.shape[0], mesh, case["config"].get("grad_accum", 1)))
        images, masks = images[keep], masks[keep]
    return images, masks, draws, mix


def _teacher(case: dict, mesh):
    """The case's distillation teacher (eval mode, frozen), on bands under
    a mesh with a ``model`` axis, as the Trainer sets it; None without."""
    spec = case.get("teacher")
    if spec is None:
        return None
    m = create_model(spec["model_type"], **spec["model_kw"])
    m.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in spec["weights"].items()}, strict=True)
    teacher = Teacher([m], amp=False)
    set_spatial_mesh(teacher, mesh)
    return teacher


def run_step(case: dict, mesh=None) -> dict:
    """One SGD train step of ``case``: the metrics, the gradients, the
    parameters and BatchNorm statistics after the update, and each conv's
    input rows (a forward hook)."""
    cfg = port_config(case)
    model, qstats = port_model(case, mesh, cfg)
    state = TrainState(model, cfg.lr, 10, 0.0, model_type=cfg.model_type)
    state.optimizer = torch.optim.SGD(state.trainable, lr=SGD_LR)
    state.capturable = False  # its rate is a float, filled every step
    if cfg.qat:
        state.qstats = qstats
    rows = {}

    def seen(name):
        def hook(mod, args):
            rows.setdefault(name, args[0].shape[2])
        return hook

    hooks = [m.register_forward_pre_hook(seen(name))
             for name, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    s = case["size"]
    aug = AugmentConfig(out_size=(s, s))
    teacher = _teacher(case, mesh)
    if case.get("host"):
        # --host_augment: the step takes augmented float32 frames (here
        # the device chain's, on the rank's rows) and bands them itself
        step = make_host_train_step(cfg, teacher, mesh=mesh)
        images, masks, draws, mix = _rows(case, mesh)
        x, y = augment_batch(images.to(torch.float32) / 255.0,
                             masks.to(torch.float32) / 255.0, draws, aug)
        m = step(state, x, y, mix)
    else:
        step = make_train_step(cfg, aug, teacher=teacher, mesh=mesh)
        m = step(state, *_rows(case, mesh))
    for h in hooks:
        h.remove()
    return {
        "terms": [float(getattr(m, k)) for k in ("loss", "bce", "dice",
                                                 "focal", "boundary")],
        "counts": [float(c) for c in m.counts], "n": float(m.n),
        "state": {k: v.clone() for k, v in model.state_dict().items()},
        "rows": rows,
        "qstats": ({k: float(v) for k, v in state.qstats.items()}
                   if state.qstats else None)}


def run_grads64(case: dict, mesh=None) -> dict:
    """The gradients of one batch's weighted loss (the deep-supervision
    heads' too) with the network in float64 (the augmented, mixed batch in
    float32 as the step makes it, then widened), on the whole batch or
    under ``mesh`` on this rank's band of its rows, averaged over the
    ranks."""
    cfg = port_config(case)
    model = port_model(case, mesh).double().train()
    images, masks, draws, mix = _rows(case, mesh)
    s = case["size"]
    x, y = augment_batch(images.to(torch.float32) / 255.0,
                         masks.to(torch.float32) / 255.0, draws,
                         AugmentConfig(out_size=(s, s)))
    if mix is not None:
        x, y = mixup(x, y, mix)
    whole = y
    if mesh is not None and mesh.model > 1:
        x, y = band(x, mesh, 1), band(y, mesh, 1)
    out = model(x.double().permute(0, 3, 1, 2))
    kw = dict(bce_ratio=cfg.bce_ratio, dice_ratio=cfg.dice_ratio,
              focal_ratio=cfg.focal_ratio, boundary_ratio=cfg.boundary_ratio,
              mesh=mesh)
    if isinstance(out, tuple):
        heads = [h.permute(0, 2, 3, 1) for h in out[1]]
        out = out[0]
        aux = _ds_aux_loss((None, heads), whole, kw, cfg.alpha, mesh)
    else:
        aux = 0.0
    loss = weighted_loss(out.permute(0, 2, 3, 1), y, **kw).total + aux
    loss.backward()
    mean_gradients_(model.parameters(), mesh)
    return {"grads": {k: p.grad.clone()
                      for k, p in model.named_parameters()}}


def run_units(case: dict, mesh) -> dict:
    """The halo exchange and the band gather, forward and backward in
    float64, against whole-frame references every rank computes itself
    (the same frame and every rank's upstream weights from one seed):
    the largest errors over ``case["halos"]`` (top, bottom); and the
    band flip of each flip-ensemble axis set."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 5, dtype=torch.float64, generator=g)
    hb, m, r = 8 // mesh.model, mesh.model_rank, mesh.model
    errs = {}
    for top, bottom in case["halos"]:
        w = torch.randn(r, 2, 3, top + hb + bottom, 5, dtype=torch.float64,
                        generator=g)
        whole = x.clone().requires_grad_()
        padded = F.pad(whole, (0, 0, top, bottom))
        ref = sum((padded.narrow(2, k * hb, top + hb + bottom) * w[k]).sum()
                  for k in range(r))
        ref.backward()
        xb = band(x, mesh, 2).clone().requires_grad_()
        y = halo(xb, top, bottom, mesh)
        (y * w[m]).sum().backward()
        errs[f"halo{top},{bottom}"] = (
            float((y - padded.narrow(2, m * hb, top + hb + bottom)).abs()
                  .max()),
            float((xb.grad - band(whole.grad, mesh, 2)).abs().max()))
    v = torch.randn(r, 2, 3, 8, 5, dtype=torch.float64, generator=g)
    xb = band(x, mesh, 2).clone().requires_grad_()
    y = gather_band(xb, mesh)
    (y * v[m]).sum().backward()
    errs["gather"] = (float((y - x).abs().max()),
                      float((xb.grad - band(v.sum(0), mesh, 2)).abs().max()))
    nhwc = x.permute(0, 2, 3, 1)  # the flip ensemble's layout
    errs["flip"] = tuple(
        float((flip(band(nhwc, mesh, 1), axes, mesh)
               - band(torch.flip(nhwc, axes), mesh, 1)).abs().max())
        for axes in ((1,), (2,), (1, 2)))
    return errs


def run_fused(case: dict, mesh) -> dict:
    """One train epoch of the Trainer, stepwise and under --fused_epoch,
    from the same weights on the same store: both states."""
    from ddti_tpu_torch.core.logging import create_logger
    from ddti_tpu_torch.data.dataset import DeviceDataSource
    from ddti_tpu_torch.data.synthetic import generate_ddti_like
    from ddti_tpu_torch.train.engine import Trainer
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    s = case["size"]
    src = DeviceDataSource(*generate_ddti_like(16, (s, s), 0), device="cpu")
    out = {}
    for fused in (False, True):
        cfg = Config(epochs=1, batch_size=8, image_size=s, store_size=s,
                     lr=1e-3, model_type="UNet", fused_epoch=fused,
                     base_dir=os.path.join(case["dir"],
                                           f"rank{mesh.rank}_{fused}"),
                     **case["config"])
        cfg.make_dirs()
        model = init_like_flax(create_model("UNet", **case["model_kw"]), 0)
        tr = Trainer(cfg, (src, src, src),
                     create_logger(os.path.join(cfg.log_dir, "log.log")),
                     model, mesh=mesh)
        tr.train_one_epoch(0)
        out[fused] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def run_export(case: dict, mesh=None) -> dict:
    """A Trainer's one-epoch run with --export_serving, under ``mesh`` or
    on one device, then on the writer: its f32 serving bundle loaded back
    and run on whole frames, beside the masks of the trained model's own
    serve function, and under a mesh with data > 1 the sharded bundle's.
    Every rank returns its trained weights."""
    from ddti_tpu_torch.core.logging import create_logger
    from ddti_tpu_torch.data.dataset import DeviceDataSource
    from ddti_tpu_torch.data.synthetic import generate_ddti_like
    from ddti_tpu_torch.train.engine import Trainer
    from ddti_tpu_torch.train.export import load_serving_bundle, make_serve_fn
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    s = case["size"]
    src = DeviceDataSource(*generate_ddti_like(16, (s, s), 0), device="cpu")
    rank = mesh.rank if mesh is not None else "single"
    cfg = Config(epochs=1, batch_size=8, image_size=s, store_size=s,
                 lr=1e-3, model_type="UNet", export_serving=True,
                 base_dir=os.path.join(case["dir"], f"rank{rank}"))
    cfg.make_dirs()
    model = init_like_flax(create_model("UNet", **case["model_kw"]), 0)
    tr = Trainer(cfg, (src, src, src),
                 create_logger(os.path.join(cfg.log_dir, "log.log")),
                 model, mesh=mesh)
    tr.train()
    out = {"state": {k: v.clone() for k, v in model.state_dict().items()}}
    if not tr.is_writer:
        return out
    frames, _ = generate_ddti_like(8, (s, s), 5)
    x = torch.as_tensor(frames).to(torch.float32) / 255.0
    fn = load_serving_bundle(
        os.path.join(cfg.model_dir, "UNet_serving_program.pt2"),
        device="cpu")[0]
    out["bundle"] = fn(x).clone()
    out["model"] = make_serve_fn(tr._serving_model())(x).clone()
    sharded = os.path.join(cfg.model_dir, "UNet_serving_sharded.pt2")
    if os.path.exists(sharded):
        out["sharded"] = load_serving_bundle(sharded, device="cpu")[0](x)
    return out


def spatial_worker(mesh, in_path: str, out_dir: str) -> int:
    """Every case of ``in_path`` on this rank; ``out_dir/rank<r>.pt``."""
    cases = torch.load(in_path, weights_only=False)
    run = {"grads64": run_grads64, "units": run_units, "fused": run_fused,
           "export": run_export}
    out = {name: run.get(case.get("kind"), run_step)(case, mesh)
           for name, case in cases.items()}
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    return 0
