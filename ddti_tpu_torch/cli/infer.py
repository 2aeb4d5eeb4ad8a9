"""Batch inference CLI, ported from ``ddti_tpu/cli/infer.py`` (its
live-checkpoint path).

Loads a checkpoint (``.pth`` state_dict, ``save_params_npz`` ``.npz`` or
a full-state directory such as ``<run>/models/<Model>_last``, whose EMA
shadow it prefers; a comma list of them predicts as a probability-mean
ensemble) and predicts a
nodule mask for every image of a directory, either resized to the model's
resolution (the reference's behaviour) or at native resolution through
sliding-window tiling. Writes ``<name>_pred.png`` masks, with ``--overlay``
``<name>_overlay.png`` contour overlays, and with ``--mask_dir`` scores
them (``eval_metrics.json``, ``per_image_metrics.csv``).

Usage:
  python -m ddti_tpu_torch.cli.infer --checkpoint ck.pth --input_dir imgs \\
      --output_dir preds [--model_type TransUNet --base_filters 64 \\
      --depth 4] [--sliding_window] [--tta] [--fold_bn] [--bf16]

``--device cuda`` is the default and raises without CUDA; ``--device cpu``
(or JAX's ``--cpu``) runs on the CPU deliberately. The resized path runs
the last, short batch as it is (JAX zero-pads it to its compiled batch
shape; eval BatchNorm is per sample, so the masks are the same).

Not ported yet (ROADMAP.md Queue 1 item 5): ``.stablehlo`` serving bundles
(such a checkpoint raises), with their ``--weights`` and the XLA
``--compilation_cache``, which are not offered.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _maybe_overlay(args, name: str, mask) -> None:
    """--overlay: the original grayscale image with the predicted contours
    drawn in red (marching squares, ``eval/contours.py``), written as
    ``<name>_overlay.png``. ``mask`` is the final mask at the original
    resolution: binary 0/255, or under --prob a soft 0-255 map, contoured
    at --threshold."""
    if not args.overlay:
        return
    import numpy as np
    from PIL import Image

    from ddti_tpu_torch.cli.serve import _overlay_png

    gray = Image.open(os.path.join(args.input_dir, name)).convert("L")
    thr255 = args.threshold * 255 if args.prob else 127.5
    rgb = _overlay_png(gray, np.asarray(mask, np.float32) > thr255)
    Image.fromarray(rgb).save(os.path.join(
        args.output_dir, os.path.splitext(name)[0] + "_overlay.png"))


def _maybe_eval(args) -> None:
    """--mask_dir: score the written predictions against ground truth
    (``eval/folder_eval.py``). Soft --prob maps binarize at the --threshold
    they were written with, binary masks (0/255) at 127."""
    if not args.mask_dir:
        return
    from ddti_tpu_torch.eval.folder_eval import (
        evaluate_predictions,
        write_eval_artifacts,
    )

    thr255 = args.threshold * 255.0 if args.prob else 127.0
    summary, rows = evaluate_predictions(args.output_dir, args.mask_dir,
                                         pred_thresh255=thr255)
    if not rows:
        print(f"--mask_dir: no <stem>_pred.png / <stem>_mask.* pairs "
              f"matched between {args.output_dir} and {args.mask_dir}")
        return
    print(write_eval_artifacts(args.output_dir, summary, rows))


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="batch nodule-mask inference (PyTorch/CUDA)")
    ap.add_argument("--checkpoint", required=True,
                    help=".pth state_dict, .npz weight export or a "
                         "full-state directory (<Model>_last). A COMMA "
                         "LIST of checkpoints of the same architecture "
                         "predicts as a probability-mean ensemble")
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--model_type", default="ResUNet")
    ap.add_argument("--base_filters", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--sliding_window", action="store_true",
                    help="native-resolution tiled inference")
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--stride", type=int, default=256)
    ap.add_argument("--overlay", action="store_true",
                    help="also write contour overlays")
    ap.add_argument("--prob", action="store_true",
                    help="write soft probability maps (grayscale 0-255) "
                         "instead of binary masks")
    ap.add_argument("--tta", action="store_true",
                    help="4-way flip test-time augmentation")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="binarization threshold")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 autocast compute (params stay float32)")
    ap.add_argument("--fold_bn", action="store_true",
                    help="fold BatchNorm into conv weights before "
                         "predicting")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default; raises if CUDA is absent) or "
                         "cpu")
    ap.add_argument("--cpu", dest="device", action="store_const",
                    const="cpu", help="the same as --device cpu")
    ap.add_argument("--mask_dir", default=None,
                    help="ground-truth <stem>_mask.* directory: after "
                         "predicting, score the predictions (IoU/F1 + "
                         "HD95/ASSD) and write eval_metrics.json + "
                         "per_image_metrics.csv into --output_dir")
    return ap


def build_apply_fn(args, device):
    """``apply_fn`` mapping NHWC float images on ``device`` to NHWC float32
    logits: the model's, the logit of the members' mean probability for an
    ensemble (a comma list of checkpoints), and with --tta the flip
    ensemble of either."""
    import torch

    from ddti_tpu_torch.eval.tta import logit_of_mean, tta_logits
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import nhwc_logits
    from ddti_tpu_torch.train.fold_bn import fold_batchnorm

    ck_paths = [p for p in args.checkpoint.split(",") if p]
    if any(p.endswith(".stablehlo") for p in ck_paths):
        raise NotImplementedError(
            ".stablehlo serving bundles are a JAX format the port does not "
            "run yet (ROADMAP.md Queue 1 item 5); pass the .pth or .npz "
            "weights")
    kwargs = dict(in_channels=1, out_channels=1,
                  base_filters=args.base_filters, depth=args.depth)
    if args.model_type == "TransUNet":
        kwargs["image_size"] = (args.window if args.sliding_window
                                else args.image_size)
    members = []
    for ck in ck_paths:
        model = load_checkpoint_into(
            ck, args.model_type, create_model(args.model_type, **kwargs))
        model = model.to(device).eval()
        if args.fold_bn:
            model = fold_batchnorm(model, args.model_type)
        members.append(model)
    if len(members) > 1:
        print(f"ensembling {len(members)} checkpoints (probability mean)")

    def logits(x):
        if len(members) == 1:
            return nhwc_logits(members[0], x, args.bf16)
        p = torch.stack([torch.sigmoid(nhwc_logits(m, x, args.bf16))
                         for m in members]).mean(0)
        return logit_of_mean(p)

    if args.tta:
        return lambda x: tta_logits(logits, x)
    return logits


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.cli.serve import resolve_device
    from ddti_tpu_torch.ops import attention

    device = resolve_device(args.device)
    apply_fn = build_apply_fn(args, device)

    os.makedirs(args.output_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(args.input_dir)
                   if n.lower().endswith(IMAGE_EXTS))
    if not names:
        print(f"no images in {args.input_dir}")
        return 1

    def save(name, out):
        Image.fromarray(out).save(os.path.join(
            args.output_dir, os.path.splitext(name)[0] + "_pred.png"))

    t0 = time.perf_counter()
    n_done = 0
    with torch.inference_mode():
        if args.sliding_window:
            from ddti_tpu_torch.eval.sliding_window import (
                sliding_window_logits,
            )
            for name in names:
                img = Image.open(os.path.join(args.input_dir, name)
                                 ).convert("L")
                arr = torch.from_numpy(
                    np.asarray(img, np.float32)[..., None] / 255.0)
                logits = sliding_window_logits(
                    apply_fn, arr.to(device), window=args.window,
                    stride=args.stride)
                probs = torch.sigmoid(logits).cpu().numpy()
                out = ((probs if args.prob else probs > args.threshold)
                       [..., 0] * 255).astype(np.uint8)
                save(name, out)
                _maybe_overlay(args, name, out)
                n_done += 1
        else:
            size = args.image_size
            for start in range(0, len(names), args.batch_size):
                chunk, metas = names[start:start + args.batch_size], []
                batch = []
                for name in chunk:
                    img = Image.open(os.path.join(args.input_dir, name)
                                     ).convert("L")
                    metas.append(img.size)
                    img = img.resize((size, size), Image.BILINEAR)
                    batch.append(np.asarray(img, np.float32)[..., None]
                                 / 255.0)
                x = torch.from_numpy(np.stack(batch)).to(device)
                probs = torch.sigmoid(apply_fn(x)).cpu().numpy()
                preds = probs if args.prob else probs > args.threshold
                for name, orig_size, p in zip(chunk, metas, preds):
                    m = Image.fromarray((p[..., 0] * 255).astype(np.uint8))
                    m = m.resize(orig_size, Image.BILINEAR if args.prob
                                 else Image.NEAREST)
                    save(name, np.asarray(m))
                    _maybe_overlay(args, name, m)
                    n_done += 1

    dt = time.perf_counter() - t0
    print(f"predicted {n_done} images in {dt:.1f}s "
          f"({n_done / max(dt, 1e-9):.1f} img/s)")
    _maybe_eval(args)
    # the hand-written kernel this run launched (0 on the CPU)
    print(f"[KERNELS] flash_fwd={attention.flash_forward_cuda.launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
