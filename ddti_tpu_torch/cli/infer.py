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

A ``.pt2`` serving bundle (``--export_serving``, ``cli/export.py``,
``cli/quantize.py``; ``train/export.py``) predicts with no model code: its
fixed batch (a short tail zero-padded), its size and its baked threshold,
TTA and precision; ``--weights`` names its tensors (default: the sibling
``.npz``). With ``--sliding_window`` its binarized tiles are blended by a
Hann-weighted vote. A JAX ``.stablehlo`` raises: export the checkpoint
with ``python -m ddti_tpu_torch.cli.export`` instead. The XLA
``--compilation_cache`` is not offered.
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
    ap.add_argument("--weights", default=None,
                    help="tensor bundle (.npz) of a weights-as-arguments "
                         ".pt2 program; default: the program path with "
                         ".pt2 -> .npz")
    ap.add_argument("--mask_dir", default=None,
                    help="ground-truth <stem>_mask.* directory: after "
                         "predicting, score the predictions (IoU/F1 + "
                         "HD95/ASSD) and write eval_metrics.json + "
                         "per_image_metrics.csv into --output_dir")
    return ap


def check_not_stablehlo(paths) -> None:
    """A JAX StableHLO bundle raises, naming the port's own export."""
    if any(p.endswith(".stablehlo") for p in paths):
        raise NotImplementedError(
            ".stablehlo serving bundles are JAX programs the port does not "
            "run (ROADMAP.md, Known divergences); export the checkpoint as "
            "a .pt2 bundle with python -m ddti_tpu_torch.cli.export (or "
            "cli.quantize for int8), or pass its .pth / .npz weights")


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
    check_not_stablehlo(ck_paths)
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

    from ddti_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    ck_paths = [p for p in args.checkpoint.split(",") if p]
    check_not_stablehlo(ck_paths)
    if any(p.endswith(".pt2") for p in ck_paths):
        if len(ck_paths) > 1:
            print("error: checkpoint ensembles need live checkpoints (a "
                  ".pt2 bundle bakes its binarization in); export one "
                  "ensemble bundle with cli.export --checkpoint a,b,c")
            return 1
        if args.prob:
            print("warning: --prob is unavailable for .pt2 bundles "
                  "(binarization is baked into the program); writing "
                  "binary masks")
            args.prob = False
        rc = _infer_serving_bundle(args, device)
        if rc == 0:
            _maybe_eval(args)
        print(_kernels_line())
        return rc
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
    print(_kernels_line())
    return 0


def _kernels_line() -> str:
    """The hand-written kernels this run launched (0 on the CPU)."""
    from ddti_tpu_torch.ops import attention, conv_s8

    return (f"[KERNELS] flash_fwd={attention.flash_forward_cuda.launches} "
            f"conv_s8={conv_s8.conv_s8_cuda.launches}")


def _infer_serving_bundle(args, device) -> int:
    """Predict from a ``.pt2`` bundle (JAX ``_infer_serving_bundle``): no
    model code, the program's fixed batch and size, a short tail
    zero-padded."""
    import numpy as np
    from PIL import Image

    from ddti_tpu_torch.train.export import load_serving_bundle

    serve, batch_n, size, _ = load_serving_bundle(
        args.checkpoint, args.weights, device=device)
    names = sorted(n for n in os.listdir(args.input_dir)
                   if n.lower().endswith(IMAGE_EXTS))
    if not names:
        print(f"no images in {args.input_dir}")
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    if args.sliding_window:
        return _serve_bundle_tiled(args, serve, batch_n, size, names)

    t0 = time.perf_counter()
    n_done = 0
    for start in range(0, len(names), batch_n):
        chunk = names[start:start + batch_n]
        arrs, metas = [], []
        for name in chunk:
            img = Image.open(os.path.join(args.input_dir, name)).convert("L")
            metas.append((name, img.size))
            img = img.resize((size, size), Image.BILINEAR)
            arrs.append(np.asarray(img, np.uint8)[..., None])
        x = np.stack(arrs)
        if len(chunk) < batch_n:  # pad the tail to the program's batch
            x = np.concatenate([x, np.zeros((batch_n - len(chunk),)
                                            + x.shape[1:], x.dtype)])
        preds = _bundle_predict(serve, x)[:len(chunk)]
        for p, (name, orig_size) in zip(preds, metas):
            m = Image.fromarray((p[..., 0] * 255).astype(np.uint8))
            m = m.resize(orig_size, Image.NEAREST)
            m.save(os.path.join(args.output_dir,
                                os.path.splitext(name)[0] + "_pred.png"))
            _maybe_overlay(args, name, m)
            n_done += 1
    dt = time.perf_counter() - t0
    print(f"served {n_done} images in {dt:.1f}s "
          f"({n_done / max(dt, 1e-9):.1f} img/s) "
          f"[artifact batch={batch_n} size={size}]")
    return 0


def _bundle_predict(serve, x_u8):
    """uint8 NHWC frames through a bundle -> uint8 numpy masks (a float
    program's fn scales the frames to [0, 1] itself)."""
    return serve(x_u8).cpu().numpy()


def _serve_bundle_tiled(args, serve, batch_n, window, names) -> int:
    """Sliding-window serving from a fixed-shape bundle (JAX
    ``_serve_bundle_tiled``): each frame reflect-padded and cut into the
    program's window, tiles batched to its batch, the binarized tile
    masks blended by a Hann-weighted vote."""
    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.eval.sliding_window import (
        _importance,
        _tile_positions,
        reflect_pad_2d,
    )

    stride = min(args.stride, window)
    weight = _importance(window)
    t0 = time.perf_counter()
    n_done = 0
    for name in names:
        img = Image.open(os.path.join(args.input_dir, name)).convert("L")
        frame = np.asarray(img, np.uint8)
        h, w = frame.shape
        pad_h = max(window - h, (-h) % stride if h > window else 0)
        pad_w = max(window - w, (-w) % stride if w > window else 0)
        padded = reflect_pad_2d(torch.from_numpy(frame.copy()).float(), pad_h,
                                pad_w).numpy().astype(np.uint8)
        ph, pw = padded.shape
        coords = [(y, x) for y in _tile_positions(ph, window, stride)
                  for x in _tile_positions(pw, window, stride)]
        tiles = np.stack([padded[y:y + window, x:x + window]
                          for y, x in coords])[..., None]
        n_tiles = len(coords)
        pad_t = (-n_tiles) % batch_n
        if pad_t:
            tiles = np.concatenate(
                [tiles, np.zeros((pad_t,) + tiles.shape[1:], tiles.dtype)])
        preds = np.concatenate(
            [_bundle_predict(serve, tiles[i:i + batch_n])
             for i in range(0, len(tiles), batch_n)])[:n_tiles]
        acc = np.zeros((ph, pw), np.float32)
        norm = np.zeros((ph, pw), np.float32)
        for (y, x), p in zip(coords, preds):
            acc[y:y + window, x:x + window] += p[..., 0] * weight
            norm[y:y + window, x:x + window] += weight
        mask = ((acc / norm)[:h, :w] > 0.5).astype(np.uint8) * 255
        Image.fromarray(mask).save(os.path.join(
            args.output_dir, os.path.splitext(name)[0] + "_pred.png"))
        _maybe_overlay(args, name, mask)
        n_done += 1
    dt = time.perf_counter() - t0
    print(f"served {n_done} frames tiled in {dt:.1f}s "
          f"({n_done / max(dt, 1e-9):.1f} img/s) "
          f"[artifact batch={batch_n} window={window} stride={stride}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
