"""Augmentation preview, ported from ``ddti_tpu/cli/preview.py``: render
what the training pipeline will feed the model.

  python -m ddti_tpu_torch.cli.preview --output preview.png \\
      [--use_elastic true --use_clahe true ...] [--count 4 --variants 5] \\
      [--dataset_path DIR | --synthetic] [--seed 42] [--device cuda]

One grid PNG: each row is a source image, column 0 the original (its
ground-truth contour in blue), the other columns independent draws of the
training chain (``data/augment.py``'s ``augment_batch``, on ``--device``,
the card unless ``--device cpu``), each with its mask's contour in red.
The flags are the training CLI's, so a training command's augmentation
flags preview that run's input distribution (the same ``AugmentConfig``
and uint8 -> float ingestion as the train step; mixup is left out, it
blends across the batch after augmentation).

The layout is the JAX tool's: ``--count`` rows of 1 + ``--variants``
panels of 242 pixels (its 2.2-inch panels at 110 dpi), "original" and
"draw <v>" over the first row. It is drawn by Pillow through
``eval/visualize.py``'s ``paste_panel`` (gray levels over 0..1, the 0.5
contours of ``eval/contours.py``), so no matplotlib is needed.
"""

from __future__ import annotations

import argparse
import os

PANEL_PX = 242   # the JAX tool's 2.2-inch panels at 110 dpi
MARGIN_PX = 16   # room for the first row's titles


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "t", "yes", "y", "1"):
        return True
    if v.lower() in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", default="preview_augment.png")
    ap.add_argument("--count", type=int, default=4,
                    help="source images (grid rows)")
    ap.add_argument("--variants", type=int, default=5,
                    help="augmented draws per image (grid columns - 1)")
    ap.add_argument("--dataset_path", default="data/dataset")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic DDTI-like frames (default when no "
                         "dataset tree exists at --dataset_path)")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--store_size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=42)
    # augmentation flags, training-CLI names
    ap.add_argument("--use_elastic", type=_str2bool, default=False)
    ap.add_argument("--use_speckle", type=_str2bool, default=False)
    ap.add_argument("--use_tgc", type=_str2bool, default=False)
    ap.add_argument("--use_clahe", type=_str2bool, default=False)
    ap.add_argument("--p_crop", type=float, default=0.0)
    ap.add_argument("--aug_shared_geometry", action="store_true")
    ap.add_argument("--aug_fast_warp", action="store_true", default=True)
    ap.add_argument("--aug_exact_warp", dest="aug_fast_warp",
                    action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="where the augmentation chain runs (default "
                         "cuda; cpu to run it on the host)")
    return ap


def source_frames(args):
    """(images, masks) uint8 (n, S, S, 1) of ``--store_size``: the train
    split of ``--dataset_path``, else synthetic frames from ``--seed``."""
    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    n = max(args.count, 1)
    size = (args.store_size, args.store_size)
    root = args.dataset_path
    if args.synthetic or not os.path.isdir(os.path.join(root, "train")):
        return generate_ddti_like(n, size, args.seed)
    from ddti_tpu_torch.data.dataset import MedicalDataset, decode_to_store

    ds = MedicalDataset(os.path.join(root, "train"),
                        os.path.join(root, "train_mask"))
    images, masks = decode_to_store(ds, size)
    return images[:n], masks[:n]


def augmented_draws(images, masks, args, device):
    """``--variants`` draws of the chain over the whole batch: draw ``v``
    from generators seeded ``seed + v`` (the per-frame draws on the host,
    the elastic and speckle fields on ``device``), as (images, masks)
    float32 (n, H, W) numpy arrays."""
    import torch

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import augment_batch, sample_draws
    from ddti_tpu_torch.train.engine import aug_config_from

    cfg = Config(image_size=args.image_size, store_size=args.store_size,
                 use_elastic=args.use_elastic, use_speckle=args.use_speckle,
                 use_tgc=args.use_tgc, use_clahe=args.use_clahe,
                 p_crop=args.p_crop,
                 aug_shared_geometry=args.aug_shared_geometry,
                 aug_fast_warp=args.aug_fast_warp)
    aug_cfg = aug_config_from(cfg)
    imf = torch.from_numpy(images).to(device).float() / 255.0
    maf = torch.from_numpy(masks).to(device).float() / 255.0
    hw = tuple(images.shape[1:3])
    out = []
    for v in range(max(args.variants, 1)):
        draws = sample_draws(
            torch.Generator().manual_seed(args.seed + v), len(images),
            aug_cfg, hw,
            torch.Generator(device=device).manual_seed(args.seed + v))
        with torch.no_grad():
            ai, am = augment_batch(imf, maf, draws.to(device), aug_cfg)
        out.append((ai[..., 0].cpu().numpy(), am[..., 0].cpu().numpy()))
    return out


def draw_grid(images, masks, draws, path: str) -> tuple[int, int]:
    """The grid PNG at ``path``: row i is frame i, column 0 the original
    (uint8 (n, H, W, 1) ``images`` / ``masks``) with its contour in blue,
    column v + 1 draw v with its contour in red. Returns (rows, cols)."""
    from PIL import Image, ImageDraw

    from ddti_tpu_torch.eval.visualize import paste_panel

    n, ncols = len(images), 1 + len(draws)
    canvas = Image.new("RGB", (ncols * PANEL_PX, n * PANEL_PX), "white")
    pen = ImageDraw.Draw(canvas)
    blue, red = (0, 0, 255), (255, 0, 0)
    for i in range(n):
        panels = [(images[i, ..., 0] / 255.0, masks[i, ..., 0] / 255.0,
                   blue)] + [(ai[i], am[i], red) for ai, am in draws]
        for c, (img, mask, color) in enumerate(panels):
            paste_panel(canvas, pen, img, ((mask, color),), c * PANEL_PX,
                        i * PANEL_PX, PANEL_PX, MARGIN_PX, (0.0, 1.0))
    for c in range(ncols):
        title = "original" if c == 0 else f"draw {c - 1}"
        w = pen.textlength(title)
        pen.text((c * PANEL_PX + (PANEL_PX - w) / 2, 2), title,
                 fill=(0, 0, 0))
    out = os.path.abspath(path)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    canvas.save(out)
    return n, ncols


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    from ddti_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    images, masks = source_frames(args)
    draws = augmented_draws(images, masks, args, device)
    n, ncols = draw_grid(images, masks, draws, args.output)
    on = [k for k in ("use_elastic", "use_speckle", "use_tgc", "use_clahe")
          if getattr(args, k)] + (["p_crop"] if args.p_crop else [])
    print(f"wrote {n}x{ncols} preview grid ({', '.join(on) or 'baseline'}"
          f" augmentation) -> {os.path.abspath(args.output)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
