"""Contour-overlay test grids, ported from ``ddti_tpu/eval/visualize.py``
(the reference's ``trainer.py:264-299``): a 5 x 4 grid every 20 test
images, ground-truth contours in blue and predicted contours in red over
the gray frame, saved as ``test_boundaries_<k>.png``.

Drawn with matplotlib where it imports (one line collection per colour a
panel), else composed with Pillow in the same layout: 400 x 400 pixel
panels (matplotlib's 4 inches at 100 dpi), four columns, the frame
stretched over its min..max as ``imshow`` does, one-pixel lines in the
same colours. Either way the same files are written.
"""

from __future__ import annotations

import os

import numpy as np

from .contours import find_contours

PANEL_PX = 400   # 4 inches at matplotlib's 100 dpi
MARGIN_PX = 20


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def save_boundary_grids(images: np.ndarray, masks: np.ndarray,
                        preds: np.ndarray, result_dir: str,
                        per_fig: int = 20) -> list[str]:
    """images/masks/preds: (N, H, W) arrays (images float [0, 1], masks
    and predictions binary). Returns the written paths."""
    draw = _figure_matplotlib if _have_matplotlib() else _figure_pillow
    total = images.shape[0]
    # four columns; as many rows as per_fig needs (5 at the default 20)
    ncols = 4
    nrows = max(-(-per_fig // ncols), 1)
    paths = []
    for batch_start in range(0, total, per_fig):
        sl = slice(batch_start, min(batch_start + per_fig, total))
        path = os.path.join(result_dir,
                            f"test_boundaries_{batch_start // per_fig}.png")
        draw(images[sl], masks[sl], preds[sl], nrows, ncols, path)
        paths.append(path)
    return paths


def _figure_matplotlib(images, masks, preds, nrows, ncols, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows),
                             squeeze=False)
    axes = axes.flatten()
    for i in range(len(images)):
        ax = axes[i]
        ax.imshow(images[i], cmap="gray")
        for field, color in ((masks[i], "blue"), (preds[i], "red")):
            lines = [c[:, ::-1] for c in find_contours(field, 0.5)]
            if lines:
                ax.add_collection(LineCollection(lines, colors=color,
                                                 linewidths=1))
        ax.axis("off")
    for ax in axes[len(images):]:
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def paste_panel(canvas, pen, img, fields, x0: int, y0: int,
                panel_px: int = PANEL_PX, margin_px: int = MARGIN_PX,
                vrange=None) -> None:
    """Draw one frame into the ``panel_px`` square at (x0, y0) of a Pillow
    ``canvas``: the (H, W) frame scaled (bilinear) to fit inside
    ``margin_px`` of the border, its gray levels over ``vrange`` (lo, hi)
    or else its own min..max as ``imshow`` stretches them, and the 0.5
    contour of each ``(field, rgb)`` of ``fields`` in one-pixel lines."""
    from PIL import Image

    img = np.asarray(img, np.float64)
    h, w = img.shape
    lo, hi = vrange if vrange else (float(img.min()), float(img.max()))
    gray = (np.clip((img - lo) / (hi - lo), 0.0, 1.0) * 255.0 if hi > lo
            else np.zeros_like(img))
    scale = (panel_px - 2 * margin_px) / max(h, w)
    ph, pw = max(round(h * scale), 1), max(round(w * scale), 1)
    x0 += (panel_px - pw) // 2
    y0 += (panel_px - ph) // 2
    panel = Image.fromarray(np.round(gray).astype(np.uint8), "L")
    canvas.paste(panel.resize((pw, ph), Image.BILINEAR).convert("RGB"),
                 (x0, y0))
    sy, sx = ph / h, pw / w
    for field, color in fields:
        contours = find_contours(np.asarray(field), 0.5)
        if not contours:
            continue
        rc = np.concatenate(contours)
        # pixel centres at +0.5 of a pixel, as imshow places them; (x, y)
        # pairs flattened, each contour a slice of them
        xy = np.stack([x0 + (rc[:, 1] + 0.5) * sx,
                       y0 + (rc[:, 0] + 0.5) * sy], -1).ravel().tolist()
        end = np.cumsum([2 * len(c) for c in contours]).tolist()
        for a, b in zip([0] + end[:-1], end):
            pen.line(xy[a:b], fill=color, width=1)


def _figure_pillow(images, masks, preds, nrows, ncols, path):
    from PIL import Image, ImageDraw

    canvas = Image.new("RGB", (ncols * PANEL_PX, nrows * PANEL_PX), "white")
    pen = ImageDraw.Draw(canvas)
    for i in range(len(images)):
        paste_panel(canvas, pen, images[i],
                    ((masks[i], (0, 0, 255)), (preds[i], (255, 0, 0))),
                    (i % ncols) * PANEL_PX, (i // ncols) * PANEL_PX)
    canvas.save(path)
