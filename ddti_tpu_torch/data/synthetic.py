"""Synthetic DDTI-like data generator, copied from
``ddti_tpu/data/synthetic.py`` (numpy and PIL only; the same seed gives the
same frames as the JAX package).

The DDTI ultrasound dataset is not redistributable with this repo, so tests
and benchmarks run on synthetic frames that mimic its statistics: speckled
log-normal ultrasound texture, a darker elliptical "nodule" region, and the
corresponding binary mask. Shapes/dtypes match ``decode_to_store`` output.
"""

from __future__ import annotations

import numpy as np


def generate_ddti_like(n: int, size=(512, 512), seed: int = 0
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images, masks) uint8 arrays of shape (n, H, W, 1)."""
    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    images = np.zeros((n, h, w, 1), np.uint8)
    masks = np.zeros((n, h, w, 1), np.uint8)
    for i in range(n):
        # background speckle (multiplicative, like ultrasound)
        base = rng.gamma(3.0, 30.0, (h, w))
        # depth-dependent attenuation
        base *= np.linspace(1.0, 0.55, h)[:, None]
        # elliptical hypoechoic nodule
        cy = rng.uniform(0.3, 0.7) * h
        cx = rng.uniform(0.3, 0.7) * w
        ry = rng.uniform(0.08, 0.22) * h
        rx = rng.uniform(0.08, 0.22) * w
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        ellipse = (u / rx) ** 2 + (v / ry) ** 2
        nodule = ellipse < 1.0
        base[nodule] *= rng.uniform(0.35, 0.6)
        # smooth boundary halo
        halo = (ellipse >= 1.0) & (ellipse < 1.3)
        base[halo] *= 1.15
        images[i, ..., 0] = np.clip(base, 0, 255).astype(np.uint8)
        masks[i, ..., 0] = nodule.astype(np.uint8) * 255
    return images, masks


def write_synthetic_dataset(root: str, n_train=32, n_val=8, n_test=8,
                            size=(256, 256), seed: int = 0) -> None:
    """Materialize a synthetic dataset on disk in the reference's directory
    layout: <root>/{train,val,test} + <root>/{train,val,test}_mask with the
    ``<name>.jpg`` / ``<name>_mask.jpg`` pairing convention."""
    import os

    from PIL import Image

    counts = {"train": n_train, "val": n_val, "test": n_test}
    idx = 0
    for split, cnt in counts.items():
        img_dir = os.path.join(root, split)
        mask_dir = os.path.join(root, f"{split}_mask")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)
        images, masks = generate_ddti_like(cnt, size, seed + idx)
        for i in range(cnt):
            name = f"{split}_{i:04d}"
            Image.fromarray(images[i, ..., 0]).save(
                os.path.join(img_dir, f"{name}.jpg"))
            Image.fromarray(masks[i, ..., 0]).save(
                os.path.join(mask_dir, f"{name}_mask.jpg"))
        idx += cnt
