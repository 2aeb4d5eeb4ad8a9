"""The reference's host-side paired augmentation chain (PIL, cv2, numpy),
ported from ``ddti_tpu/data/host_transforms.py``: what ``--host_augment``
runs per image on the host instead of the device chain of ``augment.py``.

Plain functions over ``(PIL.Image, PIL.Image)`` pairs. The probabilities and
the scalar draws come from a ``random.Random`` (``rng``), as in the JAX
package. The frame-sized fields (the elastic displacements, the speckle
noise) come from an explicit ``numpy.random.RandomState`` (``nprng``),
where the JAX package draws them from the global ``np.random``: a
``RandomState(s)`` gives the stream that ``np.random.seed(s)`` gives, so the
two chains are bit-equal when seeded alike, and the port's chain replays
from its seeds alone (``dataset.HostBatchIterator``).
"""

from __future__ import annotations

import random as _random
from typing import Callable

import numpy as np
from PIL import Image, ImageEnhance


def elastic_deform(img: Image.Image, mask: Image.Image, rng: _random.Random,
                   nprng: np.random.RandomState, alpha=(20, 40),
                   sigma=(6, 10), p=0.3):
    import cv2

    if rng.random() > p:
        return img, mask
    img_np = np.array(img)
    mask_np = np.array(mask)
    h, w = img_np.shape[:2]
    a = rng.uniform(*alpha)
    s = rng.uniform(*sigma)
    dx = cv2.GaussianBlur(nprng.rand(h, w) * 2 - 1, (17, 17), s) * a
    dy = cv2.GaussianBlur(nprng.rand(h, w) * 2 - 1, (17, 17), s) * a
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    mx = (x + dx).astype(np.float32)
    my = (y + dy).astype(np.float32)
    img_d = cv2.remap(img_np, mx, my, cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REFLECT)
    mask_d = cv2.remap(mask_np, mx, my, cv2.INTER_NEAREST,
                       borderMode=cv2.BORDER_REFLECT)
    return Image.fromarray(img_d), Image.fromarray(mask_d)


def speckle_noise(img, mask, rng, nprng, sigma=(0.05, 0.15), p=0.5):
    if rng.random() > p:
        return img, mask
    arr = np.array(img).astype(np.float32) / 255.0
    noise = nprng.normal(0, rng.uniform(*sigma), arr.shape)
    arr = np.clip((arr + arr * noise) * 255.0, 0, 255).astype(np.uint8)
    return Image.fromarray(arr), mask


def tgc_augment(img, mask, rng, num_bins=10, gain=(0.8, 1.2), p=0.5):
    if rng.random() > p:
        return img, mask
    arr = np.array(img).astype(np.float32)
    bin_h = arr.shape[0] // num_bins
    for i in range(num_bins):
        arr[i * bin_h:(i + 1) * bin_h] *= rng.uniform(*gain)
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr), mask


def clahe(img, mask, rng, clip=2.0, grid=(4, 4), p=0.3):
    import cv2

    if rng.random() > p:
        return img, mask
    eq = cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(
        np.array(img))
    return Image.fromarray(eq), mask


def adjust_brightness(img, mask, rng, p=0.5):
    if rng.random() < p:
        img = ImageEnhance.Brightness(img).enhance(rng.uniform(0.5, 1.5))
    return img, mask


def random_crop(img, mask, rng, p, crop_w, crop_h):
    if rng.random() < p:
        w, h = img.size
        top = rng.randint(0, h - crop_h)
        left = rng.randint(0, w - crop_w)
        box = (left, top, left + crop_w, top + crop_h)
        img = img.crop(box)
        mask = mask.crop(box)
    return img, mask


def flip(img, mask, rng, p=0.5):
    if rng.random() < p:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    if rng.random() < p:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
        mask = mask.transpose(Image.FLIP_TOP_BOTTOM)
    return img, mask


def rotate(img, mask, rng, p=0.5):
    if rng.random() < p:
        angle = rng.uniform(-180, 180)
        img = img.rotate(angle)  # nearest, zero fill: TF.rotate on PIL
        mask = mask.rotate(angle)
    return img, mask


def resize(img, mask, size=(512, 512)):
    # TF.resize on PIL: PIL bilinear
    img = img.resize(size[::-1], Image.BILINEAR)
    mask = mask.resize(size[::-1], Image.BILINEAR)
    return img, mask


def to_arrays(img, mask):
    """ToTensor's equivalent: float32 [0, 1] (H, W, 1) numpy arrays."""
    i = np.asarray(img, np.float32)[..., None] / 255.0
    m = np.asarray(mask, np.float32)[..., None] / 255.0
    return i, m


def build_train_chain(use_elastic=False, use_speckle=False, use_tgc=False,
                      use_clahe=False, out_size=(512, 512)) -> Callable:
    """The reference's ``build_train_transform``:
    ``chain(img, mask, rng, nprng) -> (image, mask)`` float32 arrays."""

    def chain(img, mask, rng: _random.Random,
              nprng: np.random.RandomState):
        if use_elastic:
            img, mask = elastic_deform(img, mask, rng, nprng, p=0.25)
        img, mask = flip(img, mask, rng, p=0.5)
        img, mask = rotate(img, mask, rng, p=0.5)
        img, mask = adjust_brightness(img, mask, rng, p=0.5)
        if use_speckle:
            img, mask = speckle_noise(img, mask, rng, nprng, p=0.3)
        if use_tgc:
            img, mask = tgc_augment(img, mask, rng, p=0.25)
        if use_clahe:
            img, mask = clahe(img, mask, rng, p=0.3)
        img, mask = resize(img, mask, out_size)
        return to_arrays(img, mask)

    return chain


def build_eval_chain(out_size=(512, 512)) -> Callable:
    def chain(img, mask, rng=None, nprng=None):
        img, mask = resize(img, mask, out_size)
        return to_arrays(img, mask)

    return chain
