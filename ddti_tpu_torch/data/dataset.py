"""Dataset and device-resident data source, ported from
``ddti_tpu/data/dataset.py``.

``MedicalDataset`` pairs every image ``<name>.jpg`` with
``<name>_mask.jpg``; ``decode_to_store`` decodes and resizes the whole set
once (PIL, bilinear, grayscale) to two uint8 (N, H, W, 1) arrays.
``DeviceDataSource`` keeps them on the device as uint8 (1 byte a pixel):
per-step batches are gathers by index, the uint8 -> float conversion and
the augmentation happen in the train step.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator

import numpy as np
import torch


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor onto ``device`` without waiting for the device: a copy
    from pageable memory would first drain the stream, so CUDA copies go
    through pinned memory. A tensor already on a card (the augmentation's
    fields, drawn there) moves as it is."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class MedicalDataset:
    """Filename-paired (image, mask) dataset with lazy PIL decode."""

    def __init__(self, img_dir: str, mask_dir: str):
        self.img_dir = str(img_dir)
        self.mask_dir = str(mask_dir)
        # a flat listing, as the reference pairs a flat directory
        self.img_names = [p.name for p in sorted(Path(img_dir).iterdir())
                          if p.is_file()]
        self.mask_names = [n.split(".jpg")[0] + "_mask.jpg"
                           for n in self.img_names]

    def __len__(self):
        return len(self.img_names)

    def open_pair(self, idx: int):
        from PIL import Image

        img = Image.open(os.path.join(self.img_dir, self.img_names[idx]))
        mask = Image.open(os.path.join(self.mask_dir, self.mask_names[idx]))
        return img, mask


def decode_to_store(dataset: MedicalDataset, store_size=(512, 512)
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Decode + resize the whole dataset to two uint8 (N, H, W, 1) arrays:
    grayscale ('L'), PIL bilinear, the JAX package's strict PIL path
    (``use_native=False``)."""
    from PIL import Image

    h, w = store_size
    n = len(dataset)
    images = np.zeros((n, h, w, 1), np.uint8)
    masks = np.zeros((n, h, w, 1), np.uint8)
    for i in range(n):
        img, mask = dataset.open_pair(i)
        images[i, ..., 0] = np.asarray(
            img.convert("L").resize((w, h), Image.BILINEAR), np.uint8)
        masks[i, ..., 0] = np.asarray(
            mask.convert("L").resize((w, h), Image.BILINEAR), np.uint8)
    return images, masks


class DeviceDataSource:
    """The whole dataset resident on ``device`` as uint8 (N, H, W, 1);
    ``gather`` takes a batch by index on the device."""

    def __init__(self, images: np.ndarray, masks: np.ndarray,
                 device="cpu", names=None):
        if images.ndim != 4 or masks.ndim != 4:
            raise ValueError("images and masks must be (N, H, W, C)")
        self.n = images.shape[0]
        # per-item identifiers (file names) for the per-image test audit
        self.names = list(names) if names is not None else None
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            device)
        self.masks = torch.from_numpy(np.ascontiguousarray(masks)).to(device)

    def epoch_batches(self, rng: np.random.Generator, batch_size: int,
                      shuffle: bool = True) -> Iterator[np.ndarray]:
        """Index arrays for one epoch; the final short batch is padded by
        wraparound, as in the JAX package (the same ``rng`` gives the same
        order)."""
        order = rng.permutation(self.n) if shuffle else np.arange(self.n)
        for start in range(0, self.n, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            yield idx

    def num_batches(self, batch_size: int) -> int:
        return -(-self.n // batch_size)

    def gather(self, idx: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-side batch gather: (B, H, W, 1) uint8 images and masks."""
        i = to_device(torch.from_numpy(np.asarray(idx, np.int64)),
                      self.images.device)
        return self.images[i], self.masks[i]


def synthetic_source(n: int, store_size=(512, 512), seed: int = 0,
                     device="cpu") -> DeviceDataSource:
    from .synthetic import generate_ddti_like

    return DeviceDataSource(*generate_ddti_like(n, store_size, seed),
                            device=device)
