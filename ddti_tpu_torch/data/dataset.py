"""Datasets and data sources, ported from ``ddti_tpu/data/dataset.py``.

``MedicalDataset`` pairs every image ``<name>.jpg`` with
``<name>_mask.jpg``; ``decode_to_store`` decodes and resizes the whole set
once (grayscale, PIL bilinear; all-JPEG sets through the C++ libjpeg path of
``runtime/native.py``) to two uint8 (N, H, W, 1) arrays, memoized as raw
``.u8`` files under a ``cache_dir`` (the ``.store_cache``, whose file names
``store_cache_paths`` derives as the JAX package does, so either package
reads the other's). ``DeviceDataSource`` keeps them on the device as uint8
(1 byte a pixel): per-step batches are gathers by index, the uint8 -> float
conversion and the augmentation happen in the train step. The streaming
sources feed the same Trainer from the host: ``HostBatchIterator`` (PIL
decode and the host chain of ``host_transforms.py`` per image, float32
batches, ``--host_augment``) and ``runtime.NativeSource`` (the C++ mmap
loader over a ``.store_cache``, uint8 batches, ``--native_loader``).
"""

from __future__ import annotations

import logging
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
    """Filename-paired (image, mask) dataset with lazy PIL decode;
    ``transform(img, mask)`` (an eval chain) applies in ``__getitem__``,
    and ``HostBatchIterator`` calls it with its random streams."""

    def __init__(self, img_dir: str, mask_dir: str, transform=None):
        self.img_dir = str(img_dir)
        self.mask_dir = str(mask_dir)
        # a flat listing, as the reference pairs a flat directory
        self.img_names = [p.name for p in sorted(Path(img_dir).iterdir())
                          if p.is_file()]
        self.mask_names = [n.split(".jpg")[0] + "_mask.jpg"
                           for n in self.img_names]
        self.transform = transform

    def __len__(self):
        return len(self.img_names)

    def open_pair(self, idx: int):
        from PIL import Image

        img = Image.open(os.path.join(self.img_dir, self.img_names[idx]))
        mask = Image.open(os.path.join(self.mask_dir, self.mask_names[idx]))
        return img, mask

    def __getitem__(self, idx: int):
        img, mask = self.open_pair(idx)
        if self.transform is not None:
            return self.transform(img, mask)
        return img, mask


def store_cache_paths(dataset: MedicalDataset, store_size=(512, 512),
                      cache_dir: str = ".store_cache") -> tuple[str, str]:
    """The cache key of a dataset's decoded ``.u8`` store, the JAX package's
    derivation letter for letter (so the two packages share one cache):
    the directories' absolute paths and every file's (name, size, mtime),
    so a renamed, replaced or regenerated dataset never hits a stale
    store."""
    import hashlib

    h, w = store_size
    sig = hashlib.sha1()
    for d in (dataset.img_dir, dataset.mask_dir):
        sig.update(os.path.abspath(d).encode())
    for names, d in ((dataset.img_names, dataset.img_dir),
                     (dataset.mask_names, dataset.mask_dir)):
        for nm in names:
            st = os.stat(os.path.join(d, nm))
            sig.update(f"{nm}:{st.st_size}:{st.st_mtime_ns}".encode())
    tag = (f"{os.path.basename(dataset.img_dir)}_{len(dataset)}_{h}x{w}_"
           f"{sig.hexdigest()[:16]}")
    return (os.path.join(cache_dir, f"{tag}_imgs.u8"),
            os.path.join(cache_dir, f"{tag}_masks.u8"))


def _cached(paths, n: int, h: int, w: int) -> bool:
    return all(os.path.isfile(p) and os.path.getsize(p) == n * h * w
               for p in paths)


def decode_to_store(dataset: MedicalDataset, store_size=(512, 512),
                    cache_dir: str | None = None, use_native: bool = True
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Decode + resize the whole dataset to two uint8 (N, H, W, 1) arrays:
    grayscale ('L'), PIL bilinear.

    With ``cache_dir`` the store is memoized as raw ``.u8`` files (the
    native loader's format): a later call reads them back instead of
    decoding. ``use_native`` (the default, as in JAX) decodes an all-JPEG
    set through the C++ libjpeg path, grayscale JPEGs within one gray
    level of PIL; ``use_native=False`` is the strict PIL path. Where the
    native decode is absent or refuses a file, the PIL path runs, with a
    warning.
    """
    from PIL import Image

    h, w = store_size
    n = len(dataset)
    if cache_dir:
        ip, mp = store_cache_paths(dataset, store_size, cache_dir)
        if _cached((ip, mp), n, h, w):
            images = np.fromfile(ip, np.uint8).reshape(n, h, w, 1)
            masks = np.fromfile(mp, np.uint8).reshape(n, h, w, 1)
            return images, masks
    images = masks = None
    img_paths = [os.path.join(dataset.img_dir, nm)
                 for nm in dataset.img_names]
    mask_paths = [os.path.join(dataset.mask_dir, nm)
                  for nm in dataset.mask_names]
    if use_native and all(p.lower().endswith((".jpg", ".jpeg"))
                          for p in img_paths + mask_paths):
        from ddti_tpu_torch.runtime import native

        log = logging.getLogger(__name__)
        if native.decode_available():
            try:
                images = native.decode_jpegs(img_paths, h, w)
                masks = native.decode_jpegs(mask_paths, h, w)
            except OSError as e:
                log.warning(f"native JPEG decode failed ({e}); decoding "
                            f"with PIL")
                images = masks = None
        else:
            log.warning(f"native JPEG decode is absent "
                        f"({native.decode_available_reason()}); decoding "
                        f"with PIL")
    if images is None:
        images = np.zeros((n, h, w, 1), np.uint8)
        masks = np.zeros((n, h, w, 1), np.uint8)
        for i in range(n):
            img, mask = dataset.open_pair(i)
            images[i, ..., 0] = np.asarray(
                img.convert("L").resize((w, h), Image.BILINEAR), np.uint8)
            masks[i, ..., 0] = np.asarray(
                mask.convert("L").resize((w, h), Image.BILINEAR), np.uint8)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        for arr, path in ((images, ip), (masks, mp)):
            tmp = f"{path}.{os.getpid()}.tmp"
            arr[..., 0].tofile(tmp)
            os.replace(tmp, path)  # a concurrent reader never sees half
    return images, masks


def decode_to_store_files(dataset: MedicalDataset, store_size=(512, 512),
                          cache_dir: str = ".store_cache"
                          ) -> tuple[str, str, int]:
    """The raw ``.u8`` store files of ``dataset``, decoded first where
    missing: ``(imgs_path, masks_path, n)``, what the native batch loader
    maps. The arrays need not stay resident anywhere."""
    h, w = store_size
    n = len(dataset)
    ip, mp = store_cache_paths(dataset, store_size, cache_dir)
    if not _cached((ip, mp), n, h, w):
        decode_to_store(dataset, store_size, cache_dir=cache_dir)
    return ip, mp, n


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


class HostBatchIterator:
    """Streaming host loader (PIL decode and ``dataset.transform`` per
    image) for the strict host chain (``--host_augment``) or datasets too
    large for the device store. Single-process; yields float32
    (B, H, W, 1) numpy batches, the last one short.

    Randomness as the JAX package derives it: the order from
    ``default_rng((seed, epoch))`` after ``set_epoch`` (else from one
    stream seeded by ``seed``), the chain's ``random.Random`` from that
    generator's next integer. The frame-sized fields' ``RandomState`` is
    seeded from that integer too (``field_seed``), where the JAX package
    uses the global ``np.random``: a ``--resume`` of the port replays every
    draw, one of JAX's replays all but the fields."""

    def __init__(self, dataset: MedicalDataset, batch_size: int,
                 shuffle: bool, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = None
        self.rng = np.random.default_rng(seed)
        self.field_seed = None  # the last iteration's RandomState seed

    def set_epoch(self, epoch: int) -> None:
        """Pin the next iteration's randomness to (seed, epoch): the
        Trainer calls it before each train epoch, so a --resume replays
        the stream the uninterrupted run had."""
        self._epoch = int(epoch)

    def __iter__(self):
        import random as _random

        rng = (np.random.default_rng((self.seed, self._epoch))
               if self._epoch is not None else self.rng)
        order = (rng.permutation(len(self.dataset)) if self.shuffle
                 else np.arange(len(self.dataset)))
        host_seed = int(rng.integers(2 ** 31))
        host_rng = _random.Random(host_seed)
        # from the chain's seed, so the order's generator keeps JAX's stream
        self.field_seed = int(np.random.SeedSequence(
            (host_seed, 1)).generate_state(1)[0])
        nprng = np.random.RandomState(self.field_seed)
        batch_imgs, batch_masks = [], []
        for i in order:
            img, mask = self.dataset.open_pair(int(i))
            if self.dataset.transform is not None:
                im, ma = self.dataset.transform(img, mask, host_rng, nprng)
            else:
                im, ma = (np.asarray(img, np.float32)[..., None] / 255.0,
                          np.asarray(mask, np.float32)[..., None] / 255.0)
            batch_imgs.append(im)
            batch_masks.append(ma)
            if len(batch_imgs) == self.batch_size:
                yield np.stack(batch_imgs), np.stack(batch_masks)
                batch_imgs, batch_masks = [], []
        if batch_imgs:
            yield np.stack(batch_imgs), np.stack(batch_masks)
