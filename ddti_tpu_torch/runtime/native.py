"""ctypes bindings and build of the native host loader (``host_loader.cpp``),
ported from ``ddti_tpu/runtime/native.py``. Plain C ABI, no pybind11.

The library is compiled by ``g++`` into ``build/ddti_tpu_torch/`` at the
repository root, under a name that hashes the source and the flags, so an
edited source is rebuilt at its next use; a cross-process file lock and an
atomic rename keep concurrent processes (test workers, CLI runs started
together) from loading half a file. Nothing is built at import time.

Where ``jpeglib.h`` is absent the library is built without its decode half
(``-DDDTI_NO_JPEG``): the mmap batch loader still works,
``decode_available()`` is False, the decode functions raise, and
``decode_available_reason()`` says why.

Usage::

    from ddti_tpu_torch.runtime import NativeBatchLoader
    with NativeBatchLoader(imgs_path, masks_path, n, h, w, batch) as ld:
        imgs, masks, epoch = ld.next()
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "host_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddti_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
NO_JPEG = ("-DDDTI_NO_JPEG",)
_lock = threading.Lock()
_lib = None
_no_decode_reason = None  # the compiler's refusal of the libjpeg build
build_seconds = 0.0       # spent compiling in this process (0.0: cached)


def library_path(flags=()) -> Path:
    """Where the library for the current source and ``flags`` lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(flags)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhostloader_{h.hexdigest()[:16]}.so"


def _compile(flags, libs) -> Path:
    """Build the library for ``flags`` unless it exists, under a
    cross-process lock; raises with the compiler's output on failure."""
    global build_seconds
    out = library_path(flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    import fcntl

    with open(BUILD_DIR / ".hostloader.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, *flags, "-o", str(tmp), str(SOURCE),
                   *libs]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host loader build failed "
                                   f"({res.returncode}): {' '.join(cmd)}\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)  # atomic: loaders never see half a file
            build_seconds += time.perf_counter() - t0
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return out


def build_library() -> Path:
    """The library's path, built if needed: with libjpeg where its header
    is found, else without the decode half (the reason is kept)."""
    global _no_decode_reason
    try:
        return _compile((), ("-ljpeg",))
    except RuntimeError as e:
        if "jpeglib.h" not in str(e) and "ljpeg" not in str(e):
            raise
        # the compiler's complaint, else the command line (-ljpeg)
        lines = [line.strip() for line in str(e).splitlines()]
        _no_decode_reason = next(
            (line for line in lines if "jpeglib.h" in line), lines[0])
        return _compile(NO_JPEG, ())


def _load():
    global _lib, _no_decode_reason
    with _lock:
        if _lib is not None:
            return _lib
        path = build_library()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            # a libjpeg build made on a machine that has libjpeg, in a
            # build directory carried to one that has not: the loader
            # without the decode half still serves
            if "libjpeg" not in str(e):
                raise
            _no_decode_reason = f"{path.name} does not load: {e}"
            lib = ctypes.CDLL(str(_compile(NO_JPEG, ())))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.loader_next.restype = ctypes.c_long
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.host_loader_has_jpeg.restype = ctypes.c_int
        lib.host_loader_has_jpeg.argtypes = []
        if lib.host_loader_has_jpeg():
            lib.decode_jpegs.restype = ctypes.c_long
            lib.decode_jpegs.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.decode_jpeg_mem.restype = ctypes.c_long
            lib.decode_jpeg_mem.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def native_available() -> bool:
    """The library builds and loads (the mmap batch loader works)."""
    try:
        _load()
        return True
    except Exception:
        return False


def decode_available() -> bool:
    """The library was built with its libjpeg decode half."""
    return native_available() and bool(_load().host_loader_has_jpeg())


def decode_available_reason() -> str:
    """Why decode is absent ('' when it is there)."""
    if decode_available():
        return ""
    if not native_available():
        try:
            _load()
        except Exception as e:
            return f"host loader unavailable: {e}"
    return _no_decode_reason or "built without libjpeg"


def _decode_lib():
    lib = _load()
    if not lib.host_loader_has_jpeg():
        raise RuntimeError("native JPEG decode is absent: "
                           + decode_available_reason())
    return lib


def decode_jpegs(paths, h: int, w: int,
                 num_threads: int | None = None) -> np.ndarray:
    """Decode JPEG files to grayscale and resize each to (h, w) with PIL
    BILINEAR's triangle filter, in parallel C++ threads (libjpeg): the
    equivalent of ``Image.open(p).convert("L").resize((w, h), BILINEAR)``
    per file, within one gray level. Returns a (N, h, w, 1) uint8 array;
    raises OSError when any file does not decode."""
    lib = _decode_lib()
    paths = [os.fspath(p) for p in paths]
    n = len(paths)
    out = np.empty((n, h, w, 1), np.uint8)
    blob = b"".join(p.encode() + b"\0" for p in paths)
    if num_threads is None:
        num_threads = min(16, os.cpu_count() or 1)
    ok = lib.decode_jpegs(blob, n, h, w,
                          out.ctypes.data_as(ctypes.c_void_p), num_threads)
    if ok != n:
        raise OSError(f"native JPEG decode failed for {n - ok} of {n} files")
    return out


def decode_jpeg_bytes(data: bytes, h: int, w: int):
    """Decode ONE in-memory JPEG to grayscale and resize it to (h, w) as
    ``decode_jpegs`` does. Returns ``((h, w, 1) uint8 array, (orig_w,
    orig_h))``, the original size in PIL's ``Image.size`` order. Raises
    ValueError on bytes that do not decode: the serving daemon's
    per-request path, which then falls to PIL."""
    lib = _decode_lib()
    out = np.empty((h, w, 1), np.uint8)
    oh = ctypes.c_int(0)
    ow = ctypes.c_int(0)
    ok = lib.decode_jpeg_mem(data, len(data), h, w,
                             out.ctypes.data_as(ctypes.c_void_p),
                             ctypes.byref(oh), ctypes.byref(ow))
    if ok != 1:
        raise ValueError("native JPEG decode failed")
    return out, (ow.value, oh.value)


class NativeBatchLoader:
    """Threaded mmap-backed batch assembler over a raw uint8 store.

    Yields (batch, H, W, 1) uint8 image and mask arrays, shuffled per epoch
    from (seed, epoch) alone (a mt19937_64 Fisher-Yates in the C++); the
    final short batch of an epoch wraps around, as
    ``DeviceDataSource.epoch_batches`` pads it, unless ``drop_last``."""

    def __init__(self, imgs_path: str, masks_path: str, n: int, h: int,
                 w: int, batch: int, seed: int = 0, num_threads: int = 2,
                 queue_depth: int = 4, drop_last: bool = False):
        self._lib = _load()
        self.n, self.h, self.w, self.batch = n, h, w, batch
        self._handle = self._lib.loader_create(
            os.fspath(imgs_path).encode(), os.fspath(masks_path).encode(),
            n, h, w, batch, seed, num_threads, queue_depth, int(drop_last))
        if not self._handle:
            raise OSError(f"loader_create failed for {imgs_path!r} / "
                          f"{masks_path!r} (size/permissions?)")
        self.steps_per_epoch = n // batch if drop_last else -(-n // batch)

    def next(self):
        if not self._handle:  # closed: a NULL handle would crash the C++
            raise StopIteration
        imgs = np.empty((self.batch, self.h, self.w, 1), np.uint8)
        masks = np.empty((self.batch, self.h, self.w, 1), np.uint8)
        epoch = self._lib.loader_next(
            self._handle, imgs.ctypes.data_as(ctypes.c_void_p),
            masks.ctypes.data_as(ctypes.c_void_p))
        if epoch < 0:
            raise StopIteration
        return imgs, masks, int(epoch)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeSource:
    """A ``NativeBatchLoader`` as the Trainer's streaming source: iterating
    yields one epoch of (imgs, masks) uint8 batches, which the device
    augmentation step then takes."""

    def __init__(self, loader: NativeBatchLoader):
        self.loader = loader
        self.batch_size = loader.batch

    def num_batches(self, batch_size: int | None = None) -> int:
        """Steps an epoch (the schedule's sizing)."""
        if batch_size not in (None, self.loader.batch):
            raise ValueError(f"native loader was built for batch "
                             f"{self.loader.batch}, got {batch_size}")
        return self.loader.steps_per_epoch

    def __iter__(self):
        for _ in range(self.loader.steps_per_epoch):
            try:
                imgs, masks, _ = self.loader.next()
            except StopIteration:
                # the loader was closed: end the epoch (a StopIteration
                # escaping a generator is a RuntimeError, PEP 479)
                return
            yield imgs, masks


def write_store(path_prefix: str, images: np.ndarray, masks: np.ndarray
                ) -> tuple[str, str]:
    """Write (N, H, W, 1) uint8 arrays as the raw store files the native
    loader maps; returns (imgs_path, masks_path)."""
    if images.dtype != np.uint8 or masks.dtype != np.uint8:
        raise ValueError("the store holds uint8 images and masks")
    imgs_path = path_prefix + "_imgs.u8"
    masks_path = path_prefix + "_masks.u8"
    images[..., 0].tofile(imgs_path)
    masks[..., 0].tofile(masks_path)
    return imgs_path, masks_path
