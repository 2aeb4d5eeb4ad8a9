"""The port's native host loader (ddti_tpu_torch/runtime/) against the JAX
package's, on the CPU: the mmap batch loader's batches bit for bit over two
epochs, the libjpeg decode bit for bit and within one gray level of PIL, the
errors, and where the port builds its library (build/, never ddti_tpu/).
"""

import ctypes
import io
import os
import pathlib

import numpy as np
import pytest
from PIL import Image

from ddti_tpu.runtime import native as jn
from ddti_tpu_torch.data.synthetic import generate_ddti_like
from ddti_tpu_torch.runtime import native as tn

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, H, W = 10, 24, 20


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    images, masks = generate_ddti_like(N, (H, W), 3)
    return tn.write_store(str(d / "ds"), images, masks), images, masks


def _epochs(mod, paths, batch, threads, drop_last, epochs=2):
    ip, mp = paths
    out = []
    with mod.NativeBatchLoader(ip, mp, N, H, W, batch, seed=11,
                               num_threads=threads,
                               drop_last=drop_last) as ld:
        for _ in range(epochs * ld.steps_per_epoch):
            imgs, masks, epoch = ld.next()
            out.append((imgs.copy(), masks.copy(), epoch))
    return out


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_bit_equal_to_jax(store, threads, drop_last):
    """Two epochs of batch 4 over 10 frames: 3 steps an epoch with the last
    wrapped (2 with drop_last), each epoch reshuffled from (seed, epoch)."""
    paths, images, masks = store
    got = _epochs(tn, paths, 4, threads, drop_last)
    want = _epochs(jn, paths, 4, threads, drop_last)
    assert len(got) == len(want) == 2 * (2 if drop_last else 3)
    for (gi, gm, ge), (wi, wm, we) in zip(got, want):
        assert ge == we
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    # every batch row is a stored pair, masks aligned with images
    flat = images.reshape(N, -1)
    for gi, gm, _ in got:
        for j in range(4):
            k = int(np.flatnonzero((flat == gi[j].ravel()).all(1))[0])
            np.testing.assert_array_equal(gm[j], masks[k])
    assert not np.array_equal(got[0][0], got[len(got) // 2][0])


def test_native_source_yields_one_epoch(store):
    (ip, mp), _, _ = store
    src = tn.NativeSource(tn.NativeBatchLoader(ip, mp, N, H, W, 4, seed=1))
    assert src.num_batches(4) == 3
    with pytest.raises(ValueError, match="built for batch 4"):
        src.num_batches(8)
    batches = list(src)
    assert len(batches) == 3 and batches[0][0].dtype == np.uint8
    src.loader.close()
    assert list(src) == []  # a closed loader ends the epoch


def test_loader_refuses_bad_stores(store, tmp_path):
    (ip, mp), _, _ = store
    with pytest.raises(OSError, match="loader_create failed"):
        tn.NativeBatchLoader(str(tmp_path / "nope.u8"), mp, N, H, W, 4)
    with pytest.raises(OSError):  # a store shorter than N frames
        tn.NativeBatchLoader(ip, mp, N + 1, H, W, 4)
    with pytest.raises(OSError):  # drop_last leaves no step
        tn.NativeBatchLoader(ip, mp, N, H, W, N + 1, drop_last=True)
    with pytest.raises(ValueError, match="uint8"):
        tn.write_store(str(tmp_path / "f"), np.zeros((1, 2, 2, 1)),
                       np.zeros((1, 2, 2, 1), np.uint8))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Grayscale JPEGs of several sizes, and one RGB-encoded."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(48, 40), (20, 30), (64, 64), (33, 17)]):
        yy, xx = np.mgrid[0:h, 0:w]
        frame = (128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
                 + rng.normal(0, 20, (h, w))).clip(0, 255).astype(np.uint8)
        p = d / f"g{i}.jpg"
        Image.fromarray(frame, "L").save(p, quality=90)
        paths.append(str(p))
    rgb = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    Image.fromarray(rgb, "RGB").save(d / "rgb.jpg")
    return paths, str(d / "rgb.jpg")


def _pil(path_or_bytes, h, w):
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    return np.asarray(Image.open(src).convert("L").resize(
        (w, h), Image.BILINEAR), np.int16)


@pytest.mark.parametrize("h, w", [(32, 32), (17, 29)])
def test_decode_jpegs_bit_equal_to_jax_and_within_one_of_pil(jpegs, h, w):
    paths, rgb = jpegs
    got = tn.decode_jpegs(paths + [rgb], h, w, num_threads=3)
    np.testing.assert_array_equal(got, jn.decode_jpegs(paths + [rgb], h, w))
    assert got.shape == (len(paths) + 1, h, w, 1) and got.dtype == np.uint8
    for k, p in enumerate(paths):  # grayscale: PIL's resize within 1
        diff = np.abs(got[k, ..., 0].astype(np.int16) - _pil(p, h, w))
        assert diff.max() <= 1, (p, diff.max())


def test_decode_jpeg_bytes_bit_equal_to_jax_and_within_one_of_pil(jpegs):
    for p in jpegs[0]:
        data = open(p, "rb").read()
        got, size = tn.decode_jpeg_bytes(data, 32, 24)
        want, jsize = jn.decode_jpeg_bytes(data, 32, 24)
        np.testing.assert_array_equal(got, want)
        assert size == jsize == Image.open(p).size
        assert np.abs(got[..., 0].astype(np.int16)
                      - _pil(data, 32, 24)).max() <= 1


def test_decode_errors_raise(jpegs, tmp_path):
    paths, _ = jpegs
    with pytest.raises(OSError, match="1 of 2 files"):
        tn.decode_jpegs([paths[0], str(tmp_path / "missing.jpg")], 8, 8)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    with pytest.raises(OSError):
        tn.decode_jpegs([str(bad)], 8, 8)
    with pytest.raises(ValueError, match="native JPEG decode failed"):
        tn.decode_jpeg_bytes(b"not an image", 8, 8)
    with pytest.raises(ValueError):
        tn.decode_jpeg_bytes(open(paths[0], "rb").read()[:40], 8, 8)


def _tree(root):
    """(path, size, mtime) of the JAX package's files, leaving out what its
    own tests build (runtime/libhostloader.so, its lock) and caches."""
    out = set()
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f in ("libhostloader.so", ".build.lock"):
                continue
            p = os.path.join(dirpath, f)
            st = os.stat(p)
            out.add((p, st.st_size, st.st_mtime_ns))
    return out


def test_library_lands_under_build_and_leaves_ddti_tpu_alone(
        tmp_path, monkeypatch):
    """A fresh build goes to build/ddti_tpu_torch/ under a name that hashes
    the source and flags; it writes nothing under ddti_tpu/."""
    path = tn.build_library()
    assert path.parent == ROOT / "build" / "ddti_tpu_torch"
    assert path.name.startswith("libhostloader_") and path.exists()
    assert tn.library_path() != tn.library_path(tn.NO_JPEG)
    before = _tree(ROOT / "ddti_tpu")
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tn, "library_path",
                        lambda flags=(): tmp_path / "b" / (
                            "lib_nojpeg.so" if flags else "lib.so"))
    built = tn._compile((), ("-ljpeg",))
    assert built == tmp_path / "b" / "lib.so"
    assert not list((tmp_path / "b").glob("*.tmp"))
    assert _tree(ROOT / "ddti_tpu") == before


def test_a_libjpeg_build_that_does_not_load_falls_back_to_no_decode(
        tmp_path, monkeypatch, store):
    """A libjpeg build carried in ``build/`` to a machine without
    libjpeg.so (it fails to load): the library without decode is built
    and loaded instead, and decode says why it is absent."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "b")
    (tmp_path / "b").mkdir()
    stale = tn.library_path(())
    stale.write_bytes(b"not loadable here")
    real = ctypes.CDLL

    def cdll(path, *args, **kwargs):
        if path == str(stale):
            raise OSError("libjpeg.so.62: cannot open shared object file: "
                          "No such file or directory")
        return real(path, *args, **kwargs)

    monkeypatch.setattr(tn.ctypes, "CDLL", cdll)
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_no_decode_reason", None)
    assert tn.native_available() and not tn.decode_available()
    reason = tn.decode_available_reason()
    assert stale.name in reason and "libjpeg.so.62" in reason
    assert tn.library_path(tn.NO_JPEG).exists()
    (ip, mp), images, _ = store
    with tn.NativeBatchLoader(ip, mp, N, H, W, 5, seed=0) as ld:
        assert ld.next()[0].shape == (5, H, W, 1)


def test_without_jpeglib_the_loader_builds_and_says_decode_is_absent(
        tmp_path, monkeypatch, store):
    """Where the libjpeg build fails on its header, the library is built
    with -DDDTI_NO_JPEG: the loader works, decode says it is absent and
    raises, and decode_to_store's native path is skipped with a warning."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "b")
    real = tn._compile

    def no_header(flags, libs):
        if not flags:
            raise RuntimeError("host loader build failed (1): g++ ...\n"
                               "fatal error: jpeglib.h: No such file")
        return real(flags, libs)

    monkeypatch.setattr(tn, "_compile", no_header)
    monkeypatch.setattr(tn, "library_path",
                        lambda flags=(): tmp_path / "b" / "lib_nojpeg.so")
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_no_decode_reason", None)
    assert tn.native_available() and not tn.decode_available()
    assert "jpeglib.h" in tn.decode_available_reason()
    lib = ctypes.CDLL(str(tmp_path / "b" / "lib_nojpeg.so"))
    assert lib.host_loader_has_jpeg() == 0
    assert not hasattr(lib, "decode_jpegs")
    with pytest.raises(RuntimeError, match="decode is absent"):
        tn.decode_jpeg_bytes(b"\xff\xd8", 8, 8)
    (ip, mp), images, _ = store
    with tn.NativeBatchLoader(ip, mp, N, H, W, 5, seed=0) as ld:
        assert ld.next()[0].shape == (5, H, W, 1)
