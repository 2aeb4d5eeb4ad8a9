"""The port's test-phase figures (ddti_tpu_torch/eval/visualize.py,
eval/confusion.py, Trainer.test) against the JAX package's on the CPU:
``save_boundary_grids`` writes the same files as JAX's
(``test_boundaries_<k>.png``, one every ``per_fig`` frames) with
matplotlib and with its Pillow composition, the figures decode at the
layout's size with both contour colours drawn, the contours they trace
are JAX's bit for bit (eval/contours.py), and the confusion plot takes
JAX's file name. Tolerance: none (contours, file names, counts and sizes
are compared exactly; pixels are not compared across renderers).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from ddti_tpu.eval.confusion import save_confusion_matrix as jconfusion
from ddti_tpu.eval.visualize import save_boundary_grids as jgrids
from ddti_tpu_torch.eval import visualize
from ddti_tpu_torch.eval.confusion import save_confusion_matrix
from ddti_tpu_torch.eval.visualize import save_boundary_grids

RENDERERS = ["matplotlib", "pillow"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(params=RENDERERS)
def renderer(request, monkeypatch):
    """Each renderer in turn: matplotlib where it imports (here), Pillow
    as where it does not (the card's machine)."""
    if request.param == "pillow":
        monkeypatch.setattr(visualize, "_have_matplotlib", lambda: False)
    return request.param


def _frames(n, size=16, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, size, size)).astype(np.float32)
    masks = (rng.random((n, size, size)) > 0.7).astype(np.uint8)
    preds = (rng.random((n, size, size)) > 0.6).astype(np.uint8)
    return imgs, masks, preds


@pytest.mark.parametrize("n, per_fig", [(25, 20), (25, 24), (25, 6),
                                        (20, 20), (1, 20)])
def test_grid_files_match_jax(tmp_path, renderer, n, per_fig):
    """The same file names, in the same order, as JAX's for N frames at
    ``per_fig`` (N = 25 at the default 20: two grids)."""
    imgs, masks, preds = _frames(n)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jgrids(imgs, masks, preds, str(tmp_path / "jax"), per_fig=per_fig)
    got = save_boundary_grids(imgs, masks, preds, str(tmp_path / "port"),
                              per_fig=per_fig)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for p in got:
        with Image.open(p) as im:
            im.load()


def _field(kind, seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(2, 48, 2)
    return {"binary": lambda: (rng.random((h, w)) > 0.5).astype(np.uint8),
            "sparse": lambda: (rng.random((h, w)) > 0.9).astype(np.float32),
            "soft": lambda: rng.random((h, w)),
            "at level": lambda: rng.choice([0.0, 0.5, 1.0], (h, w)),
            "quarters": lambda: np.round(rng.random((h, w)) * 4) / 4}[kind]()


@pytest.mark.parametrize("kind", ["binary", "sparse", "soft", "at level",
                                  "quarters"])
def test_contours_equal_jax_bit_for_bit(kind):
    """The port's find_contours (vectorized segments, an integer walk where
    every crossing lies strictly inside its edge, else the walk over the
    points) gives JAX's contours, in JAX's order, bit for bit: binary and
    soft fields, values at the level, at four levels, 40 fields each."""
    from ddti_tpu.eval.contours import find_contours as jfind
    from ddti_tpu_torch.eval.contours import find_contours

    n = 0
    for seed in range(40):
        a = _field(kind, seed)
        for level in (0.5, 0.25, 0.0, 1.0):
            want, got = jfind(a, level), find_contours(a, level)
            assert len(got) == len(want), (seed, level)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
            n += len(got)
    assert n > 0


def test_contours_of_a_speckled_frame_equal_jax():
    """A 256^2 speckled prediction (thousands of contours): the same
    contours as JAX's."""
    from ddti_tpu.eval.contours import find_contours as jfind
    from ddti_tpu_torch.eval.contours import find_contours

    m = (np.random.default_rng(3).random((256, 256)) < 0.5).astype(np.uint8)
    want, got = jfind(m, 0.5), find_contours(m, 0.5)
    assert len(got) == len(want) > 1000
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _shapes(kind, seed, h=48, w=56):
    """Binary fields whose contours are all closed (nested rings inside the
    frame) or mostly open (discs centred off the frame, cut by its
    border)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    f = np.zeros((h, w), bool)
    for _ in range(rng.integers(1, 5)):
        if kind == "rings":
            cy, cx = rng.uniform(12, h - 12), rng.uniform(12, w - 12)
            r = np.hypot(yy - cy, xx - cx)
            f ^= (r < rng.uniform(6, 11)) & (r > rng.uniform(1, 5))
        else:
            cy, cx = rng.choice([-4.0, h + 3.0]), rng.uniform(0, w)
            f ^= np.hypot(yy - cy, xx - cx) < rng.uniform(8, 30)
    return f.astype(np.float32)


@pytest.mark.parametrize("kind", ["rings", "border cuts"])
def test_contour_chains_equal_jax_on_closed_and_open_contours(kind):
    """find_contours orders its chains by list ranking (a closed contour
    opened at its smallest segment, an open one from its first): JAX's
    walk's contours, in its order, bit for bit, 30 fields each."""
    from ddti_tpu.eval.contours import find_contours as jfind
    from ddti_tpu_torch.eval.contours import find_contours

    closed = n = 0
    for seed in range(30):
        a = _shapes(kind, seed)
        want, got = jfind(a, 0.5), find_contours(a, 0.5)
        assert len(got) == len(want), seed
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), seed
            closed += bool(np.array_equal(g[0], g[-1]))
        n += len(got)
    assert n > 30 and (closed == n if kind == "rings" else closed < n)


def test_contour_table_is_the_contours_end_to_end():
    """contour_table, which the Pillow grid draws from, holds
    find_contours' contours one after another, with their lengths."""
    from ddti_tpu_torch.eval.contours import contour_table, find_contours

    m = (np.random.default_rng(5).random((96, 80)) < 0.5).astype(np.uint8)
    pts, sizes = contour_table(m, 0.5)
    want = find_contours(m, 0.5)
    assert sizes.tolist() == [len(c) for c in want] and min(sizes) >= 2
    assert np.array_equal(pts, np.concatenate(want))
    pts, sizes = contour_table(np.zeros((8, 8)), 0.5)
    assert pts.shape == (0, 2) and sizes.shape == (0,)


def test_pillow_grid_layout_and_colours(tmp_path, monkeypatch):
    """The Pillow composition: 4 x 400 by 5 x 400 pixels at per_fig 20,
    the frame in gray, ground-truth contours blue, predictions red."""
    monkeypatch.setattr(visualize, "_have_matplotlib", lambda: False)
    size = 32
    yy, xx = np.mgrid[0:size, 0:size]
    img = (xx / size).astype(np.float32)[None]
    gt = (((yy - 16) ** 2 + (xx - 16) ** 2) < 64).astype(np.uint8)[None]
    pred = (((yy - 12) ** 2 + (xx - 20) ** 2) < 49).astype(np.uint8)[None]
    (path,) = save_boundary_grids(img, gt, pred, str(tmp_path))
    with Image.open(path) as im:
        a = np.asarray(im.convert("RGB"))
    assert a.shape == (5 * 400, 4 * 400, 3)
    blue = (a[..., 2] == 255) & (a[..., 0] == 0) & (a[..., 1] == 0)
    red = (a[..., 0] == 255) & (a[..., 1] == 0) & (a[..., 2] == 0)
    assert blue.sum() > 100 and red.sum() > 100
    assert not blue[:, 400:].any() and not red[400:].any()  # panel 0 only
    gray = (a[..., 0] == a[..., 1]) & (a[..., 1] == a[..., 2])
    assert gray[20:380, 20:380].mean() > 0.8


def test_default_renderer_falls_back_to_pillow(tmp_path, monkeypatch):
    """Without matplotlib the grids are still written, by Pillow."""
    called = []
    monkeypatch.setattr(visualize, "_have_matplotlib", lambda: False)
    real = visualize._figure_pillow
    monkeypatch.setattr(visualize, "_figure_pillow",
                        lambda *a: called.append(1) or real(*a))
    paths = save_boundary_grids(*_frames(3), str(tmp_path))
    assert called == [1] and len(paths) == 1 and os.path.exists(paths[0])


def test_confusion_plot_takes_jax_file_name(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jconfusion(10, 2, 3, 85, str(tmp_path / "jax"), 4)
    got = save_confusion_matrix(10.0, 2.0, 3.0, 85.0, str(tmp_path / "port"),
                                4)
    assert os.path.basename(got) == os.path.basename(want) == \
        "epoch_5_confusion_matrix.png"
    with Image.open(got) as im:
        im.load()


def test_trainer_test_writes_the_grids(tmp_path):
    """Trainer.test() draws the test split's frames (8: one grid) and
    logs the render time; visualize=False draws none."""
    from test_torch_lifecycle import _trainer

    tr = _trainer(tmp_path / "a", epochs=1)
    tr.test()
    assert sorted(f for f in os.listdir(tr.config.result_dir)
                  if f.startswith("test_boundaries")) == [
        "test_boundaries_0.png"]
    with open(os.path.join(tr.config.log_dir, "log.log")) as f:
        assert "Contour grids: 8 frames in" in f.read()
    tr2 = _trainer(tmp_path / "b", epochs=1)
    tr2.test(visualize=False)
    assert not any(f.startswith("test_boundaries")
                   for f in os.listdir(tr2.config.result_dir))
