"""The port's EDT (ddti_tpu_torch/ops/edt.py) against the JAX package's and
scipy's, on the CPU, where the port runs its plain version.

While h + w <= 4096 every value before the square root is an integer below
2^24, so all of them must agree bit for bit: the port's plain version with
the JAX Pallas kernel in interpret mode, with JAX's plain path (ragged W),
and with scipy on frames that have a zero. Past that the port keeps the
squared distances exact (float64) and agrees bit for bit with scipy's
float64 EDT as float32, while JAX's float32 sums round: it is held to
JAX within two float32 ulps there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy import ndimage

from ddti_tpu.ops import edt as jedt
from ddti_tpu_torch.ops import edt


def _masks(n, h, w, seed, p=0.15):
    """Blobby random masks: a few ellipses plus salt."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = rng.random((n, h, w)) < p * 0.1
    for i in range(n):
        for _ in range(3):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry = rng.uniform(1, max(2, h / 3))
            rx = rng.uniform(1, max(2, w / 3))
            out[i] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    return out.astype(np.uint8)


def _port(masks):
    return edt.edt_batch(torch.from_numpy(masks)).numpy()


@pytest.mark.parametrize("h,w", [(16, 128), (24, 256)])
def test_plain_matches_pallas_kernel_in_interpret_mode(h, w):
    m = _masks(2, h, w, seed=h)
    for img in m:
        g = jedt._column_pass(jnp.asarray(img) == 0)
        d2 = jedt._minplus_pallas(g * g, interpret=True)
        want = np.asarray(jnp.sqrt(jnp.minimum(d2, float((h + w) ** 2))))
        got = _port(img[None])[0]
        np.testing.assert_array_equal(got, want)
    # and the row pass alone, on the same squared column distances
    g = jedt._column_pass(jnp.asarray(m[0]) == 0)
    want = np.asarray(jedt._minplus_pallas(g * g, interpret=True))
    tg = edt._column_pass(torch.from_numpy(m[:1]) == 0)[0]
    np.testing.assert_array_equal(np.asarray(g), tg.numpy())
    np.testing.assert_array_equal(
        edt._minplus_reference(tg * tg).numpy(), want)


@pytest.mark.parametrize("h,w", [(33, 100), (17, 333), (1, 7), (9, 1)])
def test_plain_matches_jax_plain_path_on_ragged_shapes(h, w):
    m = _masks(3, h, w, seed=w)
    want = np.stack([np.asarray(jedt.distance_transform_edt(
        jnp.asarray(img), use_pallas=False)) for img in m])
    np.testing.assert_array_equal(_port(m), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.float32])
def test_plain_matches_scipy(dtype):
    m = _masks(4, 40, 52, seed=7)
    m[1] = 1
    m[1, 20, 30] = 0  # a single zero
    got = _port(m.astype(dtype))
    for i in range(len(m)):
        want = ndimage.distance_transform_edt(m[i]).astype(np.float32)
        np.testing.assert_array_equal(got[i], want)


def test_plain_square_root_is_correctly_rounded():
    """A single zero in a corner of a 512^2 frame: every sum of two squares
    below 2 * 511^2 appears as a squared distance, and the float32 root of
    each must be the correctly rounded one (scipy's, JAX's, the kernel's)."""
    m = np.ones((1, 512, 512), np.uint8)
    m[0, 0, 0] = 0
    want = ndimage.distance_transform_edt(m[0]).astype(np.float32)
    np.testing.assert_array_equal(_port(m)[0], want)


def test_all_foreground_caps_at_h_plus_w():
    m = np.ones((2, 12, 20), np.uint8)
    m[1, 3, 4] = 0
    got = _port(m)
    assert (got[0] == 32.0).all()
    want = ndimage.distance_transform_edt(m[1]).astype(np.float32)
    np.testing.assert_array_equal(got[1], want)
    # JAX caps the same way
    np.testing.assert_array_equal(
        got[0], np.asarray(jedt.distance_transform_edt(
            jnp.asarray(m[0]), use_pallas=False)))


def test_edt_batch_layouts():
    m = _masks(3, 20, 24, seed=3)
    flat = _port(m)
    four = edt.edt_batch(torch.from_numpy(m)[..., None])
    assert four.shape == (3, 20, 24, 1) and four.dtype == torch.float32
    np.testing.assert_array_equal(four[..., 0].numpy(), flat)
    want = np.asarray(jedt.edt_batch(jnp.asarray(m)[..., None]))
    np.testing.assert_array_equal(four.numpy(), want)
    one = edt.distance_transform_edt(torch.from_numpy(m[1]))
    np.testing.assert_array_equal(one.numpy(), flat[1])


def _far_masks(n, h, w, seed):
    """Frames past 2048 a side: foreground but for a zero at one end (the
    distances run the whole long side, squared past 2^24 where h + w >
    4096), then blobs and salt."""
    m = _masks(n, h, w, seed)
    m[0] = 1
    m[0, 0, 0] = 0
    return m


# JAX's float32 squared distances past 2^24 round to even: the root
# within two float32 ulps of the exact one
JAX_RTOL = 2 * 2.0 ** -23


@pytest.mark.parametrize("shape", [(1, 4, 4104), (2, 2100, 8),
                                   (2, 2049, 16)])
def test_plain_past_2048_matches_scipy_and_jax(shape):
    """Sides past 2048: bit-equal to scipy, and to JAX's plain path
    within JAX_RTOL (bit-equal where h + w <= 4096)."""
    m = _far_masks(*shape, seed=sum(shape))
    got = _port(m)
    h, w = shape[1:]
    for i in range(len(m)):
        want = ndimage.distance_transform_edt(m[i]).astype(np.float32)
        np.testing.assert_array_equal(got[i], want)
        jax_d = np.asarray(jedt.distance_transform_edt(
            jnp.asarray(m[i]), use_pallas=False))
        if h + w <= edt.F32_EXACT_SUM:
            np.testing.assert_array_equal(got[i], jax_d)
        else:
            np.testing.assert_allclose(got[i], jax_d, rtol=JAX_RTOL, atol=0)
    assert got[0].max() ** 2 > 2 ** 24 or h + w <= edt.F32_EXACT_SUM


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        edt.edt_cuda(torch.zeros(1, 4, 4, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# numpy models of csrc/edt.cu's integer arithmetic, held bit-equal to the
# plain version (the kernel itself is held to it on the card)

FAR = 1 << 20  # the kernel's kFar: no zero on that side


def _c_div(a, b):
    """C's int division (b > 0): the quotient truncated toward zero."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


STATS = dict(negative_numerators=0, largest_cross=0)


def _hidden_exact(a, ga, b, gb, c, gc):
    """csrc/edt.cu's hidden(): site b lies on the lower envelope of a < b
    < c nowhere that a or c does not, the separators' comparison
    cross-multiplied (the kernel's int64 products; Python's ints are
    exact)."""
    ab, bc = b * b - a * a + gb - ga, c * c - b * b + gc - gb
    STATS["negative_numerators"] += (ab < 0) + (bc < 0)
    STATS["largest_cross"] = max(STATS["largest_cross"], abs(ab * (c - b)),
                                 abs(bc * (b - a)))
    return ab * (c - b) >= bc * (b - a)


def _hidden_truncated(a, ga, b, gb, c, gc):
    """The same test on integer separators divided with C's truncation: a
    hazard where a numerator is negative."""
    ab, bc = b * b - a * a + gb - ga, c * c - b * b + gc - gb
    return int(_c_div(np.array(ab), 2 * (b - a))) >= int(
        _c_div(np.array(bc), 2 * (c - b)))


_hidden = _hidden_exact


def _row_shape(w):
    """csrc/edt.cu's row_shape: (columns a band, lanes a row)."""
    band, lanes = 2, 32
    while 32 * band < w:
        band *= 2
    while band < 32 and lanes > 4:
        band, lanes = band * 2, lanes // 2
    return band, lanes


def _banded_row(g, cap):
    """csrc/edt.cu's row pass on one row of column distances, step by step
    as its lanes run it: the kernel's bands (``_row_shape``), each band's
    stack of sites (columns with g < cap) built by the hidden() test, the
    merges of 1 + 1, 2 + 2, ... bands with each band's survivors a range
    [lo, hi) of its stack, then each band's columns by a walk from the
    nearest site on its left. Returns min(D^2, cap^2) as a list of ints."""
    w = len(g)
    band, nl = _row_shape(w)
    g = [int(x) for x in g]
    st = [[] for _ in range(nl)]
    for lane in range(nl):
        stack = st[lane]
        for k in range(lane * band, min(w, lane * band + band)):
            if g[k] >= cap:
                continue
            while len(stack) >= 2 and _hidden(
                    stack[-2], g[stack[-2]] ** 2, stack[-1],
                    g[stack[-1]] ** 2, k, g[k] ** 2):
                stack.pop()
            stack.append(k)
    lo, hi = [0] * nl, [len(x) for x in st]
    span = 1
    while span < nl:
        for lane in range(0, nl, 2 * span):
            end = lane + 2 * span
            tb, hb = lane + span - 1, lane + span
            while tb >= lane and hi[tb] == lo[tb]:
                tb -= 1
            while hb < end and hi[hb] == lo[hb]:
                hb += 1
            while tb >= lane and hb < end:
                t, h = st[tb][hi[tb] - 1], st[hb][lo[hb]]
                pb, pi = tb, hi[tb] - 2
                if pi < lo[tb]:
                    pb = tb - 1
                    while pb >= lane and hi[pb] == lo[pb]:
                        pb -= 1
                    pi = hi[pb] - 1 if pb >= lane else 0
                if pb >= lane:
                    p = st[pb][pi]
                    if _hidden(p, g[p] ** 2, t, g[t] ** 2, h, g[h] ** 2):
                        hi[tb] -= 1
                        if hi[tb] == lo[tb]:
                            tb = pb
                        continue
                nb, ni = hb, lo[hb] + 1
                if ni >= hi[hb]:
                    nb = hb + 1
                    while nb < end and hi[nb] == lo[nb]:
                        nb += 1
                    ni = lo[nb] if nb < end else 0
                if nb < end:
                    q = st[nb][ni]
                    if _hidden(t, g[t] ** 2, h, g[h] ** 2, q, g[q] ** 2):
                        lo[hb] += 1
                        if lo[hb] == hi[hb]:
                            hb = nb
                        continue
                break
        span *= 2
    full = [b for b in range(nl) if hi[b] > lo[b]]
    env = [s for b in full for s in st[b][lo[b]:hi[b]]]  # the envelope
    assert env == sorted(env)
    out = [cap * cap] * w
    if not env:
        return out
    f = lambda j, s: (j - s) ** 2 + g[s] ** 2  # noqa: E731
    for lane in range(nl):
        j0, j1 = lane * band, min(w, lane * band + band)
        if j0 >= w:
            continue
        left = [i for i, s in enumerate(env) if s < j0]
        c = left[-1] if left else 0
        while c > 0 and f(j0, env[c - 1]) <= f(j0, env[c]):
            c -= 1
        for j in range(j0, j1):
            while c + 1 < len(env) and f(j, env[c + 1]) <= f(j, env[c]):
                c += 1
            out[j] = min(f(j, env[c]), cap * cap)
    return out


def _row_model(g, cap):
    """``_banded_row`` over the rows of an (R, W) array -> int64."""
    return np.array([_banded_row(r, cap) for r in g], np.int64)


def _highest_bit(x):
    """63 - clz of each uint64 (only where x != 0 is it used; -1 at 0)."""
    hi = (x >> np.uint64(32)).astype(np.float64)
    lo = (x & np.uint64(0xffffffff)).astype(np.float64)
    top = np.where(hi > 0, 32 + np.floor(np.log2(np.maximum(hi, 1))),
                   np.floor(np.log2(np.maximum(lo, 1))))
    return np.where(x != 0, top, -1).astype(np.int64)


def _lowest_bit(x):
    return _highest_bit(x & (~x + np.uint64(1)))


def _column_model(zero):
    """The kernel's column pass on (N, H, W) bool (True where the mask is
    zero): 32 segments of ceil(H / 32) rows (a block's warps) keep a bit a
    zero row for each column; a thread a column turns the segments' first
    and last zeros into the last zero above each segment (a running max
    down) and the first below it (a running min up); each row's g comes
    from the bits."""
    n, h, w = zero.shape
    segs = 32
    seg = -(-h // segs)
    cap = h + w
    r0 = np.arange(segs) * seg
    bits = np.zeros((segs, n, w), np.uint64)
    for r in range(h):
        bits[r // seg] |= zero[:, r].astype(np.uint64) << np.uint64(r % seg)
    has = bits != 0
    at = r0[:, None, None]
    last = np.where(has, at + _highest_bit(bits), -FAR)
    first = np.where(has, at + _lowest_bit(bits), FAR)
    above = np.full_like(last, -FAR)
    below = np.full_like(first, FAR)
    for k in range(1, segs):
        above[k] = np.maximum(above[k - 1], last[k - 1])
        below[segs - 1 - k] = np.minimum(below[segs - k], first[segs - k])
    g = np.empty((n, h, w), np.int64)
    for r in range(h):
        sg, rel = divmod(r, seg)
        rest = bits[sg] >> np.uint64(rel)
        above[sg] = np.where(rest & np.uint64(1), r, above[sg])
        nxt = np.where(rest != 0, r + _lowest_bit(rest), below[sg])
        g[:, r] = np.minimum(np.minimum(r - above[sg], nxt - r), cap)
    return g


def _column_model_long(zero):
    """The kernel's column pass past 2048 rows (edt_column_long_kernel):
    the same 32 segments and scan, each segment's first and last zero from
    a read of its rows, then g downward from the last zero above it and
    upward, min'd, from the first zero below it."""
    n, h, w = zero.shape
    segs = 32
    seg = -(-h // segs)
    cap = h + w
    first = np.full((segs, n, w), FAR)
    last = np.full((segs, n, w), -FAR)
    for sg in range(segs):
        rows = zero[:, sg * seg:min(h, sg * seg + seg)]
        if rows.shape[1]:
            has = rows.any(1)
            first[sg] = np.where(has, sg * seg + rows.argmax(1), FAR)
            last[sg] = np.where(
                has, sg * seg + rows.shape[1] - 1 - rows[:, ::-1].argmax(1),
                -FAR)
    above = np.full_like(last, -FAR)
    below = np.full_like(first, FAR)
    for k in range(1, segs):
        above[k] = np.maximum(above[k - 1], last[k - 1])
        below[segs - 1 - k] = np.minimum(below[segs - k], first[segs - k])
    g = np.empty((n, h, w), np.int64)
    for sg in range(segs):
        r0, r1 = sg * seg, min(h, sg * seg + seg)
        a, b = above[sg].copy(), below[sg].copy()
        for r in range(r0, r1):
            a = np.where(zero[:, r], r, a)
            g[:, r] = np.minimum(r - a, cap)
        for r in range(r1 - 1, r0 - 1, -1):
            b = np.where(zero[:, r], r, b)
            g[:, r] = np.minimum(g[:, r], np.minimum(b - r, cap))
    return g


def _kernel_model(masks):
    """The whole kernel in numpy: float32 (N, H, W)."""
    n, h, w = masks.shape
    g = _column_model(masks == 0)
    d2 = _row_model(g.reshape(n * h, w), h + w).reshape(n, h, w)
    return np.sqrt(d2.astype(np.float32))


def _edge_frames(h, w):
    """All zeros, all ones (no zero: g = h + w), a single zero, a single
    nonzero pixel."""
    frames = np.stack([np.zeros((h, w)), np.ones((h, w)), np.ones((h, w)),
                       np.zeros((h, w))]).astype(np.uint8)
    frames[2, h // 2, w // 3] = 0
    frames[3, h // 3, w // 2] = 1
    return frames


@pytest.mark.parametrize("h,w", [(16, 128), (24, 256)])
def test_envelope_model_matches_pallas_kernel_in_interpret_mode(h, w):
    """The kernel's banded integer row pass bit-equal to JAX's Pallas
    min-plus kernel (interpret mode) and to the plain row pass, clamped at
    (h + w)^2, on the same column distances; masks with a column of no
    zero (g = h + w, no site) included."""
    m = _masks(2, h, w, seed=h + 1)
    m[1, :, w // 2] = 1
    cap2 = float((h + w) ** 2)
    for img in m:
        g = jedt._column_pass(jnp.asarray(img) == 0)
        want = np.minimum(np.asarray(jedt._minplus_pallas(
            g * g, interpret=True)), cap2)
        got = _row_model(np.asarray(g).astype(np.int64), h + w)
        np.testing.assert_array_equal(got.astype(np.float32), want)
        tg = edt._column_pass(torch.from_numpy(img[None]) == 0)[0]
        np.testing.assert_array_equal(torch.clamp(edt._minplus_reference(
            tg * tg), max=cap2).numpy(), got.astype(np.float32))


@pytest.mark.parametrize("h,w", [(5, 1), (6, 2), (7, 3), (33, 100),
                                 (17, 333), (40, 52), (1, 7), (64, 31)])
def test_kernel_model_matches_plain_on_ragged_and_narrow_shapes(h, w):
    """W = 1, 2, 3 and ragged W, with the edge frames and random masks."""
    m = np.concatenate([_edge_frames(h, w), _masks(3, h, w, seed=h * w)])
    np.testing.assert_array_equal(_kernel_model(m), _port(m))


def test_negative_separator_numerators_need_the_exact_comparison():
    """Where a site with a large g precedes one with a small g, the
    abscissa from which the second beats the first has a negative
    numerator; there C's truncating division is not the floor. The model
    meets such numerators and stays bit-equal to the plain row pass with
    the kernel's cross-multiplied comparison. With separators divided by
    truncation in its place it drops a site that owns column 0: g = (3,
    cap, 2, 0) puts the abscissae of sites 0 | 2 and 2 | 3 at -1/4 and 1/2,
    both truncated to 0, so site 2 (8 at column 0, against 9 and 9) looks
    hidden."""
    global _hidden
    m = _masks(6, 48, 96, seed=11)
    m[:, ::9, :] = 1                # sparse zeros: large g beside small
    cap = 48 + 96
    rows = edt._column_pass(torch.from_numpy(m) == 0).reshape(-1, 96)
    rows[0] = cap
    rows[0, :4] = torch.tensor([3, cap, 2, 0])
    want = torch.clamp(edt._minplus_reference(rows * rows),
                       max=float(cap * cap)).numpy()
    rows = rows.numpy().astype(np.int64)
    STATS["negative_numerators"] = 0
    np.testing.assert_array_equal(
        _row_model(rows, cap).astype(np.float32), want)
    assert STATS["negative_numerators"] > 0
    assert want[0, 0] == 8
    _hidden = _hidden_truncated
    try:
        trunc = _row_model(rows, cap)
    finally:
        _hidden = _hidden_exact
    assert trunc[0, 0] == 9
    np.testing.assert_array_equal(trunc[1:].astype(np.float32), want[1:])


def test_kernel_model_at_the_largest_side():
    """W = H = 2048: 64 rows a segment (64-bit words) in the column model
    over the whole frame, and the row model on its extreme rows and on a
    frame with no zero (every column capped, no site): the cross products
    stay below 2^35 (int64) and the model agrees with the plain version."""
    h = w = 2048
    m = np.ones((2, h, w), np.uint8)
    m[0, h - 1, 0] = m[0, 0, w - 1] = 0
    m[0, 1000:1010, 1500] = 0
    m[0, 5, 3:2040:97] = 0
    zero = torch.from_numpy(m) == 0
    g = edt._column_pass(zero)
    np.testing.assert_array_equal(_column_model(m == 0).astype(np.float32),
                                  g.numpy())
    cap = h + w
    STATS["largest_cross"] = 0
    for img, row in ((0, 0), (0, 5), (0, 999), (0, 1005), (0, h - 1),
                     (1, 0)):
        r = g[img, row:row + 1]
        plain = torch.clamp(edt._minplus_reference(r * r),
                            max=float(cap * cap)).numpy()
        model = _row_model(r.numpy().astype(np.int64), cap)
        np.testing.assert_array_equal(model.astype(np.float32), plain)
    assert 2 ** 30 < STATS["largest_cross"] < 2 ** 35
    np.testing.assert_array_equal(np.sqrt(model[0].astype(np.float32)),
                                  np.full(w, cap, np.float32))


@pytest.mark.parametrize("h", [1, 31, 32, 33, 64, 95, 100, 512, 1025, 2048])
def test_column_model_matches_plain_column_pass(h):
    """The segmented column pass bit-equal to ``_column_pass``: H below,
    at and past a multiple of the 32 segments, zeros planted on segments'
    first and last rows, columns with no zero and all-zero columns."""
    w = 24
    rng = np.random.default_rng(h)
    m = (rng.random((2, h, w)) > 0.02).astype(np.uint8)
    seg = -(-h // 32)
    m[0, ::seg, 3] = 0            # each segment's first row
    m[0, seg - 1::seg, 5] = 0     # each segment's last row
    m[:, :, 7] = 1                # no zero
    m[:, :, 9] = 0                # all zeros
    m[1, h - 1, 11] = 0           # only the last row
    m[1, 0, 12] = 0               # only the first row
    want = edt._column_pass(torch.from_numpy(m) == 0).numpy()
    np.testing.assert_array_equal(_column_model(m == 0).astype(np.float32),
                                  want)


@pytest.mark.parametrize("h", [2049, 2100, 4100])
def test_long_column_model_matches_plain_column_pass(h):
    """The column pass past 2048 rows, where a segment outgrows a 64-bit
    word: the three-read form bit-equal to ``_column_pass``, with zeros on
    segments' first and last rows, columns with no zero, all-zero columns
    and a zero on the first or last row only."""
    w = 12
    rng = np.random.default_rng(h)
    m = (rng.random((2, h, w)) > 0.002).astype(np.uint8)
    seg = -(-h // 32)
    m[0, ::seg, 3] = 0
    m[0, seg - 1::seg, 5] = 0
    m[:, :, 7] = 1
    m[:, :, 9] = 0
    m[1, h - 1, 10] = 0
    m[1, 0, 11] = 0
    want = edt._column_pass(torch.from_numpy(m) == 0).numpy()
    np.testing.assert_array_equal(
        _column_model_long(m == 0).astype(np.float32), want)


def test_row_model_int32_bounds_at_the_largest_frame():
    """h + w = 46340 (the kernel's bound) at its widest row, w = 32768:
    the row model against the exact minimum over the row's sites, and the
    quantities the kernel keeps in int32 (the separators' numerators, the
    parabolas' values, cap^2) below 2^31; their cross products need the
    int64 hidden()."""
    w = 32768
    h = edt.MAX_SUM - w
    cap = h + w
    rng = np.random.default_rng(3)
    g = np.full(w, cap, np.int64)
    sites = np.sort(rng.choice(w, 40, replace=False))
    g[sites] = rng.integers(0, h, 40)
    g[sites[:2]] = h - 1, 0
    k = np.arange(w)
    want = np.minimum(((k[None] - sites[:, None]) ** 2
                       + g[sites][:, None] ** 2).min(0), cap * cap)
    STATS["largest_cross"] = 0
    np.testing.assert_array_equal(_row_model(g[None], cap)[0], want)
    # every numerator is a difference of two parabolas' values at 0
    values = k[:, None] ** 2 + g[None, sites] ** 2
    assert values.max() < 2 ** 31 and cap * cap < 2 ** 31
    assert want.max() < 2 ** 31
    assert STATS["largest_cross"] >= 2 ** 31


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 33), st.integers(1, 70), st.integers(0, 2 ** 32 - 1),
       st.floats(0.0, 1.0))
def test_kernel_model_matches_plain_on_drawn_masks(h, w, seed, p):
    """Hypothesis-drawn shapes and densities of zeros."""
    m = (np.random.default_rng(seed).random((2, h, w)) >= p).astype(np.uint8)
    np.testing.assert_array_equal(_kernel_model(m), _port(m))


def test_edt_column_widths_fixes_the_load_width():
    """The diagnostic ``probes/edt_column_widths.py`` still finds the
    launch's choice of width in csrc/edt.cu exactly once and replaces it by
    each width the column pass is built for; a source that lost it
    raises."""
    from ddti_tpu_torch.probes import edt_column_widths as CW

    text = (CW.PKG / "csrc" / "edt.cu").read_text()
    for v in CW.WIDTHS:
        assert f"launch_columns<{v}>" in text
        forced = CW.forced_source(text, v)
        assert f"  const int v = {v};\n" in forced
        assert forced.count("column_bytes(") == text.count("column_bytes(") - 1
    with pytest.raises(ValueError):
        CW.forced_source(text.replace(CW.ANCHOR, ""), 4)
