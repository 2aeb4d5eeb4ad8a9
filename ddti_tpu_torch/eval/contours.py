"""Marching-squares iso-contour extraction, a copy of
``ddti_tpu/eval/contours.py`` (numpy only; the port keeps its own copy so
that it imports nothing of the JAX package).

Produces closed/open contours of a 2D scalar field at a given level as
(row, col) float vertex arrays with linear interpolation along cell edges —
the convention of ``skimage.measure.find_contours`` (scikit-image is not a
dependency). Used by the infer CLI's ``--overlay`` and the daemon's
``?overlay=1``.

Implementation: vectorized numpy cell classification + segment generation,
then a walk to chain segments into polylines: through integer successor
links where every crossing lies strictly inside its grid edge and no
point starts or ends two segments (binary masks always), else through
dicts of the points themselves; both give the JAX copy's contours, in its
order, bit for bit. Ambiguous saddle cells are resolved like skimage's
default ('low' connectivity for vertices above the level). Also used by
the Trainer's test-phase grids (``eval/visualize.py``).
"""

from __future__ import annotations

import numpy as np


# the segments of each marching-squares case, oriented so that higher
# values lie on the LEFT of travel (skimage's 'positive' orientation), as
# (start edge, end edge); edges 0 top, 1 bottom, 2 left, 3 right. The two
# saddles (5, 10) treat the centre as below the level (skimage's default)
# and wrap each high corner apart: a second segment, drawn after the first
_FIRST = np.array([[0, 0], [1, 2], [3, 1], [3, 2], [0, 3], [0, 3], [0, 1],
                   [0, 2], [2, 0], [1, 0], [2, 0], [3, 0], [2, 3], [1, 3],
                   [2, 1], [0, 0]])
_SECOND = {5: (1, 2), 10: (3, 1)}


def _frac(level, v0, v1):
    """Where along each edge, from its v0 end, the level crossing sits;
    0.5 on an edge whose ends are equal (computed for every edge, then
    discarded where it has no crossing)."""
    d = v1 - v0
    out = np.full(d.shape, 0.5)
    np.divide(level - v0, d, out=out, where=d != 0.0)
    return out


def _segments(a: np.ndarray, level: float):
    """Every mixed cell's segments, cells in row-major order, as (starts,
    ends, start_edges, end_edges, inside): (n, 2) float64 (row, col)
    points, the id of the grid edge each lies on, and whether every point
    lies strictly inside its edge, in which case two points are equal
    exactly when they lie on the same edge (the two cells beside an edge
    compute its crossing from the same two values)."""
    h, w = a.shape
    tl = a[:-1, :-1]
    tr = a[:-1, 1:]
    bl = a[1:, :-1]
    br = a[1:, 1:]
    # cell case index: 4 bits (tl, tr, br, bl) above level
    case = ((tl > level).astype(np.uint8) << 3 |
            (tr > level).astype(np.uint8) << 2 |
            (br > level).astype(np.uint8) << 1 |
            (bl > level).astype(np.uint8))
    ys, xs = np.nonzero((case != 0) & (case != 15))
    c = case[ys, xs]
    vtl, vtr = tl[ys, xs], tr[ys, xs]
    vbl, vbr = bl[ys, xs], br[ys, xs]
    y, x = ys.astype(np.float64), xs.astype(np.float64)
    top, bottom = x + _frac(level, vtl, vtr), x + _frac(level, vbl, vbr)
    left, right = y + _frac(level, vtl, vbl), y + _frac(level, vtr, vbr)
    # the crossing on each edge of each cell: (edge, cell, row/col)
    pts = np.stack([np.stack([y, top], -1), np.stack([y + 1, bottom], -1),
                    np.stack([left, x], -1), np.stack([right, x + 1], -1)])
    inside = np.stack([(x < top) & (top < x + 1),
                       (x < bottom) & (bottom < x + 1),
                       (y < left) & (left < y + 1),
                       (y < right) & (right < y + 1)])
    # grid edge ids: horizontal (r, c) -> r * (w - 1) + c, then vertical
    # (r, c) -> h * (w - 1) + r * w + c
    ids = np.stack([ys * (w - 1) + xs, (ys + 1) * (w - 1) + xs,
                    h * (w - 1) + ys * w + xs, h * (w - 1) + ys * w + xs + 1])
    saddle = (c == 5) | (c == 10)
    second = np.where((c == 5)[:, None], _SECOND[5], _SECOND[10])
    # a saddle's second segment follows its first
    at = np.arange(len(c)) + np.cumsum(saddle) - saddle
    edges = np.empty((len(c) + int(saddle.sum()), 2), np.int64)
    cells = np.empty(len(edges), np.int64)
    edges[at], cells[at] = _FIRST[c], np.arange(len(c))
    edges[at[saddle] + 1] = second[saddle]
    cells[at[saddle] + 1] = np.flatnonzero(saddle)
    s_e, e_e = edges[:, 0], edges[:, 1]
    return (pts[s_e, cells], pts[e_e, cells], ids[s_e, cells],
            ids[e_e, cells], bool(inside[s_e, cells].all()
                                  and inside[e_e, cells].all()))


def _chains_by_edge(start_edges, end_edges):
    """The dict walk's chains, where every point is a distinct edge's and
    starts and ends at most one segment each: from the first unused
    segment, forward through the segment starting where the chain ends,
    then backward through the one ending where it starts. Returns (head
    segments, nearest first, [segment, forward segments...]) pairs; None
    where a point starts or ends two segments."""
    n_ids = int(max(start_edges.max(), end_edges.max())) + 1
    if (np.bincount(start_edges, minlength=n_ids).max() > 1
            or np.bincount(end_edges, minlength=n_ids).max() > 1):
        return None
    start_of = np.full(n_ids, -1)
    end_of = np.full(n_ids, -1)
    start_of[start_edges] = np.arange(len(start_edges))
    end_of[end_edges] = np.arange(len(end_edges))
    succ = start_of[end_edges].tolist()
    pred = end_of[start_edges].tolist()
    used = [False] * len(succ)
    out = []
    for i in range(len(succ)):
        if used[i]:
            continue
        used[i] = True
        fwd, j = [i], succ[i]
        while j >= 0 and not used[j]:
            used[j] = True
            fwd.append(j)
            j = succ[j]
        head, j = [], pred[i]
        while j >= 0 and not used[j]:
            used[j] = True
            head.append(j)
            j = pred[j]
        out.append((head, fwd))
    return out


def _chains_by_point(starts, ends):
    """The dict walk over the points themselves, for any input: chain
    segments start -> end (and the reverse, so that backward extension is
    O(1) a vertex), the first unused segment of a point first."""
    s_pts = [tuple(p) for p in starts.tolist()]
    e_pts = [tuple(p) for p in ends.tolist()]
    by_start: dict[tuple, list[int]] = {}
    by_end: dict[tuple, list[int]] = {}
    for i, (s, e) in enumerate(zip(s_pts, e_pts)):
        by_start.setdefault(s, []).append(i)
        by_end.setdefault(e, []).append(i)
    used = [False] * len(s_pts)
    out = []
    for i in range(len(s_pts)):
        if used[i]:
            continue
        used[i] = True
        fwd = [i]
        while True:
            nxt = next((j for j in by_start.get(e_pts[fwd[-1]], ())
                        if not used[j]), None)
            if nxt is None:
                break
            used[nxt] = True
            fwd.append(nxt)
        head = []
        while True:
            at = s_pts[head[-1] if head else i]
            prv = next((j for j in by_end.get(at, ()) if not used[j]), None)
            if prv is None:
                break
            used[prv] = True
            head.append(prv)
        out.append((head, fwd))
    return out


def find_contours(array: np.ndarray, level: float = 0.5) -> list[np.ndarray]:
    """Iso-contours of ``array`` at ``level`` as a list of (K, 2) float64
    arrays of (row, col) coordinates."""
    a = np.asarray(array, np.float64)
    h, w = a.shape
    if h < 2 or w < 2:
        return []
    starts, ends, s_edges, e_edges, inside = _segments(a, float(level))
    # drop degenerate zero-length segments (contour passing exactly through
    # a grid vertex produces them) — they would break the chain walk
    keep = np.any(starts != ends, axis=1)
    starts, ends = starts[keep], ends[keep]
    if not len(starts):
        return []
    chains = (_chains_by_edge(s_edges[keep], e_edges[keep]) if inside
              else None)
    if chains is None:
        chains = _chains_by_point(starts, ends)
    # each chain's points: its head's starts (farthest first), its first
    # segment's start, then every forward segment's end; all chains at once
    # in a table of the starts followed by the ends
    n = len(starts)
    idx, lens = [], []
    for head, fwd in chains:
        part = head[::-1] + fwd[:1] + [n + j for j in fwd]
        idx.extend(part)
        lens.append(len(part))
    pts = np.concatenate([starts, ends])[np.asarray(idx)]
    first = np.zeros(len(pts), bool)
    first[np.cumsum([0] + lens[:-1])] = True
    # collapse consecutive duplicate vertices within a chain
    keep = first.copy()
    keep[1:] |= np.any(pts[1:] != pts[:-1], axis=1)
    sizes = np.add.reduceat(keep, np.flatnonzero(first))
    pts = pts[keep]
    return [c for c in np.split(pts, np.cumsum(sizes)[:-1]) if len(c) >= 2]
