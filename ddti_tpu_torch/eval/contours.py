"""Marching-squares iso-contour extraction, a copy of
``ddti_tpu/eval/contours.py`` (numpy only; the port keeps its own copy so
that it imports nothing of the JAX package).

Produces closed/open contours of a 2D scalar field at a given level as
(row, col) float vertex arrays with linear interpolation along cell edges —
the convention of ``skimage.measure.find_contours`` (scikit-image is not a
dependency). Used by the infer CLI's ``--overlay`` and the daemon's
``?overlay=1``.

Implementation: vectorized numpy cell classification + segment generation,
then a dict-based walk to chain segments into polylines. For binary masks
(the only use here) ambiguous saddle cells are resolved like skimage's
default ('low' connectivity for vertices above the level).
"""

from __future__ import annotations

import numpy as np


def _interp(level, v0, v1):
    # fraction along the edge from the v0 endpoint where the level crossing
    # sits; edges without a crossing are computed too (then discarded), so
    # guard the degenerate equal-endpoint case
    d = v1 - v0
    if d == 0.0:
        return 0.5
    return (level - v0) / d


def find_contours(array: np.ndarray, level: float = 0.5) -> list[np.ndarray]:
    """Iso-contours of ``array`` at ``level`` as a list of (K, 2) float64
    arrays of (row, col) coordinates."""
    a = np.asarray(array, np.float64)
    h, w = a.shape
    if h < 2 or w < 2:
        return []

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
    segments: list[tuple[tuple, tuple]] = []

    for y, x in zip(ys, xs):
        c = case[y, x]
        vtl, vtr = a[y, x], a[y, x + 1]
        vbl, vbr = a[y + 1, x], a[y + 1, x + 1]
        # edge crossing points (row, col):
        top = (y, x + _interp(level, vtl, vtr))
        bottom = (y + 1, x + _interp(level, vbl, vbr))
        left = (y + _interp(level, vtl, vbl), x)
        right = (y + _interp(level, vtr, vbr), x + 1)
        # segments oriented so higher values are on the LEFT of travel
        # (skimage convention, 'positive' orientation for default params)
        if c == 1:
            segments.append((bottom, left))
        elif c == 2:
            segments.append((right, bottom))
        elif c == 3:
            segments.append((right, left))
        elif c == 4:
            segments.append((top, right))
        elif c == 5:  # saddle: tr and bl above, center treated as BELOW
            # (skimage default): wrap each high corner separately — the
            # tr piece pairs like case 4, the bl piece like case 1
            segments.append((top, right))
            segments.append((bottom, left))
        elif c == 6:
            segments.append((top, bottom))
        elif c == 7:
            segments.append((top, left))
        elif c == 8:
            segments.append((left, top))
        elif c == 9:
            segments.append((bottom, top))
        elif c == 10:  # saddle: tl and br above, center treated as below —
            # tl piece pairs like case 8, br piece like case 2
            segments.append((left, top))
            segments.append((right, bottom))
        elif c == 11:
            segments.append((right, top))
        elif c == 12:
            segments.append((left, right))
        elif c == 13:
            segments.append((bottom, right))
        elif c == 14:
            segments.append((left, bottom))

    # drop degenerate zero-length segments (contour passing exactly through
    # a grid vertex produces them) — they would break the chain walk
    segments = [(s, e) for s, e in segments if s != e]

    # chain segments: start -> end adjacency (and the reverse, so backward
    # extension is O(1) per vertex instead of a rescan of all segments)
    starts: dict[tuple, list[int]] = {}
    ends: dict[tuple, list[int]] = {}
    for i, (s, e) in enumerate(segments):
        starts.setdefault(s, []).append(i)
        ends.setdefault(e, []).append(i)
    used = np.zeros(len(segments), bool)
    contours = []

    for i in range(len(segments)):
        if used[i]:
            continue
        chain = [segments[i][0], segments[i][1]]
        used[i] = True
        # extend forward
        while True:
            nxt = None
            for j in starts.get(chain[-1], ()):
                if not used[j]:
                    nxt = j
                    break
            if nxt is None:
                break
            used[nxt] = True
            chain.append(segments[nxt][1])
        # extend backward (segments whose end == chain[0])
        head = []
        while True:
            prv = None
            for j in ends.get(chain[0] if not head else head[-1], ()):
                if not used[j]:
                    prv = j
                    break
            if prv is None:
                break
            used[prv] = True
            head.append(segments[prv][0])
        if head:
            chain = list(reversed(head)) + chain
        arr = np.array(chain, np.float64)
        # collapse consecutive duplicate vertices
        if len(arr) > 1:
            keep = np.ones(len(arr), bool)
            keep[1:] = np.any(arr[1:] != arr[:-1], axis=1)
            arr = arr[keep]
        if len(arr) >= 2:
            contours.append(arr)
    return contours
