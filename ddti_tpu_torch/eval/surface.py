"""Surface-distance metrics (HD, HD95, ASSD), ported from
``ddti_tpu/eval/surface.py``; the test phase's second caller of the EDT.

Conventions of ``medpy.metric.binary``, as in the JAX package: surface =
foreground minus its 4-connected binary erosion with a zero border;
directed distances = the exact EDT of the other mask's surface sampled at
this mask's surface pixels; ``hd`` / ``hd95`` (numpy linear interpolation)
/ ``assd`` = max / 95th percentile / mean of the union of both directed
multisets. Undefined (NaN, ``valid`` 0) when either surface is empty.

Batched over the leading axis: the JAX package vmaps one image pair; here
both EDTs of a batch run as one ``edt_batch`` call (one kernel launch).
"""

from __future__ import annotations

import torch

from ddti_tpu_torch.ops.edt import edt_batch


def boundary_map(mask: torch.Tensor) -> torch.Tensor:
    """Surface pixels of (..., H, W) masks: foreground minus its
    4-connected erosion (zero border: edge foreground counts as surface)."""
    m = mask.to(torch.bool)
    false_row = torch.zeros_like(m[..., :1, :])
    false_col = torch.zeros_like(m[..., :, :1])
    up = torch.cat([m[..., 1:, :], false_row], dim=-2)
    down = torch.cat([false_row, m[..., :-1, :]], dim=-2)
    left = torch.cat([m[..., :, 1:], false_col], dim=-1)
    right = torch.cat([false_col, m[..., :, :-1]], dim=-1)
    eroded = m & up & down & left & right
    return m & ~eroded


def _percentile_sorted(sorted_vals: torch.Tensor, n: torch.Tensor,
                       q: float) -> torch.Tensor:
    """q-th percentile (numpy linear interpolation) of the first ``n[b]``
    entries of each ascending row ``sorted_vals[b]`` (tail = +inf)."""
    rank = q / 100.0 * (torch.clamp(n, min=1) - 1).to(torch.float32)
    lo = torch.floor(rank).to(torch.int64)
    hi = torch.ceil(rank).to(torch.int64)
    frac = rank - lo.to(torch.float32)
    v_lo = sorted_vals.gather(-1, lo[..., None])[..., 0]
    v_hi = sorted_vals.gather(-1, hi[..., None])[..., 0]
    return v_lo * (1.0 - frac) + v_hi * frac


def surface_distance_stats(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """HD / HD95 / ASSD between (N, H, W) bool pred/gt masks. Returns
    ``{"hd", "hd95", "assd", "valid"}`` of (N,) float32; the distances are
    NaN where ``valid`` is 0 (either surface empty)."""
    n_img = pred.shape[0]
    pb = boundary_map(pred)
    gb = boundary_map(gt)
    n_p = pb.sum(dim=(1, 2))
    n_g = gb.sum(dim=(1, 2))
    valid = (n_p > 0) & (n_g > 0)
    # EDT input: nonzero -> distance to the nearest zero, so zeros AT the
    # other surface give every pixel its distance to that surface
    dist = edt_batch(torch.cat([~gb, ~pb]))
    dt_to_g, dt_to_p = dist[:n_img], dist[n_img:]

    inf = torch.tensor(float("inf"), device=pred.device)
    hd = torch.maximum(
        torch.where(pb, dt_to_g, -inf).amax(dim=(1, 2)),
        torch.where(gb, dt_to_p, -inf).amax(dim=(1, 2)))
    zero = torch.zeros((), device=pred.device)
    total = (torch.where(pb, dt_to_g, zero).sum(dim=(1, 2))
             + torch.where(gb, dt_to_p, zero).sum(dim=(1, 2)))
    n = n_p + n_g
    assd = total / torch.clamp(n, min=1).to(torch.float32)
    both = torch.cat([torch.where(pb, dt_to_g, inf).reshape(n_img, -1),
                      torch.where(gb, dt_to_p, inf).reshape(n_img, -1)], 1)
    hd95 = _percentile_sorted(torch.sort(both, dim=1).values, n, 95.0)

    nan = torch.tensor(float("nan"), device=pred.device)
    return {"hd": torch.where(valid, hd, nan),
            "hd95": torch.where(valid, hd95, nan),
            "assd": torch.where(valid, assd, nan),
            "valid": valid.to(torch.float32)}


@torch.no_grad()
def surface_metrics_batch(preds: torch.Tensor, gts: torch.Tensor) -> dict:
    """Per-image surface metrics over a batch. ``preds``: (N, H, W) or
    (N, H, W, 1), any dtype, nonzero = foreground; ``gts``: the same
    shape, soft masks binarize as ``> 0`` (the reference's bool
    convention). Returns ``{"hd", "hd95", "assd", "valid"}`` of (N,)
    float32 tensors."""
    p = preds[..., 0] if preds.dim() == 4 else preds
    g = gts[..., 0] if gts.dim() == 4 else gts
    return surface_distance_stats(p.to(torch.float32) > 0,
                                  g.to(torch.float32) > 0)


def surface_distance_stats_oracle(pred, gt) -> dict:
    """Host/scipy version of one image pair's HD, HD95 and ASSD with the
    same conventions (medpy's formulas from scipy primitives), as
    ``ddti_tpu/eval/surface.py:surface_distance_stats_oracle``. The folder
    scorer (``eval/folder_eval.py``) uses it because its images may each
    have their own shape."""
    import numpy as np
    from scipy import ndimage

    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    footprint = ndimage.generate_binary_structure(2, 1)

    def border(m):
        return m ^ ndimage.binary_erosion(m, structure=footprint,
                                          border_value=0)

    pb, gb = border(pred), border(gt)
    if not pb.any() or not gb.any():
        return {"hd": float("nan"), "hd95": float("nan"),
                "assd": float("nan"), "valid": 0.0}
    d_pg = ndimage.distance_transform_edt(~gb)[pb]
    d_gp = ndimage.distance_transform_edt(~pb)[gb]
    both = np.hstack([d_pg, d_gp])
    return {"hd": float(both.max()),
            "hd95": float(np.percentile(both, 95)),
            "assd": float(both.mean()),
            "valid": 1.0}
