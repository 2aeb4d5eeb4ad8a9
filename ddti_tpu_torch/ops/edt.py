"""Exact Euclidean distance transform (EDT) of binary masks, ported from
``ddti_tpu/ops/edt.py``.

Semantics of ``scipy.ndimage.distance_transform_edt(x)``: every nonzero
pixel gets the Euclidean distance to the nearest zero pixel of its image;
an image with no zero pixel gets the cap h + w everywhere (scipy has no
answer there). ``boundary_loss`` calls it on ``1 - target``, the distance to
the nearest foreground pixel; the surface metrics on ``~surface``.

Separable and exact: a column pass (per column, the distance to the nearest
zero) and a min-plus row pass, D^2[i, j] = min_k g^2[i, k] + (j - k)^2.

``edt_batch`` on a CUDA tensor launches the hand-written kernel pair in
``csrc/edt.cu`` (it replaces the TPU kernel ``_minplus_kernel`` and the XLA
column pass); on a CPU tensor it runs ``edt_reference``, the same function
in plain PyTorch. There is no other route: a CUDA tensor the kernel does not
take raises. Every value is an integer below 2^24 before the square root, so
the kernel, the plain version, the JAX package and scipy agree bit for bit.
"""

from __future__ import annotations

import torch

# the kernel's bound, and where the integer-exactness argument ends
MAX_SIDE = 2048
# rows per block of the plain row pass: bounds its (block, W, W) intermediate
_BLOCK_ELEMS = 1 << 24


def _column_pass(zero: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool, True where the input is zero -> float32 per-column
    distance to the nearest zero, capped at h + w (JAX ``_column_pass``
    with two cummax scans)."""
    n, h, w = zero.shape
    cap = h + w
    rows = torch.arange(h, device=zero.device).view(1, h, 1).expand(n, h, w)
    neg = -cap
    # index of the nearest zero at or above: running max of (row if zero)
    above = torch.cummax(torch.where(zero, rows, neg), dim=1).values
    d_above = torch.where(above >= 0, rows - above, cap)
    # nearest at or below: the same on negated indices, scanned upwards
    below = torch.cummax(torch.where(zero, -rows, neg).flip(1),
                         dim=1).values.flip(1)
    d_below = torch.where(below > neg, -below - rows, cap)
    return torch.minimum(d_above, d_below).clamp(max=cap).float()


def _minplus_reference(g2: torch.Tensor) -> torch.Tensor:
    """Row pass: (R, W) -> D^2[r, j] = min_k g2[r, k] + (j - k)^2, in blocks
    of rows so the (block, W, W) intermediate stays bounded (JAX
    ``_minplus_reference``)."""
    r, w = g2.shape
    k = torch.arange(w, dtype=torch.float32, device=g2.device)
    d2 = (k[None, :] - k[:, None]) ** 2  # (j, k)
    block = max(1, _BLOCK_ELEMS // (w * w))
    out = torch.empty_like(g2)
    for s in range(0, r, block):
        out[s:s + block] = (g2[s:s + block, None, :] + d2[None]).amin(-1)
    return out


def edt_reference(masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch EDT of (N, H, W) masks of any dtype (nonzero ->
    distance to the nearest zero) -> float32 (N, H, W)."""
    n, h, w = masks.shape
    g = _column_pass(masks == 0)
    d2 = _minplus_reference((g * g).reshape(n * h, w)).reshape(n, h, w)
    d2 = torch.clamp(d2, max=float((h + w) ** 2))
    # the correctly rounded float32 square root, as CUDA's sqrtf, XLA and
    # scipy give it: torch's CPU float32 sqrt is off by an ulp on about 0.6%
    # of integers below 2^20; through float64 it rounds once, correctly
    return torch.sqrt(d2.double()).float()


def edt_cuda(masks: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/edt.cu`` on (N, H, W) CUDA masks (bool, uint8 or any
    dtype; nonzero = foreground) -> float32 (N, H, W). Raises on anything
    the kernel does not take. Adds one to ``edt_cuda.launches`` per
    launch."""
    if masks.dim() != 3:
        raise ValueError(f"masks must be (N, H, W); got {tuple(masks.shape)}")
    n, h, w = masks.shape
    if not masks.is_cuda:
        raise ValueError("masks must lie on a CUDA device")
    if not (0 < h <= MAX_SIDE and 0 < w <= MAX_SIDE):
        raise ValueError(f"H = {h}, W = {w}: the kernel takes 1..{MAX_SIDE} "
                         f"(the float32 integer-exactness bound, ROADMAP.md "
                         f"Queue 2)")
    out = torch.empty((n, h, w), device=masks.device, dtype=torch.float32)
    if n == 0:
        return out
    if masks.dtype == torch.bool:
        fg = masks.contiguous().view(torch.uint8)
    elif masks.dtype == torch.uint8:
        fg = masks.contiguous()
    else:
        fg = (masks != 0).view(torch.uint8)
    from ._build import launch

    stream = torch.cuda.current_stream(masks.device).cuda_stream
    with torch.cuda.device(masks.device):
        launch("edt", fg.data_ptr(), out.data_ptr(), n, h, w, stream)
    edt_cuda.launches += 1
    return out


edt_cuda.launches = 0


def edt_batch(masks: torch.Tensor) -> torch.Tensor:
    """EDT over a batch: (N, H, W) or (N, H, W, 1) -> same-shaped float32.
    CPU tensors take the plain version, every other device the kernel."""
    squeeze = masks.dim() == 4
    m = masks[..., 0] if squeeze else masks
    with torch.no_grad():
        out = edt_reference(m) if m.device.type == "cpu" else edt_cuda(m)
    return out[..., None] if squeeze else out


def distance_transform_edt(x: torch.Tensor) -> torch.Tensor:
    """EDT of a single (H, W) array -> float32 (H, W)."""
    return edt_batch(x[None])[0]
