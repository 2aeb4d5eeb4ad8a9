"""The spatial ``model`` axis: frames sharded by rows, ported from what
GSPMD does for the JAX package under ``batch_sharding(mesh,
spatial=True)`` (H over ``model``).

On a mesh with ``model`` M > 1 each rank holds its data group's frames
and, inside the network, only its band of H / M rows of every
activation: rank m of the group the rows [m hb, (m + 1) hb), hb = H / M
at each level. Every op that reads across a band edge gets the rows it
needs from the neighbouring bands of its ``model_group``:

- ``edges`` and ``halo``: a conv's rows above and below its band (zeros
  at the frame's edges, as the conv's padding), their backward sending the
  halo rows' gradients back to their owners, where they are added;
- ``gather_band``: the whole frame of a band-sharded tensor, whose
  backward is a reduce-scatter (the sum over the model group, then this
  rank's band): the gathered region is computed by every model rank, and
  each rank's gradient of it is that of its own band's use;
- ``band``: this rank's rows of a whole frame (a slice: its backward
  puts the band's gradient back in place).

Both exchanges are built from ``parallel.mesh.all_gather``, an all-reduce
within ``model_group`` that gloo takes for CPU and CUDA tensors alike,
as NCCL does. A halo wider than a band (ASPP's dilations at a bottleneck
of a few rows) takes its rows through ``gather_band``.

The models read their mesh from ``band_mesh`` (``set_spatial_mesh``):
the 3x3 convs (``models.blocks.Conv2d``), the SE gates' means and the
token paths. Everything else is band-local at equal, even band heights:
1x1 convs, 2x2 pools and strided 2x2 convs, the k2 s2 transposed convs,
the attention gates; BatchNorm's statistics are the world's already.
``check_bands`` refuses a height that does not give such bands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import Mesh, all_gather, all_reduce_


def banded(mesh: Mesh | None) -> bool:
    """True on a mesh whose ``model`` axis shards the rows."""
    return mesh is not None and mesh.model > 1


def check_bands(h: int, ranks: int, levels: int) -> None:
    """Raise unless a frame of ``h`` rows gives equal, even bands over a
    ``model`` axis of ``ranks`` at each of a network's ``levels`` 2x
    downsamplings: h divisible by ranks * 2**levels (GSPMD pads uneven
    shards; the port does not)."""
    need = ranks * 2 ** levels
    if h % need:
        raise ValueError(
            f"image height {h} on a 'model' axis of {ranks}: the bands "
            f"must be equal and even at each of the model's {levels} "
            f"downsamplings, so the height must divide by model * "
            f"2**{levels} = {need}")


def pooling_levels(model) -> int:
    """The 2x downsamplings of ``model``'s encoder: ``depth`` in the
    parametric zoo, one a ``features`` entry in the Mores nets that take
    them, 4 in the fixed architectures (LegacyUNet, the triple-branch
    nets)."""
    if hasattr(model, "depth"):
        return int(model.depth)
    if hasattr(model, "features"):
        return len(model.features)
    return 4


def band(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's band of the whole frames ``x``: rows [m hb, (m + 1) hb)
    of ``dim``."""
    hb = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * hb, hb)


@torch.no_grad()
def gather_frames(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The whole frames of the band-sharded ``x`` (no gradient): the
    model group's bands concatenated on ``dim`` in rank order."""
    return torch.cat(all_gather(x.contiguous(), mesh, "model").unbind(0),
                     dim)


class _GatherBand(torch.autograd.Function):
    """``gather_frames`` with its gradient: the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return gather_frames(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_([g], ctx.mesh, axis="model")
        return band(g, ctx.mesh, ctx.dim), None, None


def gather_band(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """The whole frames of the band-sharded ``x`` on every model rank, its
    backward the reduce-scatter of the ranks' gradients."""
    return _GatherBand.apply(x, mesh, dim)


class _Edges(torch.autograd.Function):
    """The ``top`` rows of the band above NCHW ``x`` and the ``bottom``
    rows of the band below (zeros beyond the frame), each at most a band:
    one exchange of every rank's edge rows, and in the backward one of
    their gradients, each added to the rows it came from."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh):
        ctx.top, ctx.bottom, ctx.mesh, ctx.shape = top, bottom, mesh, x.shape
        n, c, hb, w = x.shape
        m = mesh.model_rank
        edges = all_gather(torch.cat([x[:, :, :bottom], x[:, :, hb - top:]],
                                     2), mesh, "model")
        above = (edges[m - 1][:, :, bottom:] if m > 0
                 else x.new_zeros((n, c, top, w)))
        below = (edges[m + 1][:, :, :bottom] if m < mesh.model - 1
                 else x.new_zeros((n, c, bottom, w)))
        return above, below

    @staticmethod
    def backward(ctx, g_above, g_below):
        top, bottom, mesh = ctx.top, ctx.bottom, ctx.mesh
        hb, m = ctx.shape[2], mesh.model_rank
        parts = all_gather(torch.cat([g_above, g_below], 2), mesh, "model")
        gx = g_above.new_zeros(ctx.shape)
        if m < mesh.model - 1:  # the band below read my last rows
            gx[:, :, hb - top:] += parts[m + 1][:, :, :top]
        if m > 0:  # the band above read my first rows
            gx[:, :, :bottom] += parts[m - 1][:, :, top:]
        return gx, None, None, None


def edges(x: torch.Tensor, top: int, bottom: int, mesh: Mesh):
    """(the ``top`` rows above NCHW band ``x``, the ``bottom`` rows below
    it), each at most a band, read from the neighbouring bands (zeros
    beyond the frame), with gradients."""
    return _Edges.apply(x, top, bottom, mesh)


def halo(x: torch.Tensor, top: int, bottom: int, mesh: Mesh) -> torch.Tensor:
    """NCHW band ``x`` widened by ``top`` rows above and ``bottom`` below,
    read from the neighbouring bands (zeros beyond the frame), with
    gradients; a halo wider than the band is cut from the gathered
    frame."""
    if not top and not bottom:
        return x
    hb = x.shape[2]
    if top <= hb and bottom <= hb:
        above, below = edges(x, top, bottom, mesh)
        return torch.cat([above, x, below], 2)
    whole = F.pad(gather_band(x, mesh), (0, 0, top, bottom))
    return whole.narrow(2, mesh.model_rank * hb, top + hb + bottom)


def flip(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """``torch.flip`` of band-sharded NHWC frames over ``axes``: a flip of
    the rows (axis 1) is the whole frame's, then this rank's band
    (the test-time flip ensemble; no gradient)."""
    if not axes:
        return x
    if 1 in axes:
        return band(torch.flip(gather_frames(x, mesh, 1), axes), mesh, 1)
    return torch.flip(x, axes)


def set_spatial_mesh(model, mesh: Mesh | None) -> int:
    """Give every module of ``model`` that works on bands (those with a
    ``band_mesh`` attribute) the mesh, where its ``model`` axis is > 1,
    else None (whole frames); returns how many it set."""
    mods = [m for m in model.modules() if hasattr(m, "band_mesh")]
    for m in mods:
        m.band_mesh = mesh if banded(mesh) else None
    return len(mods)
