"""The device mesh, ported from ``ddti_tpu/parallel/mesh.py``.

The JAX package is single-controller: one process sees every device, the
batch is sharded over the mesh's ``data`` axis and XLA inserts the
collectives (gradients, BatchNorm statistics and metric sums all become
cross-replica). The port is the torch idiom instead: one process per
device, joined by ``torch.distributed`` (NCCL between CUDA devices, gloo on
the CPU and for host-side flags), each process holding the whole train
state and its rows of every global batch. ``Mesh`` is that process's view:
the axis sizes, the process group, its rank, the world size and its
device. The helpers below are the collectives the rest of the port calls,
so that a step on a ``data=N`` mesh computes what the single-device step
computes on the same global batch: a sum that carries gradients (the
Focal-Tversky term's global sums), in-place sums and maxima (metrics,
QAT ranges), the gradient average, a row gather (the test outputs) and
host-side agreement (preemption, the run directory's name).

Axes: ``data`` shards the batch, ``model`` the frames' rows (JAX's
``batch_sharding(mesh, spatial=True)``: H over ``model``). The ranks are
laid out row-major, data first, as JAX's ``devices.reshape(dims)``: rank
= d * M + m. A rank holds its data group's frames and, inside the model,
its band of H / M rows; ``parallel/spatial.py`` holds the band ops and
their exchanges within ``model_group`` (the M ranks of one data index).
The world group keeps every sum over pixels and images (BatchNorm, the
Focal-Tversky index, counts, gradients); ``data_group`` (the D ranks of
one model index) gathers rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

# the gradient all-reduce's bucket: one flat buffer of at most this many
# bytes a collective, so a large model needs no second copy of its grads
GRAD_BUCKET_BYTES = 64 << 20
TIMEOUT = timedelta(minutes=10)


def parse_mesh_spec(spec: str) -> dict:
    """Parse a ``--mesh`` CLI value like ``'data=4,model=2'`` into a mesh
    shape dict (insertion order = mesh axis order)."""
    out = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if not name or not val.strip().isdigit():
            raise ValueError(f"bad mesh spec {spec!r}; expected "
                             f"'data=N[,model=M]'")
        out[name] = int(val)
    if not out:
        raise ValueError("empty mesh spec")
    return out


def check_mesh_shape(shape: dict, n_devices: int) -> int:
    """The mesh's size, checked: a size other than ``n_devices`` raises
    (JAX ``make_mesh``'s message)."""
    unknown = set(shape) - {"data", "model"}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: expected 'data' "
                         f"and optionally 'model'")
    n = int(math.prod(shape.values()))
    if n != n_devices:
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {n_devices}")
    return n


@dataclass(eq=False)
class Mesh:
    """One process's view of a ``data`` x ``model`` mesh. ``group`` is
    the world's process group (None in a world of one process that never
    joined one: every helper is then the identity), ``control`` a gloo
    group over the same processes for host-side values (the same group
    where the backend is gloo), ``model_group`` the ranks of this rank's
    data index (None at model 1) and ``data_group`` those of its model
    index (``group`` at model 1). ``multihost`` marks a run joined through
    ``--multihost`` with more than one process (JAX's
    ``jax.process_count() > 1``): its test phase keeps no per-image rows.
    A deep copy (of a model whose modules hold the mesh) shares it."""

    shape: dict
    rank: int = 0
    world: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: object = None
    control: object = None
    multihost: bool = False
    model_group: object = None
    data_group: object = None

    @property
    def data(self) -> int:
        return int(self.shape.get("data", 1))

    @property
    def model(self) -> int:
        return int(self.shape.get("model", 1))

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def backend(self) -> str | None:
        return dist.get_backend(self.group) if self.distributed else None

    def __deepcopy__(self, memo):
        return self


def make_mesh(shape: dict | None = None, device=None,
              multihost: bool = False) -> Mesh:
    """This process's ``Mesh`` over the initialized process group (every
    rank calls it: it creates the gloo control group and, at model > 1,
    every model and data group, in the same order on every rank).
    ``shape`` defaults to all processes on ``data``; its size must be the
    world's. Without an initialized group the world is this process
    alone."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = dict(shape) if shape else {"data": world}
    check_mesh_shape(shape, world)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    if not dist.is_initialized():
        return Mesh(shape, 0, 1, torch.device(device))
    group = dist.group.WORLD
    control = (group if dist.get_backend() == "gloo"
               else dist.new_group(backend="gloo"))
    rank = dist.get_rank()
    d_n, m_n = int(shape.get("data", 1)), int(shape.get("model", 1))
    model_group, data_group = None, group
    if m_n > 1:
        for d in range(d_n):
            g = dist.new_group([d * m_n + m for m in range(m_n)])
            if rank // m_n == d:
                model_group = g
        data_group = None  # data 1: no other rank holds other rows
        for m in range(m_n if d_n > 1 else 0):
            g = dist.new_group([d * m_n + m for d in range(d_n)])
            if rank % m_n == m:
                data_group = g
    return Mesh(shape, rank, world, torch.device(device), group, control,
                bool(multihost and world > 1), model_group, data_group)


def init_process_group(rank: int, world: int, coordinator: str,
                       backend: str):
    """Join ``world`` processes at ``tcp://<coordinator>`` with an explicit
    timeout, TIMEOUT (every collective's too): a rank that never arrives
    fails the others instead of hanging them."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank, timeout=TIMEOUT)


def backend_for(device) -> str:
    """NCCL between CUDA devices, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


# ---------------------------------------------------------------------------
# rows of a global batch
# ---------------------------------------------------------------------------


def local_rows(n: int, mesh: Mesh, grad_accum: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch of ``n`` (JAX's
    ``batch_sharding`` over ``data``), as int64 positions: its data
    group's, which every model rank of the group shares. With
    ``grad_accum`` K the global batch is K microbatches of n / K rows and
    data rank r holds the r-th of the ``data`` pieces of each, in
    microbatch order: its i-th local microbatch is its piece of the global
    i-th, so BatchNorm normalises the same images together as on one
    device. A batch that does not divide raises."""
    world, k = mesh.world // mesh.model, max(int(grad_accum), 1)
    if n % world:
        raise ValueError(
            f"batch_size {n} must divide evenly by the {world} processes "
            f"in a multi-host run")
    if n % (world * k):
        raise ValueError(
            f"batch_size {n} over --grad_accum {k}: a microbatch of "
            f"{n // k} rows must divide evenly by the {world} processes")
    micro, piece = n // k, n // (k * world)
    base = torch.arange(piece) + mesh.data_rank * piece
    return torch.cat([base + i * micro for i in range(k)])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _axis(mesh: Mesh | None, axis: str | None):
    """The process group of ``axis`` (None: the world, "model" or
    "data") and its size; None where nothing is to be reduced (no mesh,
    no process group, or an axis of one rank)."""
    if mesh is None or not mesh.distributed:
        return None
    if axis is None:
        return mesh.group, mesh.world
    if axis == "model":
        return (mesh.model_group, mesh.model) if mesh.model > 1 else None
    if axis == "data":
        return ((mesh.data_group, mesh.data)
                if mesh.data > 1 and mesh.data_group is not None else None)
    raise ValueError(f"mesh axis {axis!r}: expected 'data' or 'model'")


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over a group's ranks, carrying gradients: each
    rank's loss holds the global value, so the backward sums the ranks'
    upstream gradients (the gradient of the sum of the ranks' losses,
    which the gradient average then divides by the world)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_ranks(x: torch.Tensor, mesh: Mesh | None,
                   axis: str | None = None) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis`` (the world by default),
    differentiably (the identity without a process group)."""
    g = _axis(mesh, axis)
    return x if g is None else _SumOverRanks.apply(x, g[0])


def _op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


@torch.no_grad()
def all_reduce_(tensors, mesh: Mesh | None, op: str = "sum",
                axis: str | None = None) -> None:
    """Reduce ``tensors`` in place over the ranks of ``axis`` (the world
    by default; ``op`` sum, max or min): tensors of one dtype and device
    travel together, flattened into buckets of at most GRAD_BUCKET_BYTES
    (one collective each), in the order given, which every rank shares."""
    g = _axis(mesh, axis)
    if g is None:
        return
    tensors = list(tensors)
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        bucket, size = [], 0
        for t in ts + [None]:
            nbytes = 0 if t is None else t.numel() * t.element_size()
            if bucket and (t is None or size + nbytes > GRAD_BUCKET_BYTES):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, op=_op(op), group=g[0])
                off = 0
                for b in bucket:
                    b.copy_(flat[off:off + b.numel()].view_as(b))
                    off += b.numel()
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += nbytes


@torch.no_grad()
def mean_gradients_(params, mesh: Mesh | None) -> None:
    """Average the parameters' gradients over the ranks in place (the
    parameters with a gradient: the same ones on every rank). Each rank's
    loss holds the global value, so the world's sum is the world times
    the gradient of that value; on a model axis too, where a rank's
    gradients are its band's part."""
    if mesh is None or not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    all_reduce_(grads, mesh)
    inv = 1.0 / mesh.world
    for g in grads:
        g.mul_(inv)


def all_gather(x: torch.Tensor, mesh: Mesh | None,
               axis: str | None = None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) of ``axis``'s group,
    stacked on a new dim 0 in the group's rank order (``x[None]`` where
    there is none): an all-reduce of zeros with each rank's slot filled,
    a collective that gloo takes for CPU and CUDA tensors alike, as NCCL
    does. No gradient."""
    g = _axis(mesh, axis)
    if g is None:
        return x[None]
    group, n = g
    out = x.new_zeros((n, *x.shape))
    out[dist.get_group_rank(group, dist.get_rank())] = x
    dist.all_reduce(out, group=group)
    return out


def gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The data groups' ``x`` (the same shape on each) concatenated on
    dim 0 in data order: the global batch of tensors split by
    ``local_rows`` (grad_accum 1). Every model rank of a data group must
    hold the same ``x``."""
    return all_gather(x.contiguous(), mesh, "data").flatten(0, 1)


def host_reduce(value: float, mesh: Mesh | None, op: str = "sum") -> float:
    """A host number reduced over the ranks through the gloo control
    group (no device work, so no stream waits on it)."""
    if mesh is None or not mesh.distributed:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, op=_op(op), group=mesh.control)
    return float(t.item())


def any_rank(flag: bool, mesh: Mesh | None) -> bool:
    """True on every rank when ``flag`` is true on any (the preemption
    signal a rank received)."""
    return host_reduce(1.0 if flag else 0.0, mesh, "max") > 0.0


def broadcast_object(obj, mesh: Mesh | None):
    """Rank 0's picklable ``obj`` on every rank (the control group)."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.control)
    return box[0]
