"""Multi-process launch, ported from ``ddti_tpu/parallel/multihost.py``.

In the JAX package one process per host joins one runtime through
``jax.distributed.initialize``. In the port one process is one rank is one
device (the torch idiom), and the processes join one
``torch.distributed`` group: NCCL between CUDA devices, gloo on the CPU.

Across hosts, launch one process per device on each host (or let a
scheduler set the environment):

    python -m ddti_tpu_torch.cli.main ... --multihost \\
        --coordinator host0:8476 --num_processes 8 --process_id $RANK

or with ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
``JAX_PROCESS_ID`` in the environment (flags win over them). Where none of
the three is set, the variables a torch launcher sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` does)
take the part of JAX's TPU-pod autodetection. On one host,
``launch_local`` starts the ranks itself (``--mesh data=N[,model=M]``:
N x M ranks).
"""

from __future__ import annotations

import os
import signal
import socket
import time
from dataclasses import dataclass
from typing import Mapping, Optional

from .mesh import TIMEOUT, backend_for, init_process_group

GRACE_S = 10.0  # a failed rank's peers get this long before they are ended


@dataclass
class MultihostSpec:
    """Resolved arguments of ``initialize_multihost``. All None: a
    single-process run."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


def _torch_launcher_env(env: Mapping[str, str]) -> dict:
    """The torch launcher's variables as JAX's three names, where all of
    RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT are set."""
    keys = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    if not all(env.get(k) for k in keys):
        return {}
    return {"JAX_COORDINATOR_ADDRESS":
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            "JAX_NUM_PROCESSES": env["WORLD_SIZE"],
            "JAX_PROCESS_ID": env["RANK"]}


def spec_from(coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              env: Optional[Mapping[str, str]] = None) -> MultihostSpec:
    """Merge explicit arguments over environment variables. Explicit
    values win; env fallbacks are JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID, and where none of those three is
    set, a torch launcher's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT.
    Partial specs raise."""
    env = os.environ if env is None else env
    jax_keys = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID")
    if not any(env.get(k) for k in jax_keys):
        env = {**env, **_torch_launcher_env(env)}
    coordinator = coordinator or env.get("JAX_COORDINATOR_ADDRESS") or None

    def _int(value, key):
        if value is not None:
            return int(value)
        raw = env.get(key)
        return int(raw) if raw not in (None, "") else None

    num_processes = _int(num_processes, "JAX_NUM_PROCESSES")
    process_id = _int(process_id, "JAX_PROCESS_ID")

    given = [coordinator is not None, num_processes is not None,
             process_id is not None]
    if any(given) and not all(given):
        raise ValueError(
            "multi-host launch needs all three of coordinator address, "
            f"num_processes and process_id (or none, for TPU-pod "
            f"autodetection); got coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}")
    if num_processes is not None:
        if num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, "
                             f"got {num_processes}")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} out of range for "
                             f"{num_processes} processes")
    return MultihostSpec(coordinator, num_processes, process_id)


def initialize_multihost(spec: Optional[MultihostSpec] = None,
                         device="cuda") -> bool:
    """Join this process into the global process group (NCCL for a CUDA
    ``device``, gloo for the CPU) at ``tcp://<coordinator>``, with an
    explicit timeout. Call once per process, before the first collective.
    A fully empty spec is a no-op (a single-process run): False."""
    spec = spec or spec_from()
    if spec.coordinator_address is None and spec.num_processes is None:
        return False
    init_process_group(spec.process_id, spec.num_processes,
                       spec.coordinator_address, backend_for(device))
    return True


def process_local_batch(global_arrays, mesh):
    """This process's part of a global batch that every process holds
    whole (the same seed gives every process the same batch): a tuple or
    list of (N, ...) arrays -> their rows ``local_rows`` gives, or one
    array -> its rows; on a ``model`` axis, of (N, H, ...) arrays, the
    band of H that the rank's model index holds (``spatial.band``). An N
    the data groups, or an H the model ranks, do not divide raises."""
    from .mesh import local_rows

    one = not isinstance(global_arrays, (tuple, list))
    arrays = [global_arrays] if one else list(global_arrays)
    rows = local_rows(len(arrays[0]), mesh).numpy()
    out = [a[rows] for a in arrays]
    if mesh.model > 1:
        h = arrays[0].shape[1]
        if h % mesh.model:
            raise ValueError(f"{h} rows do not divide evenly by the "
                             f"{mesh.model} ranks of the 'model' axis")
        hb = h // mesh.model
        out = [a[:, mesh.model_rank * hb:(mesh.model_rank + 1) * hb]
               for a in out]
    return out[0] if one else type(global_arrays)(out)


def free_port() -> int:
    """A free TCP port on localhost, for a local launch's coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, coordinator: str, device_type: str,
                target, args: tuple, shape: dict | None = None) -> None:
    """A spawned rank: join the group, build its mesh of ``shape`` (all
    ranks on ``data`` by default) on its device (rank r on cuda:r, or the
    CPU, with its share of the host's cores unless OMP_NUM_THREADS says
    otherwise) and run ``target(mesh, *args)``; the exit code is what
    ``target`` returns."""
    import sys

    import torch
    import torch.distributed as dist

    from .mesh import make_mesh

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        if not os.environ.get("OMP_NUM_THREADS"):  # else torch's, from it
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_process_group(rank, world, coordinator, backend_for(device))
    rc = 1
    try:
        rc = int(target(make_mesh(shape or {"data": world}, device),
                        *args) or 0)
    finally:
        try:
            dist.destroy_process_group()
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
    sys.exit(rc)


def launch_local(target, world: int, device_type: str,
                 args: tuple = (), shape: dict | None = None) -> int:
    """Run ``target(mesh, *args)`` in ``world`` spawned processes on this
    host, one rank each (cuda:r, or the CPU for gloo), joined at a free
    localhost port, on a mesh of ``shape`` (by default all ``world``
    ranks on ``data``); ``target`` must be importable by name. Returns 0 when
    every rank returned 0, else the first nonzero exit code (75, a
    preempted run, where that is what the ranks gave). A rank that fails
    takes the others down after GRACE_S (a rank that hangs in a collective
    fails at TIMEOUT). SIGTERM is passed on to every
    rank (SIGINT from a terminal reaches them itself), and the ranks stop
    together at a step boundary."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, name=f"ddti-rank{r}", args=(
        r, world, coordinator, device_type, target, tuple(args), shape))
        for r in range(world)]
    prev = {}

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    try:
        prev[signal.SIGTERM] = signal.signal(signal.SIGTERM, forward)
        # a terminal's ^C reaches every rank itself (one process group)
        prev[signal.SIGINT] = signal.signal(signal.SIGINT, signal.SIG_IGN)
    except ValueError:  # not the main thread: no forwarding
        prev = {}
    try:
        for p in procs:
            p.start()
        failed_at = None
        while any(p.is_alive() for p in procs):
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad and failed_at is None:
                failed_at = time.monotonic()
            if failed_at is not None and (time.monotonic() - failed_at
                                          > GRACE_S):
                break
            time.sleep(0.05)
    finally:
        procs = [p for p in procs if p.pid is not None]  # the started
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=GRACE_S)
            if p.is_alive():
                p.kill()
                p.join()
        for s, h in prev.items():
            signal.signal(s, h)
    codes = [p.exitcode for p in procs]
    if all(c == 0 for c in codes):
        return 0
    failed = [c for c in codes if c is not None and c > 0]
    return failed[0] if failed else 1
