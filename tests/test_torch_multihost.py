"""The port's multi-process launch (``ddti_tpu_torch/parallel/multihost.py``)
against the JAX package's (``tests/test_multihost.py``): the spec's
resolution from flags and the environment, JAX's precedence and errors
(and a torch launcher's variables where JAX's are absent); then REAL
two-process runs over localhost, each process joined by
``initialize_multihost(spec_from())`` from the JAX environment variables
(gloo on the CPU; the bodies are ``torch_parallel_workers.multihost_main``):
a global reduction, and the Trainer's epoch whose val IoU both ranks agree
on and an exact host oracle confirms within 1e-5 (6 val images at batch
8, so two wraparound-padded duplicates are weighted out over the global
indices).

Each two-process test bounds its run (120 s) and kills both processes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ddti_tpu.parallel import MultihostSpec as JMultihostSpec
from ddti_tpu.parallel import spec_from as jspec_from
from ddti_tpu_torch.parallel import (
    Mesh,
    MultihostSpec,
    initialize_multihost,
    process_local_batch,
    spec_from,
)
from ddti_tpu_torch.parallel.multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(ROOT, "tests", "torch_parallel_workers.py")
TIMEOUT_S = 120

ENV_CASES = {
    "explicit_wins": (("a:1", 4, 2), {"JAX_COORDINATOR_ADDRESS": "b:2",
                                      "JAX_NUM_PROCESSES": "8",
                                      "JAX_PROCESS_ID": "7"}),
    "from_env": ((), {"JAX_COORDINATOR_ADDRESS": "h:9",
                      "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}),
    "empty": ((), {}),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_spec_matches_jax(case):
    args, env = ENV_CASES[case]
    got = spec_from(*args, env=env)
    want = jspec_from(*args, env=env)
    assert isinstance(want, JMultihostSpec)
    assert (got.coordinator_address, got.num_processes, got.process_id) == (
        want.coordinator_address, want.num_processes, want.process_id)


@pytest.mark.parametrize("args, match", [
    ((("h:1",), {}), "all three"),
    ((("h:1", 2, 2), {}), "out of range"),
    ((("h:1", 0, 0), {}), ">= 1"),
])
def test_spec_partial_raises_as_jax(args, match):
    (pos, kw) = args
    for fn in (spec_from, jspec_from):
        with pytest.raises(ValueError, match=match):
            fn(*pos, env={}, **kw)


def test_spec_from_a_torch_launcher():
    """RANK, WORLD_SIZE and MASTER_ADDR/MASTER_PORT take the part of JAX's
    TPU-pod autodetection where none of JAX's three is set; JAX's win."""
    torchrun = {"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "node0",
                "MASTER_PORT": "29500"}
    assert spec_from(env=torchrun) == MultihostSpec("node0:29500", 4, 3)
    jax_env = {"JAX_COORDINATOR_ADDRESS": "h:9", "JAX_NUM_PROCESSES": "2",
               "JAX_PROCESS_ID": "1"}
    assert spec_from(env={**torchrun, **jax_env}) == MultihostSpec(
        "h:9", 2, 1)
    assert spec_from(env={"RANK": "3"}) == MultihostSpec()
    assert not initialize_multihost(MultihostSpec(), device="cpu")


def test_process_local_batch_keeps_this_processes_rows():
    glob = np.arange(8 * 3).reshape(8, 3)
    for r in range(2):
        mesh = Mesh({"data": 2}, r, 2)
        np.testing.assert_array_equal(process_local_batch(glob, mesh),
                                      glob[4 * r:4 * r + 4])
        a, b = process_local_batch((glob, glob * 2), mesh)
        np.testing.assert_array_equal(b, 2 * a)
    with pytest.raises(ValueError, match="must divide evenly by the 2"):
        process_local_batch(glob[:7], Mesh({"data": 2}, 0, 2))


def _two_processes(kind, tmp_path):
    """Both processes of ``multihost_main(kind)``, joined at a free
    localhost port through the JAX variables; their outputs. A hang is
    cut at TIMEOUT_S and both are killed."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                   PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, WORKERS, kind, str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return outs


def test_two_process_reduction(tmp_path):
    """Each process holds its 4 rows of an (8, 8) global batch (ones, then
    twos); the global sum, 96, is the same in both."""
    outs = _two_processes("reduce", tmp_path)
    for rank, out in enumerate(outs):
        assert f"RANK{rank} SUM 96.0" in out, out


def test_two_process_trainer_epoch(tmp_path):
    """The Trainer's epoch over two joined processes: the identical val
    IoU in both, equal to the exact oracle within 1e-5 (checked in each
    process); the test phase keeps the summed counts alone, as JAX's
    multi-host path does (no per-image rows, no grids), the same in
    both."""
    outs = _two_processes("epoch", tmp_path)
    lines = []
    for rank, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if f"RANK{rank} IOU" in ln]
        assert line, out
        lines.append(line[0].split(maxsplit=1)[1])
    assert lines[0] == lines[1]
    log = (next((tmp_path / "run0").iterdir()) / "log" / "log.log"
           ).read_text()
    assert "visualization skipped in multi-host runs" in log
    assert "Total Images: 8" in log
    run1 = next((tmp_path / "run1").iterdir())
    assert not (run1 / "result" / "test_metrics.json").exists()


def test_a_sigterm_on_one_rank_stops_both_at_one_step(tmp_path):
    """A SIGTERM to rank 1 alone, in epoch 2's first step: both ranks stop
    after that step (the same step count, 3 of 4), both report the
    preemption, and rank 0 alone saved the last full state."""
    outs = _two_processes("preempt", tmp_path)
    lines = {}
    for rank, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if f"RANK{rank} PREEMPTED" in ln]
        assert line, out
        lines[rank] = line[0].split()
    assert lines[0][2:5] == lines[1][2:5] == ["True", "STEP", "3"]
    assert lines[0][-1] == "True" and lines[1][-1] == "False"
