"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``ddti_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process, all of them at once, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/ddti_tpu_torch/`` at the repository root under
a name that carries a hash of the sources and flags, so an edited source is
rebuilt at its next use and an unchanged one is loaded as it is. Nothing
here runs at import time: the CPU-only test environment imports this module
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddti_tpu_torch"
# DDTI_POLY_EXP2=1 in the environment, read once as the JAX package reads it
# (ddti_tpu/ops/attention.py): every flash kernel's exponential becomes the
# order-6 polynomial on the FMA pipes (csrc/sm90.cuh:flash_exp2) and every
# plain version's ops/attention.py:_exp2_poly. The flag is part of the
# library's hashed name, so both builds live side by side.
USE_POLY_EXP2 = os.environ.get("DDTI_POLY_EXP2", "0") == "1"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v") + (
                  ("-DDDTI_POLY_EXP2=1",) if USE_POLY_EXP2 else ())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libddti_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless the library for them exists. Returns the
    library's path and the seconds spent compiling (0.0 when it existed);
    the compiler's output lands beside it, with the suffix ``.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    steps = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    if all(rc == 0 for _, _, rc in steps):
        res = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, res.stdout + res.stderr, res.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, log, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
    # the compiler's report (ptxas: registers, spills, shared memory per
    # kernel) beside the library
    out.with_suffix(".log").write_text(
        "".join(f"$ {' '.join(cmd)}\n{log}" for cmd, log, _ in steps))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, time.perf_counter() - t0


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# every kernel's C entry point: argument types; each returns a cudaError_t
KERNELS = {
    "ddti_flash_fwd_split_f32": [_P] * 4 + [_I] * 4 + [_P],
    "ddti_flash_fwd": [_P] * 6 + [_I] * 6 + [_P],
    "ddti_flash_bwd_dkdv": [_P] * 11 + [_I] * 6 + [_P],
    "ddti_flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_P],
    "ddti_flash_fwd_mskip": [_P] * 6 + [_I] * 5 + [_P],
    "ddti_edt": [_P, _P, _LL, _I, _I, _P],
    "ddti_exp2_probe": [_P, _P, _LL, _I, _I, _P],
    "ddti_gather_probe": [_P] * 4 + [_I] * 8 + [_P],
    "ddti_conv3x3_relu": [_P] * 4 + [_I] * 6 + [_P],
    "ddti_conv_s8": [_P] * 6 + [_I] * 18 + [_P],
    "ddti_conv_s8_wgmma": [_P] * 6 + [_I] * 16 + [_P],
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in KERNELS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.ddti_error_string.argtypes = [_I]
    lib.ddti_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call the kernel entry point ``ddti_<name>`` and raise, naming the
    kernel, when it returns a CUDA error (a refused launch never runs, and
    a later synchronize would not report it)."""
    lib = load_library()
    err = getattr(lib, f"ddti_{name}")(*args)
    if err:
        msg = lib.ddti_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError_t {err} ({msg})")
