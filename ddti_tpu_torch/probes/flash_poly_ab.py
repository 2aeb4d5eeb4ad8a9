"""A/B: the exp2 unit against the polynomial exp2 inside the production
flash kernels.

The port of the TPU probe ``benchmarks/flash_poly_ab.py`` at its shape, B8
H8 S4096 D32 bf16: the forward (``flash_attention``) and the forward with
the backward (autograd through ``sum(sin(flash_attention(q, k, v)))``), one
subprocess for each setting of DDTI_POLY_EXP2, each loading the kernels
built for it (``ops/_build.py`` hashes the flag into the library's name).
Each prints the TPU probe's line ``poly=... fwd_ms=... fwdbwd_ms=...
fwd_err=...`` (queued device time; max|err| of the forward against
attention_reference).

    python -m ddti_tpu_torch.probes.flash_poly_ab
    python -m ddti_tpu_torch.probes.flash_poly_ab --device cpu \\
        --shape 1 2 256 32          # the plain versions, no times
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import attention as A

B, H, S, D = 8, 8, 4096, 32
ROOT = Path(__file__).resolve().parents[2]
CHILD_TIMEOUT_S = 600


def measure(shape=(B, H, S, D), seed=0, device="cuda"):
    """One setting (this process's DDTI_POLY_EXP2): returns and prints the
    probe's line."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd():
        with torch.no_grad():
            return A.flash_attention(q, k, v)

    def fwdbwd():
        o = A.flash_attention(*leaves)
        return torch.autograd.grad(torch.sin(o.float()).sum(), leaves)

    o = fwd()
    grads = fwdbwd()
    err = float((o.float() - A.attention_reference(q, k, v).float())
                .abs().max())
    finite = bool(torch.isfinite(o.float()).all()
                  and all(torch.isfinite(t.float()).all() for t in grads))
    t_fwd = t_bwd = None
    if o.device.type != "cpu":
        from ._timing import queued_ms

        t_fwd, t_bwd = queued_ms(fwd), queued_ms(fwdbwd, calls=20)
    ms = ["not measured" if t is None else f"{t:.4f}"
          for t in (t_fwd, t_bwd)]
    print(f"RESULT poly={A.USE_POLY_EXP2} fwd_ms={ms[0]} fwdbwd_ms={ms[1]} "
          f"fwd_err={err:.3e} finite={finite}", flush=True)
    return dict(poly=A.USE_POLY_EXP2, fwd_ms=t_fwd, fwdbwd_ms=t_bwd,
                fwd_err=err, finite=finite)


def _parse(line):
    """The fields of a RESULT line: numbers as floats, the rest as text."""
    fields = {}
    for key, val in re.findall(r"(\w+)=(not measured|\S+)", line):
        try:
            fields[key] = float(val)
        except ValueError:
            fields[key] = val
    return fields


def run(shape=(B, H, S, D), seed=0, device="cuda"):
    """Both settings, each measured in a subprocess of its own; prints each
    one's line and returns [the DDTI_POLY_EXP2=0 fields, the =1 fields].
    Raises where a subprocess fails."""
    child = [sys.executable, "-m", __spec__.name, "--child", "--device",
             device, "--seed", str(seed), "--shape", *map(str, shape)]
    out = []
    for poly in ("0", "1"):
        env = dict(os.environ, DDTI_POLY_EXP2=poly)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [x for x in [env.get("PYTHONPATH")] if x])
        res = subprocess.run(child, capture_output=True, text=True, cwd=ROOT,
                             env=env, timeout=CHILD_TIMEOUT_S)
        lines = [l[len("RESULT "):] for l in res.stdout.splitlines()
                 if l.startswith("RESULT ")]
        if res.returncode != 0 or not lines:
            raise RuntimeError(f"DDTI_POLY_EXP2={poly} failed (exit "
                               f"{res.returncode}):\n{res.stdout[-2000:]}"
                               f"{res.stderr[-4000:]}")
        print(lines[0], flush=True)
        out.append(_parse(lines[0]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--shape", type=int, nargs=4, default=[B, H, S, D],
                   metavar=("B", "H", "S", "D"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--child", action="store_true",
                   help="measure this process's setting only")
    a = p.parse_args(argv)
    if a.child:
        return 0 if measure(tuple(a.shape), a.seed, a.device)["finite"] else 1
    run(tuple(a.shape), a.seed, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
