"""A/B: a flash forward that skips the online-softmax rescale where no
running max grew, against the production forward.

The port of the TPU probe ``benchmarks/flash_mskip_ab.py`` at its shape,
B8 H8 S4096 D32 bf16. After the first key tiles the running max m rarely
grows, so alpha = exp2(m_prev - m_new) is 1 and ``l * alpha``, ``acc *
alpha`` are identity work. The TPU probe branched on one 256-row block
(``lax.cond``); the kernel (``csrc/flash_fwd.cu``, the bf16 forward with
kSkipRescale, entry point ``ddti_flash_fwd_mskip``) votes per warp of 16
query rows. exp2(0) is exactly 1, so the m-skip kernel's o and lse2 are
bit for bit the production kernel's.

On the card (queued device time; max|err| against attention_reference):

    python -m ddti_tpu_torch.probes.flash_mskip_ab

On the CPU, through the plain versions, errors only:

    python -m ddti_tpu_torch.probes.flash_mskip_ab --device cpu \\
        --shape 1 2 512 32
"""

from __future__ import annotations

import argparse
import math

import torch

from ..ops import attention as A

B, H, S, D = 8, 8, 4096, 32
# the kernel's key tile and the query rows of one warp's vote
BLOCK_K = 64
VOTE_ROWS = 16


def flash_forward_mskip_reference(q, k, v, block_k=BLOCK_K,
                                  vote_rows=VOTE_ROWS):
    """The probe's body in plain PyTorch: an online softmax over key tiles
    of ``block_k``, each group of ``vote_rows`` query rows taking the
    rescale branch where any of its rows' running max grew and the stale
    branch (alpha = 1 left out) where none did. Returns (o, lse2) as
    ``flash_forward_reference`` does; probabilities are rounded to v's
    dtype before P V, l sums them unrounded. The JAX probe is
    ``block_k = vote_rows = 256``. Sets ``.stale_share``, the share of
    (row group, key tile) pairs that took the stale branch."""
    with torch.autocast(q.device.type, enabled=False):
        b, h, s, d = q.shape
        scale, qf = A.LOG2E / math.sqrt(d), q.float()
        m = qf.new_full((b, h, s, 1), -math.inf)
        l = qf.new_zeros((b, h, s, 1))
        acc = qf.new_zeros((b, h, s, d))
        groups, stale, votes = -(-s // vote_rows), 0, 0
        for k0 in range(0, s, block_k):
            kt = k[:, :, k0:k0 + block_k].float()
            vt = v[:, :, k0:k0 + block_k]
            st = (qf @ kt.transpose(-1, -2)) * scale
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            p = A._exp2(st - m_new)
            tile_sum = p.sum(-1, keepdim=True)
            pv = p.to(v.dtype).float() @ vt.float()
            grew = (m_new > m)[..., 0]
            grew = torch.cat([grew, grew.new_zeros(
                (b, h, groups * vote_rows - s))], -1)
            grew = grew.view(b, h, groups, vote_rows).any(-1)
            stale, votes = stale + int((~grew).sum()), votes + grew.numel()
            grew = grew.repeat_interleave(vote_rows, -1)[..., :s, None]
            alpha = A._exp2(m - m_new)
            # rescale where the group's max grew; the stale branch keeps m
            # (m_new == m for every row of such a group)
            l = torch.where(grew, l * alpha + tile_sum, l + tile_sum)
            acc = torch.where(grew, acc * alpha + pv, acc + pv)
            m = m_new
        flash_forward_mskip_reference.stale_share = stale / votes
        o = (acc / l).to(q.dtype)
        return o, (m + torch.log2(l))[..., 0]


flash_forward_mskip_reference.stale_share = None


def flash_forward_mskip_cuda(q, k, v):
    """Launch the m-skip forward (``ddti_flash_fwd_mskip``) on bf16 CUDA
    tensors: returns (o, lse2). Raises on anything the production forward
    does not take (``attention.check_forward_inputs``), and on float32.
    Adds one to ``flash_forward_mskip_cuda.launches`` per launch."""
    A.check_forward_inputs(q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the m-skip forward takes bfloat16 only; got "
                         f"{q.dtype}")
    from ..ops._build import launch

    b, h, s, d = q.shape
    dev = q.device
    o = torch.empty_like(q)
    lse = q.new_empty((b, h, s), dtype=torch.float32)
    launch("flash_fwd_mskip", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), lse.data_ptr(), None, b * h, s, d, 1, dev.index,
           A._stream(dev.index))
    flash_forward_mskip_cuda.launches += 1
    return o, lse


flash_forward_mskip_cuda.launches = 0


def flash_forward_mskip(q, k, v):
    """The m-skip kernel on CUDA tensors, its plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_forward_mskip_reference(q, k, v)
    return flash_forward_mskip_cuda(q, k, v)


def baseline(q, k, v):
    """The production forward: the kernel on CUDA tensors, the plain
    version on CPU ones."""
    if q.device.type == "cpu":
        return A.flash_forward_reference(q, k, v)
    return A.flash_forward_cuda(q, k, v)


def run(shape=(B, H, S, D), dtype=torch.bfloat16, seed=0, device="cuda"):
    """Both forwards on one seeded input: max|err| against
    attention_reference, whether the m-skip output is the baseline's bit for
    bit, and on the card the queued device time of each, taken in the order
    baseline, m-skip, m-skip, baseline (``ms`` is the mean of a side's two,
    ``ms_runs`` both). Prints the TPU probe's lines and returns {name:
    dict}."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(dtype)
               for _ in range(3))
    ref = A.attention_reference(q, k, v).float()
    on_card = q.device.type != "cpu"
    fns = {"baseline": baseline, "m-skip": flash_forward_mskip}
    runs = {name: [] for name in fns}
    if on_card:
        from ._timing import queued_ms

        for name in ("baseline", "m-skip", "m-skip", "baseline"):
            runs[name].append(queued_ms(lambda: fns[name](q, k, v)))
    out = {}
    for name, fn in fns.items():
        o, lse = fn(q, k, v)
        err = float((o.float() - ref).abs().max())
        ms = sum(runs[name]) / 2 if on_card else None
        out[name] = dict(ms=ms, ms_runs=runs[name], max_abs_err=err, o=o,
                         lse=lse)
        print(f"{name:9s} fwd "
              + (f"{ms:6.4f} ms ({runs[name][0]:.4f}, {runs[name][1]:.4f})"
                 if on_card else "not measured")
              + f"   max|err| {err:.3e}", flush=True)
    # the plain versions differ by algorithm (one softmax over all keys,
    # an online one over key tiles): only the kernels are held bit for bit
    pairs = [(out[n].pop("o"), out[n].pop("lse")) for n in out]
    same = None
    if on_card:
        same = all(torch.equal(x, y) for x, y in zip(*pairs))
        print(f"m-skip o and lse2 bit-equal to the baseline: {same}",
              flush=True)
    return dict(out, bit_equal=same, shape=list(shape),
                dtype=str(dtype).split(".")[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--shape", type=int, nargs=4, default=[B, H, S, D],
                   metavar=("B", "H", "S", "D"))
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    run(tuple(a.shape), torch.bfloat16, a.seed, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
