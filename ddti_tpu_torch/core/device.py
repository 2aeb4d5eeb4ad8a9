"""The device every entry point of the port runs on: the card unless the
caller asks for the CPU."""

from __future__ import annotations


def resolve_device(name: str = "cuda"):
    """``--device`` (or a library call's ``device``) -> ``torch.device``.
    A CUDA device that is not there raises: nothing falls back to the CPU
    on its own."""
    import torch

    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: CUDA is not available. Pass --device cpu "
                f"(device='cpu') to run on the CPU deliberately")
        # float32 means float32: no TF32 in convolutions or matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"--device {name}: expected cuda[:N] or cpu")
    return device
