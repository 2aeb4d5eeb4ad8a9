"""ddti_tpu_torch — the PyTorch/CUDA port of ``ddti_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same file and class names so
each part finds its counterpart. It imports torch, numpy and the standard
library, never JAX or ``ddti_tpu``. Ported so far: the TransUNet serving
path (``cli.serve``), whose attention runs through the hand-written
flash-attention forward kernel in ``csrc/flash_fwd.cu``. ROADMAP.md lists
what is still to port.

- ``ops``    — attention: the CUDA kernel's wrapper and its plain version.
- ``models`` — ``blocks`` and ``zoo`` (TransUNet), NCHW ``nn.Module``s whose
               ``state_dict`` keys are the JAX package's torch export keys.
- ``train``  — ``.pth`` / ``.npz`` checkpoint loading and the serving body.
- ``cli``    — the HTTP serving daemon.
"""

__version__ = "0.1.0"
