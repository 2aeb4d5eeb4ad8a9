"""ddti_tpu_torch — the PyTorch/CUDA port of ``ddti_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same file and class names so
each part finds its counterpart. It imports torch, numpy and the standard
library, never JAX or ``ddti_tpu``. Ported so far: the TransUNet serving
path (``cli.serve``), whose attention runs through the hand-written
flash-attention forward kernel in ``csrc/flash_fwd.cu``, and the ResUNet
training loop (``cli.main``), whose boundary loss and surface metrics run
through the hand-written EDT kernel in ``csrc/edt.cu``. ROADMAP.md lists
what is still to port.

- ``ops``    — the CUDA kernels' wrappers and plain versions (attention,
               EDT), their build, the augmentation warps.
- ``models`` — ``blocks`` and ``zoo`` (ResUNet, TransUNet), NCHW
               ``nn.Module``s whose ``state_dict`` keys are the JAX
               package's torch export keys.
- ``data``   — datasets, the device-resident uint8 store, augmentation,
               synthetic frames.
- ``losses``, ``eval`` — the loss suite, confusion counts, surface metrics.
- ``train``  — checkpoints, interop, optimizer and schedule, the steps, the
               Trainer, the serving body.
- ``core``, ``utils`` — config, logging, seeding, early stopping, weight
               initialisers.
- ``cli``    — the training CLI and the HTTP serving daemon.
"""

__version__ = "0.2.0"
