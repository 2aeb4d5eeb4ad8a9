"""Model-zoo parameter counter, ported from ``ddti_tpu/cli/params.py`` (the
reference's ``python test.py``).

    python -m ddti_tpu_torch.cli.params

The first section counts the reference tool's set, the legacy zoo at its
default ctors with one channel in and out (LegacyUNet, MoresVNet2D,
TripleBranchImprovedVNet, MoresTransUNet with its 512-pixel positional
embedding, MoresResUNet, MoresASPPUNet, MoresAttentionUNet), printed under
the reference's names in its order; the second the active zoo the training
CLI uses. The models are built on the ``meta`` device: nothing is
allocated, so even the 160M-parameter triple-branch net costs
milliseconds, and no ``--device`` is needed.
"""

from __future__ import annotations

import sys

# the reference test.py set, in its order: (printed name, legacy model)
REFERENCE_SET = [
    ("UNet", "LegacyUNet"),
    ("VNet2D", "MoresVNet2D"),
    ("ImprovedVNet", "TripleBranchImprovedVNet"),
    ("TransUNet", "MoresTransUNet"),
    ("ResUNet", "MoresResUNet"),
    ("ASPPUNet", "MoresASPPUNet"),
    ("AttentionUNet", "MoresAttentionUNet"),
]


def count(model_type: str, **kwargs) -> int:
    """The parameter count of ``create_model(model_type, **kwargs)``, built
    on the meta device."""
    import torch

    from ddti_tpu_torch.models import create_model

    with torch.device("meta"):
        model = create_model(model_type, **kwargs)
    return sum(p.numel() for p in model.parameters())


def main(argv=None) -> int:
    from ddti_tpu_torch.models import MODEL_REGISTRY

    print("# reference test.py set (legacy zoo, torch-default ctors)")
    for ref_name, port_name in REFERENCE_SET:
        print(f"{ref_name}: {count(port_name)}")
    print("# active zoo (models/mod.py equivalents, default ctors)")
    for name in MODEL_REGISTRY:
        print(f"{name}: {count(name, in_channels=1, out_channels=1)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
