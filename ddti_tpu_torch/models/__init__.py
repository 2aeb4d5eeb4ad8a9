from .zoo import MODEL_REGISTRY, ResUNet, TransUNet, create_model  # noqa: F401
from . import blocks  # noqa: F401
