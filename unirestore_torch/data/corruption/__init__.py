"""ImageNet-C corruptions (the port's copy of ``unirestore_tpu/data/corruption``)."""

from .imagenet_c import (  # noqa: F401
    CORRUPTION_NAMES,
    corrupt,
    init_corruption_function,
)
