"""Port parity: HRNetV2-32 and -48 under DeepLabV3 / V3+ against the JAX package.

``tests/test_torch_backbones.py``'s comparison (one calibrated seeded tree at
published widths and full depth on both sides, a 64 x 64 image, the JAX
functions eager) for the two HRNet names of each head: the backbone's
{"low", "high"} and the logits within 1e-4 of their largest |value|.
"""

import pytest
import torch

from test_torch_backbones import check_features_and_logits

torch.set_num_threads(2)


@pytest.mark.parametrize("plus", ["", "plus"])
@pytest.mark.parametrize("backbone", ["hrnetv2_32", "hrnetv2_48"])
def test_hrnet_features_and_logits_match_jax(backbone, plus):
    check_features_and_logits(backbone, plus)
