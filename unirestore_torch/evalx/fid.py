"""FID: the Frechet distance over deep features, with real-feature caching
(the port's own copy of ``unirestore_tpu/evalx/fid.py:17-90``; numpy and scipy
only, the statistics in float64 on the host).

The reference uses torchmetrics' FrechetInceptionDistance with
``reset_real_features`` control, so that the real statistics persist across
epochs (eval_image_restoration.py:186-187, 243-253). ``FID`` takes a pluggable
extractor; ``evalx/inception.py:make_fid_extractor`` gives the InceptionV3
pool3 one on the card.
"""

from __future__ import annotations

import numpy as np


class FIDStats:
    """Streaming mean / covariance accumulator over feature vectors."""

    def __init__(self, dim: int):
        self.dim = dim
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = np.zeros(self.dim, np.float64)
        self.outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats: np.ndarray):
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    def finalize(self):
        mu = self.sum / max(self.n, 1)
        cov = (self.outer - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6):
    """||mu1 - mu2||^2 + Tr(c1 + c2 - 2 sqrt(c1 c2)).

    ``sqrtm`` is called without the JAX function's ``disp=False``: SciPy 1.16
    deprecated the argument and 1.18 removed it; the square root is the same."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))


class FID:
    """FID with torchmetrics' ``reset_real_features`` semantics."""

    def __init__(self, extractor, dim: int):
        """``extractor(images_nhwc_float01) -> (B, dim)`` numpy features."""
        self.extractor = extractor
        self.real = FIDStats(dim)
        self.fake = FIDStats(dim)
        # after the first epoch's reset(reset_real_features=False) the real
        # statistics are frozen: the FID objects live across validate() epochs
        # (config.build's _eval_cache) while validation_step feeds the targets
        # every epoch, and without the freeze each epoch would add another copy
        # of the val set's real features (eval_image_restoration.py:235-253)
        self.real_frozen = False

    def update(self, images, real: bool):
        if real and self.real_frozen:
            return  # and no extractor call
        feats = np.asarray(self.extractor(images))
        (self.real if real else self.fake).update(feats)

    def compute(self):
        mu_r, cov_r = self.real.finalize()
        mu_f, cov_f = self.fake.finalize()
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)

    def reset(self, reset_real_features: bool = True):
        self.fake.reset()
        if reset_real_features:
            self.real.reset()
            self.real_frozen = False
        else:
            self.real_frozen = True
