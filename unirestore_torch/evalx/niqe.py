"""NIQE, the Natural Image Quality Evaluator (no-reference): the port's own
copy of ``unirestore_tpu/evalx/niqe.py:26-160`` (numpy, scipy and cv2 on the
host, as in the JAX package; the reference's pyiqa NIQE is host code too).

The reference's NR evaluation uses 10 pyiqa metrics with ``niqe`` as the NR
val monitor (eval_image_restoration.py:190-203, :107). NIQE is the one
classical member: NSS features (AGGD fits over MSCN coefficients and pairwise
products, 2 scales) compared to a pristine multivariate Gaussian by a
Mahalanobis-style distance. The pristine model (mu, cov) is
``weights/niqe_params.npz`` (committed; ``tools/fit_niqe.py`` fits one from a
folder of clean images with ``fit_niqe_model``). The weights directory is an
argument (default ``weights``, relative to the working directory, as
``zoo.py``); the port reads no environment variable.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
from scipy.special import gamma as gamma_fn

DEFAULT_WEIGHTS = "weights"

_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)
_R_GAM = (gamma_fn(1.0 / _GAMMA_RANGE) * gamma_fn(3.0 / _GAMMA_RANGE)
          / gamma_fn(2.0 / _GAMMA_RANGE) ** 2)


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0):
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2(img, kernel):
    import cv2
    return cv2.filter2D(img, -1, kernel, borderType=cv2.BORDER_REPLICATE)


def mscn(img: np.ndarray):
    """Mean-subtracted contrast-normalised coefficients (float64 HW)."""
    w = _gaussian_window()
    mu = _filter2(img, w)
    sigma = np.sqrt(np.abs(_filter2(img * img, w) - mu * mu))
    return (img - mu) / (sigma + 1.0)


def fit_aggd(x: np.ndarray):
    """Asymmetric generalised Gaussian fit -> (alpha, beta_l, beta_r)."""
    x = x.ravel()
    left = x[x < 0]
    right = x[x > 0]
    sigma_l = np.sqrt(np.mean(left ** 2)) if left.size else 1e-6
    sigma_r = np.sqrt(np.mean(right ** 2)) if right.size else 1e-6
    gamma_hat = sigma_l / max(sigma_r, 1e-9)
    r_hat = (np.mean(np.abs(x)) ** 2) / max(np.mean(x ** 2), 1e-9)
    rhat_norm = r_hat * (gamma_hat ** 3 + 1) * (gamma_hat + 1) / (gamma_hat ** 2 + 1) ** 2
    alpha = _GAMMA_RANGE[np.argmin((_R_GAM - rhat_norm) ** 2)]
    beta_l = sigma_l * np.sqrt(gamma_fn(1 / alpha) / gamma_fn(3 / alpha))
    beta_r = sigma_r * np.sqrt(gamma_fn(1 / alpha) / gamma_fn(3 / alpha))
    return alpha, beta_l, beta_r


def _patch_features(patch: np.ndarray):
    feats = []
    m = mscn(patch)
    alpha, bl, br = fit_aggd(m)
    feats += [alpha, (bl + br) / 2.0]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        prod = m * np.roll(m, shift, axis=(0, 1))
        alpha, bl, br = fit_aggd(prod)
        mean = (br - bl) * (gamma_fn(2 / alpha) / gamma_fn(1 / alpha))
        feats += [alpha, mean, bl, br]
    return np.asarray(feats)  # 18 features


def niqe_features(gray: np.ndarray, patch_size: int = 96):
    """Per-patch 36-d features over 2 scales; patches chosen at scale 1."""
    import cv2
    h, w = gray.shape
    h2, w2 = (h // patch_size) * patch_size, (w // patch_size) * patch_size
    if h2 < patch_size or w2 < patch_size:
        raise ValueError("image too small for NIQE")
    img1 = gray[:h2, :w2]
    img2 = cv2.resize(img1, (w2 // 2, h2 // 2), interpolation=cv2.INTER_AREA)
    feats = []
    for i in range(0, h2 - patch_size + 1, patch_size):
        for j in range(0, w2 - patch_size + 1, patch_size):
            f1 = _patch_features(img1[i:i + patch_size, j:j + patch_size])
            p2 = patch_size // 2
            f2 = _patch_features(img2[i // 2:i // 2 + p2, j // 2:j // 2 + p2])
            feats.append(np.concatenate([f1, f2]))
    return np.asarray(feats)


def _gray255(image: np.ndarray) -> np.ndarray:
    """float [0, 1] HWC (RGB, through cv2's grey conversion in fp32) or HW ->
    float64 [0, 255] HW."""
    if image.ndim == 3:
        import cv2
        return cv2.cvtColor(image.astype(np.float32),
                            cv2.COLOR_RGB2GRAY).astype(np.float64) * 255.0
    return image.astype(np.float64) * 255.0


def niqe(image: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray):
    """image: float [0, 1] HWC or HW. Lower is better."""
    feats = niqe_features(_gray255(image))
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    pooled = (cov_pris + cov) / 2.0
    diff = mu_pris - mu
    inv = np.linalg.pinv(pooled)
    return float(np.sqrt(max(diff @ inv @ diff, 0.0)))


def fit_niqe_model(images):
    """Fit the pristine MVG from an iterable of [0, 1] HWC float images."""
    feats = np.concatenate([niqe_features(_gray255(img)) for img in images], axis=0)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


class NIQEMetric:
    """MeanMetric-style wrapper over ``<weights_dir>/niqe_params.npz``."""

    def __init__(self, params_path: str | None = None, weights_dir=None):
        path = params_path or os.path.join(weights_dir or DEFAULT_WEIGHTS, "niqe_params.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"NIQE pristine model not found at {path}; fit one with "
                "tools/fit_niqe.py <clean_image_dir>")
        d = np.load(path)
        self.mu, self.cov = d["mu"], d["cov"]
        self.total, self.count = 0.0, 0

    def update(self, images):
        for img in images:
            try:
                score = niqe(np.asarray(img), self.mu, self.cov)
            except ValueError:
                # an image under 96 px has no 96 x 96 block (niqe_features):
                # skip it and score the rest rather than abort the epoch
                warnings.warn("NIQE skipped an image smaller than 96px")
                continue
            self.total += score
            self.count += 1

    def compute(self):
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0
