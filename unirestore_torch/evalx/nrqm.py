"""NRQM, the no-reference quality metric for restored images (Ma et al.,
"Learning a no-reference quality metric for single-image super-resolution",
CVIU 2017), the second component of the reference's ``pi`` metric
(eval_image_restoration.py:190-203; PI = 0.5 * ((10 - NRQM) + NIQE)): the
port's own copy of ``unirestore_tpu/evalx/nrqm.py:46-342`` (numpy, scipy and
cv2 on the host, as in the JAX package).

Three statistical feature groups: (1) block-DCT frequency statistics (GGD
shape and energy-ratio pooling over blocks, 2 scales), (2) a steerable
derivative-of-Gaussian pyramid (3 scales x 4 orientations: GGD shape,
spread, cross-scale correlation), (3) spatial PCA of local patches
(normalised singular-value curve and spectral entropy), each regressed to a
score by its own random forest, linearly stacked. Higher is better, on
[0, 10].

The forests are flat node arrays in an .npz (no pickle in the load path) and
inference is a numpy tree walk: ``weights/nrqm_model.npz`` is committed
(``tools/fit_nrqm.py``, self-calibrated on the corruption library's severity
scale). ``fit_nrqm`` imports sklearn lazily: it is needed to fit a model,
never to score. The weights directory is an argument (default ``weights``,
relative to the working directory); the port reads no environment variable.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.fft import dctn
from scipy.special import gamma as gamma_fn

DEFAULT_WEIGHTS = "weights"

_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)
_R_GAM = (gamma_fn(1.0 / _GAMMA_RANGE) * gamma_fn(3.0 / _GAMMA_RANGE)
          / gamma_fn(2.0 / _GAMMA_RANGE) ** 2)
# rho(alpha) is monotonically decreasing -> invert by interpolation
_RHO_SORTED = _R_GAM[::-1]
_ALPHA_SORTED = _GAMMA_RANGE[::-1]


def _ggd_shape_vec(rho):
    """Vectorized GGD shape from the moment ratio E[x^2]/E[|x|]^2."""
    rho = np.clip(rho, _RHO_SORTED[0], _RHO_SORTED[-1])
    return np.interp(rho, _RHO_SORTED, _ALPHA_SORTED)


def _ggd_shape(x):
    x = np.asarray(x, np.float64).ravel()
    e2 = np.mean(x * x)
    e1 = np.mean(np.abs(x))
    if e1 < 1e-12:
        return 10.0
    return float(_ggd_shape_vec(np.asarray([e2 / (e1 * e1)]))[0])


def _to_gray(image):
    """float [0,1] HWC/HW -> float64 [0,255] HW."""
    img = np.asarray(image, np.float64)
    if img.ndim == 3:
        img = img @ np.asarray([0.299, 0.587, 0.114])
    return img * 255.0


def _half(img):
    h, w = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    x = img[:h, :w]
    return (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2]
            + x[1::2, 1::2]) / 4.0


# -- group 1: block-DCT frequency statistics ---------------------------------


def dct_features(gray, block: int = 8):
    """Per-block GGD shape of AC coefficients + low/high energy ratio,
    pooled (mean, 10th percentile) over blocks, at 2 scales -> 8 dims."""
    feats = []
    img = gray
    for _ in range(2):
        h = (img.shape[0] // block) * block
        w = (img.shape[1] // block) * block
        if h < block or w < block:
            feats += [0.0] * 4
            img = _half(img)
            continue
        blocks = img[:h, :w].reshape(h // block, block, w // block, block)
        blocks = blocks.transpose(0, 2, 1, 3).reshape(-1, block, block)
        coeffs = dctn(blocks, axes=(1, 2), norm="ortho")
        flat = coeffs.reshape(len(blocks), -1)
        ac = flat[:, 1:]
        e1 = np.abs(ac).mean(axis=1)
        e2 = (ac * ac).mean(axis=1)
        gam = _ggd_shape_vec(e2 / np.maximum(e1 * e1, 1e-12))
        # low-frequency (top-left quadrant minus DC) share of AC energy
        q = block // 2
        low = (coeffs[:, :q, :q] ** 2).sum(axis=(1, 2)) - coeffs[:, 0, 0] ** 2
        total = (ac * ac).sum(axis=1)
        ratio = low / np.maximum(total, 1e-12)
        feats += [gam.mean(), np.percentile(gam, 10),
                  ratio.mean(), np.percentile(ratio, 10)]
        img = _half(img)
    return np.asarray(feats)


# -- group 2: steerable (derivative-of-Gaussian) pyramid ---------------------


def _dog_kernel(theta, size: int = 7, sigma: float = 1.5):
    half = size // 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    d = -(x * np.cos(theta) + y * np.sin(theta)) / (sigma * sigma) * g
    return d - d.mean()


_THETAS = [0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4]
_DOG = [_dog_kernel(t) for t in _THETAS]


def _filt(img, k):
    import cv2
    return cv2.filter2D(img, -1, k, borderType=cv2.BORDER_REPLICATE)


def pyramid_features(gray, scales: int = 3):
    """GGD shape + spread per (scale, orientation) subband, plus
    cross-scale magnitude correlation per orientation -> 32 dims."""
    img = gray / 255.0
    bands = []  # [scale][orientation]
    for _ in range(scales):
        bands.append([_filt(img, k) for k in _DOG])
        img = _half(img)
    feats = []
    for s in range(scales):
        for b in bands[s]:
            feats += [_ggd_shape(b), float(np.std(b))]
    for s in range(scales - 1):
        for o in range(len(_THETAS)):
            a = np.abs(bands[s][o])
            c = np.abs(bands[s + 1][o])
            a = _half(a)[:c.shape[0], :c.shape[1]]
            c = c[:a.shape[0], :a.shape[1]]
            if a.size < 4 or a.std() < 1e-12 or c.std() < 1e-12:
                feats.append(0.0)
            else:
                feats.append(float(np.corrcoef(a.ravel(), c.ravel())[0, 1]))
    return np.asarray(feats)


# -- group 3: spatial PCA -----------------------------------------------------


def pca_features(gray, patch: int = 5, stride: int = 4, k: int = 10):
    """Normalized singular-value curve of mean-centered patches + spectral
    entropy -> 11 dims."""
    img = gray / 255.0
    ph = (img.shape[0] - patch) // stride + 1
    pw = (img.shape[1] - patch) // stride + 1
    if ph < 2 or pw < 2:
        return np.zeros(k + 1)
    s0, s1 = img.strides
    patches = np.lib.stride_tricks.as_strided(
        img, (ph, pw, patch, patch), (s0 * stride, s1 * stride, s0, s1))
    mat = patches.reshape(-1, patch * patch)
    mat = mat - mat.mean(axis=1, keepdims=True)
    sv = np.linalg.svd(mat, compute_uv=False)[:patch * patch]
    p = sv / max(sv.sum(), 1e-12)
    ent = float(-(p * np.log(p + 1e-12)).sum())
    # fewer than k singular values (tiny images yield min(n_patches, 25)):
    # pad with zeros so the feature vector is always k+1-dim — the
    # regression forests require a fixed input width
    head = np.zeros(k)
    head[:min(k, p.size)] = p[:k]
    return np.concatenate([head, [ent]])


def nrqm_features(image):
    """float [0,1] HWC/HW -> (f_dct(8), f_pyr(32), f_pca(11)) groups."""
    gray = _to_gray(image)
    return dct_features(gray), pyramid_features(gray), pca_features(gray)


# -- two-stage regression (3 forests + linear stack) --------------------------


class NumpyForest:
    """Random-forest regressor as flat node arrays (numpy-only inference).

    All trees' nodes are concatenated; ``offsets`` (len n_trees+1) indexes
    each tree's root. Internal nodes have ``feature >= 0``; a sample goes
    left when ``x[feature] <= threshold``. Leaves carry the regression
    value. This is the standard CART array layout (sklearn's ``tree_``
    exposes the same arrays), so fitted sklearn forests convert losslessly.
    """

    def __init__(self, left, right, feature, threshold, value, offsets):
        self.left = np.asarray(left, np.int32)
        self.right = np.asarray(right, np.int32)
        self.feature = np.asarray(feature, np.int32)
        self.threshold = np.asarray(threshold, np.float64)
        self.value = np.asarray(value, np.float64)
        self.offsets = np.asarray(offsets, np.int64)

    @classmethod
    def from_sklearn(cls, rf):
        left, right, feat, thr, val, off = [], [], [], [], [], [0]
        for est in rf.estimators_:
            t = est.tree_
            left.append(t.children_left)
            right.append(t.children_right)
            feat.append(t.feature)
            thr.append(t.threshold)
            val.append(t.value.reshape(-1))
            off.append(off[-1] + t.node_count)
        return cls(np.concatenate(left), np.concatenate(right),
                   np.concatenate(feat), np.concatenate(thr),
                   np.concatenate(val), off)

    def predict(self, X):
        X = np.asarray(X, np.float64)
        out = np.zeros(len(X))
        n_trees = len(self.offsets) - 1
        for i, x in enumerate(X):
            acc = 0.0
            for t in range(n_trees):
                node = self.offsets[t]
                while self.feature[node] >= 0:
                    if x[self.feature[node]] <= self.threshold[node]:
                        node = self.offsets[t] + self.left[node]
                    else:
                        node = self.offsets[t] + self.right[node]
                acc += self.value[node]
            out[i] = acc / n_trees
        return out

    def arrays(self, prefix):
        return {f"{prefix}_left": self.left, f"{prefix}_right": self.right,
                f"{prefix}_feature": self.feature,
                f"{prefix}_threshold": self.threshold,
                f"{prefix}_value": self.value,
                f"{prefix}_offsets": self.offsets}

    @classmethod
    def from_arrays(cls, d, prefix):
        return cls(d[f"{prefix}_left"], d[f"{prefix}_right"],
                   d[f"{prefix}_feature"], d[f"{prefix}_threshold"],
                   d[f"{prefix}_value"], d[f"{prefix}_offsets"])


class NRQMModel:
    def __init__(self, forests, stack_w, stack_b):
        self.forests = forests  # one NumpyForest per feature group
        self.stack_w = np.asarray(stack_w, np.float64)
        self.stack_b = float(stack_b)

    def score(self, image) -> float:
        groups = nrqm_features(image)
        s = np.asarray([f.predict(g[None])[0]
                        for f, g in zip(self.forests, groups)])
        return float(np.clip(s @ self.stack_w + self.stack_b, 0.0, 10.0))

    def save(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {"stack_w": self.stack_w,
                  "stack_b": np.asarray([self.stack_b])}
        for g, f in enumerate(self.forests):
            arrays.update(f.arrays(f"f{g}"))
        # write to the exact path given (np.savez on a str appends .npz)
        with open(path, "wb") as fh:
            np.savez_compressed(fh, **arrays)

    @classmethod
    def load(cls, path):
        # allow_pickle stays False (numpy's default): the artifact is pure
        # arrays and must never be an arbitrary-code-execution vector
        with np.load(path) as d:
            forests = [NumpyForest.from_arrays(d, f"f{g}") for g in range(3)]
            return cls(forests, d["stack_w"], float(d["stack_b"][0]))


def fit_nrqm(images, labels, n_estimators: int = 100, seed: int = 0):
    """Fit the two-stage regression on (image, score) pairs.

    Stage 1: one random forest per feature group (the paper's three
    group-specific forests). Stage 2: least-squares linear stack of the
    three group predictions (the paper's linear combination).
    """
    from sklearn.ensemble import RandomForestRegressor

    feats = [nrqm_features(im) for im in images]
    y = np.asarray(labels, np.float64)
    forests, preds = [], []
    for g in range(3):
        X = np.stack([f[g] for f in feats])
        rf = RandomForestRegressor(n_estimators=n_estimators,
                                   random_state=seed + g, n_jobs=-1)
        rf.fit(X, y)
        forests.append(NumpyForest.from_sklearn(rf))
        preds.append(forests[-1].predict(X))
    P = np.stack(preds, axis=1)
    A = np.concatenate([P, np.ones((len(y), 1))], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return NRQMModel(forests, coef[:3], coef[3])


def default_model_path(weights_dir=None):
    return os.path.join(weights_dir or DEFAULT_WEIGHTS, "nrqm_model.npz")


class NRQMMetric:
    """MeanMetric-style wrapper using weights/nrqm_model.npz."""

    def __init__(self, model_path: str | None = None, weights_dir=None):
        path = model_path or default_model_path(weights_dir)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"NRQM model not found at {path}; fit one with "
                "tools/fit_nrqm.py <clean_image_dir>")
        self.model = NRQMModel.load(path)
        self.total, self.count = 0.0, 0

    def update(self, images):
        for img in np.asarray(images):
            self.total += self.model.score(img)
            self.count += 1

    def compute(self):
        if self.count == 0:
            # match the suite's documented no-data stand-in (NRQM=5.0,
            # nr_suite.PIMetric) instead of silently returning 0.0 and
            # shifting PI by 2.5 points
            return 5.0
        return self.total / self.count

    def reset(self):
        self.total, self.count = 0.0, 0
