"""ImageNet-C style corruption library (fresh numpy/cv2/scipy implementation).

The port's own copy of ``unirestore_tpu/data/corruption/imagenet_c.py`` (numpy only; the port imports
nothing of the JAX package).

Implements the 19 corruption families + "clean" that the reference's data
engine draws from (reference: src/data/corruption/corruptions.py, an
imagecorruptions fork; dispatcher src/data/corruption/__init__.py:36-117).
The severity parameter tables follow the public ImageNet-C specification
(Hendrycks & Dietterich, arXiv:1903.12261) so corrupted distributions match;
the implementations here are written from scratch for this framework.

API: ``corrupt(uint8 HWC image, severity 1-5, corruption_name)`` -> uint8 HWC,
``init_corruption_function(subset)`` -> list of names incl. "clean".

Frost textures: the original ships 6 photographs. We procedurally synthesize
frost-like textures at import time (seeded fractal noise sharpened into
crystalline streaks) and also accept user textures via
``UNIRESTORE_FROST_DIR`` (any images in that directory are used instead).
"""

from __future__ import annotations

import io
import os

import cv2
import numpy as np
from PIL import Image

from . import native as _native

# native C++ fast path for the pure-python hot spots (fog fractal, glass
# shuffle, impulse); disable with UNIRESTORE_NATIVE=0
_USE_NATIVE = (os.environ.get("UNIRESTORE_NATIVE", "1") != "0"
               and _native.available())


# ---------------------------------------------------------------------------
# randomness: thread-local generator
# ---------------------------------------------------------------------------
# The reference library draws from numpy's GLOBAL RNG, which makes
# multi-threaded loaders nondeterministic (worker threads interleave draws
# from one stream). Every corruption here draws from a thread-local
# Generator instead: ``corrupt(..., rng=...)`` (or ``set_rng``) installs
# the caller's per-sample generator for the current thread, so N loader
# threads corrupt N samples concurrently AND reproducibly.

import threading

_TLS = threading.local()


def set_rng(rng: np.random.Generator | None):
    _TLS.rng = rng


def _rand() -> np.random.Generator:
    rng = getattr(_TLS, "rng", None)
    if rng is None:
        rng = np.random.default_rng()
        _TLS.rng = rng
    return rng


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.uint8(np.clip(img, 0.0, 1.0) * 255.0)


def _gaussian_blur(img_f: np.ndarray, sigma: float) -> np.ndarray:
    return cv2.GaussianBlur(img_f, ksize=(0, 0), sigmaX=sigma,
                            borderType=cv2.BORDER_REFLECT101)


def _disk_kernel(radius: int, alias_blur: float) -> np.ndarray:
    if radius <= 8:
        coords = np.arange(-8, 8 + 1)
        ksize = (3, 3)
    else:
        coords = np.arange(-radius, radius + 1)
        ksize = (5, 5)
    xx, yy = np.meshgrid(coords, coords)
    disk = ((xx ** 2 + yy ** 2) <= radius ** 2).astype(np.float32)
    disk /= disk.sum()
    return cv2.GaussianBlur(disk, ksize=ksize, sigmaX=alias_blur)


def _plasma_fractal(mapsize: int = 256, wibbledecay: float = 3.0,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Diamond-square heightmap in [0, 1], power-of-two size."""
    rng = rng or np.random.default_rng()
    assert mapsize & (mapsize - 1) == 0
    maparray = np.empty((mapsize, mapsize), dtype=np.float64)
    maparray[0, 0] = 0
    stepsize = mapsize
    wibble = 100.0

    def wibbledmean(array):
        return array / 4.0 + wibble * rng.uniform(-wibble, wibble,
                                                  array.shape) / wibble

    while stepsize >= 2:
        half = stepsize // 2
        # diamond step
        corners = maparray[0:mapsize:stepsize, 0:mapsize:stepsize]
        squareaccum = (corners + np.roll(corners, 1, axis=0)
                       + np.roll(corners, 1, axis=1)
                       + np.roll(np.roll(corners, 1, axis=0), 1, axis=1))
        maparray[half:mapsize:stepsize, half:mapsize:stepsize] = \
            wibbledmean(squareaccum)
        # square step
        centers = maparray[half:mapsize:stepsize, half:mapsize:stepsize]
        up = corners + np.roll(corners, 1, axis=0)
        left = corners + np.roll(corners, 1, axis=1)
        ldr = centers + np.roll(centers, 1, axis=1)
        tdr = centers + np.roll(centers, 1, axis=0)
        maparray[half:mapsize:stepsize, 0:mapsize:stepsize] = \
            wibbledmean(up + ldr)
        maparray[0:mapsize:stepsize, half:mapsize:stepsize] = \
            wibbledmean(left + tdr)
        stepsize //= 2
        wibble /= wibbledecay

    maparray -= maparray.min()
    return maparray / maparray.max()


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _motion_kernel(radius: int, sigma: float, angle_deg: float) -> np.ndarray:
    """Gaussian-weighted line kernel (ImageMagick-style motion blur)."""
    size = 2 * radius + 1
    k = np.zeros((size, size), np.float32)
    x = np.arange(0, radius + 1, dtype=np.float32)
    w = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    rad = np.deg2rad(angle_deg)
    for i, wi in enumerate(w):
        px = int(round(radius + i * np.cos(rad)))
        py = int(round(radius + i * np.sin(rad)))
        if 0 <= px < size and 0 <= py < size:
            k[py, px] += wi
    return k / k.sum()


# ---------------------------------------------------------------------------
# frost textures (procedural)
# ---------------------------------------------------------------------------

_FROST_CACHE: list[np.ndarray] = []
_FROST_LOCK = threading.Lock()


def _make_frost_textures():
    global _FROST_CACHE
    if _FROST_CACHE:  # published atomically below; safe lock-free fast path
        return _FROST_CACHE
    with _FROST_LOCK:
        if _FROST_CACHE:
            return _FROST_CACHE
        built: list[np.ndarray] = []
        user_dir = os.environ.get("UNIRESTORE_FROST_DIR")
        if user_dir and os.path.isdir(user_dir):
            for f in sorted(os.listdir(user_dir)):
                p = os.path.join(user_dir, f)
                img = cv2.imread(p, cv2.IMREAD_COLOR)
                if img is not None:
                    built.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        if not built:
            rng = np.random.default_rng(1234)
            for i in range(6):
                size = 768
                base = _plasma_fractal(1024, wibbledecay=2.2,
                                       rng=rng)[:size, :size]
                # streaky crystalline structure: directional blur of
                # thresholded noise
                streaks = (base > 0.55).astype(np.float32)
                angle = rng.uniform(-60, 60)
                streaks = cv2.filter2D(streaks, -1,
                                       _motion_kernel(9, 4.0, angle))
                tex = np.clip(0.55 * base + 0.75 * streaks + 0.35, 0, 1)
                tex = (tex * 255).astype(np.uint8)
                built.append(np.stack([tex] * 3, axis=-1))
        _FROST_CACHE = built  # single publish
    return _FROST_CACHE


# ---------------------------------------------------------------------------
# corruption functions: img is uint8 HWC RGB, return float HWC in [0,1]
# ---------------------------------------------------------------------------


def gaussian_noise(img, severity):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = _to_float(img)
    return x + _rand().normal(size=x.shape, scale=c).astype(np.float32)


def shot_noise(img, severity):
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _to_float(img)
    return _rand().poisson(x * c).astype(np.float32) / c


def impulse_noise(img, severity):
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    x = _to_float(img).copy()
    if _USE_NATIVE:
        return _native.impulse_noise(x, c, int(_rand().integers(2 ** 31)))
    mask = _rand().uniform(size=x.shape)
    x[mask < c / 2] = 0.0
    x[mask > 1 - c / 2] = 1.0
    return x


def speckle_noise(img, severity):
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    x = _to_float(img)
    return x + x * _rand().normal(size=x.shape, scale=c).astype(np.float32)


def gaussian_blur(img, severity):
    c = [1, 2, 3, 4, 6][severity - 1]
    return _gaussian_blur(_to_float(img), c)


def glass_blur(img, severity):
    sigma, max_delta, iters = [(0.7, 1, 2), (0.9, 2, 1), (1, 2, 3),
                               (1.1, 3, 2), (1.5, 4, 2)][severity - 1]
    x = _gaussian_blur(_to_float(img), sigma)
    h, w = x.shape[:2]
    if _USE_NATIVE:
        x = _native.glass_shuffle(x, max_delta, iters,
                                  int(_rand().integers(2 ** 31)))
    else:
        for _ in range(iters):
            dx = _rand().integers(-max_delta, max_delta + 1, (h, w))
            dy = _rand().integers(-max_delta, max_delta + 1, (h, w))
            yy = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
            xx = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
            x = x[yy, xx]
    return _gaussian_blur(x, sigma)


def defocus_blur(img, severity):
    radius, alias = [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5),
                     (10, 0.5)][severity - 1]
    kernel = _disk_kernel(radius, alias)
    x = _to_float(img)
    return cv2.filter2D(x, -1, kernel, borderType=cv2.BORDER_REFLECT101)


def motion_blur(img, severity):
    radius, sigma = [(10, 3), (15, 5), (15, 8), (15, 12), (20, 15)][severity - 1]
    angle = _rand().uniform(-45, 45)
    x = _to_float(img)
    return cv2.filter2D(x, -1, _motion_kernel(radius, sigma, angle),
                        borderType=cv2.BORDER_REFLECT101)


def zoom_blur(img, severity):
    c = [np.arange(1, 1.11, 0.01), np.arange(1, 1.16, 0.01),
         np.arange(1, 1.21, 0.02), np.arange(1, 1.26, 0.02),
         np.arange(1, 1.31, 0.03)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    out = np.zeros_like(x)
    for factor in c:
        zh, zw = int(np.ceil(h * factor)), int(np.ceil(w * factor))
        zoomed = cv2.resize(x, (zw, zh), interpolation=cv2.INTER_LINEAR)
        top, left = (zh - h) // 2, (zw - w) // 2
        out += zoomed[top:top + h, left:left + w]
    return (x + out) / (len(c) + 1)


def fog(img, severity):
    c, decay = [(1.5, 2), (2.0, 2), (2.5, 1.7), (2.5, 1.5),
                (3.0, 1.4)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    mapsize = _next_pow2(max(h, w, 32))
    if _USE_NATIVE:
        plasma = _native.plasma_fractal(mapsize, decay,
                                        int(_rand().integers(2 ** 31)))[:h, :w]
    else:
        plasma = _plasma_fractal(mapsize, wibbledecay=decay,
                                 rng=_rand())[:h, :w]
    maxval = x.max()
    x = x + c * plasma[..., None].astype(np.float32)
    return x * maxval / (maxval + c)


def frost(img, severity):
    mix = [(1.0, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7),
           (0.6, 0.75)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    textures = _make_frost_textures()
    tex = textures[_rand().integers(len(textures))]
    th, tw = tex.shape[:2]
    if th < h or tw < w:
        tex = cv2.resize(tex, (max(w, tw), max(h, th)))
        th, tw = tex.shape[:2]
    top = _rand().integers(0, th - h + 1)
    left = _rand().integers(0, tw - w + 1)
    patch = _to_float(tex[top:top + h, left:left + w])
    return mix[0] * x + mix[1] * patch


def snow(img, severity):
    loc, scale, zoom_f, thresh, blur_r, blur_sig, mix = [
        (0.1, 0.3, 3, 0.5, 10, 4, 0.8), (0.2, 0.3, 2, 0.5, 12, 4, 0.7),
        (0.55, 0.3, 4, 0.9, 12, 8, 0.7), (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
        (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    layer = _rand().normal(size=(h, w), loc=loc, scale=scale).astype(
        np.float32)
    zh, zw = int(np.ceil(h * zoom_f)), int(np.ceil(w * zoom_f))
    layer = cv2.resize(layer, (zw, zh),
                       interpolation=cv2.INTER_LINEAR)[:h, :w]
    layer[layer < thresh] = 0.0
    angle = _rand().uniform(-135, -45)
    layer = cv2.filter2D(layer, -1, _motion_kernel(blur_r, blur_sig, angle))
    layer = np.clip(layer, 0, 1)[..., None]
    gray = cv2.cvtColor(x, cv2.COLOR_RGB2GRAY)
    x = mix * x + (1 - mix) * np.maximum(x, gray[..., None] * 1.5 + 0.5)
    return np.clip(x + layer + np.rot90(layer, k=2), 0, 1)


def brightness(img, severity):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    x = _to_float(img)
    hsv = cv2.cvtColor(x, cv2.COLOR_RGB2HSV)
    hsv[..., 2] = np.clip(hsv[..., 2] + c, 0, 1)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def saturate(img, severity):
    c = [(0.3, 0.0), (0.1, 0.0), (2.0, 0.0), (5.0, 0.1),
         (20.0, 0.2)][severity - 1]
    x = _to_float(img)
    hsv = cv2.cvtColor(x, cv2.COLOR_RGB2HSV)
    hsv[..., 1] = np.clip(hsv[..., 1] * c[0] + c[1], 0, 1)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def contrast(img, severity):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = _to_float(img)
    mean = x.mean(axis=(0, 1), keepdims=True)
    return (x - mean) * c + mean


def elastic_transform(img, severity):
    # (affine strength, displacement sigma, displacement alpha) relative to
    # the image side, per the public spec
    c = [(0.05, 0.01, 0.02), (0.065, 0.02, 0.02), (0.085, 0.03, 0.02),
         (0.1, 0.04, 0.02), (0.12, 0.06, 0.02)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    shape_size = np.array([h, w], np.float32)

    # random affine around the center
    center = shape_size // 2
    sq_size = min(h, w) // 3
    pts1 = np.float32([center + sq_size,
                       [center[1] + sq_size, center[0] - sq_size],
                       center - sq_size])
    pts2 = pts1 + _rand().uniform(-c[2] * min(h, w), c[2] * min(h, w),
                                    size=pts1.shape).astype(np.float32)
    M = cv2.getAffineTransform(pts1, pts2)
    x = cv2.warpAffine(x, M, (w, h), borderMode=cv2.BORDER_REFLECT101)

    dx = cv2.GaussianBlur(
        _rand().uniform(-1, 1, size=(h, w)).astype(np.float32), (0, 0),
        c[1] * min(h, w)) * c[0] * min(h, w)
    dy = cv2.GaussianBlur(
        _rand().uniform(-1, 1, size=(h, w)).astype(np.float32), (0, 0),
        c[1] * min(h, w)) * c[0] * min(h, w)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    map_x = (xx + dx).astype(np.float32)
    map_y = (yy + dy).astype(np.float32)
    return cv2.remap(x, map_x, map_y, interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REFLECT101)


def pixelate(img, severity):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = cv2.resize(img, (max(1, int(w * c)), max(1, int(h * c))),
                       interpolation=cv2.INTER_AREA)
    return _to_float(cv2.resize(small, (w, h),
                                interpolation=cv2.INTER_NEAREST))


def jpeg_compression(img, severity):
    c = [25, 18, 15, 10, 7][severity - 1]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=c)
    buf.seek(0)
    return _to_float(np.asarray(Image.open(buf).convert("RGB")))


def spatter(img, severity):
    # (loc, scale, blur sigma, threshold, mud multiplier, water mode)
    c = [(0.65, 0.3, 4, 0.69, 0.6, 0), (0.65, 0.3, 3, 0.68, 0.6, 0),
         (0.65, 0.3, 2, 0.68, 0.5, 0), (0.65, 0.3, 1, 0.65, 1.5, 1),
         (0.67, 0.4, 1, 0.65, 1.5, 1)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    liquid = _rand().normal(size=(h, w), loc=c[0], scale=c[1]).astype(
        np.float32)
    liquid = _gaussian_blur(liquid, c[2])
    liquid[liquid < c[3]] = 0.0
    if c[5] == 0:
        # water droplets: bluish translucent overlay
        m = np.clip(liquid * c[4], 0, 1)
        dist = _gaussian_blur(m, 1.0)
        drops = np.stack([dist * 0.7, dist * 0.7, dist * 1.0], axis=-1)
        return np.clip(x * (1 - m[..., None]) + drops * m[..., None] + x * 0.6
                       * m[..., None], 0, 1)
    # mud: brown opaque splotches
    m = np.where(liquid > 0, 1.0, 0.0).astype(np.float32)
    m = _gaussian_blur(m, 0.7) * c[4]
    m = np.clip(m, 0, 1)[..., None]
    mud = np.stack([0.44 * np.ones((h, w)), 0.31 * np.ones((h, w)),
                    0.19 * np.ones((h, w))], axis=-1).astype(np.float32)
    return x * (1 - m) + mud * m


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

CORRUPTION_FUNCS = (
    gaussian_noise, shot_noise, impulse_noise, defocus_blur, glass_blur,
    motion_blur, zoom_blur, snow, frost, fog, brightness, contrast,
    elastic_transform, pixelate, jpeg_compression,
    speckle_noise, gaussian_blur, spatter, saturate,
)
CORRUPTION_NAMES = tuple(f.__name__ for f in CORRUPTION_FUNCS)
_BY_NAME = {f.__name__: f for f in CORRUPTION_FUNCS}


def corrupt(image: np.ndarray, severity: int = 1,
            corruption_name: str | None = None,
            corruption_number: int = -1,
            rng: np.random.Generator | None = None) -> np.ndarray:
    """uint8 HWC in -> uint8 HWC out (same API as the reference dispatcher).

    ``rng`` (optional) installs a per-sample Generator for this thread for
    the duration of THIS call only — deterministic corruption under
    multi-threaded loaders without leaking the generator into later
    unrelated corrupt() calls on the same thread."""
    if rng is not None:
        set_rng(rng)
    try:
        if image.dtype != np.uint8:
            raise ValueError("expected uint8 image")
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        if severity not in (1, 2, 3, 4, 5):
            raise ValueError("severity must be in [1, 5]")
        if corruption_name == "clean":
            return image.copy()
        if corruption_name is not None:
            fn = _BY_NAME[corruption_name]
        elif corruption_number >= 0:
            fn = CORRUPTION_FUNCS[corruption_number]
        else:
            raise ValueError("need corruption_name or corruption_number")
        return _to_uint8(fn(image, severity))
    finally:
        if rng is not None:
            set_rng(None)


def init_corruption_function(subset: str = "common") -> list[str]:
    """Subset selector (reference corruption/__init__.py:98-117); every
    subset additionally includes "clean"."""
    names = list(CORRUPTION_NAMES)
    table = {
        "common": names[:15],
        "clean": [],
        "validation": names[15:],
        "all": names,
        "noise": names[0:3],
        "blur": names[3:7],
        "weather": names[7:11],
        "digital": names[11:15],
    }
    if subset not in table:
        raise ValueError(
            "subset must be one of ['clean', 'common', 'validation', 'all', "
            "'noise', 'blur', 'weather', 'digital']")
    return table[subset] + ["clean"]
