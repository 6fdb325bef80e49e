"""ctypes bindings for the native corruption kernels (optional fast path).

The port's own copy of ``unirestore_tpu/data/corruption/native.py`` (numpy only; the port imports
nothing of the JAX package).

Loads ``native/libcorruption_kernels.so``, building it with g++ on first use
if missing. Falls back silently (``AVAILABLE = False``) when no toolchain is
present — the numpy implementations in imagenet_c remain the reference path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "native")
_SO = os.path.join(_NATIVE_DIR, "libcorruption_kernels.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.plasma_fractal.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ctypes.c_uint64]
    lib.glass_shuffle.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.impulse_noise.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_uint64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def plasma_fractal(mapsize: int, wibbledecay: float, seed: int) -> np.ndarray:
    lib = _load()
    out = np.empty((mapsize, mapsize), np.float64)
    lib.plasma_fractal(out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       mapsize, wibbledecay, seed & 0xFFFFFFFFFFFFFFFF)
    return out


def glass_shuffle(img: np.ndarray, max_delta: int, iters: int,
                  seed: int) -> np.ndarray:
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    lib.glass_shuffle(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      h, w, c, max_delta, iters,
                      seed & 0xFFFFFFFFFFFFFFFF)
    return img


def impulse_noise(img: np.ndarray, amount: float, seed: int) -> np.ndarray:
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    lib.impulse_noise(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      img.size, amount, seed & 0xFFFFFFFFFFFFFFFF)
    return img
