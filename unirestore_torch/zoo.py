"""Pretrained-weight zoo: converted checkpoints where present (mirrors ``unirestore_tpu/zoo.py``).

External weights (sd-turbo VAE/UNet, the null text embedding) are converted
offline by ``tools/convert_*.py`` into flat ``//``-keyed ``.npz`` files in the
JAX layout, and ``sd_null_emb.npy``, in a weights directory. This module
merges them into the port's parameter trees through ``bridge.load_tree``. A
missing file keeps the seeded init and warns once, as the JAX module does;
so does a file with no key of the tree. The directory is an argument
(default ``weights``, relative to the working directory like the JAX
package's ``./weights``); the port reads no environment variable.

One difference: a leaf whose shape differs from the tree's raises
``ValueError`` here, where the JAX module merges it and fails at first use.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from . import bridge

DEFAULT_WEIGHTS = "weights"

_WARNED: set = set()


def weights_dir(path=None) -> Path:
    return Path(DEFAULT_WEIGHTS if path is None else path)


def _warn_once(name: str, path=None) -> None:
    if name not in _WARNED:
        _WARNED.add(name)
        warnings.warn(f"pretrained weights '{name}' not found under {weights_dir(path)} — "
                      "using random init (convert with tools/convert_*.py)")


def _leaf(tree) -> torch.Tensor:
    return next(iter(bridge.flatten(tree).values()))


def load_npz_tree(name: str, template, path=None):
    """Merge ``<weights>/<name>.npz`` into ``template`` (non-strict); returns (tree, loaded).

    The merged leaves take the device and dtype of ``template``'s leaves.
    """
    file = weights_dir(path) / f"{name}.npz"
    if not file.exists():
        _warn_once(name, path)
        return template, False
    with np.load(file, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    if not set(flat) & set(bridge.flatten(template)):
        _warn_once(name + " (no matching keys)", path)
        return template, False
    ref = _leaf(template)
    return bridge.load_tree(flat, template, device=ref.device, dtype=ref.dtype,
                            strict=False), True


def load_null_embedding(shape, path=None):
    """The (1, 77, 1024) CLIP-H null-prompt embedding as float32 numpy, or None
    (warned once) when the file is missing or of another shape."""
    file = weights_dir(path) / "sd_null_emb.npy"
    if not file.exists():
        _warn_once("sd_null_emb", path)
        return None
    emb = np.load(file).astype(np.float32)
    if emb.shape != tuple(shape):
        _warn_once(f"sd_null_emb shape {emb.shape} != {tuple(shape)}", path)
        return None
    return emb


def load_frozen_backbone(frozen, cfg, path=None):
    """The frozen tree with the converted sd-turbo VAE/UNet and null embedding merged in."""
    frozen = dict(frozen)
    frozen["vae"], _ = load_npz_tree("sd_turbo_vae", frozen["vae"], path)
    if "unet" in frozen:
        frozen["unet"], _ = load_npz_tree("sd_turbo_unet", frozen["unet"], path)
    null = frozen["null_emb"]
    emb = load_null_embedding(null.shape, path)
    if emb is not None:
        frozen["null_emb"] = torch.from_numpy(emb).to(device=null.device, dtype=null.dtype)
    return frozen

