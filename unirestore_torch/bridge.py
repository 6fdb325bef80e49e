"""Weight bridge: the JAX package's parameter trees <-> the port's tensors.

Takes a tree as nested numpy dicts/lists (``jax.tree.map(np.asarray, tree)``)
or as a flat ``//``-keyed mapping or ``.npz`` (the format of
``unirestore_tpu/train/checkpoints.py:29-57`` that ``zoo.load_npz_tree``
reads). Returns the same tree of tensors on a given device and dtype. Conv
kernels go from HWIO ``(kh, kw, cin/g, cout)`` to OIHW in ``channels_last``
memory, the layout ``nn/layers.py:conv2d`` hands to cuDNN. Dict keys, such as
the TFA ``task_prompts`` task names, are kept. The port's own parameter tree
(from ``models/unirestore.init(..., device="meta")``) fixes the expected keys
and shapes: a key missing on either side, or a shape that differs, raises
(``strict=False`` keeps the template's leaf for a missing key and ignores
extra keys, as checkpoint loading does). ``to_numpy_tree`` is the inverse: the
port's tree as nested numpy arrays in the JAX layout, which
``train/checkpoints.py`` writes so that each package reads the other's files.

``critics_from_jax`` is the same path for the frozen critics of stage 2
(``unirestore_tpu/tasks/resnet.py``, ``deeplab.py``): their JAX trees, by
task, against the port's own critic trees (``tasks.critic_init(task,
"meta")``) as templates.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch

from .device import resolve_device
from .models import unirestore as UR
from .tasks import critic_init

# key separator of the flat format (unirestore_tpu/train/checkpoints.py:29)
SEP = "//"


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict/list tree -> {"a//0//w": leaf}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-len(SEP)]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}{SEP}"))
    return out


def unflatten_like(flat: Mapping, template):
    """Rebuild ``template``'s structure with the leaves of ``flat``."""
    def rebuild(node, prefix):
        if isinstance(node, Mapping):
            return {k: rebuild(v, f"{prefix}{k}{SEP}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, f"{prefix}{i}{SEP}") for i, v in enumerate(node)]
        return flat[prefix[:-len(SEP)]]
    return rebuild(template, "")


def _is_conv_kernel(key: str, arr) -> bool:
    return (key == "w" or key.endswith(SEP + "w")) and arr.ndim == 4


def _read_flat(src, prefix: str | None) -> dict:
    if isinstance(src, (str, os.PathLike)):
        with np.load(src, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    else:  # nested, flat, or a mix: flattening leaves "a//b" keys as they are
        flat = flatten(src)
    if prefix:
        head = prefix + SEP
        flat = {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}
    return flat


def load_tree(src, template, *, device=None, dtype=torch.float32, prefix: str | None = None,
              strict: bool = True):
    """Convert ``src`` (nested tree, flat mapping or ``.npz`` path) to ``template``'s shape.

    ``prefix`` selects the keys under one top-level name of a flat source
    (e.g. ``"trainable"`` in a checkpoint); other keys are then ignored. With
    ``strict=False`` a key missing from ``src`` keeps the template's leaf and a
    key ``template`` lacks is ignored.
    """
    dev = resolve_device(device)
    flat = _read_flat(src, prefix)
    want = flatten(template)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if strict and (missing or extra):
        raise KeyError(f"parameter keys differ: missing {missing[:8]} "
                       f"({len(missing)}), unexpected {extra[:8]} ({len(extra)})")
    out = {}
    for key, ref in want.items():
        if key not in flat:
            out[key] = ref
            continue
        arr = np.asarray(flat[key])
        conv = _is_conv_kernel(key, arr)
        if conv:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(ref.shape)}")
        t = torch.tensor(np.asarray(arr, np.float32)).to(device=dev, dtype=dtype)
        out[key] = t.contiguous(memory_format=torch.channels_last) if conv else t
    return unflatten_like(out, template)


def cast_tree(tree, dtype):
    """The same tree with every leaf in ``dtype`` (a leaf already in it is kept, not copied)."""
    return unflatten_like({k: v.to(dtype) for k, v in flatten(tree).items()}, tree)


def to_numpy_tree(tree):
    """The port's tree -> the same tree of float32 numpy arrays in the JAX layout
    (conv kernels OIHW -> HWIO)."""
    out = {}
    for key, t in flatten(tree).items():
        arr = t.detach().float().cpu().numpy()
        if _is_conv_kernel(key, arr):
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        out[key] = arr
    return unflatten_like(out, tree)


def from_jax(frozen, trainable, cfg, *, device=None, dtype=torch.float32):
    """The JAX ``(frozen, trainable)`` pair for ``cfg`` -> the port's pair."""
    frozen_t, trainable_t = UR.init(cfg, device="meta")
    return (load_tree(frozen, frozen_t, device=device, dtype=dtype),
            load_tree(trainable, trainable_t, device=device, dtype=dtype))


def critics_from_jax(critics, *, device=None, dtype=torch.float32) -> dict:
    """The JAX critic trees by task (``{"cls": ..., "seg": ...}``) -> the port's."""
    return {task: load_tree(tree, critic_init(task, "meta"), device=device, dtype=dtype)
            for task, tree in critics.items()}


def load_null_embedding(path, shape=(1, 77, 1024), *, device=None, dtype=torch.float32):
    """The (1, 77, 1024) null-prompt text embedding (``weights/sd_null_emb.npy``)."""
    emb = np.load(path).astype(np.float32)
    if emb.shape != tuple(shape):
        raise ValueError(f"{path}: shape {emb.shape} != {tuple(shape)}")
    return torch.from_numpy(emb).to(device=resolve_device(device), dtype=dtype)
