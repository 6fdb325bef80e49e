"""A configuration's weights, drawn from the seed on the device.

The program fixes the tree's layout (its parameter tree on ``meta``); the
values are the benchmark's own, so that the reference reads weights the
program did not make. Each tree is one uniform draw in the dtype it is
served in, cut into leaves and scaled by rule:

- ``w``: within 1/sqrt(fan_in), PyTorch's layer default (fan_in is
  cin/groups x kh x kw for an OIHW conv kernel, the rows of an (in, out)
  linear kernel); ``b``: within 1/sqrt(fan_in) of its ``w``;
- a path matching one of the configuration's ``small`` patterns (the leaves
  the program initialises to zero): uniform with std ``small_std``;
- ``scale`` 1, ``bias`` 0 (norms); ``null_emb`` from the configuration's file
  (a standard normal draw where it names none, as the tests' tiny configurations).
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

SEP = "/"


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts / lists -> {"a/0/w": leaf}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}{SEP}"))
    return out


def unflatten_like(flat: Mapping, template, prefix: str = ""):
    if isinstance(template, Mapping):
        return {k: unflatten_like(flat, v, f"{prefix}{k}{SEP}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten_like(flat, v, f"{prefix}{i}{SEP}") for i, v in enumerate(template)]
    return flat[prefix[:-1]]


def fan_in(w_shape) -> int:
    return math.prod(w_shape[1:]) if len(w_shape) == 4 else w_shape[0]


def bounds(flat_meta: dict, rules: dict, root: str) -> dict:
    """{path: uniform bound} of every drawn leaf of one tree (``root`` is
    "frozen" or "trainable"), in the tree's order; raises on a leaf no rule
    covers."""
    small = [re.compile(p) for p in rules["small"]]
    small_bound = rules["small_std"] * math.sqrt(3.0)
    out = {}
    for path, leaf in flat_meta.items():
        full = f"{root}{SEP}{path}"
        name = path.rsplit(SEP, 1)[-1]
        if any(p.search(full) for p in small):
            out[path] = small_bound
        elif name == "w":
            out[path] = 1.0 / math.sqrt(fan_in(leaf.shape))
        elif name == "b":
            w = flat_meta[path[:-1] + "w"]
            out[path] = 1.0 / math.sqrt(fan_in(w.shape))
        elif name not in ("scale", "bias", "null_emb"):
            raise ValueError(f"no weight rule covers {full} {tuple(leaf.shape)}")
    return out


def draw_tree(template, rules: dict, root: str, generator, device, dtype):
    """``template`` (meta leaves) filled: one uniform draw for the drawn leaves."""
    flat_meta = flatten(template)
    scale = bounds(flat_meta, rules, root)
    total = sum(flat_meta[p].numel() for p in scale)
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.uniform_(-1.0, 1.0, generator=generator)
    out, offset = {}, 0
    for path, leaf in flat_meta.items():
        name = path.rsplit(SEP, 1)[-1]
        if path in scale:
            n = leaf.numel()
            out[path] = buf[offset:offset + n].view(leaf.shape).mul_(scale[path])
            offset += n
        elif name == "scale":
            out[path] = torch.ones(leaf.shape, dtype=dtype, device=device)
        else:
            out[path] = torch.zeros(leaf.shape, dtype=dtype, device=device)
    return unflatten_like(out, template)


def draw(template: tuple, weights: dict, seed: int, device, dtypes: tuple, root_dir: Path):
    """(frozen, trainable) of the configuration's ``weights`` rules from
    ``seed``, frozen in ``dtypes[0]`` and trainable in ``dtypes[1]``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    frozen = draw_tree(template[0], weights, "frozen", gen, device, dtypes[0])
    trainable = draw_tree(template[1], weights, "trainable", gen, device, dtypes[1])
    shape = tuple(frozen["null_emb"].shape)
    if weights["null_embedding"] is None:  # a test configuration's: standard normal
        null = torch.randn(shape, generator=gen, device=device).cpu().numpy()
    else:
        null = np.load(root_dir / weights["null_embedding"]).astype(np.float32)
    if null.shape != shape:
        raise ValueError(f"null embedding {null.shape} for {shape}")
    frozen["null_emb"] = torch.from_numpy(null).to(device=device, dtype=dtypes[0])
    return frozen, trainable


def on_meta(tree):
    """The same tree with ``meta`` leaves of its leaves' shapes (for counting)."""
    return unflatten_like({k: torch.empty(v.shape, device="meta")
                           for k, v in flatten(tree).items()}, tree)


def as_float32(tree):
    """The same tree with float32 copies of its leaves (the reference's)."""
    return unflatten_like({k: v.float() for k, v in flatten(tree).items()}, tree)
