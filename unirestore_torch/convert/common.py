"""What the converters share: the flat key separator, the layout changes, the
helpers that put one layer's tensors into the flat tree, and the reader of a
checkpoint file.

The helpers are those of the tools, under one name each:
``put_conv`` is ``tools/convert_sd_turbo.py:_put_conv`` and
``tools/convert_iqa.py:_conv``; ``put_lin`` is ``_put_lin`` and
``tools/convert_classifiers.py:_lin``; ``put_norm`` is ``_put_norm`` and
``_ln``; ``put_bn`` is ``tools/convert_torchvision.py:_bn``.
``load_state_dict`` merges ``convert_sd_turbo.py:_load_state_dict`` (:27-37)
and ``convert_torchvision.py:_sd`` (:32-39).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import bridge
from . import safetensors as ST

SEP = bridge.SEP


def conv_w(t):
    return np.transpose(t, (2, 3, 1, 0))  # OIHW -> HWIO


def lin_w(t):
    return np.transpose(t, (1, 0))  # (out, in) -> (in, out)


def put_conv(out, ours, theirs, sd, bias=True):
    out[f"{ours}{SEP}w"] = conv_w(sd[f"{theirs}.weight"])
    if bias and f"{theirs}.bias" in sd:
        out[f"{ours}{SEP}b"] = sd[f"{theirs}.bias"]


def put_lin(out, ours, theirs, sd, bias=True):
    out[f"{ours}{SEP}w"] = lin_w(sd[f"{theirs}.weight"])
    if bias and f"{theirs}.bias" in sd:
        out[f"{ours}{SEP}b"] = sd[f"{theirs}.bias"]


def put_norm(out, ours, theirs, sd):
    """A GroupNorm or LayerNorm affine."""
    out[f"{ours}{SEP}scale"] = sd[f"{theirs}.weight"]
    out[f"{ours}{SEP}bias"] = sd[f"{theirs}.bias"]


def put_bn(out, ours, theirs, sd):
    put_norm(out, ours, theirs, sd)
    out[f"{ours}{SEP}mean"] = sd[f"{theirs}.running_mean"]
    out[f"{ours}{SEP}var"] = sd[f"{theirs}.running_var"]


def load_state_dict(path) -> dict:
    """A checkpoint as {name: numpy array}: a ``.safetensors`` file through
    ``safetensors.load_file``, anything else through ``torch.load`` as the
    tools call it, then its ``"state_dict"`` entry where it has one."""
    path = str(path)
    if path.endswith(".safetensors"):
        return ST.load_file(path)
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in sd.items()}


def weights_out(name: str) -> str:
    """The path a converter writes ``<name>.npz`` to: ``$UNIRESTORE_WEIGHTS``,
    else ``./weights``, made if missing."""
    dst = os.environ.get("UNIRESTORE_WEIGHTS", "./weights")
    os.makedirs(dst, exist_ok=True)
    return os.path.join(dst, f"{name}.npz")


def save(path: str, out: dict) -> None:
    """``np.savez`` the flat tree and print the tools' line."""
    np.savez(path, **out)
    print(f"wrote {os.path.basename(path)} ({len(out)} tensors)")
