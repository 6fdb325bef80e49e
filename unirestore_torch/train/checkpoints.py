"""Adapter-only checkpoints with stage-surgery loading (mirrors
``unirestore_tpu/train/checkpoints.py``).

Format (the JAX package's, so each package reads the other's files): one flat
numpy ``.npz`` with ``trainable//path//to//leaf`` keys in the JAX layout (conv
kernels HWIO, ``bridge.to_numpy_tree``), the optimizer state as ``opt//<i>``
leaves, and a JSON ``__meta__`` entry with the step and ``opt_num_leaves``.
The frozen SD backbone is never written.

Stage surgery selects top-level keys of the trainable tree: a frenc
checkpoint gives "cfrm", a cnet checkpoint "controller" + "control", a tedit
checkpoint "tfa"; loading is non-strict (a key the file lacks keeps the
template's value, so new tasks keep their fresh prompts).

The optimizer state is the port's own (``train/optim.py``); restoring it into
a state of another structure keeps the fresh state, as the JAX function does.

``CheckpointManager`` keeps the ``save_top_k`` best checkpoints by a
monitored metric under the JAX file's names (``step=<n>-val=<v>.npz``,
``unirestore_tpu/train/checkpoints.py:129-174``) and adopts the files an
earlier run left in its directory.
"""

from __future__ import annotations

import json
import os
import re
import warnings

import numpy as np
import torch

from .. import bridge

SEP = bridge.SEP


def save_checkpoint(path: str, trainable, step: int, opt_state=None,
                    metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"trainable{SEP}{k}": v
            for k, v in bridge.flatten(bridge.to_numpy_tree(trainable)).items()}
    meta = {"step": int(step)}
    if opt_state is not None:
        leaves = list(bridge.flatten(opt_state).values())
        meta["opt_num_leaves"] = len(leaves)
        for i, leaf in enumerate(leaves):
            flat[f"opt{SEP}{i}"] = (leaf.detach().cpu().numpy()
                                    if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
    np.savez(path, __meta__=json.dumps({**meta, **(metadata or {})}), **flat)


def load_checkpoint(path: str):
    """Returns ({flat key: array}, meta)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    return flat, meta


def _load_trainable(flat, template, keys=None):
    head = "trainable" + SEP
    sub = {k[len(head):]: v for k, v in flat.items()
           if k.startswith(head) and (keys is None or k[len(head):].split(SEP)[0] in keys)}
    ref = next(iter(bridge.flatten(template).values()))
    return bridge.load_tree(sub, template, device=ref.device, dtype=ref.dtype, strict=False)


def load_trainable(path: str, template):
    """Non-strict restore of the trainable tree; returns (tree, meta)."""
    flat, meta = load_checkpoint(path)
    return _load_trainable(flat, template), meta


def load_subtree(path: str, template, keys):
    """Stage surgery: only the top-level ``keys`` of the file's trainable tree
    go into ``template``."""
    flat, _ = load_checkpoint(path)
    return _load_trainable(flat, template, set(keys))


def restore_opt_state(path: str, opt_state_template):
    """The optimizer state by flat leaf index; a file of another structure (leaf
    count) or a leaf of another shape keeps the template's value."""
    flat, meta = load_checkpoint(path)
    leaves = bridge.flatten(opt_state_template)
    n_saved = meta.get("opt_num_leaves")
    if n_saved is not None and n_saved != len(leaves):
        warnings.warn(f"optimizer structure changed ({n_saved} saved leaves vs "
                      f"{len(leaves)} in template); starting optimizer state fresh")
        return opt_state_template
    out = {}
    for i, (key, leaf) in enumerate(leaves.items()):
        arr = flat.get(f"opt{SEP}{i}")
        if arr is not None and np.shape(arr) != tuple(np.shape(leaf)):
            warnings.warn(f"optimizer leaf {i} shape {np.shape(arr)} != template "
                          f"{tuple(np.shape(leaf))}; keeping fresh value")
            arr = None
        if arr is None:
            out[key] = leaf
        elif isinstance(leaf, torch.Tensor):
            out[key] = torch.as_tensor(arr, dtype=leaf.dtype, device=leaf.device)
        else:
            out[key] = type(leaf)(arr)
    return bridge.unflatten_like(out, opt_state_template)


class CheckpointManager:
    """save_top_k by a monitored metric (ModelCheckpoint equivalent,
    train_stage1.yaml:36-43)."""

    def __init__(self, directory: str, save_top_k: int = 5, mode: str = "max",
                 monitor: str = "val_monitor"):
        self.dir = directory
        self.save_top_k = save_top_k
        self.mode = mode
        self.monitor = monitor
        self._saved: list[tuple[float, str]] = []
        os.makedirs(directory, exist_ok=True)
        # adopt checkpoints left by a previous run (trainer.resume) so top-k
        # pruning spans restarts instead of only this process's saves
        for fname in sorted(os.listdir(directory)):
            m = re.fullmatch(r"step=\d+-val=(-?[\d.]+(?:[eE][+-]?\d+)?)\.npz", fname)
            if m:
                v = float(m.group(1))
                self._saved.append((v if mode == "max" else -v, os.path.join(directory, fname)))
        self._saved.sort(key=lambda t: -t[0])

    def save(self, trainable, step: int, metric_value: float, opt_state=None, metadata=None):
        fname = os.path.join(self.dir, f"step={step}-val={metric_value:.4f}.npz")
        save_checkpoint(fname, trainable, step, opt_state,
                        {**(metadata or {}), self.monitor: metric_value})
        key = metric_value if self.mode == "max" else -metric_value
        # a resumed run can re-save an identical step/val file name: replace
        # the entry, never duplicate it (a duplicate would take a top-k slot,
        # and popping it would delete the surviving entry's file)
        self._saved = [t for t in self._saved if t[1] != fname]
        self._saved.append((key, fname))
        self._saved.sort(key=lambda t: -t[0])
        while len(self._saved) > self.save_top_k:
            _, worst = self._saved.pop()
            if os.path.exists(worst):
                os.remove(worst)
        return fname

    @property
    def best_path(self):
        return self._saved[0][1] if self._saved else None
