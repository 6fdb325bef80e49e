"""Tiled restore with overlap-blend for large inputs (mirrors ``unirestore_tpu/ops/tiling.py``).

Inputs larger than the working resolution are split into fixed-size
overlapping tiles, restored in batches of a fixed shape, and re-composited
with linear feather blending. numpy in, numpy out, as the JAX module; the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def plan_tiles(h: int, w: int, tile: int, overlap: int):
    """Tile origin grid covering (h, w) with the given overlap."""
    stride = tile - overlap
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if not ys or ys[-1] + tile < h:
        ys.append(max(h - tile, 0))
    if not xs or xs[-1] + tile < w:
        xs.append(max(w - tile, 0))
    return [(y, x) for y in ys for x in xs]


def _feather(tile: int, overlap: int) -> np.ndarray:
    """2D feathering window: linear ramps on all edges over the overlap."""
    ramp = np.ones(tile, np.float32)
    if overlap > 0:
        e = np.linspace(1.0 / (overlap + 1), 1.0, overlap, dtype=np.float32)
        ramp[:overlap] = e
        ramp[-overlap:] = e[::-1]
    return np.outer(ramp, ramp)


def restore_tiled(restore_fn, images: np.ndarray, task: str, tile: int = 512,
                  overlap: int = 64, batch_tiles: int = 4) -> np.ndarray:
    """Restore (B, H, W, C) images of any size by overlap-blended tiles.

    ``restore_fn(batch_nhwc, task) -> batch_nhwc`` runs at the fixed
    (batch_tiles, tile, tile) shape; the last batch is padded with copies of
    its last tile. Images no larger than the tile go to ``restore_fn``
    directly; an image with exactly one side under the tile is padded up to
    it (symmetric, or edge where the pad exceeds the side) and cropped back.
    The overlap is clamped to half the tile.
    """
    b, h, w, c = images.shape
    if h <= tile and w <= tile:
        return np.asarray(restore_fn(images, task))
    if h < tile or w < tile:
        ph, pw = max(0, tile - h), max(0, tile - w)
        mode = "symmetric" if ph <= h and pw <= w else "edge"
        padded = np.pad(images, ((0, 0), (0, ph), (0, pw), (0, 0)), mode=mode)
        out = restore_tiled(restore_fn, padded, task, tile, overlap, batch_tiles)
        return out[:, :h, :w]
    overlap = min(overlap, tile // 2)

    coords = plan_tiles(h, w, tile, overlap)
    window = _feather(tile, overlap)[..., None]
    out = np.zeros((b, h, w, c), np.float32)
    weight = np.zeros((b, h, w, 1), np.float32)
    tiles, meta = [], []
    for bi in range(b):
        for (y, x) in coords:
            tiles.append(images[bi, y:y + tile, x:x + tile])
            meta.append((bi, y, x))

    for i in range(0, len(tiles), batch_tiles):
        chunk = tiles[i:i + batch_tiles]
        n = len(chunk)
        if n < batch_tiles:
            chunk = chunk + [chunk[-1]] * (batch_tiles - n)
        restored = np.asarray(restore_fn(np.stack(chunk), task), np.float32)[:n]
        for r, (bi, y, x) in zip(restored, meta[i:i + n]):
            out[bi, y:y + tile, x:x + tile] += r * window
            weight[bi, y:y + tile, x:x + tile] += window
    return out / np.maximum(weight, 1e-8)
