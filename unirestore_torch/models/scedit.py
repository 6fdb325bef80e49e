"""SC-Tuner skip adapters for the UNet (mirrors ``unirestore_tpu/models/scedit.py``).

``csce_adapter``: out = tuner(x + proj(cond)) + proj(cond) + x, with
tuner = 1x1 -> GELU -> 1x1, one adapter per UNet skip tensor;
``sce_adapter`` (JAX ``scedit.py:19-31``): the same without the condition,
out = tuner(x) + x.
"""

from __future__ import annotations

from ..nn import layers as L


def sce_adapter_init(ini, c_in: int, c_emb: int):
    return {
        "tuner_in": L.conv2d_init(ini, c_in, c_emb, 1),
        "tuner_out": L.conv2d_init(ini, c_emb, c_in, 1),
    }


def sce_adapter(p, x):
    h = L.conv2d(p["tuner_in"], x, padding=0)
    h = L.conv2d(p["tuner_out"], L.gelu(h), padding=0)
    return h + x


def csce_adapter_init(ini, c_in: int, c_emb: int, c_cond: int):
    return {
        "proj": L.conv2d_init(ini, c_cond, c_in, 1),
        "tuner_in": L.conv2d_init(ini, c_in, c_emb, 1),
        "tuner_out": L.conv2d_init(ini, c_emb, c_in, 1),
    }


def csce_adapter(p, x, cond):
    proj = L.conv2d(p["proj"], cond, padding=0)
    h = L.conv2d(p["tuner_in"], x + proj, padding=0)
    h = L.conv2d(p["tuner_out"], L.gelu(h), padding=0)
    return h + proj + x


SD_SKIP_CHANNELS = [320] * 4 + [640] * 3 + [1280] * 5


def sc_tuner_init(ini, skip_channels=None, c_cond: int = 256):
    """One CSCEAdapter per UNet skip tensor (c_emb = c_in)."""
    chans = SD_SKIP_CHANNELS if skip_channels is None else list(skip_channels)
    return [csce_adapter_init(ini, c, c, c_cond) for c in chans]
