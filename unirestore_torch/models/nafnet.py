"""NAFNet block over NHWC maps (mirrors ``unirestore_tpu/models/nafnet.py:naf_block``)."""

from __future__ import annotations

from ..nn import layers as L


def naf_block_init(ini, c: int, dw_expand: int = 2, ffn_expand: int = 2):
    dw = c * dw_expand
    ffn = c * ffn_expand
    return {
        "norm1": L.norm_init(ini, c),
        "conv1": L.conv2d_init(ini, c, dw, 1),
        "conv2": L.conv2d_init(ini, dw, dw, 3, groups=dw),
        "sca": L.conv2d_init(ini, dw // 2, dw // 2, 1),
        "conv3": L.conv2d_init(ini, dw // 2, c, 1),
        "norm2": L.norm_init(ini, c),
        "conv4": L.conv2d_init(ini, c, ffn, 1),
        "conv5": L.conv2d_init(ini, ffn // 2, c, 1),
        "beta": ini.zeros((c,)),
        "gamma": ini.zeros((c,)),
    }


def naf_block(p, x):
    """LN -> 1x1 expand -> depthwise 3x3 -> SimpleGate -> SCA -> 1x1; LN -> FFN gate.

    Residual branches are scaled by zero-initialised beta/gamma, so a fresh
    block is the identity.
    """
    h = L.conv2d(p["conv1"], L.layer_norm(p["norm1"], x, eps=1e-6), padding=0)
    dw = p["conv2"]["w"].shape[0]  # depthwise: one group per channel
    h = L.simple_gate(L.conv2d(p["conv2"], h, padding=1, groups=dw))
    h = h * L.conv2d(p["sca"], L.global_avg_pool(h), padding=0)
    h = L.conv2d(p["conv3"], h, padding=0)
    y = x + h * p["beta"].to(h.dtype)

    h = L.conv2d(p["conv4"], L.layer_norm(p["norm2"], y, eps=1e-6), padding=0)
    h = L.conv2d(p["conv5"], L.simple_gate(h), padding=0)
    return y + h * p["gamma"].to(h.dtype)
