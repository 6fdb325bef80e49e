"""NAFNet over NHWC maps (mirrors ``unirestore_tpu/models/nafnet.py``): the
block CFRM builds on (``naf_block``) and the whole NAFNet UNet
(``nafnet_init`` / ``nafnet``, JAX ``nafnet.py:59-105``), which the
restoration model does not use."""

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


def nafnet_init(ini, img_channels: int = 3, width: int = 16, middle_blk_num: int = 1,
                enc_blk_nums=(), dec_blk_nums=()):
    """The NAFNet UNet: intro 3x3, encoders with 2x2 stride-2 downs, middle
    blocks, 1x1 (no bias) + pixel-shuffle ups with decoders, ending 3x3."""
    p = {"intro": L.conv2d_init(ini, img_channels, width, 3),
         "encoders": [], "downs": [], "middle": [], "ups": [], "decoders": []}
    chan = width
    for num in enc_blk_nums:
        p["encoders"].append([naf_block_init(ini, chan) for _ in range(num)])
        p["downs"].append(L.conv2d_init(ini, chan, 2 * chan, 2))
        chan *= 2
    p["middle"] = [naf_block_init(ini, chan) for _ in range(middle_blk_num)]
    for num in dec_blk_nums:
        p["ups"].append(L.conv2d_init(ini, chan, chan * 2, 1, bias=False))
        chan //= 2
        p["decoders"].append([naf_block_init(ini, chan) for _ in range(num)])
    p["ending"] = L.conv2d_init(ini, width, img_channels, 3)
    return p


def nafnet(p, x):
    """x + ending(decoders(middle(encoders(intro(x))))), NHWC."""
    h = L.conv2d(p["intro"], x, padding=1)
    skips = []
    for enc, down in zip(p["encoders"], p["downs"]):
        for blk in enc:
            h = naf_block(blk, h)
        skips.append(h)
        h = L.conv2d(down, h, stride=2, padding="VALID")
    for blk in p["middle"]:
        h = naf_block(blk, h)
    for up, dec, skip in zip(p["ups"], p["decoders"], skips[::-1]):
        h = L.pixel_shuffle(L.conv2d(up, h, padding=0), 2) + skip
        for blk in dec:
            h = naf_block(blk, h)
    return x + L.conv2d(p["ending"], h, padding=1)
