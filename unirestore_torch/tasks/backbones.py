"""DeepLab's other backbones: MobileNetV2, aligned Xception, HRNetV2 (the port
of ``unirestore_tpu/tasks/backbones.py``).

The ``deeplabv3(+)_mobilenet`` / ``_xception`` / ``_hrnetv2_32`` /
``_hrnetv2_48`` names of ``tasks/deeplab.py:deeplab_factory``. NHWC, inference
BatchNorm (``resnet.batch_norm``), the JAX trees' keys and shapes (conv
kernels OIHW; the HRNet fuse rows and transitions hold None where JAX does).
A stride-1 convolution pads "SAME" and a strided one (k - 1) // 2 * dilation
on each side, as the JAX ``_cbn``.

Feature contract, as ``deeplab.py`` reads it: ``{"low", "high"}``, low at /4
and high at /16 (MobileNetV2 and Xception at output stride 16, by dilation in
the last strided stage) with channel pairs (24, 320) and (128, 2048); HRNetV2
returns its /4 stem output as low and the four branches resized to /4 and
concatenated as high (480 or 720 channels at width 32 or 48).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from . import resnet as RN

# MobileNetV2 inverted-residual plan: (expand, cout, repeats, stride)
MBV2_PLAN = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _cbn_init(ini, cin, cout, k, groups=1):
    return {"conv": L.conv2d_init(ini, cin, cout, k, groups=groups, bias=False),
            "bn": RN.bn_init(ini, cout)}


def _cbn(p, x, stride=1, groups=1, dilation=1, relu6=True):
    k = p["conv"]["w"].shape[2]
    h = L.conv2d(p["conv"], x, stride=stride, groups=groups, dilation=dilation,
                 padding="SAME" if stride == 1 else (k - 1) // 2 * dilation)
    h = RN.batch_norm(p["bn"], h)
    return h.clamp(0, 6) if relu6 else h


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------


def _invres_init(ini, cin, cout, expand):
    mid = cin * expand
    p = {}
    if expand != 1:
        p["expand"] = _cbn_init(ini, cin, mid, 1)
    p["dw"] = _cbn_init(ini, mid, mid, 3, groups=mid)
    p["project"] = _cbn_init(ini, mid, cout, 1)
    return p


def mobilenet_v2_init(ini):
    p = {"stem": _cbn_init(ini, 3, 32, 3), "stages": []}
    cin = 32
    for expand, cout, n, _ in MBV2_PLAN:
        p["stages"].append([_invres_init(ini, cin if j == 0 else cout, cout, expand)
                            for j in range(n)])
        cin = cout
    return p


def _invres(p, x, stride, dilation):
    h = _cbn(p["expand"], x) if "expand" in p else x
    h = _cbn(p["dw"], h, stride=stride, groups=h.shape[-1], dilation=dilation)
    h = _cbn(p["project"], h, relu6=False)
    if stride == 1 and x.shape[-1] == h.shape[-1]:
        h = h + x
    return h


def mobilenet_v2_features(p, x, output_stride: int = 16):
    """A stride-2 block that would pass ``output_stride`` runs at stride 1 and
    doubles the dilation of the blocks after it."""
    h = _cbn(p["stem"], x, stride=2)
    low = None
    cur_stride, dilation = 2, 1
    for stage, (_, cout, _, stride) in zip(p["stages"], MBV2_PLAN):
        for j, blk in enumerate(stage):
            s, d, dil_next = (stride if j == 0 else 1), dilation, dilation
            if s == 2 and cur_stride >= output_stride:
                s, dil_next = 1, dilation * 2
            elif s == 2:
                cur_stride *= 2
            h = _invres(blk, h, s, d)
            dilation = dil_next
        if cout == 24:
            low = h
    return {"low": low, "high": h}


# ---------------------------------------------------------------------------
# Aligned Xception (the DeepLabV3 variant)
# ---------------------------------------------------------------------------


def _sep_init(ini, cin, cout):
    """Separable conv: depthwise 3x3 + BN, pointwise 1x1 + BN."""
    return {"dw": _cbn_init(ini, cin, cin, 3, groups=cin), "pw": _cbn_init(ini, cin, cout, 1)}


def _sep(p, x, stride=1, dilation=1, relu_first=True):
    h = F.relu(x) if relu_first else x
    h = _cbn(p["dw"], h, stride=stride, groups=h.shape[-1], dilation=dilation, relu6=False)
    return _cbn(p["pw"], h, relu6=False)


def _xblock_init(ini, cin, cout, n=3):
    p = {"seps": [_sep_init(ini, cin if i == 0 else cout, cout) for i in range(n)]}
    if cin != cout:
        p["skip"] = _cbn_init(ini, cin, cout, 1)
    return p


def _xblock(p, x, stride=1, dilation=1):
    h = x
    for i, sep in enumerate(p["seps"]):
        h = _sep(sep, h, stride=stride if i == len(p["seps"]) - 1 else 1, dilation=dilation)
    skip = x
    if "skip" in p:
        skip = _cbn(p["skip"], x, stride=stride, relu6=False)
    elif stride != 1:
        skip = x[:, ::stride, ::stride]
    return h + skip


def xception_init(ini):
    return {
        "conv1": _cbn_init(ini, 3, 32, 3),
        "conv2": _cbn_init(ini, 32, 64, 3),
        "entry1": _xblock_init(ini, 64, 128),
        "entry2": _xblock_init(ini, 128, 256),
        "entry3": _xblock_init(ini, 256, 728),
        "middle": [_xblock_init(ini, 728, 728) for _ in range(16)],
        "exit": _xblock_init(ini, 728, 1024),
        "sep1": _sep_init(ini, 1024, 1536),
        "sep2": _sep_init(ini, 1536, 1536),
        "sep3": _sep_init(ini, 1536, 2048),
    }


def xception_features(p, x, output_stride: int = 16):
    """Entry flow /2 conv and blocks at /4, /8, /16; the exit flow dilated 2
    at output stride 16 (stride 2, dilation 1 at 32)."""
    exit_stride = 2 if output_stride == 32 else 1
    exit_dil = 1 if output_stride == 32 else 2
    h = F.relu(_cbn(p["conv1"], x, stride=2, relu6=False))
    h = F.relu(_cbn(p["conv2"], h, relu6=False))
    h = _xblock(p["entry1"], h, stride=2)
    low = h  # 128 channels at /4
    h = _xblock(p["entry2"], h, stride=2)
    h = _xblock(p["entry3"], h, stride=2)
    for blk in p["middle"]:
        h = _xblock(blk, h)
    h = _xblock(p["exit"], h, stride=exit_stride, dilation=exit_dil)
    for name in ("sep1", "sep2", "sep3"):
        h = F.relu(_sep(p[name], h, dilation=exit_dil, relu_first=False))
    return {"low": low, "high": h}


# ---------------------------------------------------------------------------
# HRNetV2 (the DeepLabV3 variant)
# ---------------------------------------------------------------------------

HRNET_MODULES = {2: 1, 3: 4, 4: 3}     # modules per stage
HRNET_BLOCKS = 4                        # BasicBlocks per branch per module


def _basic_init(ini, cin, cout):
    p = {"conv1": _cbn_init(ini, cin, cout, 3), "conv2": _cbn_init(ini, cout, cout, 3)}
    if cin != cout:
        p["down"] = _cbn_init(ini, cin, cout, 1)
    return p


def _basic(p, x):
    h = F.relu(_cbn(p["conv1"], x, relu6=False))
    h = _cbn(p["conv2"], h, relu6=False)
    skip = _cbn(p["down"], x, relu6=False) if "down" in p else x
    return F.relu(h + skip)


def _bottleneck_init(ini, cin, width, cout):
    p = {"conv1": _cbn_init(ini, cin, width, 1),
         "conv2": _cbn_init(ini, width, width, 3),
         "conv3": _cbn_init(ini, width, cout, 1)}
    if cin != cout:
        p["down"] = _cbn_init(ini, cin, cout, 1)
    return p


def _bottleneck(p, x):
    h = F.relu(_cbn(p["conv1"], x, relu6=False))
    h = F.relu(_cbn(p["conv2"], h, relu6=False))
    h = _cbn(p["conv3"], h, relu6=False)
    skip = _cbn(p["down"], x, relu6=False) if "down" in p else x
    return F.relu(h + skip)


def _fuse_init(ini, chans):
    """Fuse layers: ``fuse[i][j]`` takes branch j to branch i's resolution (None
    on the diagonal): a 1x1 conv (then a nearest resize) from a coarser
    branch, ``i - j`` strided 3x3 convs from a finer one."""
    fuse = []
    for i in range(len(chans)):
        row = []
        for j in range(len(chans)):
            if j == i:
                row.append(None)
            elif j > i:
                row.append({"up": _cbn_init(ini, chans[j], chans[i], 1)})
            else:
                downs, c = [], chans[j]
                for step in range(i - j):
                    cout = chans[i] if step == i - j - 1 else c
                    downs.append(_cbn_init(ini, c, cout, 3))
                    c = cout
                row.append({"downs": downs})
        fuse.append(row)
    return fuse


def _fuse(fuse_p, xs):
    outs = []
    for i, row in enumerate(fuse_p):
        acc = xs[i]
        for j, pij in enumerate(row):
            if j == i:
                continue
            if "up" in pij:
                y = L.resize_nearest(_cbn(pij["up"], xs[j], relu6=False), xs[i].shape[1:3])
            else:
                y = xs[j]
                for step, dp in enumerate(pij["downs"]):
                    y = _cbn(dp, y, stride=2, relu6=False)
                    if step < len(pij["downs"]) - 1:
                        y = F.relu(y)
            acc = acc + y
        outs.append(F.relu(acc))
    return outs


def _module_init(ini, chans):
    return {"branches": [[_basic_init(ini, c, c) for _ in range(HRNET_BLOCKS)] for c in chans],
            "fuse": _fuse_init(ini, chans)}


def hrnetv2_init(ini, width: int = 48):
    chans = [width * 2 ** i for i in range(4)]
    p = {"conv1": _cbn_init(ini, 3, 64, 3),
         "conv2": _cbn_init(ini, 64, 64, 3),
         "layer1": [_bottleneck_init(ini, 64 if i == 0 else 256, 64, 256) for i in range(4)],
         "transitions": [], "stages": []}
    prev = [256]
    for s in (2, 3, 4):
        cur = chans[:s]
        trans = []
        for i, c in enumerate(cur):
            if i < len(prev):
                trans.append(_cbn_init(ini, prev[i], c, 3) if prev[i] != c else None)
            else:  # a new branch from the last previous one, stride 2
                trans.append(_cbn_init(ini, prev[-1], c, 3))
        p["transitions"].append(trans)
        p["stages"].append([_module_init(ini, cur) for _ in range(HRNET_MODULES[s])])
        prev = cur
    return p


def hrnetv2_features(p, x, width: int = 48):
    h = F.relu(_cbn(p["conv1"], x, stride=2, relu6=False))
    h = F.relu(_cbn(p["conv2"], h, stride=2, relu6=False))
    for blk in p["layer1"]:
        h = _bottleneck(blk, h)
    low = h  # 256 channels at /4
    xs = [h]
    for trans, stage in zip(p["transitions"], p["stages"]):
        xs = [(F.relu(_cbn(t, xs[i], relu6=False)) if t is not None else xs[i])
              if i < len(xs) else F.relu(_cbn(t, xs[-1], stride=2, relu6=False))
              for i, t in enumerate(trans)]
        for mod in stage:
            for bi, branch in enumerate(mod["branches"]):
                for blk in branch:
                    xs[bi] = _basic(blk, xs[bi])
            xs = _fuse(mod["fuse"], xs)
    # the HRNetV2 head: every branch resized to /4 and concatenated
    up = [xs[0]] + [L.resize_nearest(b, xs[0].shape[1:3]) for b in xs[1:]]
    return {"low": low, "high": torch.cat(up, dim=-1)}
