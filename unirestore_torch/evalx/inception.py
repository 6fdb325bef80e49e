"""InceptionV3 up to pool3 (2048-d), the FID feature extractor (the port of
``unirestore_tpu/evalx/inception.py``).

The reference's FID uses torchmetrics' InceptionV3 features
(eval_image_restoration.py:186). This is the torchvision InceptionV3 topology
(Conv-BN stem, InceptionA/B/C/D/E towers) up to the global average pool,
NHWC, in fp32 over a parameter tree with the JAX tree's keys and shapes
(conv kernels OIHW), so that ``weights/inception_v3.npz``
(``tools/convert_torchvision.py inception``) serves both packages. Without
the file the tree is a seeded init and ``zoo.load_npz_tree`` warns once (FID
then measures a distance under a random projection: the pipeline works, the
values are not comparable to the paper's).

Inputs in [0, 1] are resized to 299 x 299 (bilinear, float64 tap positions,
``ops/resize.py:resize_bilinear``) and mapped to [-1, 1]. Two details follow
the JAX function where torch's defaults differ: the average pools divide by
the count of valid elements (``count_include_pad=False``), and the 1 x 7 /
7 x 1 (and 1 x 3 / 3 x 1) convolutions pad only along their long axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import zoo
from ..device import resolve_device
from ..nn import layers as L
from ..nn.init import make_init
from ..ops.resize import resize_bilinear
from ..tasks import resnet as RN
from .evaluators import network_call

DIM = 2048
SEED = 11


def _cbn_init(ini, cin, cout, k):
    return {"conv": L.conv2d_init(ini, cin, cout, k, bias=False), "bn": RN.bn_init(ini, cout)}


def _cbn(p, x, stride=1, padding="SAME"):
    x = L.conv2d(p["conv"], x, stride=stride, padding=padding)
    return F.relu(RN.batch_norm(p["bn"], x, eps=1e-3))


def _max_pool(x, size=3, stride=2):
    return F.max_pool2d(x.permute(0, 3, 1, 2), size, stride).permute(0, 2, 3, 1)


def _avg_pool(x):
    """3 x 3 average, stride 1, padded by one, over the valid elements only."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=False)
    return y.permute(0, 2, 3, 1)


def inception_v3_init(ini):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    p = {"stem": [_cbn_init(ini, 3, 32, 3), _cbn_init(ini, 32, 32, 3),
                  _cbn_init(ini, 32, 64, 3), _cbn_init(ini, 64, 80, 1),
                  _cbn_init(ini, 80, 192, 3)]}

    def inc_a(cin, pool_ch):
        return {"b1x1": _cbn_init(ini, cin, 64, 1),
                "b5_1": _cbn_init(ini, cin, 48, 1), "b5_2": _cbn_init(ini, 48, 64, 5),
                "b3_1": _cbn_init(ini, cin, 64, 1), "b3_2": _cbn_init(ini, 64, 96, 3),
                "b3_3": _cbn_init(ini, 96, 96, 3),
                "bp": _cbn_init(ini, cin, pool_ch, 1)}

    p["a"] = [inc_a(192, 32), inc_a(256, 64), inc_a(288, 64)]
    p["b"] = {"b3": _cbn_init(ini, 288, 384, 3), "d3_1": _cbn_init(ini, 288, 64, 1),
              "d3_2": _cbn_init(ini, 64, 96, 3), "d3_3": _cbn_init(ini, 96, 96, 3)}

    def inc_c(c7):
        return {"b1x1": _cbn_init(ini, 768, 192, 1),
                "b7_1": _cbn_init(ini, 768, c7, 1), "b7_2": _cbn_init(ini, c7, c7, (1, 7)),
                "b7_3": _cbn_init(ini, c7, 192, (7, 1)),
                "b7d_1": _cbn_init(ini, 768, c7, 1), "b7d_2": _cbn_init(ini, c7, c7, (7, 1)),
                "b7d_3": _cbn_init(ini, c7, c7, (1, 7)), "b7d_4": _cbn_init(ini, c7, c7, (7, 1)),
                "b7d_5": _cbn_init(ini, c7, 192, (1, 7)),
                "bp": _cbn_init(ini, 768, 192, 1)}

    p["c"] = [inc_c(128), inc_c(160), inc_c(160), inc_c(192)]
    p["d"] = {"b3_1": _cbn_init(ini, 768, 192, 1), "b3_2": _cbn_init(ini, 192, 320, 3),
              "b7_1": _cbn_init(ini, 768, 192, 1), "b7_2": _cbn_init(ini, 192, 192, (1, 7)),
              "b7_3": _cbn_init(ini, 192, 192, (7, 1)), "b7_4": _cbn_init(ini, 192, 192, 3)}

    def inc_e(cin):
        return {"b1x1": _cbn_init(ini, cin, 320, 1),
                "b3_1": _cbn_init(ini, cin, 384, 1),
                "b3_2a": _cbn_init(ini, 384, 384, (1, 3)),
                "b3_2b": _cbn_init(ini, 384, 384, (3, 1)),
                "bd_1": _cbn_init(ini, cin, 448, 1), "bd_2": _cbn_init(ini, 448, 384, 3),
                "bd_3a": _cbn_init(ini, 384, 384, (1, 3)),
                "bd_3b": _cbn_init(ini, 384, 384, (3, 1)),
                "bp": _cbn_init(ini, cin, 192, 1)}

    p["e"] = [inc_e(1280), inc_e(2048)]
    return p


# explicit paddings of the separable convolutions: ((top, bottom), (left, right))
_ROW1, _COL1 = ((0, 0), (1, 1)), ((1, 1), (0, 0))
_ROW3, _COL3 = ((0, 0), (3, 3)), ((3, 3), (0, 0))


def _inception_a(p, x):
    b1 = _cbn(p["b1x1"], x, padding=0)
    b5 = _cbn(p["b5_2"], _cbn(p["b5_1"], x, padding=0), padding=2)
    b3 = _cbn(p["b3_3"], _cbn(p["b3_2"], _cbn(p["b3_1"], x, padding=0), padding=1), padding=1)
    bp = _cbn(p["bp"], _avg_pool(x), padding=0)
    return torch.cat([b1, b5, b3, bp], -1)


def _inception_c(p, x):
    b1 = _cbn(p["b1x1"], x, padding=0)
    b7 = _cbn(p["b7_1"], x, padding=0)
    b7 = _cbn(p["b7_2"], b7, padding=_ROW3)
    b7 = _cbn(p["b7_3"], b7, padding=_COL3)
    bd = _cbn(p["b7d_1"], x, padding=0)
    bd = _cbn(p["b7d_2"], bd, padding=_COL3)
    bd = _cbn(p["b7d_3"], bd, padding=_ROW3)
    bd = _cbn(p["b7d_4"], bd, padding=_COL3)
    bd = _cbn(p["b7d_5"], bd, padding=_ROW3)
    bp = _cbn(p["bp"], _avg_pool(x), padding=0)
    return torch.cat([b1, b7, bd, bp], -1)


def _inception_e(p, x):
    b1 = _cbn(p["b1x1"], x, padding=0)
    b3 = _cbn(p["b3_1"], x, padding=0)
    b3 = torch.cat([_cbn(p["b3_2a"], b3, padding=_ROW1), _cbn(p["b3_2b"], b3, padding=_COL1)],
                   -1)
    bd = _cbn(p["bd_2"], _cbn(p["bd_1"], x, padding=0), padding=1)
    bd = torch.cat([_cbn(p["bd_3a"], bd, padding=_ROW1), _cbn(p["bd_3b"], bd, padding=_COL1)],
                   -1)
    bp = _cbn(p["bp"], _avg_pool(x), padding=0)
    return torch.cat([b1, b3, bd, bp], -1)


def inception_v3_features(p, images):
    """[0, 1] NHWC -> (B, 2048) pool3 features."""
    x = resize_bilinear(images, (299, 299))
    x = x * 2.0 - 1.0
    s = p["stem"]
    x = _cbn(s[0], x, stride=2, padding="VALID")
    x = _cbn(s[1], x, padding="VALID")
    x = _cbn(s[2], x, padding=1)
    x = _max_pool(x)
    x = _cbn(s[3], x, padding="VALID")
    x = _cbn(s[4], x, padding="VALID")
    x = _max_pool(x)
    for blk in p["a"]:
        x = _inception_a(blk, x)
    b = p["b"]  # reduction B
    b3 = _cbn(b["b3"], x, stride=2, padding="VALID")
    d3 = _cbn(b["d3_3"], _cbn(b["d3_2"], _cbn(b["d3_1"], x, padding=0), padding=1),
              stride=2, padding="VALID")
    x = torch.cat([b3, d3, _max_pool(x)], -1)
    for blk in p["c"]:
        x = _inception_c(blk, x)
    d = p["d"]  # reduction D
    b3 = _cbn(d["b3_2"], _cbn(d["b3_1"], x, padding=0), stride=2, padding="VALID")
    b7 = _cbn(d["b7_2"], _cbn(d["b7_1"], x, padding=0), padding=_ROW3)
    b7 = _cbn(d["b7_3"], b7, padding=_COL3)
    b7 = _cbn(d["b7_4"], b7, stride=2, padding="VALID")
    x = torch.cat([b3, b7, _max_pool(x)], -1)
    for blk in p["e"]:
        x = _inception_e(blk, x)
    return x.mean(dim=(1, 2))


def make_fid_extractor(params=None, device=None, weights_dir=None, seed: int = SEED,
                       cuda_graphs: bool = False):
    """Returns (extract, 2048) for ``evalx.fid.FID``: ``extract(images_nhwc01
    numpy) -> (B, 2048)`` fp32 numpy features, computed in fp32 on ``device``
    (default: the card) with one read-back a call; with ``cuda_graphs``
    replayed from CUDA graphs, one per input shape (``evaluators.
    network_call``), where the JAX function jits it. Without ``params``: the
    seeded tree with ``<weights_dir>/inception_v3.npz`` merged in where present."""
    dev = resolve_device(device)
    if params is None:
        params, _ = zoo.load_npz_tree("inception_v3",
                                      inception_v3_init(make_init(None, dev, seed=seed)),
                                      weights_dir)
    call = network_call(lambda x: inception_v3_features(params, x).float(), dev, cuda_graphs)

    def extract(images):
        return call(images).numpy()

    extract.params, extract.call = params, call
    return extract, DIM
