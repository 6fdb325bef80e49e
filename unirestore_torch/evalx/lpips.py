"""LPIPS (alex backbone), the port of ``unirestore_tpu/evalx/lpips.py``.

The reference uses torchmetrics LPIPS(net_type="alex", normalize=True)
(eval_image_restoration.py:184). ``LPIPS`` is an ``nn.Module`` that takes and
gives the JAX layout (NHWC images in, one distance per image out): the
AlexNet feature trunk (11x11/4 conv, 3x3/2 max-pools with no padding, as
``lax.reduce_window(..., "VALID")``), 5 taps after each ReLU, per-position
channel unit-normalisation, learned 1x1 linear heads, spatial mean, layer
sum. Its parameters are the JAX tree's (``convs``: ``w``, ``b``; ``lins``:
``w``), conv kernels OIHW; ``bridge`` carries the JAX params (HWIO) across.
``make_lpips`` loads ``weights/lpips_alex.npz`` through the port's
``zoo.load_npz_tree`` and keeps the port's seeded init when it is absent, as
the JAX function does (values then not comparable to the paper's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import bridge as BR
from ..device import resolve_device
from ..nn import layers as L
from ..nn.init import make_init

# AlexNet feature config: (cout, kernel, stride, pad), M = maxpool 3x3/2
_ALEX_CFG = [(64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
_TAP_CHANNELS = (64, 192, 384, 256, 256)

# LPIPS input scaling (the official net expects [-1,1] then these shifts)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_init(generator=None, *, device=None, seed: int = 13):
    """The LPIPS parameter tree (the JAX ``lpips_init``'s keys and shapes, OIHW)."""
    ini = make_init(generator, resolve_device(device), seed=seed)
    convs, cin = [], 3
    for c in _ALEX_CFG:
        if c == "M":
            continue
        cout, k, _, _ = c
        convs.append(L.conv2d_init(ini, cin, cout, k))
        cin = cout
    lins = [L.conv2d_init(ini, ch, 1, 1, bias=False) for ch in _TAP_CHANNELS]
    return {"convs": convs, "lins": lins}


class LPIPS(torch.nn.Module):
    """LPIPS distance over a parameter tree shaped like ``lpips_init``'s."""

    def __init__(self, params):
        super().__init__()
        self.convs = torch.nn.ParameterList()
        for p in params["convs"]:
            self.convs.append(torch.nn.Parameter(p["w"], requires_grad=False))
            self.convs.append(torch.nn.Parameter(p["b"], requires_grad=False))
        self.lins = torch.nn.ParameterList(
            torch.nn.Parameter(p["w"], requires_grad=False) for p in params["lins"])
        dev = params["lins"][0]["w"].device
        self.register_buffer("shift", torch.tensor(_SHIFT, device=dev).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE, device=dev).view(1, 3, 1, 1))

    def features(self, x):
        """The five ReLU taps of the AlexNet trunk, NCHW in and out."""
        feats, i = [], 0
        for c in _ALEX_CFG:
            if c == "M":
                x = F.max_pool2d(x, 3, 2)
                continue
            _, _, stride, pad = c
            x = F.relu(F.conv2d(x, self.convs[2 * i], self.convs[2 * i + 1], stride, pad))
            feats.append(x)
            i += 1
        return feats

    def forward(self, x, y, normalize: bool = True):
        """x, y: NHWC; ``normalize=True`` means inputs are in [0, 1]. Returns (N,)."""
        x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
        if normalize:
            x, y = 2.0 * x - 1.0, 2.0 * y - 1.0
        x, y = (x - self.shift) / self.scale, (y - self.shift) / self.scale
        total = 0.0
        for lin, a, b in zip(self.lins, self.features(x), self.features(y)):
            na = a * torch.rsqrt(torch.sum(a * a, 1, keepdim=True) + 1e-10)
            nb = b * torch.rsqrt(torch.sum(b * b, 1, keepdim=True) + 1e-10)
            total = total + F.conv2d((na - nb) ** 2, lin).mean(dim=(1, 2, 3))
        return total


def bridge(jax_params, *, device=None) -> LPIPS:
    """``LPIPS`` over the JAX LPIPS params (nested numpy, conv kernels HWIO)."""
    dev = resolve_device(device)
    return LPIPS(BR.load_tree(jax_params, lpips_init(device="meta"), device=dev)).to(dev)


def make_lpips(model: LPIPS | None = None, *, device=None, weights_dir=None,
               cuda_graphs: bool = False):
    """Returns fn(pred, target) -> per-image LPIPS distances (numpy float32),
    the ``lpips_fn`` the ImageRestorationEvaluator wires into the FR metric
    collection (reference eval_image_restoration.py:184); NHWC numpy in
    [0, 1] in. Without ``model``: weights from ``<weights_dir>/lpips_alex.npz``
    (``tools/convert_torchvision.py``) over the seeded init. With
    ``cuda_graphs`` the distance replays from CUDA graphs, one per input
    shape (``evaluators.network_call``), where the JAX function jits it."""
    from .. import zoo
    from .evaluators import network_call

    dev = resolve_device(device)
    if model is None:
        params, _ = zoo.load_npz_tree("lpips_alex", lpips_init(device=dev), weights_dir)
        model = LPIPS(params)
    call = network_call(lambda x, y: model(x, y).float(), dev, cuda_graphs)

    def distance(pred, target):
        return call(pred, target).numpy()

    distance.model, distance.call = model, call
    return distance
