"""No-reference IQA metric suite, the reference's NR protocol
(eval_image_restoration.py:190-203): clipiqa, musiq, musiq-ava,
musiq-paq2piq, musiq-spaq, nima-koniq, maniqa, hyperiqa, pi, niqe (the port
of ``unirestore_tpu/evalx/nr_suite.py:30-175``: the same names, order,
warnings and fallbacks).

Each neural metric is a network of this package (``evalx/clipiqa.py``,
``musiq.py``, ``nima.py``, ``maniqa.py``, ``hyperiqa.py``) over its seeded
fp32 tree with ``<weights_dir>/<file>.npz`` merged in where present
(``zoo.load_npz_tree``: the seeded init and a warning when absent; scores
then have the right shape and protocol but arbitrary values). It runs under
``torch.inference_mode`` in fp32 on ``device`` (default: the card) and reads
its scores back to the host once per ``update``. NIQE and PI are host numpy
(``evalx/niqe.py``, ``nrqm.py``), as in the JAX package: classical
statistics over MSCN coefficients and the NRQM feature groups.

PI = 0.5 * ((10 - NRQM) + NIQE) (Blau et al., PIRM 2018). When no fitted
NRQM model exists PI falls back to the constant NRQM = 5 with a warning.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import zoo
from ..device import resolve_device
from ..nn.init import make_init
from . import clipiqa as CIQ
from . import hyperiqa as HIQ
from . import inception as INC
from . import maniqa as MAN
from . import musiq as MUS
from . import nima as NIM
from .evaluators import upload

# the reference's full 10-metric NR protocol (eval_image_restoration.py:190-203)
DEFAULT_NR_METRICS = (
    "clipiqa", "musiq", "musiq-ava", "musiq-paq2piq", "musiq-spaq",
    "nima-koniq", "maniqa", "hyperiqa", "pi", "niqe")

SEED = 11

# the networks by suite name: (init(ini), score(p, images), weights file);
# "inception" is FID's extractor (evalx/inception.py)
NETS = {
    "clipiqa": (CIQ.clip_rn50_init, CIQ.clipiqa_score, "clipiqa_rn50"),
    "musiq": (lambda i: MUS.musiq_init(i, 1), lambda p, x: MUS.musiq_score(p, x, 1),
              "musiq_koniq"),
    "musiq-ava": (lambda i: MUS.musiq_init(i, 10), lambda p, x: MUS.musiq_score(p, x, 10),
                  "musiq_ava"),
    "musiq-paq2piq": (lambda i: MUS.musiq_init(i, 1), lambda p, x: MUS.musiq_score(p, x, 1),
                      "musiq_paq2piq"),
    "musiq-spaq": (lambda i: MUS.musiq_init(i, 1), lambda p, x: MUS.musiq_score(p, x, 1),
                   "musiq_spaq"),
    # nima-koniq: the Inception-ResNet-V2 regressor trained on KonIQ-10k
    "nima-koniq": (lambda i: NIM.inception_resnet_v2_init(i, num_classes=1),
                   lambda p, x: NIM.nima_score(p, x, num_classes=1), "nima_koniq"),
    "maniqa": (MAN.maniqa_init, MAN.maniqa_score, "maniqa"),
    "hyperiqa": (HIQ.hyperiqa_init, HIQ.hyperiqa_score, "hyperiqa"),
    "inception": (INC.inception_v3_init, INC.inception_v3_features, "inception_v3"),
}

_WARNED = set()


def _warn_once(msg):
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg)


def net_init(name: str, seed: int = SEED, device=None):
    """The seeded fp32 tree of a network of ``NETS`` (``device="meta"``: shapes only)."""
    dev = "meta" if device == "meta" else resolve_device(device)
    return NETS[name][0](make_init(None, dev, seed=seed))


class NeuralNR:
    """MeanMetric-style wrapper over ``apply(images) -> scores`` on tensors,
    run in fp32 on ``device`` with one read-back an update."""

    def __init__(self, apply, device):
        self.apply = apply
        self.device = torch.device(device)
        self.total, self.count = 0.0, 0

    def scores(self, images) -> np.ndarray:
        with torch.inference_mode():
            s = self.apply(upload(images, self.device))
            return s.double().cpu().numpy()

    def update(self, images):
        scores = self.scores(images)
        self.total += float(scores.sum())
        self.count += int(scores.shape[0])

    def compute(self):
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0


def _neural_metric(name: str, seed: int, device, weights_dir):
    p, _ = zoo.load_npz_tree(NETS[name][2], net_init(name, seed, device), weights_dir)
    score = NETS[name][1]
    metric = NeuralNR(lambda x: score(p, x), device)
    metric.params = p
    return metric


class PIMetric:
    """Perceptual Index: 0.5 * ((10 - NRQM) + NIQE).

    ``nrqm_metric`` is the fitted Ma et al. pipeline when available; otherwise
    the constant ``nrqm_const`` stands in (NIQE still ranks)."""

    def __init__(self, niqe_metric, nrqm_metric=None, nrqm_const: float = 5.0):
        self.niqe = niqe_metric
        self.nrqm = nrqm_metric
        self.nrqm_const = nrqm_const

    def update(self, images):
        self.niqe.update(images)
        if self.nrqm is not None:
            self.nrqm.update(images)

    def compute(self):
        nrqm = self.nrqm.compute() if self.nrqm is not None else self.nrqm_const
        return 0.5 * ((10.0 - nrqm) + self.niqe.compute())

    def reset(self):
        self.niqe.reset()
        if self.nrqm is not None:
            self.nrqm.reset()


def build_nr_suite(names=None, seed: int = SEED, device=None, weights_dir=None) -> dict:
    """name -> MeanMetric-style object for the requested NR metrics, the
    networks on ``device`` (default: the card, which must exist).

    Default: the reference's full 10-metric NR set. NIQE (and so PI) is
    skipped with a warning when no pristine model has been fitted.
    """
    names = list(names) if names is not None else list(DEFAULT_NR_METRICS)
    dev = resolve_device(device)
    out = {}
    for name in names:
        if name in NETS and name != "inception":
            out[name] = _neural_metric(name, seed, dev, weights_dir)
        elif name in ("niqe", "pi"):
            from .niqe import NIQEMetric
            try:
                m = NIQEMetric(weights_dir=weights_dir)
            except FileNotFoundError:
                _warn_once(f"NR metric '{name}' skipped: no NIQE pristine model "
                           "(fit one with tools/fit_niqe.py)")
                continue
            if name == "niqe":
                out[name] = m
            else:
                from .nrqm import NRQMMetric
                try:
                    nrqm = NRQMMetric(weights_dir=weights_dir)
                except FileNotFoundError:
                    nrqm = None
                    _warn_once("PI uses NRQM=5.0 (constant) — no fitted NRQM model (fit one "
                               "with tools/fit_nrqm.py); NIQE drives the ranking signal")
                out[name] = PIMetric(m, nrqm_metric=nrqm)
        else:
            raise ValueError(f"unknown NR metric {name}")
    return out
