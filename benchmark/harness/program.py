"""The program under test, ``unirestore_torch``: the one module of the
harness that imports it (the reference never does)."""

from __future__ import annotations

import torch

from unirestore_torch import graphs as GR
from unirestore_torch.models import controller as CTRL
from unirestore_torch.models import unet as UN
from unirestore_torch.models import unirestore as UR
from unirestore_torch.models import vae as VAE
from unirestore_torch.nn import kernels as KN

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def config(spec: dict) -> UR.UniRestoreConfig:
    """The program's configuration of a configuration file's ``model``."""
    top = _tuples({k: v for k, v in spec.items() if k not in ("vae", "unet", "controller")})
    return UR.UniRestoreConfig(vae=VAE.VAEConfig(**_tuples(spec["vae"])),
                               unet=UN.UNetConfig(**_tuples(spec["unet"])),
                               controller=CTRL.ControllerConfig(**_tuples(spec["controller"])),
                               **top)


def template(cfg, device="meta", dtype=torch.float32) -> tuple:
    """(frozen, trainable) parameter trees of the program's layout. On ``meta``
    by default; set-up takes them on the card, where the first ``meta``
    operations of a process would import ``sympy`` (seconds of set-up)."""
    return UR.init(cfg, device=device, dtype=dtype)


def latent_shape(cfg, images_shape) -> tuple:
    return UR.latent_shape(cfg, UR.padded_shape(images_shape, cfg))


def graphed_restore(frozen, trainable, cfg, device):
    """``restore(x, task, steps, posterior_noise, diffusion_noise)`` replayed
    from CUDA graphs (``graphs.GraphedRestore``), every kernel built first."""
    KN.build_all()
    graphed = GR.GraphedRestore(frozen, trainable, cfg, UR.schedule(cfg, device=device),
                                device=device)

    def restore(x, task, steps, post, diff):
        return graphed(x, task, None, steps, posterior_noise=post, diffusion_noise=diff)

    restore.stats = graphed.stats
    return restore


def eager_restore(frozen, trainable, cfg, device):
    """The same call through ``models/unirestore.py:restore``, eagerly (the
    CPU tests' route; the card's cells use ``graphed_restore``)."""
    sched = UR.schedule(cfg, device=device)

    def restore(x, task, steps, post, diff):
        return UR.restore(frozen, trainable, cfg, sched, x, task, None, steps,
                          posterior_noise=post, diffusion_noise=diff, device=device)

    return restore
