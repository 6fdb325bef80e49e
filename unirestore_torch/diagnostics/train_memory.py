"""Card memory of the stage-1 Controller backward (the port of
``tools/debug_train_memory.py``).

    python -m unirestore_torch.diagnostics train_memory [--batch 8] [--res 512]
        [--remat | --no-remat]

What it measures is the JAX tool's: the control loss's value and gradients,
the ``cn`` part of the split train step (JAX ``train/steps.py:cn_part``,
:328-336): ``predict_z0`` of the noised latents under the Controller,
MSE against ``h0``, gradients over the ``controller`` and ``control``
families. ``cn_value_and_grad`` is that part of the port's step, on the
step's own pieces (``train/steps.py``: the ``cn`` family of ``_FAMILIES``,
``_tracking``, ``_grads``, ``_mse``). The model is the tool's,
``UniRestoreConfig(use_tfa=False, tasks=("ir",))`` at sd-turbo width, the
frozen tree in bf16 and the trainable tree in fp32, with per-unit
rematerialisation (``train/steps.py:with_remat``) unless ``--no-remat`` (the
tool's ``MEM_REMAT``).

PyTorch has no ahead-of-time memory analysis, so the part runs on the card
(one warm-up call, then one measured under ``reset_peak_memory_stats``) and
the tool's labels (:73-81) are read from the allocator:

- ``argument_size``: the bytes of the call's arguments (the frozen tree, the
  two trained families, the four inputs);
- ``output_size``: the loss and the gradients;
- ``temp_size``: the peak less what was held before the call less the
  output;
- ``total``: their sum.

XLA's ``alias_size`` and ``generated_code`` have no counterpart here. Runs on
the card only.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import bridge
from ..models import unirestore as UR
from ..train import steps as TS
from . import timing as TM

GIB = 2 ** 30
PARAM_SEED, INPUT_SEED = 0, 1


def model_config(remat: bool = True) -> UR.UniRestoreConfig:
    cfg = UR.UniRestoreConfig(use_tfa=False, tasks=("ir",))
    return TS.with_remat(cfg) if remat else cfg


def cn_leaves(trainable) -> dict:
    """The leaves the ``cn`` part differentiates, by flat name."""
    return TS._family(bridge.flatten(trainable), "cn")


def cn_value_and_grad(frozen, trainable, cfg, sched, zt, l0, timesteps, h0):
    """(loss, {flat name: gradient}) of the control loss over ``cn_leaves``:
    the ``cn`` part of ``train/steps.py:make_step_parts``."""
    leaves = cn_leaves(trainable)
    with TS._tracking(leaves):
        pred_z0 = UR.predict_z0(frozen, trainable, cfg, sched, zt, l0, timesteps)
        loss = TS._mse(pred_z0, h0)
        grads = TS._grads(loss, leaves)
    return loss.detach(), grads


def inputs(cfg, batch: int, res: int, device, generator, dtype=torch.bfloat16) -> tuple:
    """Seeded (zt, l0, timesteps, h0) of a ``res`` px batch, as the tool's shapes."""
    lat = (batch, res // 8, res // 8, cfg.vae.latent_channels)
    zt, l0, h0 = (torch.randn(lat, generator=generator, device=device).to(dtype)
                  for _ in range(3))
    timesteps = torch.randint(0, 1000, (batch,), generator=generator, device=device,
                              dtype=torch.int32)
    return zt, l0, timesteps, h0


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def measure(frozen, trainable, cfg, batch: int = 8, res: int = 512,
            warmup: bool = True) -> dict:
    """The ``cn`` part on the card at ``batch`` x ``res`` px: bytes of its
    arguments, output and temporaries (``peak - held - output``), the peak
    and what was held, and the loss. One warm-up call first (the library
    handles and workspaces a first call allocates and keeps) unless
    ``warmup`` is False, where the caller ran the part at these shapes."""
    dev = TM.card()
    sched = UR.schedule(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(INPUT_SEED)
    args = inputs(cfg, batch, res, dev, gen)
    if warmup:
        cn_value_and_grad(frozen, trainable, cfg, sched, *args)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    loss, grads = cn_value_and_grad(frozen, trainable, cfg, sched, *args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    output = nbytes([loss, *grads.values()])
    argument = nbytes([*bridge.flatten(frozen).values(), *cn_leaves(trainable).values(), *args])
    temp = peak - held - output
    return {"batch": batch, "res": res, "remat": cfg.unet.remat, "argument_bytes": argument,
            "output_bytes": output, "temp_bytes": temp, "total_bytes": argument + output + temp,
            "peak_bytes": peak, "held_bytes": held, "loss": loss.item()}


def seeded_trees(cfg, device):
    """The tool's trees at full width, seeded: frozen in bf16, trainable in fp32."""
    gen = torch.Generator(device=device).manual_seed(PARAM_SEED)
    frozen, trainable = UR.init(cfg, gen, device=device, dtype=torch.float32)
    frozen = bridge.cast_tree(frozen, torch.bfloat16)
    return frozen, trainable


def report(m: dict, card: str) -> list:
    return [f"measured (remat={m['remat']}, batch={m['batch']}, res={m['res']}, {card})",
            f"argument_size:  {m['argument_bytes'] / GIB:8.3f} GiB",
            f"output_size:    {m['output_bytes'] / GIB:8.3f} GiB",
            f"temp_size:      {m['temp_bytes'] / GIB:8.3f} GiB",
            f"total:          {m['total_bytes'] / GIB:8.3f} GiB",
            f"(peak {m['peak_bytes'] / GIB:.3f} GiB, held before the call "
            f"{m['held_bytes'] / GIB:.3f} GiB)"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m unirestore_torch.diagnostics train_memory",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = TM.card()
    card = TM.card_line()
    cfg = model_config(args.remat)
    frozen, trainable = seeded_trees(cfg, dev)
    m = measure(frozen, trainable, cfg, args.batch, args.res)
    print("\n".join(report(m, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
