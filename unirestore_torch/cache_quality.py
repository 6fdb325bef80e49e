"""The approximation cost of the cached DDIM modes (the port of
``tools/eval_cache_quality.py``).

Restores one seeded image batch in the exact mode and in each cached mode,
stride and warm-up, with the same restore noise, and prints for each cached
configuration one JSON row: PSNR and relative L2 of its output against the
exact output, both clipped to [0, 1] in fp32 (``compare`` rounds as the
tool's ``_compare``, :101-107). That is the number a deployment uses to pick
a speed / quality point.

    python -m unirestore_torch.cache_quality [--steps 20] [--batch 4] [--size 512]
        [--strides 2,3,4,5] [--warmups 0] [--modes encoder,deep] [--tiny]
        [--weights-dir weights] [--device cpu]

The model is the server's, ``UniRestoreConfig(use_tfa=True, tasks=("ir",
"cls", "seg"))`` (``tiny_config()`` under ``--tiny``) from the seeded init,
with the converted sd-turbo VAE / UNet and the null embedding of
``--weights-dir`` merged in (``zoo.load_frozen_backbone``, as ``serve.py``
does), in bf16. The tool's docstring promises those weights but its code
never loads them: with converted weights this is a real quality proxy;
without them (a warning says so) the numbers only show that the cached
restores stay close to the exact one. Every configuration runs eagerly in
this process, once: the tool's subprocess per configuration works round the
TPU compile server, and a CUDA graph capture would cost more than one run.
The default device is the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import bridge, zoo
from .device import resolve_device
from .models import unirestore as UR

IMAGE_SEED, NOISE_SEED = 1, 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m unirestore_torch.cache_quality",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--strides", default="2,3,4,5")
    ap.add_argument("--warmups", default="0",
                    help="comma list of cache_warmup values (first N steps exact) to sweep per "
                         "stride")
    ap.add_argument("--modes", default="encoder,deep",
                    help="comma list of cache modes to sweep")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU smoke; structural numbers only)")
    ap.add_argument("--weights-dir", default=zoo.DEFAULT_WEIGHTS,
                    help="converted sd-turbo weights and sd_null_emb.npy")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; 'cpu' for tests)")
    return ap.parse_args(argv)


def specs_of(modes: str, strides: str, warmups: str) -> list:
    """``exact`` and one ``mode:stride:warmup`` per configuration, in the tool's order."""
    return ["exact"] + [f"{mode}:{stride}:{warmup}" for mode in modes.split(",")
                        for stride in strides.split(",") for warmup in warmups.split(",")]


def config_for(base: UR.UniRestoreConfig, spec: str) -> UR.UniRestoreConfig:
    if spec == "exact":
        return base
    mode, stride, warmup = spec.split(":")
    return dataclasses.replace(base, cache_mode=mode, cache_stride=int(stride),
                               cache_warmup=int(warmup))


def make_inputs(cfg, batch: int, size: int, device, dtype=torch.bfloat16):
    """The seeded image batch in [0, 1] and its restore noise, drawn with numpy
    (the same numbers on any device): (images, (posterior, diffusion))."""
    images = np.random.default_rng(IMAGE_SEED).random((batch, size, size, 3), np.float32)
    rng = np.random.default_rng(NOISE_SEED)
    lat = UR.latent_shape(cfg, images.shape)
    noise = [rng.standard_normal(lat, np.float32) for _ in range(2)]
    return (torch.from_numpy(images).to(device=device, dtype=dtype),
            tuple(torch.from_numpy(n).to(device=device, dtype=dtype) for n in noise))


def compare(out, exact) -> tuple:
    """(PSNR dB, relative L2) of ``out`` against ``exact``, rounded as the tool rounds."""
    mse = float(np.mean((out - exact) ** 2))
    psnr = float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))
    rel = float(np.linalg.norm(out - exact) / max(np.linalg.norm(exact), 1e-9))
    return round(psnr, 2), round(rel, 5)


def sweep(frozen, trainable, cfg, images, noise, specs, steps: int, *, device=None,
          on_restore=None):
    """Restore ``images`` once per spec of ``specs`` (``"exact"`` among them)
    with ``noise`` = (posterior, diffusion), each through ``restore_padded``
    eagerly. Returns (outputs, rows): each spec's output as float32 numpy
    clipped to [0, 1], and the JSON row of each cached spec against exact.
    ``on_restore(spec, out)``, if given, sees each raw output as it comes."""
    if "exact" not in specs:
        raise ValueError(f"the sweep compares against 'exact', which {specs} lacks")
    dev = resolve_device(device)
    sched = UR.schedule(cfg, device=dev)
    post, diff = noise
    outputs = {}
    for spec in specs:
        out = UR.restore_padded(frozen, trainable, config_for(cfg, spec), sched, images, "ir",
                                num_inference_steps=steps, posterior_noise=post,
                                diffusion_noise=diff, device=dev)
        if on_restore is not None:
            on_restore(spec, out)
        outputs[spec] = np.clip(out.float().cpu().numpy(), 0, 1)
    rows = []
    for spec in specs:
        if spec == "exact":
            continue
        mode, stride, warmup = spec.split(":")
        psnr, rel = compare(outputs[spec], outputs["exact"])
        rows.append({"mode": mode, "stride": int(stride), "warmup": int(warmup),
                     "psnr_vs_exact_db": psnr, "rel_l2": rel})
    return outputs, rows


def build(args):
    """(frozen, trainable, cfg, device): the seeded model with ``--weights-dir``
    merged in, in bf16."""
    dev = resolve_device(args.device)
    cfg = (UR.tiny_config() if args.tiny
           else UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg")))
    frozen, trainable = UR.init(cfg, device=dev, seed=0)
    frozen = zoo.load_frozen_backbone(frozen, cfg, args.weights_dir)
    return (bridge.cast_tree(frozen, torch.bfloat16), bridge.cast_tree(trainable, torch.bfloat16),
            cfg, dev)


def main(argv=None) -> list:
    args = parse_args(argv)
    if not args.tiny and not (Path(args.weights_dir) / "sd_turbo_vae.npz").exists():
        print("# WARNING: random-init weights; numbers are structural only", file=sys.stderr)
    frozen, trainable, cfg, dev = build(args)
    images, noise = make_inputs(cfg, args.batch, args.size, dev)
    _, rows = sweep(frozen, trainable, cfg, images, noise,
                    specs_of(args.modes, args.strides, args.warmups), args.steps, device=dev)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
