"""Time, FLOPs and MFU of each component of the restore on the card (the port
of ``tools/profile_components.py:main``, :73-181).

    python -m unirestore_torch.diagnostics components [--batch 8] [--iters 5]
        [--eager] [--fused-out] [--trace DIR]

The model is the server's, ``UniRestoreConfig(use_tfa=True, tasks=("ir",
"cls", "seg"))`` at sd-turbo width from the seeded init in bf16, on a seeded
batch of ``--batch`` 512 px images with seeded restore noise (explicit
``torch.Generator``s, ``IMAGE_SEED`` and ``NOISE_SEED``). The six rows are the
JAX tool's (:134-142):

- ``encode(+CFRM) 512px``: the VAE encoder with the three CFRM stages;
- ``decode(+TFA) 512px``: the VAE decoder with TFA routing for ``ir``;
- ``controller 64px``: the Controller on the clean latents at t = 999;
- ``unet-only step``: the controlled UNet, the control maps given;
- ``ctrl+unet step``: Controller and UNet (``predict_eps``);
- ``ddim x20``: the exact 20-step DDIM loop.

Each row gives ms a call, ms an image, TFLOP a call (``flops.count`` on the
``meta`` device: tensor-core work only, where XLA's count includes
elementwise work), TFLOP/s and MFU against the card's 989 TFLOP/s bf16 peak.
Rows run on the graph route (``timing.CapturedCall``, the counterpart of the
JAX tool's ``jax.jit``); ``--eager`` times the eager route beside it. Every
row checks that the graph's replay equals its eager call bit for bit, and
reports the kernel launches of one call (``EXPECTED_LAUNCHES`` is what the
routing implies). Then, as the JAX tool prints them, the pipeline estimate
(encode + ddim x20 + decode -> img/s) and 20 x one step against ddim x20
("loop overhead"). ``--fused-out`` runs everything under
``nn.attention.fused_out_projection(True)``, the counterpart of
``UNIRESTORE_FUSED_OUT_ATTN=1``. ``--trace DIR`` writes a profiler trace
(``train/profiling.py:trace``) of 3 ctrl+unet steps, an encode and a decode,
eager so that the trace names each operation (the tool's ``PROFILE_TRACE``,
:168-178).

Runs on the card only; the FLOP count alone runs anywhere
(``count_flops``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import torch

from ..models import controller as CTRL
from ..models import unet as UN
from ..models import unirestore as UR
from ..nn import attention as ATT
from ..nn import kernels as KN
from ..train import profiling
from . import flops as FL
from . import timing as TM

RES = 512
STEPS = 20
IMAGE_SEED, NOISE_SEED, PARAM_SEED = 1, 2, 0
ROWS = ("encode(+CFRM) 512px", "decode(+TFA) 512px", "controller 64px", "unet-only step",
        "ctrl+unet step", "ddim x20")
# launches of one call (btc, bh, stream, btc_out, grouped conv), from the
# routing: the VAE's mid-block attention is one wide head (stream); CFRM runs
# three grouped convs; the Controller has two channel-flat and one head-major
# attention at stages 0-1 and 2 (4 + 2: two resnets each, and the mid-block);
# the UNet ten channel-flat and five head-major self-attentions; ddim x20 is
# 20 ctrl+unet steps
EXPECTED_LAUNCHES = {"encode(+CFRM) 512px": (0, 0, 1, 0, 3), "decode(+TFA) 512px": (0, 0, 1, 0, 0),
                     "controller 64px": (4, 2, 0, 0, 0), "unet-only step": (10, 5, 0, 0, 0),
                     "ctrl+unet step": (14, 7, 0, 0, 0), "ddim x20": (280, 140, 0, 0, 0)}


def expected_launches(fused: bool = False) -> dict:
    """``EXPECTED_LAUNCHES``; on the fused route every channel-flat launch is
    an out-projection-fused one."""
    if not fused:
        return dict(EXPECTED_LAUNCHES)
    return {name: (0, bh, stream, btc, gconv)
            for name, (btc, bh, stream, _, gconv) in EXPECTED_LAUNCHES.items()}


@dataclasses.dataclass
class Setup:
    """The model and the inputs of every component: ``z0`` and ``skips`` are
    the encode of ``images`` with ``posterior`` noise, ``zt`` the noise at
    t = 999 (the JAX tool's ``zt``), ``tb`` the timesteps (999) and
    ``control`` the Controller's maps of ``z0``."""
    cfg: UR.UniRestoreConfig
    frozen: dict
    trainable: dict
    sched: object
    images: torch.Tensor
    posterior: torch.Tensor
    z0: torch.Tensor
    skips: list
    zt: torch.Tensor
    tb: torch.Tensor
    control: list
    fused: bool = False


def route(fused: bool):
    """The attention route of every call: fused out-projection or not."""
    return ATT.fused_out_projection(True) if fused else contextlib.nullcontext()


def setup(cfg, frozen, trainable, images, posterior, diffusion, sched=None,
          fused: bool = False) -> Setup:
    """``Setup`` of a model and a batch already on one device (``meta`` too)."""
    sched = sched or UR.schedule(cfg, device=images.device)
    with torch.inference_mode(), route(fused):
        z0, skips = UR.encode(frozen, trainable, cfg, images, noise=posterior)
        tb = torch.full((images.shape[0],), 999, dtype=torch.int32, device=images.device)
        control = CTRL.controller_apply(trainable["controller"], cfg.controller, z0, tb)
    return Setup(cfg, frozen, trainable, sched, images, posterior, z0, skips,
                 diffusion.to(z0.dtype), tb, control, fused)


def model_config() -> UR.UniRestoreConfig:
    return UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))


def seeded_setup(batch: int, fused: bool = False) -> Setup:
    """The CLI's ``Setup``: the seeded bf16 model on the card and a seeded batch."""
    dev = TM.card()
    cfg = model_config()
    gen = torch.Generator(device=dev).manual_seed(PARAM_SEED)
    frozen, trainable = UR.init(cfg, gen, device=dev, dtype=torch.bfloat16)
    gen.manual_seed(IMAGE_SEED)
    images = torch.rand((batch, RES, RES, 3), generator=gen, device=dev).to(torch.bfloat16)
    gen.manual_seed(NOISE_SEED)
    post, diff = UR.restore_noise(cfg, images.shape, images.dtype, gen, dev)
    return setup(cfg, frozen, trainable, images, post, diff, fused=fused)


def meta_setup(batch: int, fused: bool = False, cfg=None, res: int = RES) -> Setup:
    """``cfg``'s model (default the CLI's) and a ``res`` px batch as shapes and
    dtypes on the ``meta`` device: nothing allocated."""
    cfg = cfg or model_config()
    frozen, trainable = UR.init(cfg, device="meta", dtype=torch.bfloat16)
    images = torch.empty((batch, res, res, 3), device="meta", dtype=torch.bfloat16)
    lat = UR.latent_shape(cfg, images.shape)
    noise = [torch.empty(lat, device="meta", dtype=torch.bfloat16) for _ in range(2)]
    with FL.plain_kernels():
        return setup(cfg, frozen, trainable, images, *noise, fused=fused)


def components(s: Setup) -> dict:
    """Each row's call with no arguments, reading ``s``' tensors, as the JAX
    tool's jitted functions (:94-127)."""
    cfg, f, t = s.cfg, s.frozen, s.trainable

    def unet_only():
        null = f["null_emb"].expand((s.zt.shape[0],) + tuple(f["null_emb"].shape[1:]))
        return UN.unet_apply(f["unet"], cfg.unet, s.zt, s.tb, null.to(s.zt.dtype),
                             control=s.control, control_params=t.get("control"))

    calls = {
        "encode(+CFRM) 512px": lambda: UR.encode(f, t, cfg, s.images, noise=s.posterior)[0],
        "decode(+TFA) 512px": lambda: UR.decode(f, t, cfg, s.zt, s.skips, "ir"),
        "controller 64px": lambda: CTRL.controller_apply(t["controller"], cfg.controller,
                                                         s.z0, s.tb)[0],
        "unet-only step": unet_only,
        "ctrl+unet step": lambda: UR.predict_eps(f, t, cfg, s.zt, s.z0, s.tb),
        "ddim x20": lambda: UR.ddim_denoise(f, t, cfg, s.sched, s.zt, s.z0, STEPS),
    }
    return {name: calls[name] for name in ROWS}


def count_flops(batch: int, fused: bool = False) -> dict:
    """FLOPs of one call of each row at ``batch``, counted on ``meta``
    (``flops.count``; about half a minute of host time, most of it ddim x20:
    the time goes to dispatching each operation, whatever the width)."""
    s = meta_setup(batch, fused)
    with route(fused):
        return {name: FL.count(fn) for name, fn in components(s).items()}


def _counts() -> tuple:
    return tuple(kern.launches for kern in KN.KERNELS)


def run(s: Setup, flops: dict | None = None, iters: int = 5, eager: bool = False) -> dict:
    """Each row of ``s`` on the card: captured (``timing.CapturedCall``; its
    eager first call's launches), one replay against that eager call, then
    ``timing.timeit`` of ``iters`` replays a window and, with ``eager``, of
    ``iters`` eager calls. Returns {row: {"launches", "bit_equal", "max_abs",
    "finite", "shape", "graph": {"ms", "timer"}, "eager": ..., "flops"}}
    with ``flops`` (a call) where given."""
    out = {}
    for name, fn in components(s).items():
        with torch.inference_mode(), route(s.fused):
            KN.reset_counts()
            first = {}
            graph = TM.CapturedCall(fn, after_first=lambda: first.update(launches=_counts()))
            replay = graph.replay()
            torch.cuda.synchronize()
            diff = (replay.float() - graph.first.float()).abs().max().item()
            row = {"launches": first["launches"], "bit_equal": torch.equal(replay, graph.first),
                   "max_abs": diff, "finite": bool(torch.isfinite(replay).all()),
                   "shape": tuple(replay.shape)}
            row["graph"] = dict(zip(("ms", "timer"), TM.timeit(fn, iters, captured=graph,
                                                               warmup=False)))
            del graph, replay
            if eager:
                # warm already: the capture's eager first call ran it
                row["eager"] = dict(zip(("ms", "timer"), TM.timeit(fn, iters, warmup=False)))
        if flops is not None:
            row["flops"] = flops[name]
        out[name] = row
        torch.cuda.empty_cache()
    return out


def rates(ms: float, nflops: float) -> dict:
    """TFLOP/s and MFU (a share of ``timing.PEAK_BF16_FLOPS``) of ``nflops`` in ``ms``."""
    per_s = nflops / (ms / 1e3)
    return {"tflops": per_s / 1e12, "mfu": per_s / TM.PEAK_BF16_FLOPS}


def summary(rows: dict, batch: int, route_name: str) -> dict:
    """The JAX tool's two closing lines (:157-166) on one route."""
    ms = {name: row[route_name]["ms"] for name, row in rows.items()}
    total = ms["encode(+CFRM) 512px"] + ms["ddim x20"] + ms["decode(+TFA) 512px"]
    return {"pipeline_ms": total, "img_per_s": batch / (total / 1e3),
            "steps20_ms": STEPS * ms["ctrl+unet step"],
            "loop_overhead_ms": ms["ddim x20"] - STEPS * ms["ctrl+unet step"]}


def report(rows: dict, batch: int, iters: int, card: str, fused: bool = False) -> list:
    """The printed table: one line a row and route (a replay that differs
    from its eager call, launches other than ``expected_launches(fused)``
    flagged), then the summaries."""
    want = expected_launches(fused)
    lines = []
    routes = [r for r in ("graph", "eager") if r in next(iter(rows.values()))]
    for name, row in rows.items():
        for r in routes:
            ms = row[r]["ms"]
            tf = row.get("flops", 0) / 1e12
            mfu = rates(ms, row["flops"])["mfu"] * 100 if row.get("flops") else 0.0
            lines.append(f"  {name:24s} {r:5s} {ms:9.1f} ms  {ms / batch:7.1f} ms/img  "
                         f"{tf:7.2f} TF  {mfu:5.1f}% MFU  launches {row['launches']}"
                         + ("" if row["bit_equal"] else f"  REPLAY != EAGER ({row['max_abs']:.3e})")
                         + ("" if row["launches"] == want[name] else f"  WANT {want[name]}"))
    lines.append(f"\nbatch={batch}  (best of 2 windows of {iters} calls between CUDA events, "
                 f"graph replays unless 'eager'; calls under {TM.GRAPH_MS} ms from {TM.GRAPH_CALLS} "
                 f"calls in one graph; MFU vs {TM.PEAK_BF16_FLOPS / 1e12:.0f} TF/s bf16 peak; "
                 f"TF counts tensor-core work only; {card})")
    for r in routes:
        sm = summary(rows, batch, r)
        lines.append(f"\n  {r}: est. pipeline: enc {rows['encode(+CFRM) 512px'][r]['ms']:.0f} "
                     f"+ ddim20 {rows['ddim x20'][r]['ms']:.0f} + dec "
                     f"{rows['decode(+TFA) 512px'][r]['ms']:.0f} = {sm['pipeline_ms']:.0f} ms "
                     f"-> {sm['img_per_s']:.2f} img/s")
        lines.append(f"  {r}: 20x single-step = {sm['steps20_ms']:.0f} ms (loop overhead = "
                     f"{sm['loop_overhead_ms']:+.0f} ms)")
    return lines


def trace(s: Setup, logdir: str) -> None:
    """3 ctrl+unet steps, an encode and a decode, eager, under
    ``profiling.trace(logdir)`` (after one untraced step)."""
    calls = components(s)
    with torch.inference_mode(), route(s.fused):
        calls["ctrl+unet step"]()
        torch.cuda.synchronize()
        with profiling.trace(logdir):
            for _ in range(3):
                calls["ctrl+unet step"]()
            calls["encode(+CFRM) 512px"]()
            calls["decode(+TFA) 512px"]()
            torch.cuda.synchronize()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m unirestore_torch.diagnostics components",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5, help="calls a timed window")
    ap.add_argument("--eager", action="store_true", help="also time the eager route")
    ap.add_argument("--fused-out", action="store_true",
                    help="the out-projection-fused attention route")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a profiler trace of 3 steps, an encode and a decode")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    s = seeded_setup(args.batch, args.fused_out)
    card = TM.card_line()
    rows = run(s, count_flops(args.batch, args.fused_out), args.iters, args.eager)
    print("\n".join(report(rows, args.batch, args.iters, card, args.fused_out)), flush=True)
    if args.trace:
        trace(s, args.trace)
        print(f"  trace written to {args.trace}")
    want = expected_launches(args.fused_out)
    return 0 if all(row["bit_equal"] and row["launches"] == want[name]
                    for name, row in rows.items()) else 1


if __name__ == "__main__":
    sys.exit(main())
