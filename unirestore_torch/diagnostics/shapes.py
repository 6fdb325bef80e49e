"""Per-shape MFU of the restore's hot convolutions and matrix products, each
run alone on the card (the port of ``tools/microbench_shapes.py``).

    python -m unirestore_torch.diagnostics shapes [--iters 50] [--batch 8]

The JAX tool asks whether the pipeline's convolutions and linears run as fast
in situ as the same shapes do alone: where an isolated op matches its in-situ
rate, the pipeline is at the shape's practical cap. The 14 cases are the
tool's (:94-113), with its names, shapes and FLOP formulas: seven 3x3
convolutions (four UNet levels and three VAE levels at 512 px) as the model
runs them (``nn.layers.conv2d``: an NCHW view of an NHWC bf16 tensor, so
``channels_last`` memory, through cuDNN), and seven bf16 products
(``nn.layers.linear``, through cuBLAS). Each case is timed by
``timing.timeit`` (CUDA events, best of two windows of ``--iters`` calls;
under 50 us from calls captured in a CUDA graph) and prints one JSON line:
``op``, ``shape``, ``ms``, ``tflops``, ``mfu`` (against 989 TFLOP/s bf16),
``tile_cap``, ``of_cap``, ``timer`` and the card's name and power limit.

``tile_cap`` is the pad-to-tile ceiling of the shape's implicit GEMM (m rows,
k contraction, n columns) at this card's granularity: a ``wgmma`` takes m in
64s, n in 8s and k in 16s (bf16), so a dimension off those multiples wastes
the padded share of every instruction. The JAX tool's cap is the TPU's (m in
8s, k and n in 128 lanes); the two are not comparable.

A case that fails prints its error line and the sweep goes on, as in the JAX
tool (:115-120); the run then exits non-zero. Runs on the card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from collections.abc import Callable

import torch

from ..nn import layers as L
from . import timing as TM


def tile_cap(m: int, k: int, n: int) -> float:
    """The share of ``wgmma`` work that is not padding for an (m, k) x (k, n)
    product: m in 64s, k in 16s, n in 8s. An upper bound (no drain, no
    memory stalls)."""
    def pad(d, t):
        return d / (-(-d // t) * t)
    return pad(m, 64) * pad(k, 16) * pad(n, 8)


@dataclasses.dataclass
class Case:
    """One case: the JAX tool's name, shape string and FLOPs; ``cap`` its
    ``tile_cap``; ``make(device, generator)`` draws its inputs on the device
    and returns the call to time."""
    name: str
    shape: str
    flops: int
    cap: float
    make: Callable


def conv_case(name: str, b: int, hw: int, cin: int, cout: int, k: int = 3) -> Case:
    """A SAME k x k convolution of a (b, hw, hw, cin) bf16 batch (``conv_case``, :51-66)."""
    def make(device, gen):
        x = torch.randn((b, hw, hw, cin), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((cout, cin, k, k), generator=gen, device=device)
             / float((k * k * cin) ** 0.5)).to(torch.bfloat16)
        return lambda: L.conv2d({"w": w}, x)

    return Case(name, f"{b}x{hw}^2x{cin}->{cout} k{k}", 2 * b * hw * hw * k * k * cin * cout,
                tile_cap(b * hw * hw, k * k * cin, cout), make)


def linear_case(name: str, rows: int, cin: int, cout: int) -> Case:
    """A (rows, cin) @ (cin, cout) bf16 product (``linear_case``, :69-79)."""
    def make(device, gen):
        x = torch.randn((rows, cin), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((cin, cout), generator=gen, device=device)
             / float(cin ** 0.5)).to(torch.bfloat16)
        return lambda: L.linear({"w": w}, x)

    return Case(name, f"({rows},{cin})@({cin},{cout})", 2 * rows * cin * cout,
                tile_cap(rows, cin, cout), make)


def cases(b: int) -> list:
    """The JAX tool's 14 cases at batch ``b`` (:94-113)."""
    return [
        # UNet conv shapes at 512px input (64^2 latent), SD2.1 channels
        conv_case("unet_conv_top", b, 64, 320, 320),
        conv_case("unet_conv_mid", b, 32, 640, 640),
        conv_case("unet_conv_deep", b, 16, 1280, 1280),
        conv_case("unet_conv_bottom", b, 8, 1280, 1280),
        # VAE encoder/decoder conv shapes (the 512^2 levels dominate)
        conv_case("vae_conv_512_128", b, 512, 128, 128),
        conv_case("vae_conv_256_256", b, 256, 256, 256),
        conv_case("vae_conv_128_512", b, 128, 512, 512),
        # UNet attention projections (token-major GEMMs)
        linear_case("qkv_320", b * 4096, 320, 960),
        linear_case("out_320", b * 4096, 320, 320),
        linear_case("qkv_640", b * 1024, 640, 1920),
        linear_case("qkv_1280", b * 256, 1280, 3840),
        linear_case("ffn_320_geglu", b * 4096, 320, 2560),
        linear_case("ffn_back_320", b * 4096, 1280, 320),
        # cross-attention K/V from the (77, 1024) null embedding
        linear_case("xattn_kv_320", 77, 1024, 640),
    ]


def run(b: int = 8, iters: int = 50, card: str | None = None, emit=print) -> list:
    """Time every case at batch ``b`` on the card; ``emit`` each row's JSON
    line and return the rows (a failed case: ``op``, ``shape``, ``error``)."""
    dev = TM.card()
    card = card or TM.card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for case in cases(b):
        try:
            with torch.inference_mode():
                ms, timer = TM.timeit(case.make(dev, gen), iters)
        except Exception as e:  # one failed case must not end the sweep
            row = {"op": case.name, "shape": case.shape, "error": str(e)[-200:]}
        else:
            tflops = case.flops / (ms / 1e3) / 1e12
            mfu = tflops * 1e12 / TM.PEAK_BF16_FLOPS
            row = {"op": case.name, "shape": case.shape, "ms": ms, "tflops": tflops, "mfu": mfu,
                   "tile_cap": case.cap, "of_cap": mfu / case.cap, "timer": timer, "card": card}
        emit(json.dumps(row))
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m unirestore_torch.diagnostics shapes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    rows = run(args.batch, args.iters, emit=lambda line: print(line, flush=True))
    return 1 if any("error" in row for row in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
