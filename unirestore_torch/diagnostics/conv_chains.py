"""Chains of 3x3 convolutions per UNet level, with and without the norm and
activation around them, and two other lowerings of the same convolution, on
the card (the port of ``tools/bench_conv.py``).

    python -m unirestore_torch.diagnostics conv_chains [--levels lvl0,lvl1,lvl2]
        [--batch 8] [--iters 5]

A chain is ``N_CHAIN`` back-to-back convolutions at one UNet level of a
512 px batch (``LEVELS``: 64² x 320, 32² x 640, 16² x 1280), enough work a
call that the time is the card's. The four variants are the tool's
(:56-114), on the port's own layers:

- ``conv``: the convolutions alone (``nn.layers.conv2d``: cuDNN on
  ``channels_last`` bf16);
- ``resblock``: each preceded by ``nn.layers.group_norm`` (32 groups) and
  ``nn.layers.silu``, the functions the main path calls. ``resblock`` minus
  ``conv`` is what the port's GroupNorm + SiLU cost around each convolution
  in situ;
- ``im2col``: ``F.unfold`` of the NCHW view, then one (B·H·W, 9·cin) x
  (9·cin, cout) product;
- ``taps``: nine shifted (B·H·W, cin) x (cin, cout) products, summed.

Each chain is captured once into a CUDA graph and its replays timed
(``timing.timeit(..., captured=...)``, the counterpart of the tool's
jitted scan). Each row gives ms a chain, ms a convolution, MFU against the
convolutions' FLOPs alone (for every variant; ``resblock``'s norms add
none), and for ``im2col`` and ``taps`` the largest difference from ``conv``
over the largest |conv| (the tool's ``relerr``). Each level ends with the
line that matters for the fused-norm kernel: ``resblock - conv`` per
convolution. Runs on the card only.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from ..nn import layers as L
from . import timing as TM

N_CHAIN = 6  # convolutions a chain
# (name, hw, c): the 512 px UNet levels at sd-turbo's 320 / 640 / 1280
LEVELS = (("lvl0", 64, 320), ("lvl1", 32, 640), ("lvl2", 16, 1280))
GROUPS = 32


def chain_conv(x, ws, gn):
    for w in ws:
        x = L.conv2d({"w": w}, x)
    return x


def chain_resblock(x, ws, gn):
    for w in ws:
        x = L.group_norm(gn, x, groups=GROUPS)
        x = L.silu(x)
        x = L.conv2d({"w": w}, x)
    return x


def _im2col_conv(x, w):
    """SAME 3x3 convolution of NHWC ``x`` by OIHW ``w`` as one product over
    unfolded patches (``F.unfold`` orders a patch (cin, kh, kw), as ``w``'s
    last three axes)."""
    b, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    p = F.unfold(x.permute(0, 3, 1, 2), k, padding=k // 2)  # (B, cin*k*k, H*W)
    y = p.transpose(1, 2).reshape(b * h * wd, cin * k * k) @ w.reshape(cout, -1).t()
    return y.reshape(b, h, wd, cout)


def chain_im2col(x, ws, gn):
    for w in ws:
        x = _im2col_conv(x, w)
    return x


def _taps_conv(x, w):
    """The same convolution as nine shifted full-width products, summed."""
    b, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(k):
        for dx in range(k):
            xs = xp[:, dy:dy + h, dx:dx + wd, :].reshape(b * h * wd, cin)
            y = xs @ w[:, :, dy, dx].t()
            out = y if out is None else out + y
    return out.reshape(b, h, wd, cout)


def chain_taps(x, ws, gn):
    for w in ws:
        x = _taps_conv(x, w)
    return x


VARIANTS = {"conv": chain_conv, "resblock": chain_resblock, "im2col": chain_im2col,
            "taps": chain_taps}


def level_inputs(b: int, hw: int, c: int, device, dtype=torch.bfloat16, seed: int = 0):
    """The tool's inputs (:124-129): x ~ 0.3 N(0, 1), ``N_CHAIN`` OIHW weights
    ~ N(0, 1 / (9 c)), GroupNorm scale 1 and bias 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, hw, hw, c), generator=gen, device=device) * 0.3).to(dtype)
    ws = [(torch.randn((c, c, 3, 3), generator=gen, device=device) * (9 * c) ** -0.5).to(dtype)
          for _ in range(N_CHAIN)]
    gn = {"scale": torch.ones((c,), dtype=dtype, device=device),
          "bias": torch.zeros((c,), dtype=dtype, device=device)}
    return x, ws, gn


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| (the tool's ``relerr``)."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()


def run(b: int = 8, iters: int = 5, levels=None, card: str | None = None, emit=print) -> dict:
    """Every variant at each level (``levels`` names, default all) on the
    card; ``emit`` each printed line; returns {level: {variant: row}} with
    row ``ms_chain``, ``ms_conv``, ``mfu``, ``relerr`` (im2col, taps),
    ``timer``, and per level ``resblock_minus_conv_ms`` (a convolution)."""
    dev = TM.card()
    card = card or TM.card_line()
    out = {}
    for name, hw, c in LEVELS:
        if levels and name not in levels:
            continue
        x, ws, gn = level_inputs(b, hw, c, dev)
        flops = 2 * b * hw * hw * 9 * c * c * N_CHAIN  # the convolutions alone
        emit(f"== {name}: {b}x{hw}^2x{c}, chain of {N_CHAIN} k3 convs ({flops / 1e9:.1f} GF; "
             f"{card})")
        rows, ref = {}, None
        with torch.inference_mode():
            for vname, f in VARIANTS.items():
                def chain(f=f):
                    return f(x, ws, gn)
                captured = TM.CapturedCall(chain)
                ms, timer = TM.timeit(chain, iters, captured=captured)
                got = captured.first
                if vname == "conv":
                    ref = got
                err = rel_err(got, ref) if vname in ("im2col", "taps") else None
                mfu = flops / (ms / 1e3) / TM.PEAK_BF16_FLOPS
                rows[vname] = {"ms_chain": ms, "ms_conv": ms / N_CHAIN, "mfu": mfu,
                               "relerr": err, "timer": timer}
                emit(f"  {vname:10s}  {ms:7.3f} ms/chain  {ms / N_CHAIN:6.3f} ms/conv  "
                     f"MFU {mfu * 100:5.1f}%  relerr "
                     + ("n/a" if err is None else f"{err:.2e}"))
                del captured, got
        rows["resblock_minus_conv_ms"] = (rows["resblock"]["ms_conv"] - rows["conv"]["ms_conv"])
        emit(f"  resblock - conv: {rows['resblock_minus_conv_ms']:.4f} ms a conv "
             f"(GroupNorm + SiLU in situ)")
        out[name] = rows
        del x, ws, gn, ref
        torch.cuda.empty_cache()
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m unirestore_torch.diagnostics conv_chains",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", default=None, help="comma list of lvl0,lvl1,lvl2 (default all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5, help="replays a timed window")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args.batch, args.iters, args.levels.split(",") if args.levels else None,
        emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
