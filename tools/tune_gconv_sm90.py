#!/usr/bin/env python3
"""Time build variants of the bf16 grouped 3x3 conv kernels against each other on one card.

Two sources carry a bf16 grouped-conv entry: ``csrc/grouped_conv.cu``
(``ur_grouped_conv3``, whose bf16 body is the ``mma.sync`` kernel
``gconv3_mma``) and ``csrc/grouped_conv_sm90.cu`` (``ur_grouped_conv3_sm90``,
the Hopper kernel that replaced it). Each variant is a copy of one of them
with exact text edits (``VARIANTS``: the two kernels as they are;
``DIAGNOSTICS``: variants that drop one piece of work on purpose, to show
what bounds a kernel, not held to the plain version), built with ``nvcc`` at
once into ``--workdir`` and loaded with ctypes. At each shape of
``chip_smoke.gconv_shapes`` (bf16, the same seeded inputs; the weights packed
once, outside the timed loop) every variant is held to the plain version
(``bf16_tolerance_ratio``) and its C entry is timed directly, in turns with
the others and cuDNN's ``F.conv2d(groups=16)`` on channels-last tensors
(forward order, then reversed; the mean of the two), by two timers: CUDA
graph replays of captured calls (``graph_ms``: the device's time) and events
around back-to-back calls (``event_ms``). Prints ptxas's register and
shared-memory lines per variant and one JSON line per shape and entry. Run
on a machine with one CUDA device, from the repository root:

    python3 tools/tune_gconv_sm90.py [--only mma] [--workdir unirestore_torch/_build/tune_gconv]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402
from unirestore_torch.nn import cuda_lib  # noqa: E402
from unirestore_torch.nn import grouped_conv as G  # noqa: E402

# family -> (source, C entry)
SOURCES = {"mma": (G.SOURCE, "ur_grouped_conv3"),
           "sm90": (G.SOURCE_SM90, "ur_grouped_conv3_sm90")}

_ATTRIBUTE_ONCE = (
    "  cudaError_t err =\n"
    "      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));\n"
    "  if (err != cudaSuccess) return int(err);\n",
    "  static const void* set[16] = {};\n"
    "  int i = 0;\n"
    "  while (i < 16 && set[i] != nullptr && set[i] != (const void*)kernel) ++i;\n"
    "  if (i < 16 && set[i] == nullptr) {\n"
    "    cudaError_t err =\n"
    "        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));\n"
    "    if (err != cudaSuccess) return int(err);\n"
    "    set[i] = (const void*)kernel;\n"
    "  }\n")
_MMA_NO_PRODUCTS = ("        mma_bf16(acc[2 * np], a, bw[0], bw[1]);\n"
                    "        mma_bf16(acc[2 * np + 1], a, bw[2], bw[3]);\n", "")
_MMA_NO_STORES = (
    "        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(v0, v1);\n",
    "        if (v0 == -12345.f) out[c] = __float2bfloat16(v1);\n")

_SM90_NO_PRODUCTS = ("wgmma_rs<N>(acc[s], a[tap & 1], j, desc_b<CG>(bm));", "(void)bm;")
_SM90_NO_STORES = ("      tma_store_4d(&ty, out_tile, c_out0, x0, y0 + 4 * wg, b);\n", "")

_M1_EVERYWHERE = ("  return cg >= 64;\n", "  return false;\n")
_T_NO_PRODUCTS = (
    "          wgmma_ss_n144(acc, desc_b<CG>(a_tap + 32 * kk), desc_sw128_any(b_tap + 32 * kk));",
    "          (void)a_tap, (void)b_tap;")
_T_NO_STORES = ("      tma_store_4d(&ty, out_tile, c_out0, x0, y0, b);\n", "")

# name -> (family, exact (old, new) edits of its source)
VARIANTS = {
    "mma": ("mma", []),
    "sm90": ("sm90", []),
    # M1 at every width (at cg >= 64 the shipped kernel runs M2)
    "sm90_m1": ("sm90", [_M1_EVERYWHERE]),
}
# variants that compute a wrong answer on purpose, to show what bounds a kernel
DIAGNOSTICS = {
    # gconv3_mma: no products (the halo and weight loads, the waits, the
    # barriers, the ldmatrix reads and the stores); every tap's weights
    # read from the first tap's buffer, loaded once; no output stores
    # (a rare store keeps the sums alive); the loop's skeleton (neither
    # products nor stores); the shared-memory attribute set once per kernel
    # and not on every launch
    "mma_no_products": ("mma", [_MMA_NO_PRODUCTS]),
    "mma_weights_once": ("mma", [
        ("    if (tap + 1 < 9) load_tap(tap + 1, wbuf + ((tap + 1) & 1) * CG * P);\n", ""),
        ("const bf16* b_tap = wbuf + (tap & 1) * CG * P + b_off;",
         "const bf16* b_tap = wbuf + b_off;")]),
    "mma_no_stores": ("mma", [_MMA_NO_STORES]),
    "mma_skeleton": ("mma", [_MMA_NO_PRODUCTS, _MMA_NO_STORES]),
    "mma_attribute_once": ("mma", [_ATTRIBUTE_ONCE]),
    # the Hopper kernel's M1, at every width: no products; no output
    # stores; neither (the halo loads, the weights' copy, the waits and the
    # ldmatrix reads alone)
    "sm90_m1_no_products": ("sm90", [_M1_EVERYWHERE, _SM90_NO_PRODUCTS]),
    "sm90_m1_no_stores": ("sm90", [_M1_EVERYWHERE, _SM90_NO_STORES]),
    "sm90_m1_skeleton": ("sm90", [_M1_EVERYWHERE, _SM90_NO_PRODUCTS, _SM90_NO_STORES]),
    # its M2 (cg >= 64; at cg <= 32 these run M1 whole): no products; no stores
    "sm90_t_no_products": ("sm90", [_T_NO_PRODUCTS]),
    "sm90_t_no_stores": ("sm90", [_T_NO_STORES]),
}


def build(workdir: Path, names) -> dict:
    workdir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        family, edits = {**VARIANTS, **DIAGNOSTICS}[name]
        source, symbol = SOURCES[family]
        src = source.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times")
            src = src.replace(old, new)
        cu = workdir / f"{name}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        jobs[name] = (so, symbol, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, symbol, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        for line in out.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "serialized")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def call(fn, x, wp, b, out):
    """One direct call of a grouped-conv C entry (bf16) into ``out``."""
    bsz, h, wd, c = x.shape
    rc = fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wd, c,
            wp.shape[-1], 1, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", type=Path,
                    default=REPO / "unirestore_torch" / "_build" / "tune_gconv")
    ap.add_argument("--only", choices=sorted(SOURCES), help="one family of variants")
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per event timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_gconv_sm90: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {CS.card_line()}", flush=True)
    names = [n for n, (fam, _) in {**VARIANTS, **DIAGNOSTICS}.items()
             if args.only in (None, fam)]
    entries = build(args.workdir.resolve(), names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    with torch.inference_mode():
        for shape in CS.gconv_shapes():
            x, w, b = CS.gconv_inputs(shape, gen)
            wp = G.pack_weights(w, 16)
            ref = G.grouped_conv3_plain(x, w, b, 16)
            ratios = {name: G.bf16_tolerance_ratio(call(fn, x, wp, b, torch.empty_like(x)), ref)
                      for name, fn in entries.items()}
            bad += [(shape, n) for n, r in ratios.items() if not r <= 1.0 and n in VARIANTS]
            out = torch.empty_like(x)
            calls = {name: (lambda fn=fn: call(fn, x, wp, b, out)) for name, fn in entries.items()}
            xc = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
            calls["cudnn"] = lambda: F.conv2d(xc, w, b, padding=1, groups=16)
            order = list(calls)
            graph, event = {n: [] for n in order}, {n: [] for n in order}
            for turn in (order, order[::-1]):
                for name in turn:
                    graph[name].append(CS.graph_ms(calls[name], calls=20))
                    event[name].append(CS.cuda_ms(calls[name], args.reps))
            bsz, h, wd, c = shape
            bound_ms, bound_by = CS.bound(2.0 * bsz * h * wd * c * 9 * (c // 16),
                                          (2 * x.numel() + w.numel() + b.numel()) * 2)
            for name in order:
                print(json.dumps({"shape": list(shape), "entry": name,
                                  "graph_ms": sum(graph[name]) / 2, "graph_ms_each": graph[name],
                                  "event_ms": sum(event[name]) / 2, "event_ms_each": event[name],
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "tolerance_ratio": ratios.get(name)}), flush=True)
            del x, w, b, wp, ref, out, xc
    if bad:
        print(f"disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
