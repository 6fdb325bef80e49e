#!/usr/bin/env python3
"""Time build variants of ``csrc/attention_stream_sm90.cu`` against each other on one card.

Each variant is a copy of the source with exact text edits (``VARIANTS``:
the shipped kernel and the designs it was chosen over; ``DIAGNOSTICS``:
variants that drop work on purpose to show what bounds the kernel), built
with ``nvcc`` at once into ``--workdir`` and loaded with ctypes. At each wide-head shape of ``chip_smoke.kernel_shapes`` (bf16, the
same seeded inputs) every variant is held to the plain version
(``bf16_tolerance_ratio``) and its C entry is timed directly, in turns with
the others, the ``mma.sync`` kernel of ``csrc/attention.cu`` and SDPA
(forward order, then reversed; the mean of the two). Prints ptxas's register
and shared-memory lines per variant and one JSON line per shape and entry.
Run on a machine with one CUDA device, from the repository root:

    python3 tools/tune_stream_sm90.py [--workdir unirestore_torch/_build/tune]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402
from unirestore_torch.nn import attention_kernels as K  # noqa: E402
from unirestore_torch.nn import cuda_lib  # noqa: E402

# variant -> exact (old, new) edits of the source. The designs measured
# before the shipped one are variants of the source as of earlier commits:
# a ring of 8 KB chunk slots, one column block per row with and without a
# setmaxnreg producer warpgroup (ddd511e); M1, each consumer reducing Q K^T
# over all of d with no exchange (a72746f).
VARIANTS = {"shipped": []}
# variants that compute a wrong answer on purpose, to show what bounds the
# kernel (not held to the plain version): the ring filled once and never
# reloaded (no K/V traffic after the first tiles); no P V products; no
# Q K^T products; no exchange of the partial S; no softmax; none of these
# four, with and without reloads
DIAGNOSTICS = {
    "no_reloads": [("      for (int j = 0; j < n_tiles; ++j) {\n        if (j >= 1) mbar_wait(empty_k, (j - 1) & 1);\n",
                    "      for (int j = 0; j < n_tiles; ++j) {\n        if (j >= 1) mbar_wait(empty_k, (j - 1) & 1);\n"
                    "        if (j >= 2) {\n"
                    "          mbar_arrive(full_k);\n"
                    "          mbar_wait(empty_v(j), ((j >> 1) - 1) & 1);\n"
                    "          mbar_arrive(full_v(j));\n"
                    "          continue;\n"
                    "        }\n")],
    "no_pv": [("          wgmma_m64n64k16_rs(oacc[i], p[kk], desc_sw128(base + kChunkBytes * i + 2048 * kk));",
               "          (void)kk;")],
    "no_qk": [("            wgmma_m64n64k16_ss<false>(s, desc_sw128(qa), desc_sw128(ka));",
               "            (void)qa;"),
              ("            wgmma_m64n64k16_ss<true>(s, desc_sw128(qa + 32 * kk), desc_sw128(ka + 32 * kk));",
               "            (void)ka;")],
    "no_exchange": [("    release(empty_k);\n    exchange(s);", "    release(empty_k);"),
                    ("      release(empty_k);\n      exchange(s);", "      release(empty_k);")],
    "no_softmax": [("                                             float (&corr)[2]) {\n",
                    "                                             float (&corr)[2]) {\n"
                    "  corr[0] = corr[1] = l[0] = l[1] = 1.f;\n  if (corr[0] > 0.f) return;\n")],
}
# the loop's skeleton alone: loads, waits, releases and barriers
DIAGNOSTICS["skeleton"] = [e for k in ("no_pv", "no_qk", "no_exchange", "no_softmax")
                           for e in DIAGNOSTICS[k]]
DIAGNOSTICS["skeleton_no_reloads"] = DIAGNOSTICS["skeleton"] + DIAGNOSTICS["no_reloads"]


def build(workdir: Path) -> dict[str, ctypes.CDLL]:
    workdir.mkdir(parents=True, exist_ok=True)
    text = K.SOURCE_STREAM_SM90.read_text()
    jobs = {}
    for name, edits in {**VARIANTS, **DIAGNOSTICS}.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times")
            src = src.replace(old, new)
        cu = workdir / f"{name}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        jobs[name] = (so, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                                            str(cu)], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "serialized")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.ur_attention_stream_sm90
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", type=Path, default=REPO / "unirestore_torch" / "_build" / "tune")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_stream_sm90: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {CS.card_line()}", flush=True)
    entries = build(args.workdir.resolve())
    entries["mma.sync"] = K.library().ur_attention_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    kern = K.streaming_attention_bh_prescaled
    with torch.inference_mode():
        for kn, shape, heads in CS.kernel_shapes(K):
            if kn is not kern:
                continue
            (q, k, v), _ = CS.kernel_inputs(K, kern, shape, heads, gen)
            ref = kern.plain(q, k, v)
            ratios = {name: kern.bf16_tolerance_ratio(CS.direct(fn, q, k, v), ref)
                      for name, fn in entries.items()}
            out = torch.empty_like(q)
            calls = {name: (lambda fn=fn: CS.direct(fn, q, k, v, out)) for name, fn in entries.items()}
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None],
                                                                   scale=math.log(2.0))
            order = list(calls)
            ms = {name: [] for name in order}
            for turn in (order, order[::-1]):
                for name in turn:
                    ms[name].append(CS.cuda_ms(calls[name], args.reps))
            bound_ms = CS.bound(4.0 * shape[0] * shape[1] ** 2 * shape[2],
                                4.0 * q.numel() * q.element_size())[0]
            for name in order:
                row = {"shape": list(shape), "entry": name, "ms": sum(ms[name]) / 2,
                       "ms_each": ms[name], "bound_ms": bound_ms,
                       "tolerance_ratio": ratios.get(name)}
                print(json.dumps(row), flush=True)
            bad = [n for n, r in ratios.items() if not r <= 1.0 and n not in DIAGNOSTICS]
            if bad:
                print(f"disagree with the plain version at {shape}: {bad}", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
