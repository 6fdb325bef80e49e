#!/usr/bin/env python3
"""Time build variants of the head-major attention kernels against each other on one card.

Two sources carry a bf16 head-major entry: ``csrc/attention.cu``
(``ur_attention_bh``, the ``mma.sync`` kernel) and ``csrc/attention_bh_sm90.cu``
(``ur_attention_bh_sm90``, the Hopper kernel that replaced it). Each variant
is a copy of one of them with exact text edits (``VARIANTS``: the two
kernels as they are; ``DIAGNOSTICS``: variants that drop one piece of work
on purpose, to show what bounds a kernel, not held to the plain version),
built with ``nvcc`` at once into ``--workdir`` and loaded with ctypes. At
each head-major shape of ``chip_smoke.kernel_shapes`` (bf16, the same seeded
inputs), and at two long rows, every variant is held to the plain version (``bf16_tolerance_ratio``)
and its C entry is timed directly, in turns with the others and SDPA
(forward order, then reversed; the mean of the two), by two timers: CUDA
graph replays of ``chip_smoke.GRAPH_CALLS`` captured calls (``graph_ms``:
the device's time) and events around back-to-back calls (``event_ms``: what
the host's launch rate allows). Prints ptxas's register and shared-memory
lines per variant and one JSON line per shape and entry. Run on a machine
with one CUDA device, from the repository root:

    python3 tools/tune_bh_sm90.py [--only mma] [--workdir unirestore_torch/_build/tune_bh]

``--only mma`` builds and times the ``mma.sync`` variants alone.
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

# family -> (source, C entry)
SOURCES = {"mma": (K.SOURCE, "ur_attention_bh"), "sm90": (K.SOURCE_BH_SM90, "ur_attention_bh_sm90")}

# name -> (family, exact (old, new) edits of its source). The designs
# measured beside the shipped one are variants of the source as of earlier
# commits: two or four warpgroups per block at d = 64, with the producer warp
# (4e6dff0) and without it, thread 0 issuing the loads (M2, a1c8c79).
VARIANTS = {
    "mma": ("mma", []),
    "sm90": ("sm90", []),
}
# variants that compute a wrong answer on purpose, to show what bounds a kernel
DIAGNOSTICS = {
    # mma.sync (attend_mma, shared by every entry of attention.cu; only
    # ur_attention_bh is called): no P V products; no Q K^T products; no
    # online softmax; no K/V loads after the first tile; the shared-memory
    # attribute set once per kernel and not on every launch (a host cost: only
    # the event timer can show it)
    "mma_no_pv": ("mma", [("        mma_bf16(acc[2 * np], pf[kk], bv[0], bv[1]);\n"
                           "        mma_bf16(acc[2 * np + 1], pf[kk], bv[2], bv[3]);\n", "")]),
    "mma_no_qk": ("mma", [("        mma_bf16(s[2 * np], a, bk[0], bk[1]);\n"
                           "        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);\n", "")]),
    "mma_no_softmax": ("mma", [("    for (int r = 0; r < 2; ++r) {\n      float mx = kNegBig;",
                                "    for (int r = 0; r < (l[0] < -1.f ? 2 : 0); ++r) {\n"
                                "      float mx = kNegBig;")]),
    "mma_no_reloads": ("mma", [
        ("    if (j + 1 < n_tiles) load_tile(ks, QP, kb, k0 + kBK, D, seq, row_stride);",
         "    (void)n_tiles;"),
        ("    if (j + 1 < n_tiles) load_tile(vs, VP, vb, k0 + kBK, DV, seq, row_stride);", "")]),
    "mma_attribute_once": ("mma", [(
        "  cudaError_t err =\n"
        "      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));\n"
        "  if (err != cudaSuccess) return int(err);\n"
        "  const dim3 grid((seq + kBQ - 1) / kBQ, n_bh, cols_split);",
        "  static const void* set[16] = {};\n"
        "  int i = 0;\n"
        "  while (i < 16 && set[i] != nullptr && set[i] != (const void*)kernel) ++i;\n"
        "  if (i < 16 && set[i] == nullptr) {\n"
        "    cudaError_t err =\n"
        "        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));\n"
        "    if (err != cudaSuccess) return int(err);\n"
        "    set[i] = (const void*)kernel;\n"
        "  }\n"
        "  const dim3 grid((seq + kBQ - 1) / kBQ, n_bh, cols_split);")]),
    # the Hopper kernel: no P V products; no Q K^T products; no softmax; no
    # K/V loads after the first tile (their barriers arrived on by hand); the
    # loop's skeleton alone (loads, waits, releases)
    "sm90_no_pv": ("sm90", [(
        "          wgmma_m64n64k16_rs(oacc[c], p[kk],\n"
        "                             desc_sw128(v_stage(st) + kChunkBytes * c + 2048 * kk));",
        "          (void)kk;")]),
    "sm90_no_qk": ("sm90", [
        ("            wgmma_m64n64k16_ss<false>(s, desc_sw128(qa), desc_sw128(ka));",
         "            (void)qa;"),
        ("            wgmma_m64n64k16_ss<true>(s, desc_sw128(qa + 32 * kk), desc_sw128(ka + 32 * kk));",
         "            (void)ka;")]),
    "sm90_no_softmax": ("sm90", [("                                             float (&corr)[2]) {\n",
                                  "                                             float (&corr)[2]) {\n"
                                  "  corr[0] = corr[1] = l[0] = l[1] = 1.f;\n"
                                  "  if (corr[0] > 0.f) return;\n")]),
    "sm90_no_reloads": ("sm90", [("        mbar_expect_tx(full_k(st), kTileBytes);\n",
                                  "        if (j >= 1) {\n"
                                  "          mbar_arrive(full_k(st));\n"
                                  "          mbar_arrive(full_v(st));\n"
                                  "          continue;\n"
                                  "        }\n"
                                  "        mbar_expect_tx(full_k(st), kTileBytes);\n")]),
}
DIAGNOSTICS["sm90_skeleton"] = ("sm90", [e for k in ("sm90_no_pv", "sm90_no_qk", "sm90_no_softmax")
                                         for e in DIAGNOSTICS[k][1]])
# long rows besides the main paths' shapes: d = 64 where the channel-flat
# route declines (T % 256 != 0), d = 128 at T = 4096 (a 2048 px Controller
# stage 2 restored whole)
LONG_ROWS = [(2, 2056, 64), (2, 4096, 128)]


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", type=Path,
                    default=REPO / "unirestore_torch" / "_build" / "tune_bh")
    ap.add_argument("--only", choices=sorted(SOURCES), help="one family of variants")
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per event timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_bh_sm90: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {CS.card_line()}", flush=True)
    names = [n for n, (fam, _) in {**VARIANTS, **DIAGNOSTICS}.items()
             if args.only in (None, fam)]
    entries = build(args.workdir.resolve(), names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kern = K.fused_attention_bh_prescaled
    shapes = [s for kn, s, _ in CS.kernel_shapes(K) if kn is kern] + LONG_ROWS
    bad = []
    with torch.inference_mode():
        for shape in shapes:
            (q, k, v), _ = CS.kernel_inputs(K, kern, shape, 1, gen)
            ref = kern.plain(q, k, v)
            ratios = {name: kern.bf16_tolerance_ratio(CS.direct(fn, q, k, v), ref)
                      for name, fn in entries.items()}
            bad += [(shape, n) for n, r in ratios.items() if not r <= 1.0 and n in VARIANTS]
            out = torch.empty_like(q)
            calls = {name: (lambda fn=fn: CS.direct(fn, q, k, v, out))
                     for name, fn in entries.items()}
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], scale=math.log(2.0))
            order = list(calls)
            graph, event = {n: [] for n in order}, {n: [] for n in order}
            for turn in (order, order[::-1]):
                for name in turn:
                    graph[name].append(CS.graph_ms(calls[name]))
                    event[name].append(CS.cuda_ms(calls[name], args.reps))
            bound_ms, bound_by = CS.bound(4.0 * shape[0] * shape[1] ** 2 * shape[2],
                                          4.0 * q.numel() * q.element_size())
            for name in order:
                print(json.dumps({"shape": list(shape), "entry": name,
                                  "graph_ms": sum(graph[name]) / 2, "graph_ms_each": graph[name],
                                  "event_ms": sum(event[name]) / 2, "event_ms_each": event[name],
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "tolerance_ratio": ratios.get(name)}), flush=True)
    if bad:
        print(f"disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
