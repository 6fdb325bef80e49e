#!/usr/bin/env python3
"""Time build variants of the out-projection-fused attention kernels against each other on one card.

Two sources carry a bf16 out-projection-fused entry: ``csrc/attention.cu``
(``ur_attention_btc_out``, the ``mma.sync`` kernel) and
``csrc/attention_out_sm90.cu`` (``ur_attention_btc_out_sm90``, the Hopper
kernel that replaced it). Each variant is a copy of one of them with exact
text edits (``VARIANTS``: the kernels as they are, and the Hopper kernel
with its cluster size G forced; ``DIAGNOSTICS``: variants that drop one
piece of work on purpose, to show what bounds a kernel, not held to the
plain version), built with ``nvcc`` at once into ``--workdir`` and loaded
with ctypes. At each out-projection-fused shape of
``chip_smoke.kernel_shapes`` (bf16, C = inner, the same seeded inputs)
every variant that runs there is held to the plain version
(``bf16_out_tolerance_ratio``) and its C entry is timed directly, in turns
with the others and with the unfused pairs (``ur_attention_btc_sm90``
called directly, then ``torch.matmul``; SDPA, then ``torch.matmul``;
forward order, then reversed; the mean of the two), by two timers: CUDA
graph replays of ``chip_smoke.GRAPH_CALLS`` captured calls (``graph_ms``:
the device's time) and events around back-to-back calls (``event_ms``).
Prints ptxas's register and shared-memory lines per variant and one JSON
line per shape and entry. Run on a machine with one CUDA device, from the
repository root:

    python3 tools/tune_btc_out_sm90.py [--only mma|sm90] [--workdir unirestore_torch/_build/tune_out]

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
SOURCES = {"mma": (K.SOURCE, "ur_attention_btc_out"),
           "sm90": (K.SOURCE_OUT_SM90, "ur_attention_btc_out_sm90")}


def _cluster(g: int) -> list:
    """Edits that force the Hopper kernel's cluster size to ``g``."""
    return [("int cluster_size(int heads, int blocks, int sms) {\n",
             f"int cluster_size(int heads, int blocks, int sms) {{\n  if (heads >= {g}) return {g};\n")]


# name -> (family, exact (old, new) edits of its source). ``sm90`` chooses
# G by its rule; ``sm90_g<G>`` forces G where H >= G and the head slots fit.
# ``sm90_g1`` is milestone M1 (every head in one CTA, no cluster exchange;
# it fits shared memory up to H = 5).
FORCED = (1, 2, 3, 4, 5, 6)
VARIANTS = {"mma": ("mma", []), "sm90": ("sm90", []),
            **{f"sm90_g{g}": ("sm90", _cluster(g)) for g in FORCED}}
# variants that compute a wrong answer on purpose, to show what bounds a kernel
DIAGNOSTICS = {
    # mma.sync: the epilogue's products dropped (the O tile is written, wo
    # streamed, zeros stored); the epilogue dropped whole (nothing stored);
    # one head attended instead of H
    "mma_no_epilogue_product": ("mma", [
        ("        mma_bf16(acc[2 * np], a, bw[0], bw[1]);\n"
         "        mma_bf16(acc[2 * np + 1], a, bw[2], bw[3]);\n", "")]),
    "mma_no_epilogue": ("mma", [("  const int n_chunks = (c_out / kOutCols) * k_chunks;",
                                 "  const int n_chunks = 0 * k_chunks;")]),
    "mma_one_head": ("mma", [("  for (int h = 0; h < heads; ++h) {  // one head at a time into the O tile",
                              "  for (int h = 0; h < 1; ++h) {  // one head at a time into the O tile")]),
    # the Hopper kernel: the epilogue's products dropped (slices pulled, wo
    # loaded, zeros stored); no slice pulled from a peer; one head attended
    # per CTA (the epilogue still reads every head's slot)
    "sm90_no_epilogue_product": ("sm90", [
        ("        epilogue_products<NQ>(acc, a_rows, wo_stage(ws));\n", "")]),
    "sm90_no_pulls": ("sm90", [("        pull_slice(stage_slot(ps), o_slot(h / groups), h % groups, tid);\n",
                                "")]),
    "sm90_one_head": ("sm90", [("  const int n_own = (heads - rank + groups - 1) / groups;",
                                "  const int n_own = heads > rank ? 1 : 0;")]),
}
# the attention and the cluster barriers alone (no epilogue pass) at G = 1
# and G = 4: at (8, 4096, 256) both give each SM the same heads, so the
# difference is what a cluster of four costs
_NO_EPILOGUE = [("  const int c_hi = n_chunks * (rank + 1) / groups;", "  const int c_hi = c_lo;")]
DIAGNOSTICS["sm90_g1_no_epilogue"] = ("sm90", _cluster(1) + _NO_EPILOGUE)
DIAGNOSTICS["sm90_g4_no_epilogue"] = ("sm90", _cluster(4) + _NO_EPILOGUE)


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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def fits(name: str, heads: int) -> bool:
    """Whether variant ``name`` runs at ``heads`` heads: a forced G needs H >= G
    and its head slots in one CTA's shared memory."""
    if not name.startswith("sm90_g"):
        return True
    g = int(name.removeprefix("sm90_g").split("_")[0])
    return heads >= g and K.btc_out_sm90_smem_bytes(heads, g) <= K.BTC_OUT_SM90_MAX_SMEM


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", type=Path,
                    default=REPO / "unirestore_torch" / "_build" / "tune_out")
    ap.add_argument("--only", choices=sorted(SOURCES), help="one family of variants")
    ap.add_argument("--reps", type=int, default=10, help="back-to-back calls per event timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_btc_out_sm90: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {CS.card_line()}", flush=True)
    names = [n for n, (fam, _) in {**VARIANTS, **DIAGNOSTICS}.items()
             if args.only in (None, fam)]
    entries = build(args.workdir.resolve(), names)
    btc_symbol, btc_lib = K.fused_attention_btc_prescaled.route(torch.bfloat16)
    btc = getattr(btc_lib, btc_symbol)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kern = K.fused_attention_btc_out_prescaled
    bad = []
    with torch.inference_mode():
        for kn, shape, heads in CS.kernel_shapes(K):
            if kn is not kern:
                continue
            (q, k, v, wo), _ = CS.kernel_inputs(K, kern, shape, heads, gen)
            n, t, inner = shape
            ref = kern.plain(q, k, v, wo)
            run = {name: fn for name, fn in entries.items() if fits(name, heads)}
            ratios = {name: kern.bf16_tolerance_ratio(CS.direct(fn, q, k, v, wo=wo), ref)
                      for name, fn in run.items()}
            bad += [(shape, nm) for nm, r in ratios.items() if not r <= 1.0 and nm in VARIANTS]
            out = torch.empty((n, t, wo.shape[1]), dtype=q.dtype, device=q.device)
            o = torch.empty_like(q)
            calls = {name: (lambda fn=fn: CS.direct(fn, q, k, v, out, wo))
                     for name, fn in run.items()}

            def split(x):
                return x.view(n, t, heads, 64).transpose(1, 2)

            calls["btc_sm90_matmul"] = lambda: torch.matmul(CS.direct(btc, q, k, v, o), wo)
            calls["sdpa_matmul"] = lambda: torch.matmul(F.scaled_dot_product_attention(
                split(q), split(k), split(v), scale=math.log(2.0)).transpose(1, 2)
                .reshape(n, t, inner), wo)
            order = list(calls)
            graph, event = {nm: [] for nm in order}, {nm: [] for nm in order}
            for turn in (order, order[::-1]):
                for name in turn:
                    graph[name].append(CS.graph_ms(calls[name]))
                    event[name].append(CS.cuda_ms(calls[name], args.reps))
            bound_ms, bound_by = CS.bound(
                4.0 * n * heads * t * t * 64 + 2.0 * n * t * inner * wo.shape[1],
                (3 * q.numel() + wo.numel() + out.numel()) * q.element_size())
            for name in order:
                print(json.dumps({"shape": list(shape), "c_out": wo.shape[1], "entry": name,
                                  "graph_ms": sum(graph[name]) / 2, "graph_ms_each": graph[name],
                                  "event_ms": sum(event[name]) / 2, "event_ms_each": event[name],
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "tolerance_ratio": ratios.get(name)}), flush=True)
            del q, k, v, wo, out, o, ref
    if bad:
        print(f"disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
