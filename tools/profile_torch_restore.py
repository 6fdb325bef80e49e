#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's restore spends its time on the card.

Runs the full-width restore of ``chip_smoke.py`` (sd-turbo widths, seeded
init, 512 px, batch 8, bf16, 20 DDIM steps) once per cache mode under
``torch.profiler`` and prints one JSON line per mode: wall seconds with
and without the profiler, the device's busy time (sum of kernel durations
on the one stream), its idle share within the profiled run (1 - busy over
the span from the first kernel's start to the last kernel's end), and the
device time by kernel family, largest first. Run from the
repository root on a machine with one CUDA device:

    python3 tools/profile_torch_restore.py

The profiler adds host overhead, so wall times here read higher than
``chip_smoke.py``'s and the idle share is an upper estimate; the device
times and their split are what this is for.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402
from unirestore_torch import bridge  # noqa: E402
from unirestore_torch.models import unirestore as UR  # noqa: E402

# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("attention_fwd", "attention kernels (this repo)"),
    ("conv", "convolution (cuDNN)"), ("xmma", "convolution (cuDNN)"),
    ("implicit_gemm", "convolution (cuDNN)"), ("winograd", "convolution (cuDNN)"),
    ("gemm", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
    ("reduce", "reductions (norm statistics, means)"),
    ("copy", "copies and dtype casts"), ("cat", "copies and dtype casts"),
    ("elementwise", "other elementwise"),
)


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_restore: no CUDA device", file=sys.stderr)
        return 2
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    frozen, trainable = CS.make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, restore = CS.restore_inputs(UR, cfg, frozen, trainable, gen)
    restore(cfg, 1)
    torch.cuda.synchronize()
    print(CS.card_line(), flush=True)
    for mode, stride, warmup in CS.MODES:
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride,
                                cache_warmup=warmup)
        t0 = time.perf_counter()
        restore(c, CS.STEPS)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            restore(c, CS.STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_family, by_name = defaultdict(float), defaultdict(float)
        n_kernels, first_us, last_us = 0, float("inf"), float("-inf")
        for evt in prof.events():
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not evt.is_user_annotation):
                sec = evt.time_range.elapsed_us() / 1e6
                by_family[family(evt.name)] += sec
                by_name[evt.name[:200]] += sec
                n_kernels += 1
                first_us = min(first_us, evt.time_range.start)
                last_us = max(last_us, evt.time_range.end)
        busy = sum(by_family.values())
        span = (last_us - first_us) / 1e6
        print(json.dumps({
            "mode": mode, "stride": stride, "warmup": warmup,
            "wall_s_unprofiled": wall_plain, "wall_s": wall,
            "device_busy_s": busy, "device_span_s": span,
            "device_idle_share": 1.0 - busy / span,
            "kernels_launched": n_kernels,
            "device_s_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
            "top_kernels_s": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
