#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's restore or training step spends its time on the card.

Default: runs the full-width restore of ``chip_smoke.py`` (sd-turbo widths,
seeded init, 512 px, batch 8, bf16, 20 DDIM steps) once per cache mode, and
exact on the out-projection-fused route, under ``torch.profiler``. With
``--graphs``: the same restores replayed from CUDA graphs
(``unirestore_torch/graphs.py``), each captured first. With ``--train``:
runs the stage-1 training step of ``chip_smoke.py`` phase 6 (sd-turbo
widths without TFA, 512 px, batch 8, bf16 frozen / fp32 trainable, AdamW,
remat on), two warm-up steps, then one step without and one under the
profiler. Prints one JSON line per run: wall
seconds with and without the profiler, the device's busy time (sum of kernel
durations on the one stream), its idle share within the profiled run (1 -
busy over the span from the first kernel's start to the last kernel's end),
and the device time by kernel family, largest first. Run from the repository
root on a machine with one CUDA device:

    python3 tools/profile_torch_restore.py [--graphs | --train]

The profiler adds host overhead, so wall times here read higher than
``chip_smoke.py``'s and the idle share is an upper estimate; the device
times and their split are what this is for.
"""

from __future__ import annotations

import argparse
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
from unirestore_torch import graphs as GR  # noqa: E402
from unirestore_torch.models import unirestore as UR  # noqa: E402

# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("attention_btc_sm90", "channel-flat attention kernel (this repo, attention_sm90.cu)"),
    ("attention_stream_sm90",
     "wide-head attention kernel (this repo, attention_stream_sm90.cu)"),
    ("attention_bh_sm90", "head-major attention kernel (this repo, attention_bh_sm90.cu)"),
    ("attention_out_sm90",
     "out-projection-fused attention kernel (this repo, attention_out_sm90.cu)"),
    ("attention_fwd", "attention kernels (this repo, attention.cu)"),
    ("gconv3_sm90", "grouped-conv kernel (this repo, grouped_conv_sm90.cu)"),
    ("gconv3_", "grouped-conv kernel (this repo, grouped_conv.cu)"),
    ("conv", "convolution (cuDNN)"), ("xmma", "convolution (cuDNN)"),
    ("implicit_gemm", "convolution (cuDNN)"), ("winograd", "convolution (cuDNN)"),
    ("gemm", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
    ("softmax", "softmax (attention backward recompute)"),
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


def profiled(label: dict, fn) -> None:
    """Run ``fn`` once without and once under the profiler; print the split."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        **label, "wall_s_unprofiled": wall_plain, "wall_s": wall,
        "device_busy_s": busy, "device_span_s": span,
        "device_idle_share": 1.0 - busy / span if span > 0 else None,
        "kernels_launched": n_kernels,
        "device_s_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "top_kernels_s": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
    }), flush=True)


def profile_restore(graphs: bool) -> None:
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    frozen, trainable = CS.make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images, noise, restore = CS.restore_inputs(UR, cfg, frozen, trainable, gen)
    restore(cfg, 1)
    torch.cuda.synchronize()
    # the restores of chip_smoke.py phase 4, once each: the cache modes, and
    # exact on the fused route
    runs = {(mode, fused): (stride, warmup) for _, mode, stride, warmup, fused in CS.RUNS}
    for (mode, fused), (stride, warmup) in runs.items():
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride,
                                cache_warmup=warmup, fused_out_attention=fused)
        label = {"mode": mode, "stride": stride, "warmup": warmup,
                 "fused_out_attention": fused, "route": "graph" if graphs else "eager"}
        if not graphs:
            profiled(label, lambda: restore(c, CS.STEPS))
            continue
        graphed = GR.GraphedRestore(frozen, trainable, c, UR.schedule(c, device="cuda"),
                                    device="cuda")
        for _ in range(2):  # the capture, then a first replay, which uploads the graph
            graphed(images, "ir", num_inference_steps=CS.STEPS, **noise)
        (stats,) = graphed.stats.values()
        label.update(capture_seconds=stats.capture_seconds,
                     launches_at_capture=stats.launches)
        profiled(label, lambda: graphed(images, "ir", num_inference_steps=CS.STEPS, **noise))
        del graphed
        torch.cuda.empty_cache()


def profile_train() -> None:
    from unirestore_torch.train import optim as OPT
    from unirestore_torch.train import steps as TS
    *_, next_inputs, run = CS.train_setup(UR, bridge, TS, OPT)
    for _ in range(2):  # warm-up: the first step autotunes cuDNN
        run(*next_inputs())
    torch.cuda.synchronize()
    inputs = [next_inputs() for _ in range(2)]
    profiled({"mode": "train_stage1", "batch": CS.BATCH, "res": CS.RES},
             lambda: run(*inputs.pop(0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile the stage-1 training step")
    ap.add_argument("--graphs", action="store_true",
                    help="profile the restores replayed from CUDA graphs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_restore: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    print(CS.card_line(), flush=True)
    if args.train:
        profile_train()
    else:
        profile_restore(args.graphs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
