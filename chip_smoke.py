#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unirestore_torch``) once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. environment: card name, ``nvidia-smi`` name and power limit, TF32 off;
2. build the CUDA kernels from ``unirestore_torch/csrc/`` (one ``nvcc`` per
   source, all seven at once);
3. each kernel against its plain PyTorch version at every shape the 512 px
   batch-8 main paths give it, and the wide-head, head-major and
   out-projection-fused kernels also at the server's shapes (bf16), with
   kernel, plain, library (``scaled_dot_product_attention``;
   ``F.conv2d(groups=16)`` in ``channels_last``; timed as yardsticks only)
   and bound times; for the out-projection-fused kernel, which no single
   PyTorch call matches, the unfused pairs ``ur_attention_btc_sm90`` +
   cuBLAS and SDPA + ``torch.matmul`` instead, always by graph replay (the
   event readings beside them); for every kernel also the C
   entry of its bf16 launches called directly (``direct_ms``) and the
   ``mma.sync`` kernel it replaced, called directly in turns with it
   (``prev_ms``, a yardstick only, held to the plain version too):
   channel-flat ``ur_attention_btc_sm90`` (``csrc/attention_sm90.cu``),
   wide-head ``ur_attention_stream_sm90`` (``attention_stream_sm90.cu``),
   head-major ``ur_attention_bh_sm90`` (``attention_bh_sm90.cu``),
   out-projection-fused ``ur_attention_btc_out_sm90``
   (``attention_out_sm90.cu``) against the entries of the same names
   without ``_sm90`` in ``csrc/attention.cu``; the grouped conv's
   ``ur_grouped_conv3_sm90`` against ``ur_grouped_conv3``; with the host
   time of one call of each and of the wrapper (``*_host_us``). A kernel
   whose direct call takes under ``GRAPH_MS`` is timed again with the host
   out of the way: ``GRAPH_CALLS`` calls of the wrapper, of each C entry and
   of the library call captured in one CUDA graph each and replayed
   (``timer: "graph"``; the event readings stay beside them as
   ``*_event_ms``);
   and each attention kernel's gradient (its autograd function) against
   autograd through its plain version at one main-path shape;
4. the full-width restore (sd-turbo widths, seeded init, 512 px, batch 8,
   bf16, 20 DDIM steps) in the exact, encoder (stride 2) and deep (stride
   17, warmup 3) modes, and exact with the out-projection-fused attention
   (``fused_out_attention=True``) on the same inputs and noise, exact and
   fused twice each in turns: finite outputs, launch counts equal to the
   counts the routing implies, img/s, PSNR of each cached mode and of the
   fused route against exact; then the graph route
   (``unirestore_torch/graphs.py``): for exact, encoder, deep and fused, one
   ``GraphedRestore`` captures the whole restore (launch counts at capture
   equal to the eager counts), and eager restores and graph replays of one
   seeded batch run in turns (eager, graph, graph, eager), each eager one
   under ``torch.cuda.set_sync_debug_mode("error")`` (nothing in it may wait
   for the card or copy from the host) and each replay with no wrapper
   launch: img/s both ways, capture seconds, peak and held memory, and the
   graph's output against the eager one, raw and in uint8 levels (at most
   1);
5. the same widths on a 256 px input in fp32, on the card (unfused, fused,
   and unfused replayed from a CUDA graph) and on the CPU (where the kernels'
   plain versions run): the restores must agree;
6. the stage-1 training step at full width (sd-turbo widths without TFA,
   512 px, batch 8, bf16 frozen weights and fp32 trainable masters, AdamW
   from the stage-1 YAML's kwargs, remat on) on a seeded synthetic pair: one
   warm-up and five timed steps with exact per-step launch counts (forward,
   remat recompute and backward counted apart), finite losses and gradient
   norms, every CFRM / Controller / SC-Tuner leaf changed, every frozen byte
   unchanged;
7. one stage-1 loss and gradient at full width, 256 px, batch 1, fp32, on the
   card and on the CPU: the losses and each family's gradient norm agree;
8. the restore server (``unirestore_torch.serve``) in this process on
   127.0.0.1 at an ephemeral port: full width, bf16, 20 steps, exact, batch
   4 tiles of 512 px with overlap 64, fused out-projection on. It answers
   ``/healthz``, an 800 x 1200 PNG (six tiles, two batches; sent twice, cold
   and warm), a 256 x 384 PNG (restored whole at 512 x 768) and an unknown
   task (400), each with the right status, size and per-request launch
   counts; the tiled answer equals the in-process call within one uint8
   level. Then the same server with ``--cuda-graphs`` answers the same
   requests: one capture per key (the tile batch's (task, steps) and the
   256 x 384 shape), each answer within one uint8 level of the eager
   in-process call;
9. fit through the CLI: ``unirestore_torch.main.main`` called in this
   process (so the launch counters can be read) with
   ``fit --config configs/train_stage1.yaml`` and dotted overrides only (the
   DIVF2KOST lists of the 576 px smoke tree that ``tools/make_smoke_data.py``
   makes, 6 micro-steps, validation every 3 over 2 batches, the log
   directory): full width, bf16 frozen and fp32 trainable, remat on, batch 3,
   accumulation 2, sanity validation, AdamW and OneCycle, 8 loader workers.
   Checks: finite logged losses; each micro-step's launches equal phase 6's;
   the validation restores' launches equal the routing's at one DDIM step;
   every CFRM / Controller / SC-Tuner leaf changed or, where its updates fell
   below its fp32 resolution, carrying a nonzero Adam first moment in
   ``last.npz``; every frozen byte as a fresh seeded build; ``step=3-...``,
   ``step=6-...`` and ``last.npz`` written; the first micro-step's losses
   bit-equal to ``make_train_step`` called directly on its batch and noise;
   one micro-step under
   ``torch.cuda.set_sync_debug_mode("error")``. Then ``--trainer.resume auto
   --trainer.max_steps 8`` (``last.npz`` at step 8), ``predict`` (one PNG per
   image, each its input's size), a run without validation timed over
   micro-steps 2-6 with the card synchronised at both ends, and a run
   profiled over steps 2-6 (``--trainer.profiler``: device busy and idle
   share). Reported: the timed run's s/step and train img/s beside phase
   6's, the trainer's own ``[timing]`` p50 (the host time of a step call,
   which does not wait for the card), the loader wait per step, peak
   memory. Every (kernel, shape) the fit, resume and predict launched that
   phase 3 did not hold is then held to its plain version as phase 3 holds
   its own (rows with ``"path": "fit"``);
11. (run after phase 9, before the report) stage 2 through the CLI:
   ``unirestore_torch.main.main`` with ``fit --config
   configs/train_stage2.yaml`` and dotted overrides only (phase 9's smoke
   tree's ir, cls and seg lists, 12 micro-steps, validation every 6 over 2
   batches, 2 sanity batches, the log directory): the ``mtl`` engine at full
   width, TFA for ir / cls / seg trained through the frozen ResNet-50 and
   DeepLabV3+-ResNet-50 critics (seeded, fp32), CFRM / Controller / SC-Tuner
   frozen, batch 1, 512 px crops, accumulation 6, AdamW and OneCycle. Checks:
   the mixture gave micro-steps of all three tasks; every micro-step's losses
   finite; launches per micro-step and task as the routing implies, and the
   validation restores' as their image sizes route them; only ``tfa`` leaves
   changed, the frozen tree as a fresh build, both critics as a fresh build;
   each task's prompt moved or carries a nonzero Adam first moment after the
   first update; the first micro-step's losses bit-equal to a direct
   ``make_train_step`` with the same task loss; a seg and a cls micro-step
   under ``set_sync_debug_mode("error")``; the validation metrics hold
   ``val_ir_lq/psnr``, the ``r50v1`` accuracies and the ``dlv3pr50`` IoU, and
   ``val_monitor`` is the IR PSNR; ``step=6-...``, ``step=12-...`` and
   ``last.npz``; a resume to step 13. Reported: s per micro-step of each task
   (the card synchronised before and after each, each task's first left
   out), the loader wait, peak memory, and the critics' share of a cls and a
   seg micro-step's device time (profiled, by kernel family). Every (kernel,
   shape) it met that was not held yet is held to its plain version (rows
   with ``"path": "fit_stage2"``). Then one stage-2 loss for cls and one for
   seg and the TFA gradient norm at full width, 256 px, fp32, card vs CPU;
10. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``. Per kernel,
   ``launches`` is the sum over the paths that drove it, which
   ``launches_by_path`` lists (``restore``: phase 4's exact, encoder and deep
   restores; ``restore_fused``: its fused ones; ``train``: phase 6's six
   steps; ``serve``: phase 8's requests; ``restore_graph``,
   ``restore_fused_graph`` and ``serve_graph`` the same on the graph route,
   each graph's launches at capture times its replays; ``fit``: phase 9's
   first fit, training and validation; ``fit_stage2``: phase 11's fit); each
   kernel must
   have run on every path that routes to it. ``ms``, ``plain_ms``,
   ``bound_ms`` and ``library_ms`` are sums of one call at each of its main-path shapes, which
   ``shapes`` lists one by one.

It needs one CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
BATCH = 8
RES = 512
STEPS = 20
# phase 4's restores in the order they run: (name, cache mode, stride,
# warmup, fused out-projection); exact and fused twice each, in turns
RUNS = (("none", "none", 2, 0, False), ("fused", "none", 2, 0, True),
        ("encoder", "encoder", 2, 0, False), ("deep", "deep", 17, 3, False),
        ("fused", "none", 2, 0, True), ("none", "none", 2, 0, False))
# launches per 512 px restore at 20 steps, in the order of ``kernels.KERNELS``:
# (btc, bh, stream, btc_out, grouped conv); the grouped conv runs once per
# CFRM stage in the one encode. The fused route takes every btc launch: each
# channel-flat self-attention's out-projection is 320, 640 or 256 wide.
EXPECTED = {"none": (280, 140, 2, 0, 3), "encoder": (200, 100, 2, 0, 3),
            "deep": (136, 28, 2, 0, 3), "fused": (0, 140, 2, 280, 3)}
# phase 4's graph route: one captured restore of each distinct run, then
# eager and replayed restores in turns
GRAPH_RUNS = tuple({run[0]: run for run in RUNS}.values())
GRAPH_TURNS = ("eager", "graph", "graph", "eager")
# launches per stage-1 training step, (forward, remat recompute, backward):
# the Controller (btc 4, bh 2, not rematerialised) and the UNet (btc 10, bh 5)
# run once; only the UNet's up path carries gradients (SC-Tuner edits the
# skips after the down path and the mid block), and its units are
# rematerialised (btc 6, bh 3); the VAE mid-block attention runs in both
# encodes behind the latent path's detach; the three CFRM grouped convs run in
# the lq encode, each in a rematerialised AdaNAF block
EXPECTED_TRAIN = {"ur_attention_btc": (14, 6, 10), "ur_attention_bh": (7, 3, 5),
                  "ur_attention_stream": (2, 0, 0), "ur_attention_btc_out": (0, 0, 0),
                  "ur_grouped_conv3": (3, 3, 3)}
# phase 8: the server's flags, and per request (name, task, image H x W,
# HTTP status, launches in KERNELS order). 800 x 1200 makes six 512 px tiles
# at overlap 64 (rows 0/288, columns 0/448/688), two batch-4 restores; 256 x
# 384 restores whole at 512 x 768, where UNet level 0/1/2 run T = 6144 /
# 1536 / 384 and the VAE mid block T = 6144, the same routes as at 512 px.
SERVE_FLAGS = ["--host", "127.0.0.1", "--port", "0", "--tasks", "ir,cls,seg", "--steps", "20",
               "--cache-mode", "none", "--batch-tiles", "4", "--overlap", "64",
               "--fused-out-attn"]
SERVE_REQUESTS = (("tiled_cold", "ir", (800, 1200), 200, (0, 280, 4, 560, 6)),
                  ("tiled", "ir", (800, 1200), 200, (0, 280, 4, 560, 6)),
                  ("whole", "cls", (256, 384), 200, (0, 140, 2, 280, 3)),
                  ("unknown_task", "nope", (64, 64), 400, (0, 0, 0, 0, 0)))
# the server with --cuda-graphs: both keys (the batch of four tiles, task ir;
# the 256 x 384 image, task cls) capture one restore of the counts above; the
# first request of a key counts an eager warm-up restore and the capture, a
# replay counts nothing. Replays per key: two batches in each of two tiled
# requests, one whole restore.
SERVE_BATCH = (0, 140, 2, 280, 3)
GRAPH_SERVE_COUNTS = {"tiled_cold": (0, 280, 4, 560, 6), "tiled": (0, 0, 0, 0, 0),
                      "whole": (0, 280, 4, 560, 6), "unknown_task": (0, 0, 0, 0, 0)}
GRAPH_SERVE_REPLAYS = {(4, RES, RES, 3): 4, (1, 256, 384, 3): 1}
TRAIN_STEPS = 5
# phase 9: ``python -m unirestore_torch.main fit`` from the stage-1 YAML on
# the smoke tree of tools/make_smoke_data.py at 576 px (576 x 592 images),
# with dotted overrides only: the DIVF2KOST lists, 6 micro-steps (three AdamW
# updates at accumulation 2), validation every 3 over 2 batches; then a
# resume to step 8 and ``predict``; then a profiled run of steps 2-6
FIT_YAML = REPO / "configs" / "train_stage1.yaml"
FIT_RES = 576
FIT_STEPS, FIT_VAL_EVERY, FIT_VAL_BATCHES, FIT_RESUME_STEPS = 6, 3, 2, 8
# every micro-step of the fit launches phase 6's per-step counts; every
# validation restore (batch 1, 512 x 512 after the evaluator's center crop,
# one DDIM step) one step's Controller and UNet attention (btc 14, bh 7), the
# VAE mid block in the encode and the decode (stream 2) and the three CFRM
# grouped convs. The sanity check and each validation restore hq and lq of
# 2 batches each.
FIT_RESTORE = (14, 7, 2, 0, 3)
FIT_VAL_RESTORES = 2 * (2 + 2 * FIT_VAL_BATCHES)
FIT_SYNC_CHECK_STEP = 3  # the micro-step run under set_sync_debug_mode("error")
# phase 11: ``python -m unirestore_torch.main fit`` from the stage-2 YAML (the
# mtl engine: TFA for ir, cls and seg trained through the frozen ResNet-50
# and DeepLabV3+ critics; batch 1, accumulation 6) on phase 9's smoke tree,
# with dotted overrides only: its lists, 12 micro-steps (two AdamW updates),
# validation every 6 over 2 batches, 2 sanity batches. The data seed of the
# YAML (the loader's default, 0) draws from the mixture's weights [0.2, 10, 1]
# over the tree's 6 cls, 4 seg and 6 ir samples the tasks
# seg seg cls ir seg seg ir cls seg seg seg seg; then a resume to step 13
FIT2_YAML = REPO / "configs" / "train_stage2.yaml"
FIT2_LISTS = (("DIVF2KOST", "ir", ("train", "val")), ("ImageNet", "cls", ("train", "val")),
              ("FoggyCityscapes", "seg", ("train",)), ("Cityscapes", "seg", ("val",)))
FIT2_STEPS, FIT2_ACCUM, FIT2_VAL_EVERY, FIT2_VAL_BATCHES, FIT2_SANITY = 12, 6, 6, 2, 2
FIT2_RESUME_STEPS = 13
FIT2_SYNC_CHECK_STEPS = (4, 7)  # a seg and a cls micro-step, after each task's first
# launches (forward, recompute, backward) per stage-2 micro-step: no gradient
# reaches an attention or a grouped conv (CFRM, Controller and SC-Tuner are
# frozen; the TFA units come after the VAE mid block), so nothing is
# recomputed or differentiated; one step's Controller and UNet, the three
# CFRM grouped convs of the lq encode, the VAE mid block in two encodes and
# one decode, and on cls and seg one more decode (the auxiliary IR loss)
EXPECTED_STAGE2 = {"ir": {"ur_attention_btc": (14, 0, 0), "ur_attention_bh": (7, 0, 0),
                          "ur_attention_stream": (3, 0, 0), "ur_attention_btc_out": (0, 0, 0),
                          "ur_grouped_conv3": (3, 0, 0)}}
EXPECTED_STAGE2["cls"] = EXPECTED_STAGE2["seg"] = {**EXPECTED_STAGE2["ir"],
                                                   "ur_attention_stream": (4, 0, 0)}
# validation restores: the sanity check's 2 ir batches (hq and lq), then at
# steps 6 and 12 the 2-batch limit over the three loaders in turn: 2 ir
# batches (hq and lq), 1 cls (hq and lq), 1 seg (lq)
FIT2_VAL_RESTORES = {"ir": 2 * FIT2_SANITY + 2 * 2 * FIT2_VAL_BATCHES, "cls": 2 * 2, "seg": 2}
# launches per validation restore, by the loader's image size: ir 512 x 512
# after the evaluator's crop (latent T = 4096 / 1024 / 256, FIT_RESTORE); cls
# 512 x 526 (the short edge resized to 512), padded to 512 x 576 (T = 4608 /
# 1152 / 288: channel-flat attention only at T = 4608, T % 256 != 0 at 1152
# goes head-major, and the VAE mid block's 512-wide head at T = 4608, not a
# multiple of 1024, runs the plain version); seg 576 x 592, padded to 576 x
# 640 (T = 5760 / 1440 / 360: all head-major, the mid block plain)
FIT2_RESTORE = {"ir": FIT_RESTORE, "cls": (7, 14, 0, 0, 3), "seg": (0, 21, 0, 0, 3)}
# the stage-1 YAML's optimizer surface (configs/train_stage1.yaml): AdamW,
# base_lr 1e-4 at base batch 64, weight decay 1e-2, OneCycle, 200k steps,
# gradient accumulation 2
STAGE1_OPT = {"opt": "adamw", "base_lr": "1e-4", "base_bsz": 64, "weight_decay": "1e-2"}
STAGE1_SCHED = {"sched": "onecycle"}
STAGE1_MAX_STEPS, STAGE1_ACCUM = 200000, 2
# bf16 kernel vs plain: each attention wrapper's ``bf16_tolerance_ratio``
# (``attention_kernels.bf16_tolerance_ratio``, ``bf16_out_tolerance_ratio`` for
# the fused kernel) and ``grouped_conv.bf16_tolerance_ratio`` <= 1,
# elementwise limits of a few bf16 ulps of the output (the reasoning is beside
# each).
# bf16 attention gradients vs autograd through the plain version: rms of the
# difference over rms of the plain gradient <= 2^-6 per input. The two
# backward functions round at other places (the probabilities before or after
# the division by the row sum, 2^-9 relative each, and the bf16 gradients
# themselves); sound runs read a few 1e-3, a wrong scale (ln 2) or a dropped
# query chunk reads 0.3 or more.
BWD_RMS_TOL = 2.0 ** -6
# fp32 card vs CPU over the whole restore: other conv algorithms and summation
# orders (about 1e-6 relative), amplified by the t=999 DDIM update
# (1/sqrt(alpha_bar)); sound runs read about 4e-6.
REFERENCE_ATOL = 1e-4
# fp32 card vs CPU over one stage-1 loss and gradient: the same 1e-6-level
# differences through a forward and a backward pass at t up to 999; relative
# limits on each loss term and on each family's gradient norm.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# the milestone of each Hopper redesign that ships (its source's head comment)
SM90_DESIGNS = {"attention_sm90.cu": "M2", "attention_stream_sm90.cu": "M2",
                "attention_bh_sm90.cu": "M1", "attention_out_sm90.cu": "M2",
                "grouped_conv_sm90.cu": "M2"}
# a call shorter than GRAPH_MS is timed by replaying GRAPH_CALLS captured
# calls: one ctypes call costs 4-9 us of host time and a wrapper call 40-115
# us, so back-to-back calls of a short kernel measure the host's launch rate
GRAPH_MS = 0.05
GRAPH_CALLS = 100
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """Device ms per call of ``fn`` with the host out of the way: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between two
    events. ``fn`` takes its stream from ``torch.cuda.current_stream()`` when
    called, so that the capture records it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_us(fn, reps: int = 20) -> float:
    """Host microseconds per call of ``fn``: the loop does not synchronise, so
    the card's time stays hidden while the queue of launches has room."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    return sec / reps * 1e6


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms, what bounds it) at the card's peak bf16 rate and memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rms_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_shapes(K):
    """(kernel, q shape, heads) at every shape the 512 px main paths give each kernel."""
    b = BATCH
    return [
        (K.fused_attention_btc_prescaled, (b, 4096, 320), 5),   # UNet level 0
        (K.fused_attention_btc_prescaled, (b, 1024, 640), 10),  # UNet level 1
        (K.fused_attention_btc_prescaled, (b, 4096, 256), 4),   # Controller stage 0
        (K.fused_attention_btc_prescaled, (b, 1024, 256), 4),   # Controller stage 1
        (K.fused_attention_bh_prescaled, (b * 20, 256, 64), 1),  # UNet level 2
        (K.fused_attention_bh_prescaled, (b * 4, 256, 128), 1),  # Controller stage 2
        # the server's: a batch of four 512 px tiles, and a 256 x 384 image
        # whole at 512 x 768 (T = 384)
        (K.fused_attention_bh_prescaled, (80, 256, 64), 1),
        (K.fused_attention_bh_prescaled, (16, 256, 128), 1),
        (K.fused_attention_bh_prescaled, (20, 384, 64), 1),
        (K.fused_attention_bh_prescaled, (4, 384, 128), 1),
        (K.streaming_attention_bh_prescaled, (b, 4096, 512), 1),  # VAE mid block
        # the server's: a batch of four 512 px tiles, a 256 x 384 image whole
        # at 512 x 768
        (K.streaming_attention_bh_prescaled, (4, 4096, 512), 1),
        (K.streaming_attention_bh_prescaled, (1, 6144, 512), 1),
        # the fused route's shapes are the channel-flat ones, each with its
        # out-projection C = inner
        (K.fused_attention_btc_out_prescaled, (b, 4096, 320), 5),
        (K.fused_attention_btc_out_prescaled, (b, 1024, 640), 10),
        (K.fused_attention_btc_out_prescaled, (b, 4096, 256), 4),
        (K.fused_attention_btc_out_prescaled, (b, 1024, 256), 4),
        # the server's (phase 8 runs it on the fused route): a batch of four
        # 512 px tiles, a 256 x 384 image whole at 512 x 768
        (K.fused_attention_btc_out_prescaled, (4, 4096, 320), 5),
        (K.fused_attention_btc_out_prescaled, (4, 1024, 640), 10),
        (K.fused_attention_btc_out_prescaled, (4, 4096, 256), 4),
        (K.fused_attention_btc_out_prescaled, (4, 1024, 256), 4),
        (K.fused_attention_btc_out_prescaled, (1, 6144, 320), 5),
        (K.fused_attention_btc_out_prescaled, (1, 1536, 640), 10),
        (K.fused_attention_btc_out_prescaled, (1, 6144, 256), 4),
        (K.fused_attention_btc_out_prescaled, (1, 1536, 256), 4),
    ]


def backward_shapes(K):
    """One main-path shape per attention kernel for the gradient check."""
    return [(K.fused_attention_btc_prescaled, (BATCH, 4096, 320), 5),
            (K.fused_attention_bh_prescaled, (BATCH * 20, 256, 64), 1),
            (K.streaming_attention_bh_prescaled, (BATCH, 4096, 512), 1),
            (K.fused_attention_btc_out_prescaled, (BATCH, 4096, 320), 5)]


def gconv_shapes():
    """x shapes of the CFRM grouped conv (dw = 4 x 128/256/512) on every main
    path: the 512 px batch-8 restore and training step; the server's batch
    of four 512 px tiles; a 256 x 384 image restored whole at 512 x 768."""
    return [(BATCH, 256, 256, 512), (BATCH, 128, 128, 1024), (BATCH, 64, 64, 2048),
            (4, 256, 256, 512), (4, 128, 128, 1024), (4, 64, 64, 2048),
            (1, 256, 384, 512), (1, 128, 192, 1024), (1, 64, 96, 2048)]


def kernel_inputs(K, kern, shape, heads, gen):
    """Seeded bf16 inputs on the card and the head width d: q (prescaled by
    d^-1/2 log2 e), k, v, and for the fused kernel an (inner, inner)
    out-projection weight with unit-variance outputs."""
    flat = kern in (K.fused_attention_btc_prescaled, K.fused_attention_btc_out_prescaled)
    d = shape[2] // heads if flat else shape[2]
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    xs = [(q.float() * (d ** -0.5 * K.LOG2E)).to(torch.bfloat16), k, v]
    if kern is K.fused_attention_btc_out_prescaled:
        wo = torch.randn((shape[2], shape[2]), generator=gen, device="cuda") * shape[2] ** -0.5
        xs.append(wo.to(torch.bfloat16))
    return xs, d


def gconv_inputs(shape, gen, dtype=torch.bfloat16):
    """Seeded x, OIHW weights (unit-variance outputs) and bias for the grouped conv."""
    c = shape[-1]
    cg = c // 16
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = (torch.randn((c, cg, 3, 3), generator=gen, device="cuda") * (9 * cg) ** -0.5).to(dtype)
    b = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
    return x, w.contiguous(memory_format=torch.channels_last), b


def kernel_source(kern) -> str:
    """The source, in the repository, of a kernel's bf16 main-path launches:
    its wrapper's bf16 entry."""
    return str(kern.entry(torch.bfloat16)[2].relative_to(REPO))


def direct(entry, q, k, v, out=None, wo=None):
    """An attention C entry called directly through ctypes, without the
    wrapper's checks and autograd: the entry of a wrapper's bf16 launches, or
    the ``mma.sync`` kernel of csrc/attention.cu that a redesigned kernel
    replaced (a yardstick, never routed). Its signature is (q, k, v, o, three
    dims, dtype, stream), or with the out-projection ``wo`` (q, k, v, wo,
    out, four dims, dtype, stream)."""
    xs, dims = (q, k, v), tuple(q.shape)
    if wo is not None:
        xs, dims = (*xs, wo), (*dims, wo.shape[1])
    if out is None:
        out = torch.empty_like(q) if wo is None else q.new_empty((*q.shape[:2], wo.shape[1]))
    rc = entry(*(x.data_ptr() for x in xs), out.data_ptr(), *dims,
               1 if q.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")
    return out


def time_in_turns(call, host_call, new, prev=None) -> dict:
    """C entry ``new`` (``direct_ms``, ``direct_host_us``) and, where given,
    the entry ``prev`` it replaced, in turns (new, previous, previous, new;
    ``prev_ms``, ``prev_host_us``). ``call(e)`` runs entry ``e`` into a
    preallocated output; ``host_call(e)`` is the bare ctypes call, so the
    host times are the entries' own host work. Where the direct call takes
    under ``GRAPH_MS`` both are graph replays (``timer``), the event readings
    kept as ``direct_event_ms`` and ``prev_event_ms``."""
    order = (new,) if prev is None else (new, prev, prev, new)
    ms = [cuda_ms(lambda e=e: call(e), 10) for e in order]
    host = [host_us(lambda e=e: host_call(e)) for e in order]
    res = {"direct_ms": (ms[0] + ms[-1]) / 2, "direct_host_us": (host[0] + host[-1]) / 2}
    if prev is not None:
        res["prev_ms"], res["prev_host_us"] = (ms[1] + ms[2]) / 2, (host[1] + host[2]) / 2
    res["timer"] = "events"
    if res["direct_ms"] < GRAPH_MS:
        res["timer"] = "graph"
        graph = [graph_ms(lambda e=e: call(e)) for e in order]
        res["direct_event_ms"], res["direct_ms"] = res["direct_ms"], (graph[0] + graph[-1]) / 2
        if prev is not None:
            res["prev_event_ms"], res["prev_ms"] = res["prev_ms"], (graph[1] + graph[2]) / 2
    return res


def time_entries(K, kern, xs) -> dict:
    """``time_in_turns`` for the C entry of ``kern``'s bf16 launches, and the
    wrapper's host time per call (``wrapper_host_us``). Where that entry is
    not the wrapper's base symbol, the base symbol's ``mma.sync`` kernel in
    csrc/attention.cu is what it replaced: it is timed in turns and held to
    the plain version too (``prev_tolerance_ratio``). At T = 1024 the
    wrapper's host time per call exceeds a kernel's. ``xs`` is q, k, v and,
    for the out-projection-fused kernel, wo."""
    symbol, lib = kern.route(torch.bfloat16)
    new, prev, res = getattr(lib, symbol), None, {}
    wo = dict(zip(("wo",), xs[3:]))  # the out-projection-fused kernel's fourth input
    if symbol != kern.symbol:
        prev = getattr(K.library(), kern.symbol)
        res["prev_tolerance_ratio"] = kern.bf16_tolerance_ratio(direct(prev, *xs[:3], **wo),
                                                                kern.plain(*xs))
        if res["prev_tolerance_ratio"] > 1.0:
            raise AssertionError(f"{kern.symbol} {tuple(xs[0].shape)}: disagrees with the plain "
                                 "version")
    out = torch.empty(kern.out_shape(*xs), dtype=xs[0].dtype, device=xs[0].device)
    ints = (*xs[0].shape, *(x.shape[1] for x in xs[3:]))
    args = (*(x.data_ptr() for x in xs), out.data_ptr(), *ints, 1,
            torch.cuda.current_stream().cuda_stream)
    res.update(time_in_turns(lambda e: direct(e, *xs[:3], out, **wo), lambda e: e(*args), new,
                             prev))
    res["wrapper_host_us"] = host_us(lambda: kern(*xs))
    return res


def compare_output(kern, out, ref) -> dict:
    """A bf16 output of an attention kernel against its plain version's ``ref``."""
    diff = out.float() - ref.float()
    return {"max_abs_err": diff.abs().max().item(), "rms_err_over_rms_ref": rms_rel(out, ref),
            "tolerance_ratio": kern.bf16_tolerance_ratio(out, ref)}


def compare_kernel(kern, *xs) -> dict:
    """The kernel against its plain version on the same inputs."""
    return compare_output(kern, kern(*xs), kern.plain(*xs))


def direct_gconv(entry, x, wp, b, out=None):
    """A grouped-conv C entry of the (x, w, bias, y, B, H, W, C, cg, dtype,
    stream) signature called directly through ctypes with weights ``wp``
    already packed: the entry of the wrapper's bf16 launches, or the
    ``mma.sync`` kernel of csrc/grouped_conv.cu that it replaced (a
    yardstick, never routed)."""
    out = torch.empty_like(x) if out is None else out
    rc = entry(x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(), *x.shape,
               wp.shape[-1], 1 if x.dtype == torch.bfloat16 else 0,
               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")
    return out


def time_gconv_entries(G, x, w, b, ref) -> dict:
    """``time_in_turns`` for the grouped conv's bf16 C entry with the weights
    packed once and the ``mma.sync`` entry it replaced (``ur_grouped_conv3``'s
    bf16 body), held to the plain version ``ref`` too
    (``prev_tolerance_ratio``), and the wrapper's host time per call."""
    kern = G.grouped_conv3
    symbol, lib = kern.route(torch.bfloat16)
    new, prev = getattr(lib, symbol), getattr(G.library(), kern.symbol)
    wp = G.pack_weights(w, 16)
    res = {"prev_tolerance_ratio": G.bf16_tolerance_ratio(direct_gconv(prev, x, wp, b), ref)}
    if res["prev_tolerance_ratio"] > 1.0:
        raise AssertionError(f"{kern.symbol} {tuple(x.shape)}: the mma.sync entry disagrees "
                             "with the plain version")
    out = torch.empty_like(x)
    args = (x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(), *x.shape,
            wp.shape[-1], 1, torch.cuda.current_stream().cuda_stream)
    res.update(time_in_turns(lambda e: direct_gconv(e, x, wp, b, out), lambda e: e(*args), new,
                             prev))
    res["wrapper_host_us"] = host_us(lambda: kern(x, w, b, 16))
    return res


def compare_gconv(G, out, ref) -> dict:
    """A bf16 grouped-conv output against the plain version's ``ref``."""
    return {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "rms_err_over_rms_ref": rms_rel(out, ref),
            "tolerance_ratio": G.bf16_tolerance_ratio(out, ref)}


def check_kernel(K, kern, shape, heads, gen):
    n, t, _ = shape
    xs, d = kernel_inputs(K, kern, shape, heads, gen)
    q, k, v = xs[:3]
    err = compare_kernel(kern, *xs)
    if err["tolerance_ratio"] > 1.0:
        raise AssertionError(f"{kern.symbol} {shape}: kernel and plain version disagree: "
                             f"{err}")

    def split(x):  # (n, t, heads*d) -> (n, heads, t, d)
        return x.view(n, t, heads, d).transpose(1, 2)

    def sdpa():  # q is prescaled by d^-1/2 log2(e): softmax_e(x ln 2) == softmax_2(x)
        return F.scaled_dot_product_attention(split(q), split(k), split(v), scale=math.log(2.0))

    extra = time_entries(K, kern, xs)
    ms = cuda_ms(lambda: kern(*xs), 10)
    plain_ms = cuda_ms(lambda: kern.plain(*xs), 3)
    flops = 4.0 * n * heads * t * t * d
    nbytes = 4.0 * q.numel() * q.element_size()
    if kern is K.fused_attention_btc_out_prescaled:
        wo = xs[3]
        flops += 2.0 * n * t * shape[2] * wo.shape[1]
        nbytes += (wo.numel() + n * t * wo.shape[1] - q.numel()) * q.element_size()
        # no one PyTorch call computes attention and its out-projection: the
        # unfused pairs are the yardsticks
        library_ms = None

        def unfused():
            return K.fused_attention_btc_prescaled(q, k, v) @ wo

        def sdpa_matmul():
            return sdpa().transpose(1, 2).reshape(n, t, shape[2]) @ wo

        # by graph replay at every shape: each pair is two launches, and the
        # channel-flat wrapper's 45-90 us of host time would set the pace of
        # back-to-back calls at T <= 1536; the event readings stay beside them
        for key, pair in (("unfused", unfused), ("sdpa_matmul", sdpa_matmul)):
            extra[f"{key}_event_ms"] = cuda_ms(pair, 10)
            extra[f"{key}_ms"] = graph_ms(pair)
    else:
        library_ms = cuda_ms(sdpa, 10)
    if extra["timer"] == "graph":  # the wrapper and SDPA as the C entries
        extra["event_ms"], ms = ms, graph_ms(lambda: kern(*xs))
        if library_ms is not None:
            extra["library_event_ms"], library_ms = library_ms, graph_ms(sdpa)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"shape": list(shape), "heads": heads, "d": d, **err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, **extra, "bound_ms": bound_ms,
           "bound_by": bound_by, "tflops": flops / (ms * 1e-3) / 1e12}
    yardsticks = (f"library {library_ms:.3f} ms" if library_ms is not None else
                  f"btc+matmul {extra['unfused_ms']:.4f} ms sdpa+matmul "
                  f"{extra['sdpa_matmul_ms']:.4f} ms (graph; events "
                  f"{extra['unfused_event_ms']:.4f} / {extra['sdpa_matmul_event_ms']:.4f} ms)")
    if "direct_ms" in extra:
        prev, prev_host = "", ""
        if "prev_ms" in extra:
            prev = (f", prev (mma.sync) {extra['prev_ms']:.4f} ms, its tolerance ratio "
                    f"{extra['prev_tolerance_ratio']:.3f}")
            prev_host = f", prev {extra['prev_host_us']:.1f} us"
        yardsticks += (f" | direct call {extra['direct_ms']:.4f} ms{prev} | host per call: C "
                       f"entry {extra['direct_host_us']:.1f} us{prev_host}, wrapper "
                       f"{extra['wrapper_host_us']:.1f} us | timer {extra['timer']}")
        if extra["timer"] == "graph":
            yardsticks += (f" (events: wrapper {extra['event_ms']:.4f} ms, direct "
                           f"{extra['direct_event_ms']:.4f} ms"
                           + (f", prev {extra['prev_event_ms']:.4f} ms" if "prev_ms" in extra
                              else "")
                           + (f", library {extra['library_event_ms']:.4f} ms" if library_ms
                              is not None else "") + ")")
    log(f"kernel {kern.symbol} {tuple(shape)} d={d}: max_abs {err['max_abs_err']:.3e} "
        f"rms_err/rms_ref {err['rms_err_over_rms_ref']:.2e} tolerance ratio "
        f"{err['tolerance_ratio']:.3f} | {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s) "
        f"plain {plain_ms:.3f} ms {yardsticks} bound {bound_ms:.4f} ms ({bound_by})")
    return row


def check_gconv(G, shape, gen):
    x, w, b = gconv_inputs(shape, gen)
    ref = G.grouped_conv3_plain(x, w, b, 16)
    err = compare_gconv(G, G.grouped_conv3(x, w, b, 16), ref)
    if err["tolerance_ratio"] > 1.0:
        raise AssertionError(f"{G.grouped_conv3.symbol} {shape}: kernel and plain version "
                             f"disagree: {err}")
    extra = time_gconv_entries(G, x, w, b, ref)
    ms = cuda_ms(lambda: G.grouped_conv3(x, w, b, 16), 10)
    plain_ms = cuda_ms(lambda: G.grouped_conv3_plain(x, w, b, 16), 3)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory

    def cudnn():
        return F.conv2d(xc, w, b, padding=1, groups=16)

    library_ms = cuda_ms(cudnn, 10)
    if extra["timer"] == "graph":  # the wrapper and cuDNN as the C entries
        extra["event_ms"], ms = ms, graph_ms(lambda: G.grouped_conv3(x, w, b, 16))
        extra["library_event_ms"], library_ms = library_ms, graph_ms(cudnn)
    bsz, h, wd, c = shape
    flops = 2.0 * bsz * h * wd * c * 9 * (c // 16)
    nbytes = (2 * x.numel() + w.numel() + b.numel()) * x.element_size()
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"shape": list(shape), "groups": 16, **err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **extra, "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {G.grouped_conv3.symbol} {tuple(shape)} cg={c // 16}: max_abs "
        f"{err['max_abs_err']:.3e} rms_err/rms_ref {err['rms_err_over_rms_ref']:.2e} "
        f"tolerance ratio {err['tolerance_ratio']:.3f} | {ms:.4f} ms "
        f"({row['tflops']:.1f} TFLOP/s) plain {plain_ms:.3f} ms library {library_ms:.4f} ms "
        f"| direct call {extra['direct_ms']:.4f} ms, prev (mma.sync) {extra['prev_ms']:.4f} ms, "
        f"its tolerance ratio {extra['prev_tolerance_ratio']:.3f} | host per call: C entry "
        f"{extra['direct_host_us']:.1f} us, prev {extra['prev_host_us']:.1f} us, wrapper "
        f"{extra['wrapper_host_us']:.1f} us | timer {extra['timer']} bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return row


def check_backward(K, kern, shape, heads, gen) -> dict:
    """The kernel's autograd function against autograd through its plain version."""
    xs, _ = kernel_inputs(K, kern, shape, heads, gen)
    g = torch.randn(kern.out_shape(*xs), generator=gen, device="cuda", dtype=torch.bfloat16)

    def grads(fn):
        leaves = [x.detach().requires_grad_() for x in xs]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    ours, ref = grads(kern), grads(kern.plain)
    errs = {name: rms_rel(a, b) for name, a, b in zip(("dq", "dk", "dv", "dwo"), ours, ref)}
    finite = all(torch.isfinite(x).all() for x in ours)
    if not finite or max(errs.values()) > BWD_RMS_TOL:
        raise AssertionError(f"{kern.symbol} {shape}: gradients disagree with autograd "
                             f"through the plain version: {errs} (finite {finite})")
    del ours, ref
    bwd_ms = cuda_ms(lambda: kern.vjp(*xs, g), 3)
    log(f"backward {kern.symbol} {tuple(shape)}: rms err/rms ref "
        + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (limit {BWD_RMS_TOL:.3e}) | recompute backward {bwd_ms:.3f} ms")
    return {"shape": list(shape), "rms_err_over_rms_ref": errs, "ms": bwd_ms}


# ---------------------------------------------------------------------------
# phases 4-5: the restore path
# ---------------------------------------------------------------------------


def fill_zero_leaves(bridge, tree, gen, std=1e-2):
    """Zero-initialised adapter leaves (Controller zero convs, NAF beta/gamma,
    TFA prompts) get small seeded values, so those paths do real work."""
    for leaf in bridge.flatten(tree).values():
        if not leaf.any():
            leaf.normal_(0.0, std, generator=gen)
    return tree


def make_params(UR, bridge, cfg, dtype, seed, trainable_dtype=None):
    """Seeded (frozen, trainable) on the card; trainable in ``trainable_dtype`` if given."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frozen, trainable = UR.init(cfg, gen, device="cuda", dtype=trainable_dtype or dtype)
    if trainable_dtype is not None:
        frozen = bridge.unflatten_like({k: v.to(dtype) for k, v in
                                        bridge.flatten(frozen).items()}, frozen)
    frozen["null_emb"] = bridge.load_null_embedding(REPO / "weights" / "sd_null_emb.npy",
                                                    device="cuda", dtype=dtype)
    return frozen, fill_zero_leaves(bridge, trainable, gen)


def psnr_u8(a, b) -> float:
    """PSNR after uint8-level rounding (the repo's eval protocol), capped at 99 dB."""
    qa = (a.float() * 255).round().clamp(0, 255) / 255
    qb = (b.float() * 255).round().clamp(0, 255) / 255
    mse = ((qa.double() - qb.double()) ** 2).mean().item()
    return 99.0 if mse == 0 else min(10 * math.log10(1.0 / mse), 99.0)


def restore_inputs(UR, cfg, frozen, trainable, gen):
    """A seeded 512 px bf16 batch, its seeded noise (``posterior_noise`` and
    ``diffusion_noise``), and ``restore(cfg, steps)`` of it with that noise."""
    sched = UR.schedule(cfg, device="cuda")
    images = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda").to(torch.bfloat16)
    post, diff = UR.restore_noise(cfg, images.shape, images.dtype, gen, "cuda")
    noise = {"posterior_noise": post, "diffusion_noise": diff}

    def restore(c, steps):  # 512 px needs no resize or pad: restore_padded runs as is
        return UR.restore(frozen, trainable, c, sched, images, "ir",
                          num_inference_steps=steps, device="cuda", **noise)

    return images, noise, restore


def counts_of(KN) -> tuple:
    return tuple(kern.launches for kern in KN.KERNELS)


def run_modes(UR, KN, cfg, frozen, trainable, gen):
    """Phase 4: the restores of ``RUNS`` on one seeded batch with one noise draw.

    Returns (results by name, launches by path): ``restore`` sums the
    unfused runs' launches, ``restore_fused`` the fused ones'."""
    images, _, restore = restore_inputs(UR, cfg, frozen, trainable, gen)
    t0 = time.perf_counter()
    restore(cfg, 1)  # warm-up: lazy library init, every shape once
    restore(dataclasses.replace(cfg, fused_out_attention=True), 1)
    torch.cuda.synchronize()
    log(f"warm-up restores (1 step, unfused and fused): {time.perf_counter() - t0:.2f} s")

    outs, results = {}, {}
    launches = {path: {kern.symbol: 0 for kern in KN.KERNELS}
                for path in ("restore", "restore_fused")}
    for name, mode, stride, warmup, fused in RUNS:
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride, cache_warmup=warmup,
                                fused_out_attention=fused)
        torch.cuda.reset_peak_memory_stats()
        KN.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(c, STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = counts_of(KN)
        path = launches["restore_fused" if fused else "restore"]
        for kern in KN.KERNELS:
            path[kern.symbol] += kern.launches
        if out.shape != images.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: output shape {tuple(out.shape)} or non-finite values")
        if counts != EXPECTED[name]:
            raise AssertionError(f"{name}: launches {counts} != expected {EXPECTED[name]}")
        if name in outs and not torch.equal(out, outs[name]):
            log(f"{name}: the repeat differs from the first run by max abs "
                f"{(out.float() - outs[name].float()).abs().max().item():.3e}")
        outs.setdefault(name, out)
        row = results.setdefault(name, {"mode": mode, "stride": stride, "warmup": warmup,
                                        "fused_out_attention": fused, "seconds": [],
                                        "launches": counts})
        row["seconds"].append(sec)
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"restore {name} (mode {mode}, stride {stride}, warmup {warmup}, fused out-projection "
            f"{fused}): {sec:.3f} s, {BATCH / sec:.3f} img/s, launches "
            f"btc/bh/stream/btc_out/gconv {counts}, peak {row['peak_mem_gib']:.1f} GiB")
    for row in results.values():
        row["img_per_s"] = [BATCH / sec for sec in row["seconds"]]
    for name in ("encoder", "deep", "fused"):
        results[name]["psnr_vs_exact"] = psnr_u8(outs["none"], outs[name])
        log(f"{name} PSNR vs exact: {results[name]['psnr_vs_exact']:.2f} dB")
    ex, fu = (sum(results[n]["seconds"]) / len(results[n]["seconds"]) for n in ("none", "fused"))
    log(f"exact restore, unfused vs fused out-projection (two runs each, in turns): "
        f"{BATCH / ex:.3f} vs {BATCH / fu:.3f} img/s ({(ex / fu - 1) * 100:+.1f} % for fused)")
    return results, launches


def uint8_levels(a, b) -> int:
    """The largest difference of two outputs in uint8 levels, each rounded as
    the eval protocol rounds (``psnr_u8``)."""
    qa, qb = ((x.float() * 255).round().clamp(0, 255) for x in (a, b))
    return int((qa - qb).abs().max().item())


def run_graph_modes(UR, KN, GR, cfg, frozen, trainable, gen):
    """Phase 4 on the graph route: for each of ``GRAPH_RUNS`` one
    ``GraphedRestore`` captures the restore of one seeded batch, then eager
    restores and graph replays of it run in ``GRAPH_TURNS``. Each eager
    restore runs under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises at any wait for the card or copy from the host.

    Returns (results by name, launches by path): ``restore_graph`` sums the
    unfused graphs' launches at capture times their replays,
    ``restore_fused_graph`` the fused one's."""
    images, noise, restore = restore_inputs(UR, cfg, frozen, trainable, gen)
    sched = UR.schedule(cfg, device="cuda")
    results = {}
    launches = {path: {kern.symbol: 0 for kern in KN.KERNELS}
                for path in ("restore_graph", "restore_fused_graph")}
    for name, mode, stride, warmup, fused in GRAPH_RUNS:
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride, cache_warmup=warmup,
                                fused_out_attention=fused)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        graphed = GR.GraphedRestore(frozen, trainable, c, sched, device="cuda")
        t0 = time.perf_counter()
        first = graphed(images, "ir", num_inference_steps=STEPS, **noise)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        (stats,) = graphed.stats.values()
        captured = tuple(stats.launches[kern.symbol] for kern in KN.KERNELS)
        if captured != EXPECTED[name]:
            raise AssertionError(f"graph {name}: launches at capture {captured} != expected "
                                 f"{EXPECTED[name]}")
        row = {"mode": mode, "stride": stride, "warmup": warmup, "fused_out_attention": fused,
               "first_call_seconds": first_s, "warmup_seconds": stats.warmup_seconds,
               "capture_seconds": stats.capture_seconds, "launches_at_capture": captured,
               "peak_mem_gib_first_call": torch.cuda.max_memory_allocated() / 2**30,
               "eager": {"seconds": [], "peak_mem_gib": []},
               "graph": {"seconds": [], "peak_mem_gib": []}}
        torch.cuda.empty_cache()
        row["graph_held_gib"] = (torch.cuda.memory_reserved() - reserved) / 2**30
        outs = {"eager": [], "graph": [first]}
        for route in GRAPH_TURNS:
            torch.cuda.reset_peak_memory_stats()
            KN.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "eager":
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = restore(c, STEPS)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                out = graphed(images, "ir", num_inference_steps=STEPS, **noise)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = counts_of(KN)
            want = EXPECTED[name] if route == "eager" else (0,) * len(KN.KERNELS)
            if counts != want:
                raise AssertionError(f"{route} {name}: launches {counts} != {want}")
            if out.shape != images.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{route} {name}: output shape {tuple(out.shape)} or "
                                     "non-finite values")
            row[route]["seconds"].append(sec)
            row[route]["peak_mem_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            outs[route].append(out)
        for route in ("eager", "graph"):
            row[route]["img_per_s"] = [BATCH / sec for sec in row[route]["seconds"]]
        row["replays"] = stats.replays
        row["graph_vs_eager_max_abs"] = (outs["graph"][1].float()
                                         - outs["eager"][0].float()).abs().max().item()
        row["graph_vs_eager_uint8_levels"] = uint8_levels(outs["graph"][1], outs["eager"][0])
        row["graph_repeats_equal"] = all(torch.equal(o, first) for o in outs["graph"])
        row["eager_repeats_equal"] = torch.equal(*outs["eager"])
        results[name] = row
        eager_s, graph_s = (sum(row[r]["seconds"]) / 2 for r in ("eager", "graph"))
        log(f"graph {name} (mode {mode}, stride {stride}, warmup {warmup}, fused out-projection "
            f"{fused}): first call {first_s:.3f} s (eager warm-up {stats.warmup_seconds:.3f} s, "
            f"capture + instantiate {stats.capture_seconds:.3f} s), launches at capture "
            f"{captured}; in turns eager {BATCH / eager_s:.3f} img/s, graph "
            f"{BATCH / graph_s:.3f} img/s ({(eager_s / graph_s - 1) * 100:+.1f} %; seconds "
            f"eager {row['eager']['seconds']}, graph {row['graph']['seconds']}); peak GiB eager "
            f"{max(row['eager']['peak_mem_gib']):.2f}, replay "
            f"{max(row['graph']['peak_mem_gib']):.2f}, first call "
            f"{row['peak_mem_gib_first_call']:.2f}, held by the graph "
            f"{row['graph_held_gib']:.2f}; graph vs eager max abs "
            f"{row['graph_vs_eager_max_abs']:.3e}, {row['graph_vs_eager_uint8_levels']} uint8 "
            f"levels (limit 1); replays equal {row['graph_repeats_equal']}, eager repeats equal "
            f"{row['eager_repeats_equal']}")
        if row["graph_vs_eager_uint8_levels"] > 1:
            raise AssertionError(f"graph {name}: {row['graph_vs_eager_uint8_levels']} uint8 "
                                 "levels from the eager restore")
        path = launches["restore_fused_graph" if fused else "restore_graph"]
        for kern in KN.KERNELS:
            path[kern.symbol] += stats.launches[kern.symbol] * stats.replays
        del graphed, outs, first, out
    torch.cuda.empty_cache()
    return results, launches


def to_cpu(bridge, tree):
    return bridge.unflatten_like({k: v.detach().cpu() for k, v in bridge.flatten(tree).items()},
                                 tree)


def reference_check(UR, KN, GR, bridge, cfg):
    """Full widths, 256 px, fp32, 2 steps: card (kernels; unfused, fused
    out-projection, and unfused replayed from a CUDA graph) vs CPU (plain
    versions)."""
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.rand((1, 256, 256, 3), generator=gen, device="cuda")
    lat = (1, 32, 32, cfg.vae.latent_channels)
    post = torch.randn(lat, generator=gen, device="cuda")
    diff = torch.randn(lat, generator=gen, device="cuda")

    def run(device, c, tree_f, tree_t):
        return UR.restore_padded(tree_f, tree_t, c, UR.schedule(c), images.to(device),
                                 "seg", num_inference_steps=2,
                                 posterior_noise=post.to(device),
                                 diffusion_noise=diff.to(device), device=device)

    gpu, counts = {}, {}
    for fused in (False, True):
        KN.reset_counts()
        gpu[fused] = run("cuda", dataclasses.replace(cfg, fused_out_attention=fused),
                         frozen, trainable).cpu()
        counts[fused] = dict(zip((kern.symbol for kern in KN.KERNELS), counts_of(KN)))
    # the graph route runs ``restore``: at min_size 256 a 256 px input is
    # neither resized nor padded, so it restores as ``restore_padded`` does
    c256 = dataclasses.replace(cfg, min_size=256)
    graphed = GR.GraphedRestore(frozen, trainable, c256, UR.schedule(c256), device="cuda")
    gpu["graph"] = graphed(images, "seg", num_inference_steps=2, posterior_noise=post,
                           diffusion_noise=diff).cpu()
    (graph_stats,) = graphed.stats.values()
    del graphed
    t0 = time.perf_counter()
    cpu = run("cpu", cfg, to_cpu(bridge, frozen), to_cpu(bridge, trainable))
    errs = {fused: (out - cpu).abs().max().item() for fused, out in gpu.items()}
    log(f"reference 256 px fp32, 2 steps: card vs CPU max abs {errs[False]:.3e} unfused, "
        f"{errs[True]:.3e} fused out-projection, {errs['graph']:.3e} unfused from a CUDA graph "
        f"(tolerance {REFERENCE_ATOL}); card launches unfused {counts[False]}, fused "
        f"{counts[True]}, graph at capture {graph_stats.launches} (capture + instantiate "
        f"{graph_stats.capture_seconds:.3f} s); CPU {time.perf_counter() - t0:.1f} s")
    for fused, out in gpu.items():
        if not (torch.isfinite(out).all() and errs[fused] <= REFERENCE_ATOL):
            raise AssertionError(f"card and CPU restores differ (fused {fused}): "
                                 f"max abs {errs[fused]:.3e}")
    # at 256 px UNet level 0 and Controller stage 0 run T = 1024 (btc, or btc_out
    # when fused), UNet level 1 and Controller stage 1 T = 256 (bh)
    unfused_ran = [s for s, n in counts[False].items() if n == 0 and s != "ur_attention_btc_out"]
    if unfused_ran or counts[False]["ur_attention_btc_out"]:
        raise AssertionError(f"unfused reference restore launches {counts[False]}")
    if counts[True]["ur_attention_btc"] or not counts[True]["ur_attention_btc_out"]:
        raise AssertionError(f"fused reference restore launches {counts[True]}")
    if graph_stats.launches != counts[False]:
        raise AssertionError(f"graph reference restore launches at capture "
                             f"{graph_stats.launches} != eager {counts[False]}")
    return {"max_abs_err": errs[False], "max_abs_err_fused": errs[True],
            "max_abs_err_graph": errs["graph"], "launches": counts[False],
            "launches_fused": counts[True], "graph_launches_at_capture": graph_stats.launches,
            "graph_capture_seconds": graph_stats.capture_seconds}


# ---------------------------------------------------------------------------
# phases 6-7: the stage-1 training step
# ---------------------------------------------------------------------------


def synthetic_pair(gen, batch: int, res: int, dtype) -> dict:
    """A seeded smooth image ``hq`` and its degradation ``lq`` (2x blur, Gaussian
    noise of sigma 0.05), NHWC in [0, 1] on the card."""
    coarse = torch.rand((batch, 3, res // 16, res // 16), generator=gen, device="cuda")
    hq = F.interpolate(coarse, size=(res, res), mode="bicubic", align_corners=False)
    hq = (hq + 0.05 * torch.randn(hq.shape, generator=gen, device="cuda")).clamp(0, 1)
    blur = F.interpolate(F.avg_pool2d(hq, 2), size=(res, res), mode="bilinear",
                         align_corners=False)
    lq = (blur + 0.05 * torch.randn(hq.shape, generator=gen, device="cuda")).clamp(0, 1)
    return {"hq": hq.permute(0, 2, 3, 1).contiguous().to(dtype),
            "lq": lq.permute(0, 2, 3, 1).contiguous().to(dtype)}


def train_counts(KN) -> dict:
    return {kern.symbol: (kern.launches - kern.recompute_launches, kern.recompute_launches,
                          kern.backwards) for kern in KN.KERNELS}


def train_setup(UR, bridge, TS, OPT):
    """The stage-1 setup of phase 6: sd-turbo widths without TFA, bf16 frozen
    weights, fp32 trainable masters, AdamW from the stage-1 YAML's kwargs,
    remat on. Returns (frozen, trainable, stage, peak lr, next_inputs, run):
    ``next_inputs()`` makes a seeded synthetic batch and its noise, and
    ``run(batch, noise)`` takes one step (updating ``trainable`` and the
    optimizer state in place) and returns its logs."""
    cfg = UR.UniRestoreConfig()
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=3,
                                    trainable_dtype=torch.float32)
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
    tx, peak_lr = OPT.build(STAGE1_OPT, STAGE1_SCHED, STAGE1_MAX_STEPS, BATCH, STAGE1_ACCUM, 1)
    opt_state = tx.init(TS.trained_leaves(stage, trainable))
    step = TS.make_train_step(frozen, cfg, UR.schedule(cfg, device="cuda"), stage, tx, "ir",
                              remat=True)
    gen = torch.Generator(device="cuda").manual_seed(4)

    def next_inputs():
        batch = synthetic_pair(gen, BATCH, RES, torch.bfloat16)
        return batch, TS.draw_noise(cfg, batch, gen)

    def run(batch, noise):
        return step(trainable, opt_state, batch, noise)[2]

    return frozen, trainable, stage, peak_lr, next_inputs, run


def run_training(UR, KN, bridge, TS, OPT):
    """Phase 6: the full-width stage-1 step, one warm-up and TRAIN_STEPS timed."""
    frozen, trainable, stage, peak_lr, next_inputs, run = train_setup(UR, bridge, TS, OPT)
    frozen_before = {k: v.clone() for k, v in bridge.flatten(frozen).items()}
    trained_before = {k: v.clone() for k, v in TS.trained_leaves(stage, trainable).items()}
    n_trained = sum(v.numel() for v in trained_before.values())
    log(f"training: stage 1, {n_trained / 1e6:.1f} M trainable fp32 params, frozen bf16, "
        f"AdamW peak lr {peak_lr:.3e}, accumulation {STAGE1_ACCUM}, remat on")

    rows, launches = [], {kern.symbol: 0 for kern in KN.KERNELS}
    for i in range(1 + TRAIN_STEPS):
        batch, noise = next_inputs()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        KN.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = run(batch, noise)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = train_counts(KN)
        for kern in KN.KERNELS:
            launches[kern.symbol] += kern.launches
        logs = {k: v.item() for k, v in logs.items()}
        log(f"train step {i}{' (warm-up)' if i == 0 else ''}: {sec * 1e3:.1f} ms, "
            + " ".join(f"{k.split('/')[-1]} {v:.5g}" for k, v in logs.items())
            + " | launches (forward, recompute, backward) "
            + " ".join(f"{s.split('_', 1)[1]} {c}" for s, c in counts.items()))
        if not all(math.isfinite(v) for v in logs.values()):
            raise AssertionError(f"train step {i}: non-finite loss or gradient norm {logs}")
        if counts != EXPECTED_TRAIN:
            raise AssertionError(f"train step {i}: launches {counts} != {EXPECTED_TRAIN}")
        rows.append({"seconds": sec, "logs": logs})
    peak = torch.cuda.max_memory_allocated() / 2**30

    unchanged = [k for k, v in TS.trained_leaves(stage, trainable).items()
                 if torch.equal(v, trained_before[k])]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} trainable leaves did not change: {unchanged[:5]}")
    touched = [k for k, v in bridge.flatten(frozen).items() if not torch.equal(v, frozen_before[k])]
    if touched:
        raise AssertionError(f"frozen leaves changed: {touched[:5]}")
    sec = [r["seconds"] for r in rows[1:]]
    mean = sum(sec) / len(sec)
    result = {"batch": BATCH, "res": RES, "steps_timed": TRAIN_STEPS, "ms_per_step": mean * 1e3,
              "ms_per_step_each": [s * 1e3 for s in sec], "train_img_per_s": BATCH / mean,
              "peak_mem_gib": peak, "launches_per_step": EXPECTED_TRAIN,
              "losses": [r["logs"] for r in rows]}
    log(f"training: {mean * 1e3:.1f} ms/step over {TRAIN_STEPS} steps "
        f"({min(sec) * 1e3:.1f}-{max(sec) * 1e3:.1f}), {BATCH / mean:.3f} train img/s, "
        f"peak {peak:.1f} GiB; every trained leaf changed, frozen bytes unchanged")
    return result, launches


def train_reference_check(UR, KN, bridge, TS):
    """Phase 7: one stage-1 loss and gradient, full widths, 256 px, fp32, card vs CPU."""
    cfg = UR.UniRestoreConfig()
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = synthetic_pair(gen, 1, 256, torch.float32)
    noise = TS.draw_noise(cfg, batch, gen)
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
    cfg_r = TS.with_remat(cfg)

    def run(device, tree_f, tree_t):
        leaves = TS.trained_leaves(stage, tree_t)
        for p in leaves.values():
            p.requires_grad_(True)
        nz = TS.StepNoise(noise.hq.to(device), noise.lq.to(device),
                          noise.diffusion.to(device), noise.timesteps.to(device))
        loss, logs = TS.compute_losses(tree_f, tree_t, cfg_r, UR.schedule(cfg, device=device),
                                       stage, {k: v.to(device) for k, v in batch.items()},
                                       nz, "ir")
        grads = torch.autograd.grad(loss, list(leaves.values()))
        norms = {}
        for k, g in zip(leaves, grads):
            fam = k.split("//")[0]
            norms[fam] = norms.get(fam, 0.0) + g.double().square().sum().item()
        return {k: v.item() for k, v in logs.items()}, {f: n ** 0.5 for f, n in norms.items()}

    KN.reset_counts()
    gpu_logs, gpu_norms = run("cuda", frozen, trainable)
    counts = train_counts(KN)
    t0 = time.perf_counter()
    cpu_logs, cpu_norms = run("cpu", to_cpu(bridge, frozen), to_cpu(bridge, trainable))
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(gpu_logs[k] - cpu_logs[k]) / abs(cpu_logs[k]) for k in cpu_logs)
    grad_err = max(abs(gpu_norms[f] - cpu_norms[f]) / cpu_norms[f] for f in cpu_norms)
    log(f"training reference 256 px fp32: card vs CPU max relative loss error {loss_err:.3e} "
        f"(limit {TRAIN_LOSS_RTOL}), gradient norm error {grad_err:.3e} "
        f"(limit {TRAIN_GRAD_RTOL}); norms card {gpu_norms} CPU {cpu_norms}; "
        f"card launches {counts}; CPU {cpu_s:.1f} s")
    finite = all(math.isfinite(v) for v in (*gpu_logs.values(), *gpu_norms.values()))
    if not finite or loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
        raise AssertionError("card and CPU training steps differ")
    if any(counts[s][0] == 0 for s, c in EXPECTED_TRAIN.items() if c[0]):
        raise AssertionError(f"a kernel did not run in the reference training step: {counts}")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": grad_err, "cpu_seconds": cpu_s}


# ---------------------------------------------------------------------------
# phase 8: the restore server
# ---------------------------------------------------------------------------


def smooth_image(gen, h: int, w: int):
    """A seeded smooth uint8 RGB image (bicubic upsampling of 16x coarser noise), on the host."""
    coarse = torch.rand((1, 3, max(h // 16, 2), max(w // 16, 2)), generator=gen, device="cuda")
    img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False).clamp(0, 1)
    return (img[0].permute(1, 2, 0) * 255).round().to(torch.uint8).cpu().numpy()


def levels(a, b) -> int:
    """The largest difference of two uint8 images in levels."""
    return int(abs(a.astype("int16") - b.astype("int16")).max())


def post(url: str, body: bytes, timeout: float = 600.0) -> tuple[int, bytes]:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def run_serving(KN, serve, png, reference=None):
    """Phase 8: the server in this process, answering real HTTP requests.

    Without ``reference``: the eager server; returns (result, launches by
    kernel, its in-process answers to the tiled and whole images). With
    ``reference`` (those answers): the server with ``--cuda-graphs``, each
    answer held to them; launches are each graph's at capture times its
    replays."""
    import numpy as np

    from unirestore_torch.ops import tiling as TIL

    graphs = reference is not None
    flags = SERVE_FLAGS + (["--cuda-graphs"] if graphs else [])
    args = serve.parse_args(flags + ["--weights-dir", str(REPO / "weights")])
    t0 = time.perf_counter()
    restore, cfg = serve.build_restore(args)
    server = serve.make_server(args, restore, cfg)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    log(f"server up on {url} in {time.perf_counter() - t0:.1f} s: {' '.join(flags)}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, launches = {}, {kern.symbol: 0 for kern in KN.KERNELS}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        want = {"status": "ok", "tasks": ["ir", "cls", "seg"], "served": 0, "cache_mode": "none"}
        if r.status != 200 or health != want:
            raise AssertionError(f"/healthz: {r.status} {health}, want 200 {want}")
        log(f"GET /healthz: {r.status} {health}")
        images, sent = {}, {}
        for name, task, (h, w), status, want_counts in SERVE_REQUESTS:
            if graphs:
                want_counts = GRAPH_SERVE_COUNTS[name]
            img = sent[name] = images.setdefault((h, w), smooth_image(gen, h, w))
            body = png.encode(img)
            KN.reset_counts()
            t0 = time.perf_counter()
            code, answer = post(f"{url}/restore?task={task}", body)
            sec = time.perf_counter() - t0
            counts = counts_of(KN)
            for kern in KN.KERNELS:
                launches[kern.symbol] += kern.launches
            row = {"task": task, "size": [h, w], "status": code, "seconds": sec,
                   "launches": counts}
            if code == 200:
                out = png.decode(answer)
                row["out_size"] = list(out.shape[:2])
                if out.shape != img.shape:
                    raise AssertionError(f"{name}: answer {out.shape}, sent {img.shape}")
                if h > cfg.min_size or w > cfg.min_size:
                    tiles = len(TIL.plan_tiles(h, w, cfg.min_size, args.overlap))
                    row.update(tiles=tiles, tiles_per_s=tiles / sec)
                rows[name] = row
                rows[name]["answer"] = out
            else:
                row["error"] = json.loads(answer).get("error")
                rows[name] = row
            log(f"POST /restore?task={task} {h}x{w}: {code} in {sec:.3f} s"
                + (f", {row['tiles']} tiles, {row['tiles_per_s']:.3f} tiles/s"
                   if "tiles" in row else "")
                + f", launches btc/bh/stream/btc_out/gconv {counts}")
            if code != status or counts != want_counts:
                raise AssertionError(f"{name}: status {code} launches {counts}, want "
                                     f"{status} {want_counts}")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            served = json.loads(r.read())["served"]
        if served != 3:
            raise AssertionError(f"/healthz counts {served} served requests, want 3")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()

    result = {"flags": flags, "healthz": health, "requests": rows}
    if graphs:
        return serve_graph_checks(KN, restore.graphs, rows, reference, result)

    # the answers of the same function called in this process, and the host's
    # share of a request: PNG decode and encode of the same image
    in_process = {}
    for name in ("tiled", "whole"):
        t0 = time.perf_counter()
        out = restore(np.asarray(sent[name], np.float32)[None] / 255.0,
                      rows[name]["task"])[0]
        result[f"in_process_{name}_seconds"] = time.perf_counter() - t0
        in_process[name] = np.clip(out * 255.0, 0, 255).astype(np.uint8)
    direct, direct_s = in_process["tiled"], result["in_process_tiled_seconds"]
    body = png.encode(sent["tiled"])
    t0 = time.perf_counter()
    png.decode(body)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    png.encode(direct)
    encode_s = time.perf_counter() - t0
    apart = levels(direct, rows["tiled"]["answer"])
    cold = levels(rows["tiled_cold"]["answer"], rows["tiled"]["answer"])
    log(f"tiled answer vs in-process restore_tiled: max {apart} uint8 levels apart (limit 1); "
        f"cold vs warm answer {cold} levels; in-process call {direct_s:.3f} s, PNG decode "
        f"{decode_s:.3f} s, encode {encode_s:.3f} s (the warm request took "
        f"{rows['tiled']['seconds']:.3f} s)")
    if apart > 1:
        raise AssertionError(f"tiled answer differs from the in-process call by {apart} levels")
    for row in rows.values():
        row.pop("answer", None)
    result.update({"uint8_levels_vs_in_process": apart, "uint8_levels_cold_vs_warm": cold,
                   "in_process_seconds": direct_s, "png_decode_seconds": decode_s,
                   "png_encode_seconds": encode_s})
    return result, launches, in_process


def serve_graph_checks(KN, graphs, rows, reference, result):
    """Phase 8's checks of the server with ``--cuda-graphs``: one capture of
    ``SERVE_BATCH`` launches per key, ``GRAPH_SERVE_REPLAYS`` replays, each
    answer within one uint8 level of the eager in-process ``reference``."""
    stats = {key[0]: st for key, st in graphs.stats.items()}
    launches = {kern.symbol: 0 for kern in KN.KERNELS}
    result["graphs"] = {}
    for shape, st in stats.items():
        captured = tuple(st.launches[kern.symbol] for kern in KN.KERNELS)
        result["graphs"][str(list(shape))] = {
            "captures": st.captures, "replays": st.replays, "launches_at_capture": captured,
            "warmup_seconds": st.warmup_seconds, "capture_seconds": st.capture_seconds}
        log(f"server graph {list(shape)}: {st.captures} capture(s), {st.replays} replays, "
            f"launches at capture {captured}, eager warm-up {st.warmup_seconds:.3f} s, capture "
            f"+ instantiate {st.capture_seconds:.3f} s")
        if st.captures != 1 or captured != SERVE_BATCH:
            raise AssertionError(f"server graph {shape}: {st.captures} captures, launches "
                                 f"{captured}, want 1 and {SERVE_BATCH}")
        for kern in KN.KERNELS:
            launches[kern.symbol] += st.launches[kern.symbol] * st.replays
    replays = {shape: st.replays for shape, st in stats.items()}
    if replays != GRAPH_SERVE_REPLAYS:
        raise AssertionError(f"server graphs: replays {replays}, want {GRAPH_SERVE_REPLAYS}")
    apart = {name: levels(rows[name]["answer"], reference[ref])
             for name, ref in (("tiled_cold", "tiled"), ("tiled", "tiled"), ("whole", "whole"))}
    log(f"graph server answers vs the eager in-process calls: {apart} uint8 levels (limit 1)")
    if max(apart.values()) > 1:
        raise AssertionError(f"graph server answers differ from the eager calls: {apart}")
    for row in rows.values():
        row.pop("answer", None)
    result["uint8_levels_vs_eager_in_process"] = apart
    return result, launches, None


# ---------------------------------------------------------------------------
# phase 9: fit through the CLI
# ---------------------------------------------------------------------------


class StepProbe:
    """Wraps ``Trainer._step`` and ``Trainer.validate`` for one fit: per
    micro-step launch counts (forward, recompute, backward) and task, the
    first micro-step's trainable tree, batch, noise and task (for the direct
    step), the first batch and noise of each task, what each validation
    returned, and the micro-steps ``sync_steps`` run under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the noise draw,
    the step or the optimizer update may wait for the card or copy from the
    host. The prefetch's own copies run outside it. With ``timed``, each
    micro-step is timed with the card synchronised before and after it, and
    its losses are read (``logs``); with
    ``keep_after`` the trainable tree and the Adam first moments after that
    micro-step are kept."""

    def __init__(self, TE, KN, bridge, sync_steps=(FIT_SYNC_CHECK_STEP,), timed=False,
                 keep_after=None):
        self.TE, self.KN, self.bridge = TE, KN, bridge
        self.sync_steps, self.timed, self.keep_after = sync_steps, timed, keep_after
        self.counts, self.tasks, self.seconds, self.metrics, self.logs = [], [], [], [], []
        self.first, self.first_by_task, self.after = None, {}, None

    def __enter__(self):
        probe, orig, orig_validate = self, self.TE.Trainer._step, self.TE.Trainer.validate
        self.orig, self.orig_validate = orig, orig_validate

        def step(trainer, step_fn, trainable, opt_state, batch, i, draw):
            before = train_counts(probe.KN)
            drawn = []
            task = getattr(step_fn, "task", "ir")

            def draw_kept(b):
                drawn.append(draw(b))
                return drawn[-1]

            kept = {"batch": {k: v.clone() for k, v in batch.items()}, "task": task}
            if i == 0:
                probe.first = {"trainable": clone_tree(probe.bridge, trainable), **kept}
            if probe.timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if i in probe.sync_steps:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(trainer, step_fn, trainable, opt_state, batch, i, draw_kept)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if probe.timed:
                torch.cuda.synchronize()
                probe.seconds.append(time.perf_counter() - t0)
                probe.logs.append({k: v.item() for k, v in out[2].items()})
            after = train_counts(probe.KN)
            probe.counts.append({s: tuple(a - b for a, b in zip(after[s], before[s]))
                                 for s in after})
            probe.tasks.append(task)
            if i == 0:
                probe.first["noise"] = drawn[0]
            if task not in probe.first_by_task:
                probe.first_by_task[task] = {**kept, "noise": drawn[0]}
            if i == probe.keep_after:
                probe.after = {"trainable": clone_tree(probe.bridge, out[0]),
                               "mu": {k: v.clone() for k, v in out[1]["mu"].items()}}
            return out

        def validate(trainer, *args, **kwargs):
            probe.metrics.append(orig_validate(trainer, *args, **kwargs))
            return probe.metrics[-1]

        self.TE.Trainer._step = step
        self.TE.Trainer.validate = validate
        return self

    def __exit__(self, *exc):
        self.TE.Trainer._step = self.orig
        self.TE.Trainer.validate = self.orig_validate
        return False


class WindowTimer:
    """Wraps ``Trainer._step`` for one fit of ``steps`` micro-steps: the wall
    time from the end of micro-step 1 to the end of the last, the card
    synchronised at both ends. It spans ``steps - 1`` whole loop iterations:
    the loader wait, the batch's cast and the step."""

    def __init__(self, TE, steps: int):
        self.TE, self.steps, self.marks = TE, steps, []

    def __enter__(self):
        timer, orig = self, self.TE.Trainer._step
        self.orig = orig

        def step(trainer, step_fn, trainable, opt_state, batch, i, draw):
            out = orig(trainer, step_fn, trainable, opt_state, batch, i, draw)
            if i in (0, timer.steps - 1):
                torch.cuda.synchronize()
                timer.marks.append(time.perf_counter())
            return out

        self.TE.Trainer._step = step
        return self

    def __exit__(self, *exc):
        self.TE.Trainer._step = self.orig
        return False

    @property
    def seconds(self) -> float:
        if len(self.marks) != 2:
            raise AssertionError(f"timed fit: {len(self.marks)} window marks, want 2")
        return self.marks[1] - self.marks[0]


def clone_tree(bridge, tree):
    return bridge.unflatten_like({k: v.detach().clone() for k, v in bridge.flatten(tree).items()},
                                 tree)


def kernel_shapes_met(KN) -> dict:
    """{kernel symbol: {(shape, dtype)}} of the launches since the last reset."""
    return {kern.symbol: set(kern.shapes) for kern in KN.KERNELS}


def fit_argv(command, data_dir: Path, root: Path, *extra) -> list:
    """``unirestore_torch.main`` arguments: the stage-1 YAML with dotted overrides only."""
    ir_list = str(data_dir / "lists" / "ir.list")
    return [command, "--config", str(FIT_YAML),
            "--data.init_args.dataset_dict.DIVF2KOST.train", ir_list,
            "--data.init_args.dataset_dict.DIVF2KOST.val", ir_list,
            "--trainer.max_steps", str(FIT_STEPS),
            "--trainer.val_check_interval", str(FIT_VAL_EVERY),
            "--trainer.limit_val_batches", str(FIT_VAL_BATCHES),
            "--trainer.logger.init_args.save_dir", str(root), *extra]


def direct_step_check(bridge, TS, OPT, engine, trainer, first, te_loss_fn=None) -> dict:
    """The fit's first micro-step against ``make_train_step`` called directly
    on the same trainable values, batch, noise, task and task loss: the losses
    bit-equal."""
    tx, _ = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs, trainer.max_steps,
                      first["batch"]["hq"].shape[0], trainer.accum, 1)
    tr = first["trainable"]
    step = TS.make_train_step(engine.frozen, engine.cfg, engine.sched, engine.stage, tx,
                              first["task"], te_loss_fn=te_loss_fn)
    logs = step(tr, tx.init(TS.trained_leaves(engine.stage, tr)), first["batch"],
                first["noise"])[2]
    logs = {k: v.item() for k, v in logs.items()}
    fit = trainer.logs[0]
    losses = [k for k in logs if k.startswith("train/loss")]
    unequal = {k: (fit[k], logs[k]) for k in losses if fit[k] != logs[k]}
    log(f"fit step 1 ({first['task']}) vs a direct make_train_step call on its batch and "
        f"noise: {len(losses) - len(unequal)} of {len(losses)} losses bit-equal; grad norm "
        f"{fit['train/grad_norm']!r} vs {logs['train/grad_norm']!r}")
    if unequal:
        raise AssertionError(f"fit step 1 losses differ from the direct step: {unequal}")
    return {"task": first["task"], "losses_bit_equal": len(losses),
            "grad_norm_fit": fit["train/grad_norm"], "grad_norm_direct": logs["train/grad_norm"]}


def run_fit(KN, bridge, TE, TS, OPT, main_fn, png, work: Path):
    """Phase 9: ``unirestore_torch.main.main`` fit, resume and predict at full
    width on the 576 px smoke tree it makes under ``work/data``, then a timed
    and a profiled fit. Returns (result, launches by kernel of the first fit,
    the (shape, dtype) each kernel met)."""
    return fit_in(KN, bridge, TE, TS, OPT, main_fn, png, work)


def fit_in(KN, bridge, TE, TS, OPT, main_fn, png, work: Path):
    """``run_fit`` in the scratch directory ``work``."""
    from unirestore_torch.data.corruption import native

    data_dir, root = work / "data", work / "logs"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(REPO / "tools" / "make_smoke_data.py"), str(data_dir),
                    str(FIT_RES)], check=True, capture_output=True, text=True, timeout=300)
    log(f"fit data: smoke tree at {FIT_RES} px in {time.perf_counter() - t0:.1f} s; native "
        f"corruption kernels loaded: {native.available()}")

    # first fit: sanity validation, 6 micro-steps, validation at 3 and 6
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepProbe(TE, KN, bridge) as probe:
        engine, trainer = main_fn(fit_argv("fit", data_dir, root))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    shapes = kernel_shapes_met(KN)
    for i, c in enumerate(probe.counts):
        if c != EXPECTED_TRAIN:
            raise AssertionError(f"fit micro-step {i + 1}: launches {c} != {EXPECTED_TRAIN}")
    if len(probe.counts) != FIT_STEPS:
        raise AssertionError(f"fit ran {len(probe.counts)} micro-steps, want {FIT_STEPS}")
    val = tuple(launches[kern.symbol] - FIT_STEPS * sum(EXPECTED_TRAIN[kern.symbol][:2])
                for kern in KN.KERNELS)
    want_val = tuple(FIT_VAL_RESTORES * n for n in FIT_RESTORE)
    log(f"fit: launches per micro-step {probe.counts[0]} (all {FIT_STEPS} equal phase 6's); "
        f"validation launches {val} = {FIT_VAL_RESTORES} restores x {FIT_RESTORE}: "
        f"{val == want_val}")
    if val != want_val:
        raise AssertionError(f"fit validation launches {val} != {want_val}")
    logged = list(trainer.logs)
    if not logged or not all(math.isfinite(v) for e in logged for v in e.values()):
        raise AssertionError(f"fit: non-finite or missing logged losses {logged}")
    moved = trained_leaves_moved(bridge, TS, OPT, engine, trainer, probe.first["trainable"],
                                 root / "checkpoints" / "last.npz")
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    if (len(ckpts) != 3 or ckpts[0] != "last.npz"
            or not ckpts[1].startswith(f"step={FIT_VAL_EVERY}-val=")
            or not ckpts[2].startswith(f"step={FIT_STEPS}-val=")):
        raise AssertionError(f"fit checkpoints {ckpts}")
    direct = direct_step_check(bridge, TS, OPT, engine, trainer, probe.first)
    timing = {k: v for k, v in trainer.timing.items() if k != "loader_waits_s"}
    log(f"fit: {fit_s:.1f} s in all; host time of a step call (not synchronised) p50 "
        f"{timing['p50_s']:.4f} s (mean {timing['mean_s']:.4f}, {timing['steps']} steps "
        f"after the first); loader wait "
        f"{timing['loader_wait_mean_s'] * 1e3:.2f} ms/step (each "
        f"{[round(w * 1e3, 2) for w in trainer.timing['loader_waits_s']]}); peak "
        f"{peak:.1f} GiB; checkpoints {ckpts}")
    n_frozen_check = frozen_unchanged(bridge, engine)
    del probe, engine, trainer
    torch.cuda.empty_cache()

    # resume to step 8
    KN.reset_counts()
    t0 = time.perf_counter()
    engine, trainer = main_fn(fit_argv("fit", data_dir, root, "--trainer.resume", "auto",
                                       "--trainer.max_steps", str(FIT_RESUME_STEPS)))
    resume_s = time.perf_counter() - t0
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    from unirestore_torch.train import checkpoints as CKPT
    meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]
    ran = len(trainer.timing["loader_waits_s"])
    if meta["step"] != FIT_RESUME_STEPS or ran != FIT_RESUME_STEPS - FIT_STEPS:
        raise AssertionError(f"resume: {ran} steps run, last.npz at step {meta['step']}; want "
                             f"{FIT_RESUME_STEPS - FIT_STEPS} steps from step {FIT_STEPS}")
    log(f"resume: {ran} steps from step {FIT_STEPS} in {resume_s:.1f} s; last.npz step "
        f"{meta['step']}")
    del engine, trainer
    torch.cuda.empty_cache()

    # predict: one PNG per val image, each the size of its input
    KN.reset_counts()
    t0 = time.perf_counter()
    main_fn(fit_argv("predict", data_dir, root))
    predict_s = time.perf_counter() - t0
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    pngs = sorted((root / "predict").iterdir())
    sizes = {tuple(png.decode(p.read_bytes()).shape) for p in pngs}
    log(f"predict: {len(pngs)} PNGs in {predict_s:.1f} s, sizes {sizes}")
    if len(pngs) != 6 or sizes != {(FIT_RES, FIT_RES + 16, 3)}:
        raise AssertionError(f"predict wrote {len(pngs)} PNGs of sizes {sizes}")
    torch.cuda.empty_cache()

    # timed: micro-steps 2-6 synchronised at both ends, no validation
    KN.reset_counts()
    no_val = ("--trainer.val_check_interval", "0", "--trainer.num_sanity_val_steps", "0")
    with WindowTimer(TE, FIT_STEPS) as window:
        _, timed = main_fn(fit_argv("fit", data_dir, work / "timed", *no_val))
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    n, batch = FIT_STEPS - 1, timed.timing["batch_size"]
    waits = timed.timing["loader_waits_s"][1:]
    timed = {"steps": n, "batch_size": batch, "wall_s": window.seconds,
             "s_per_step": window.seconds / n, "train_img_s": n * batch / window.seconds,
             "loader_wait_mean_s": sum(waits) / len(waits),
             "host_step_call_p50_s": timed.timing["p50_s"]}
    log(f"timed fit, micro-steps 2-{FIT_STEPS} (card synchronised at both ends): "
        f"{timed['wall_s']:.4f} s, {timed['s_per_step']:.4f} s/step, "
        f"{timed['train_img_s']:.3f} train img/s at batch {batch}; loader wait "
        f"{timed['loader_wait_mean_s'] * 1e3:.2f} ms/step; host time of a step call p50 "
        f"{timed['host_step_call_p50_s']:.4f} s")
    torch.cuda.empty_cache()

    # profiled: steps 2-6 under torch.profiler (trainer.profiler), no validation
    KN.reset_counts()
    _, profiled = main_fn(fit_argv("fit", data_dir, work / "profiled", "--trainer.profiler",
                                   str(work / "trace"), *no_val))
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    prof = profiled.profile
    log(f"profiled fit, steps {prof.get('steps')}: device busy "
        f"{prof.get('device_busy_s', float('nan')):.4f} s of "
        f"{prof.get('device_span_s', float('nan')):.4f} s, "
        f"idle share {prof.get('device_idle_share')}, {prof.get('kernels')} kernels; p50 "
        f"{profiled.timing['p50_s']:.4f} s/step under the profiler")
    if not prof.get("kernels"):
        raise AssertionError(f"the profiled fit recorded no device activity: {prof}")
    torch.cuda.empty_cache()
    result = {"res": FIT_RES, "steps": FIT_STEPS, "fit_seconds": fit_s, "peak_mem_gib": peak,
              "timing": timing, "timed": timed, "logs": logged, "checkpoints": ckpts,
              "direct_step": direct,
              "launches_per_micro_step": EXPECTED_TRAIN, "validation_launches": val,
              "trained_leaves": moved,
              "frozen_leaves_checked": n_frozen_check, "resume_seconds": resume_s,
              "predict_seconds": predict_s, "predict_pngs": len(pngs),
              "profile": {**prof, "p50_s_profiled": profiled.timing["p50_s"]}}
    return result, launches, shapes


def trained_leaves_moved(bridge, TS, OPT, engine, trainer, before, last) -> dict:
    """Every CFRM / Controller / SC-Tuner leaf after the fit against its value
    before the first step. A leaf may keep its value only where its updates
    fell below its fp32 resolution: a zero-initialised NAF ``beta`` / ``gamma``
    or zero conv gates the branch behind it, so at the YAML's first OneCycle
    rates (peak / 10) that branch's 1-D leaves get gradients near 1e-9 and
    Adam moves them by far less than one ulp of 1.0. Such a leaf must still
    have had a gradient: its Adam first moment in ``last.npz`` is not zero."""
    from unirestore_torch.train import checkpoints as CKPT
    trained = TS.trained_leaves(engine.stage, engine.trainable)
    before = bridge.flatten(before)
    unchanged = [k for k, v in trained.items() if torch.equal(v, before[k])]
    tx, _ = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs, trainer.max_steps,
                      trainer.timing["batch_size"], trainer.accum, 1)
    mu = CKPT.restore_opt_state(str(last), tx.init(trained))["mu"]
    silent = [k for k in unchanged if not mu[k].any()]
    mu_max = max((mu[k].abs().max().item() for k in unchanged), default=0.0)
    log(f"fit: {len(trained) - len(unchanged)} of {len(trained)} trained leaves changed; "
        f"{len(unchanged)} kept their values with nonzero first moments (largest |mu| "
        f"{mu_max:.3e}): {unchanged[:6]}{' ...' if len(unchanged) > 6 else ''}")
    if silent:
        raise AssertionError(f"fit: {len(silent)} trained leaves got no gradient: {silent[:5]}")
    return {"count": len(trained), "changed": len(trained) - len(unchanged),
            "below_resolution": unchanged, "largest_first_moment_of_those": mu_max}


def frozen_unchanged(bridge, engine) -> int:
    """The frozen tree after the fit against a fresh seeded build of it: every byte equal."""
    from unirestore_torch import zoo
    from unirestore_torch.models import unirestore as UR
    fresh, _ = UR.init(engine.cfg, device=engine.device, seed=engine.seed)
    fresh = zoo.load_frozen_backbone(fresh, engine.cfg)
    fresh = bridge.flatten(fresh)
    touched = [k for k, v in bridge.flatten(engine.frozen).items()
               if not torch.equal(v, fresh[k].to(v.dtype))]
    if touched:
        raise AssertionError(f"fit: frozen leaves changed: {touched[:5]}")
    return len(fresh)


def merge_shapes(a: dict, b: dict) -> dict:
    return {k: a[k] | b[k] for k in a}


def check_fit_shapes(K, G, KN, shapes, rows, gen, path: str = "fit") -> int:
    """Phase 3's comparison at every (shape, dtype) a fit gave a kernel that
    phase 3's lists and the rows already held do not hold (rows marked
    ``"path": path``). Returns how many shapes it added."""
    held = {(kern.symbol, tuple(shape)) for kern, shape, _ in kernel_shapes(K)}
    held |= {(G.grouped_conv3.symbol, tuple(s)) for s in gconv_shapes()}
    held |= {(symbol, tuple(row["shape"])) for symbol, rs in rows.items() for row in rs}
    added = 0
    with torch.inference_mode():
        for kern in KN.KERNELS:
            for shape, dtype in sorted(shapes[kern.symbol], key=str):
                if (kern.symbol, shape) in held:
                    continue
                if dtype != torch.bfloat16:
                    raise AssertionError(f"{kern.symbol}: the {path} launched it in {dtype} at "
                                         f"{shape}; phase 3 holds bf16 launches only")
                if kern is G.grouped_conv3:
                    row = check_gconv(G, shape, gen)
                else:
                    heads = shape[2] // 64 if kern is K.fused_attention_btc_prescaled else 1
                    row = check_kernel(K, kern, shape, heads, gen)
                row["path"] = path
                rows[kern.symbol].append(row)
                held.add((kern.symbol, shape))
                added += 1
    return added


# ---------------------------------------------------------------------------
# phase 11: the stage-2 fit through the CLI
# ---------------------------------------------------------------------------


def fit2_argv(command, data_dir: Path, root: Path, *extra) -> list:
    """``unirestore_torch.main`` arguments: the stage-2 YAML with dotted overrides only
    (the smoke tree's lists, the step counts, validation and the log directory)."""
    lists = data_dir / "lists"
    argv = [command, "--config", str(FIT2_YAML)]
    for name, lst, splits in FIT2_LISTS:
        for split in splits:
            argv += [f"--data.init_args.dataset_dict.{name}.{split}", str(lists / f"{lst}.list")]
    return argv + ["--trainer.max_steps", str(FIT2_STEPS),
                   "--trainer.val_check_interval", str(FIT2_VAL_EVERY),
                   "--trainer.limit_val_batches", str(FIT2_VAL_BATCHES),
                   "--trainer.num_sanity_val_steps", str(FIT2_SANITY),
                   "--trainer.logger.init_args.save_dir", str(root), *extra]


def profiled_device(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: the card's busy seconds, by
    kernel family (``tools/profile_torch_restore.py:family``) and in all, and
    the number of kernels."""
    import importlib.util

    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location("profile_torch_restore",
                                                  REPO / "tools" / "profile_torch_restore.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_family, n = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            fam = tool.family(evt.name)
            by_family[fam] = by_family.get(fam, 0.0) + evt.time_range.elapsed_us() / 1e6
            n += 1
    return {"device_busy_s": sum(by_family.values()), "kernels": n,
            "device_s_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1]))}


def critic_share(bridge, TS, OPT, engine, trainer, probe) -> dict:
    """The critics' share of a ``cls`` and a ``seg`` micro-step's device time:
    the card's busy time in the critic's forward and backward pass alone (the
    task loss on fp32 predictions of the micro-step's shape, differentiated to
    the predictions) over its busy time in a whole micro-step on the task's
    first batch and noise of the fit, both profiled after a warm-up."""
    te_fn = engine.te_loss_fn()
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for task in ("cls", "seg"):
        first = probe.first_by_task[task]
        batch, noise = first["batch"], first["noise"]
        tr = clone_tree(bridge, engine.trainable)
        tx, _ = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs,
                          trainer.max_steps, batch["hq"].shape[0], trainer.accum, 1)
        state = tx.init(TS.trained_leaves(engine.stage, tr))
        step = TS.make_train_step(engine.frozen, engine.cfg, engine.sched, engine.stage, tx,
                                  task, te_loss_fn=te_fn)
        preds = torch.rand(batch["hq"].shape, generator=gen, device="cuda")

        def micro_step():
            step(tr, state, batch, noise)

        def critic():
            p = preds.clone().requires_grad_(True)
            with torch.enable_grad():
                torch.autograd.grad(te_fn(p, batch["hq"], batch["gt"], task), [p])

        micro_step()
        critic()
        whole, alone = profiled_device(micro_step), profiled_device(critic)
        share = alone["device_busy_s"] / whole["device_busy_s"]
        out[task] = {"micro_step": whole, "critic": alone, "critic_share": share}
        log(f"stage-2 {task} micro-step, profiled: device busy {whole['device_busy_s']:.4f} s "
            f"({whole['kernels']} kernels); the critic's forward and backward alone "
            f"{alone['device_busy_s']:.4f} s ({alone['kernels']} kernels): share {share:.3f}; "
            f"micro-step by family {whole['device_s_by_family']}")
    return out


def run_fit_stage2(KN, bridge, TE, TS, OPT, main_fn, work: Path):
    """Phase 11: ``unirestore_torch.main.main`` fit from the stage-2 YAML on
    phase 9's smoke tree under ``work/data``, its checks, the critics' share
    of a micro-step, and a resume. Returns (result, launches by kernel of the
    fit, the (shape, dtype) each kernel met)."""
    data_dir, root = work / "data", work / "stage2"
    symbols = [kern.symbol for kern in KN.KERNELS]
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepProbe(TE, KN, bridge, sync_steps=FIT2_SYNC_CHECK_STEPS, timed=True,
                   keep_after=FIT2_ACCUM - 1) as probe:
        engine, trainer = main_fn(fit2_argv("fit", data_dir, root))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    shapes = kernel_shapes_met(KN)

    tasks = tuple(probe.tasks)
    log(f"stage-2 fit: micro-step tasks {tasks}")
    if len(tasks) != FIT2_STEPS or set(tasks) != {"ir", "cls", "seg"}:
        raise AssertionError(f"stage-2 fit: micro-steps {tasks}; want {FIT2_STEPS} covering "
                             "ir, cls and seg")
    for i, (task, counts) in enumerate(zip(tasks, probe.counts)):
        if counts != EXPECTED_STAGE2[task]:
            raise AssertionError(f"stage-2 micro-step {i + 1} ({task}): launches {counts} != "
                                 f"{EXPECTED_STAGE2[task]}")
    val = tuple(launches[s] - sum(EXPECTED_STAGE2[t][s][0] for t in tasks) for s in symbols)
    want_val = tuple(sum(FIT2_VAL_RESTORES[t] * FIT2_RESTORE[t][i] for t in FIT2_RESTORE)
                     for i in range(len(symbols)))
    log(f"stage-2 fit: launches per micro-step as the routing implies for every task "
        f"({ {t: EXPECTED_STAGE2[t]['ur_attention_stream'] for t in ('ir', 'cls', 'seg')} } "
        f"wide-head); validation launches {val} = restores {FIT2_VAL_RESTORES} x "
        f"{FIT2_RESTORE}: {val == want_val}")
    if val != want_val:
        raise AssertionError(f"stage-2 validation launches {val} != {want_val}")
    logged = probe.logs
    if len(logged) != FIT2_STEPS or not all(math.isfinite(v) for e in logged
                                            for v in e.values()):
        raise AssertionError(f"stage-2 fit: non-finite or missing losses {logged}")

    # only the TFA leaves train; the frozen tree and both critics stay as built
    before, now = bridge.flatten(probe.first["trainable"]), bridge.flatten(engine.trainable)
    changed = [k for k in now if not torch.equal(now[k], before[k])]
    families = sorted({k.split("//")[0] for k in changed})
    n_tfa = sum(k.startswith("tfa//") for k in now)
    log(f"stage-2 fit: {len(changed)} of {n_tfa} TFA leaves changed; families changed "
        f"{families}")
    if families != ["tfa"]:
        raise AssertionError(f"stage-2 fit changed {families}; only tfa may change")
    n_frozen = frozen_unchanged(bridge, engine)
    fresh = bridge.flatten(TE.build_critics("mtl", device=engine.device))
    critics = bridge.flatten(engine.critics)
    touched = [k for k in fresh if not torch.equal(fresh[k], critics[k])]
    if touched or fresh.keys() != critics.keys():
        raise AssertionError(f"stage-2 fit changed the critics: {touched[:5]}")

    # CE reaches each task's prompt: after the first update each prompt moved
    # or carries a nonzero first moment
    prompts = {}
    for task in ("ir", "cls", "seg"):
        k = f"tfa//task_prompts//{task}"
        moved = not torch.equal(bridge.flatten(probe.after["trainable"])[k], before[k])
        mu = probe.after["mu"][k].abs().max().item()
        prompts[task] = {"moved": moved, "max_abs_first_moment": mu}
        if not moved and mu == 0.0:
            raise AssertionError(f"stage-2 fit: the {task} prompt got no gradient before the "
                                 "first update")
    log(f"stage-2 fit: task prompts after the first update {prompts}")

    direct = direct_step_check(bridge, TS, OPT, engine, trainer, probe.first,
                               te_loss_fn=engine.te_loss_fn())
    metrics = probe.metrics
    need = {"val_ir_lq/psnr", "val_cls_lq/r50v1", "val_cls_hq/r50v1", "val_seg_lq/dlv3pr50",
            "val_monitor"}
    if len(metrics) != FIT2_STEPS // FIT2_VAL_EVERY or any(
            not need <= m.keys() or m["val_monitor"] != m["val_ir_lq/psnr"] for m in metrics):
        raise AssertionError(f"stage-2 validation metrics {metrics}")
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    if (len(ckpts) != 3 or ckpts[0] != "last.npz"
            or not ckpts[1].startswith(f"step={FIT2_STEPS}-val=")
            or not ckpts[2].startswith(f"step={FIT2_VAL_EVERY}-val=")):
        raise AssertionError(f"stage-2 fit checkpoints {ckpts}")

    # s per micro-step of each task, the card synchronised before and after
    # each; each task's first micro-step is its warm-up
    per_task = {}
    for task in ("ir", "cls", "seg"):
        secs = [s for t, s in zip(tasks, probe.seconds) if t == task]
        per_task[task] = {"micro_steps": len(secs), "first_s": secs[0],
                          "s_per_step": sum(secs[1:]) / len(secs[1:]), "each_s": secs}
    waits = trainer.timing["loader_waits_s"]
    share = critic_share(bridge, TS, OPT, engine, trainer, probe)
    log(f"stage-2 fit: {fit_s:.1f} s in all; s per micro-step after each task's first "
        f"(synchronised) " + ", ".join(f"{t} {v['s_per_step']:.4f} ({v['micro_steps'] - 1})"
                                       for t, v in per_task.items())
        + f"; loader wait {sum(waits) / len(waits) * 1e3:.2f} ms/step (each "
        f"{[round(w * 1e3, 2) for w in waits]}); peak {peak:.2f} GiB; checkpoints {ckpts}; "
        f"validation {metrics[-1]}")
    del probe, engine, trainer
    torch.cuda.empty_cache()

    # resume to a later step
    KN.reset_counts()
    t0 = time.perf_counter()
    _, trainer = main_fn(fit2_argv("fit", data_dir, root, "--trainer.resume", "auto",
                                   "--trainer.max_steps", str(FIT2_RESUME_STEPS),
                                   "--trainer.num_sanity_val_steps", "0"))
    resume_s = time.perf_counter() - t0
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    from unirestore_torch.train import checkpoints as CKPT
    meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]
    ran = len(trainer.timing["loader_waits_s"])
    if meta["step"] != FIT2_RESUME_STEPS or ran != FIT2_RESUME_STEPS - FIT2_STEPS:
        raise AssertionError(f"stage-2 resume: {ran} steps run, last.npz at step "
                             f"{meta['step']}; want {FIT2_RESUME_STEPS - FIT2_STEPS} from step "
                             f"{FIT2_STEPS}")
    log(f"stage-2 resume: {ran} step from step {FIT2_STEPS} in {resume_s:.1f} s; last.npz step "
        f"{meta['step']}")
    del trainer
    torch.cuda.empty_cache()
    result = {"res": FIT_RES, "steps": FIT2_STEPS, "accumulation": FIT2_ACCUM, "tasks": tasks,
              "fit_seconds": fit_s, "peak_mem_gib": peak, "s_per_micro_step": per_task,
              "loader_wait_mean_s": sum(waits) / len(waits), "loader_waits_s": waits,
              "logs": logged, "validation": metrics, "checkpoints": ckpts,
              "direct_step": direct, "launches_per_micro_step": EXPECTED_STAGE2,
              "validation_launches": val, "tfa_leaves_changed": len(changed),
              "tfa_leaves": n_tfa, "prompts_after_first_update": prompts,
              "frozen_leaves_checked": n_frozen, "critic_leaves_checked": len(fresh),
              "critic_share": share, "resume_seconds": resume_s}
    return result, launches, shapes


def train2_reference_check(UR, KN, bridge, TS, TE) -> dict:
    """Phase 11: one stage-2 loss for ``cls`` and one for ``seg`` and the TFA
    gradient norm, full widths with the critics, 256 px, fp32, card vs CPU."""
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=11)
    critics = TE.build_critics("mtl", device="cuda")
    cpu_trees = (to_cpu(bridge, frozen), to_cpu(bridge, trainable), to_cpu(bridge, critics))
    gen = torch.Generator(device="cuda").manual_seed(12)
    stage = TS.StageConfig(train_cfrm=False, train_cnet=False, train_tfa=True, multi_task=True)
    cfg_r = TS.with_remat(cfg)

    def run(device, tree_f, tree_t, crit, batch, noise, task):
        leaves = TS.trained_leaves(stage, tree_t)
        for p in leaves.values():
            p.requires_grad_(True)
        try:
            nz = TS.StepNoise(*(x.to(device) for x in (noise.hq, noise.lq, noise.diffusion,
                                                       noise.timesteps)))
            loss, logs = TS.compute_losses(tree_f, tree_t, cfg_r, UR.schedule(cfg, device=device),
                                           stage, {k: v.to(device) for k, v in batch.items()},
                                           nz, task, TE.make_te_loss_fn("mtl", crit))
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        finally:
            for p in leaves.values():
                p.requires_grad_(False)
        norm = sum(g.double().square().sum().item() for g in grads if g is not None) ** 0.5
        return {k: v.item() for k, v in logs.items()}, norm

    out = {}
    for task in ("cls", "seg"):
        batch = synthetic_pair(gen, 1, 256, torch.float32)
        if task == "cls":
            batch["gt"] = torch.tensor([417], device="cuda")
        else:
            labels = torch.randint(0, 19, (1, 256, 256), generator=gen, device="cuda")
            labels[:, :32] = 255
            batch["gt"] = labels
        noise = TS.draw_noise(cfg, batch, gen)
        KN.reset_counts()
        gpu_logs, gpu_norm = run("cuda", frozen, trainable, critics, batch, noise, task)
        counts = train_counts(KN)
        t0 = time.perf_counter()
        cpu_logs, cpu_norm = run("cpu", *cpu_trees, batch, noise, task)
        cpu_s = time.perf_counter() - t0
        loss_err = max(abs(gpu_logs[k] - cpu_logs[k]) / abs(cpu_logs[k]) for k in cpu_logs)
        grad_err = abs(gpu_norm - cpu_norm) / cpu_norm
        log(f"stage-2 reference {task}, 256 px fp32: card vs CPU max relative loss error "
            f"{loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), TFA gradient norm {gpu_norm:.6g} vs "
            f"{cpu_norm:.6g}, error {grad_err:.3e} (limit {TRAIN_GRAD_RTOL}); losses card "
            f"{gpu_logs} CPU {cpu_logs}; card launches {counts}; CPU {cpu_s:.1f} s")
        finite = all(math.isfinite(v) for v in (*gpu_logs.values(), gpu_norm))
        if not finite or loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"card and CPU stage-2 {task} steps differ")
        if any(counts[s][0] == 0 for s, c in EXPECTED_STAGE2[task].items() if c[0]):
            raise AssertionError(f"a kernel did not run in the stage-2 reference: {counts}")
        out[task] = {"loss_rel_err": loss_err, "grad_norm_rel_err": grad_err,
                     "tfa_grad_norm_card": gpu_norm, "tfa_grad_norm_cpu": cpu_norm,
                     "cpu_seconds": cpu_s}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from unirestore_torch import bridge, serve
    from unirestore_torch import graphs as GR
    from unirestore_torch import main as TMAIN
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.nn import attention_kernels as K
    from unirestore_torch.nn import grouped_conv as G
    from unirestore_torch.nn import kernels as KN
    from unirestore_torch.ops import png
    from unirestore_torch.train import engine as TE
    from unirestore_torch.train import optim as OPT
    from unirestore_torch.train import steps as TS

    # phase 1: environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power limit: {card}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # phase 2: build
    t0 = time.perf_counter()
    libs = KN.build_all()
    log(f"built {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
                log(f"  ptxas {lib.stem.split('-')[0]}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {kern.symbol: [] for kern in KN.KERNELS}

    # phase 3: kernels against their plain versions
    with torch.inference_mode():
        for kern, shape, heads in kernel_shapes(K):
            rows[kern.symbol].append(check_kernel(K, kern, shape, heads, gen))
        for shape in gconv_shapes():
            rows[G.grouped_conv3.symbol].append(check_gconv(G, shape, gen))
    backward = {kern.symbol: check_backward(K, kern, shape, heads, gen)
                for kern, shape, heads in backward_shapes(K)}
    torch.cuda.empty_cache()

    # phase 4: full-width restore in three modes, and exact on the fused route
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    t0 = time.perf_counter()
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
    n_params = sum(v.numel() for tree in (frozen, trainable)
                   for v in bridge.flatten(tree).values())
    log(f"init {n_params / 1e6:.1f} M params (bf16) in {time.perf_counter() - t0:.1f} s")
    runs, paths = run_modes(UR, KN, cfg, frozen, trainable, gen)
    graph_runs, graph_paths = run_graph_modes(UR, KN, GR, cfg, frozen, trainable, gen)
    paths.update(graph_paths)
    del frozen, trainable
    torch.cuda.empty_cache()

    # phase 5: agreement with the CPU on a small input
    reference = reference_check(UR, KN, GR, bridge, cfg)
    torch.cuda.empty_cache()

    # phase 6: the full-width stage-1 training step
    training, paths["train"] = run_training(UR, KN, bridge, TS, OPT)
    torch.cuda.empty_cache()

    # phase 7: training, card vs CPU
    training["reference"] = train_reference_check(UR, KN, bridge, TS)
    torch.cuda.empty_cache()

    # phase 8: the restore server, eager and with --cuda-graphs
    serving, paths["serve"], in_process = run_serving(KN, serve, png)
    torch.cuda.empty_cache()
    serving["cuda_graphs"], paths["serve_graph"], _ = run_serving(KN, serve, png, in_process)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as work:
        # phase 9: fit, resume and predict through the CLI; then phase 3's
        # comparison at every shape the fit met that phase 3 had not held
        fit, paths["fit"], fit_shapes = run_fit(KN, bridge, TE, TS, OPT, TMAIN.main, png,
                                                Path(work))
        fit["training_step_ms_phase6"] = training["ms_per_step"]
        fit["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, fit_shapes, rows, gen)
        log(f"fit: {fit['shapes_added_to_phase3']} (kernel, shape) pairs held to their plain "
            f"versions after the fit; CLI {fit['timed']['s_per_step'] * 1e3:.1f} ms/step at "
            f"batch {fit['timed']['batch_size']} (synchronised window) vs phase 6's "
            f"{training['ms_per_step']:.1f} ms/step at batch {BATCH}")
        torch.cuda.empty_cache()

        # phase 11: the stage-2 fit through the CLI on phase 9's smoke tree;
        # phase 3's comparison at the shapes it met that were not held yet;
        # then two stage-2 losses and the TFA gradient, card vs CPU
        t0 = time.perf_counter()
        fit2, paths["fit_stage2"], fit2_shapes = run_fit_stage2(KN, bridge, TE, TS, OPT,
                                                                TMAIN.main, Path(work))
    fit2["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, fit2_shapes, rows, gen,
                                                      path="fit_stage2")
    torch.cuda.empty_cache()
    fit2["reference"] = train2_reference_check(UR, KN, bridge, TS, TE)
    fit2["phase_seconds"] = time.perf_counter() - t0
    log(f"stage-2 fit: {fit2['shapes_added_to_phase3']} (kernel, shape) pairs held to their "
        f"plain versions after it; phase 11 took {fit2['phase_seconds']:.1f} s")
    torch.cuda.empty_cache()

    # phase 10: report; a path routes to a kernel when its expected count is not 0
    routes = {"restore": [sum(EXPECTED[m][i] for m in ("none", "encoder", "deep"))
                          for i in range(len(KN.KERNELS))],
              "restore_fused": list(EXPECTED["fused"]),
              "train": [EXPECTED_TRAIN[kern.symbol][0] for kern in KN.KERNELS],
              "serve": [sum(r[4][i] for r in SERVE_REQUESTS) for i in range(len(KN.KERNELS))]}
    routes.update(restore_graph=routes["restore"], restore_fused_graph=routes["restore_fused"],
                  serve_graph=list(SERVE_BATCH),
                  fit=[EXPECTED_TRAIN[kern.symbol][0] + FIT_RESTORE[i]
                       for i, kern in enumerate(KN.KERNELS)],
                  fit_stage2=[EXPECTED_STAGE2["ir"][kern.symbol][0] + FIT_RESTORE[i]
                              for i, kern in enumerate(KN.KERNELS)])
    entries = []
    for i, kern in enumerate(KN.KERNELS):
        r = rows[kern.symbol]
        by_path = {path: paths[path][kern.symbol] for path in routes}
        missing = [path for path, want in routes.items() if want[i] and not by_path[path]]
        if missing or not any(by_path.values()):
            raise AssertionError(f"{kern.symbol} never ran on {missing or 'any path'}: {by_path}")
        library = [x["library_ms"] for x in r]
        entry = {
            "name": kern.symbol, "route": "cuda", "status": "ported",
            "source": kernel_source(kern), "replaces": kern.replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": sum(x["ms"] for x in r), "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": max(r, key=lambda x: x["bound_ms"])["bound_by"],
            "library_ms": None if None in library else sum(library),
            "shapes": r,
        }
        for key in ("unfused_ms", "sdpa_matmul_ms", "direct_ms", "prev_ms"):
            if key in r[0]:
                entry[key] = sum(x[key] for x in r)
        if kern.symbols:  # an entry per dtype, as the wrapper routes them
            entry["symbols"] = {str(dt).removeprefix("torch."): kern.entry(dt)[0]
                                for dt in (torch.bfloat16, torch.float32)}
        if Path(entry["source"]).name in SM90_DESIGNS:
            entry["design"] = SM90_DESIGNS[Path(entry["source"]).name]
        if kern.symbol in backward:
            entry["backward"] = backward[kern.symbol]
        entries.append(entry)
    log(json.dumps({"restore": {"batch": BATCH, "res": RES, "steps": STEPS, "dtype": "bf16",
                                "runs": runs, "graph_runs": graph_runs,
                                "reference": reference}}))
    log(json.dumps({"training": training}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"fit": fit}))
    log(json.dumps({"fit_stage2": fit2}))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
