#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unirestore_torch``) once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. environment: card name, ``nvidia-smi`` name and power limit, TF32 off;
2. build the CUDA kernels from ``unirestore_torch/csrc/`` with ``nvcc``;
3. each kernel against its plain PyTorch version at every shape the 512 px
   restore gives it (batch 8, bf16), with kernel, plain, library
   (``scaled_dot_product_attention``, timed as a yardstick only) and bound
   times;
4. the full-width restore (sd-turbo widths, seeded init, 512 px, batch 8,
   bf16, 20 DDIM steps) in the exact, encoder (stride 2) and deep (stride
   17, warmup 3) modes: finite outputs, launch counts equal to the counts the
   routing implies, img/s, and PSNR of each cached mode against exact;
5. the same widths on a 256 px input in fp32, on the card and on the CPU
   (where the kernels' plain versions run): the outputs must agree;
6. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``. Per kernel,
   ``launches`` is the sum over phase 4's three restores; ``ms``,
   ``plain_ms``, ``bound_ms`` and ``library_ms`` are sums of one call at each
   of its main-path shapes, which ``shapes`` lists one by one.

It needs one CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
BATCH = 8
RES = 512
STEPS = 20
MODES = (("none", 2, 0), ("encoder", 2, 0), ("deep", 17, 3))
# launches per 512 px restore at 20 steps: (btc, bh, stream)
EXPECTED = {"none": (280, 140, 2), "encoder": (200, 100, 2), "deep": (136, 28, 2)}
# bf16 kernel vs plain: attention_kernels.bf16_tolerance_ratio(out, ref) <= 1,
# i.e. |out - ref| <= 2^-7 |ref| + 0.03 rms(ref) elementwise (one bf16 ulp of
# the output plus the probabilities' rounding; the reasoning is beside it).
# fp32 card vs CPU over the whole restore: other conv algorithms and summation
# orders (about 1e-6 relative), amplified by the t=999 DDIM update
# (1/sqrt(alpha_bar)); sound runs read about 4e-6.
REFERENCE_ATOL = 1e-4
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_shapes(K):
    """(kernel, q shape, heads) at every shape the 512 px restore gives each kernel."""
    b = BATCH
    return [
        (K.fused_attention_btc_prescaled, (b, 4096, 320), 5),   # UNet level 0
        (K.fused_attention_btc_prescaled, (b, 1024, 640), 10),  # UNet level 1
        (K.fused_attention_btc_prescaled, (b, 4096, 256), 4),   # Controller stage 0
        (K.fused_attention_btc_prescaled, (b, 1024, 256), 4),   # Controller stage 1
        (K.fused_attention_bh_prescaled, (b * 20, 256, 64), 1),  # UNet level 2
        (K.fused_attention_bh_prescaled, (b * 4, 256, 128), 1),  # Controller stage 2
        (K.streaming_attention_bh_prescaled, (b, 4096, 512), 1),  # VAE mid block
    ]


def kernel_inputs(K, kern, shape, heads, gen):
    """Seeded bf16 q (prescaled by d^-1/2 log2 e), k, v on the card, and the head width d."""
    d = shape[2] // heads if kern is K.fused_attention_btc_prescaled else shape[2]
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    return (q.float() * (d ** -0.5 * K.LOG2E)).to(torch.bfloat16), k, v, d


def compare_kernel(K, kern, q, k, v) -> dict:
    """The kernel against its plain version on the same inputs."""
    out = kern(q, k, v)
    ref = kern.plain(q, k, v)
    diff = out.float() - ref.float()
    return {"max_abs_err": diff.abs().max().item(),
            "rms_err_over_rms_ref": (diff.square().mean().sqrt()
                                     / ref.float().square().mean().sqrt()).item(),
            "tolerance_ratio": K.bf16_tolerance_ratio(out, ref)}


def check_kernel(K, kern, shape, heads, gen):
    n, t, _ = shape
    q, k, v, d = kernel_inputs(K, kern, shape, heads, gen)
    err = compare_kernel(K, kern, q, k, v)
    if err["tolerance_ratio"] > 1.0:
        raise AssertionError(f"{kern.symbol} {shape}: kernel and plain version disagree: "
                             f"{err}")

    def split(x):  # (n, t, heads*d) -> (n, heads, t, d)
        return x.view(n, t, heads, d).transpose(1, 2)

    ms = cuda_ms(lambda: kern(q, k, v), 10)
    plain_ms = cuda_ms(lambda: kern.plain(q, k, v), 3)
    # q is prescaled by d^-1/2 log2(e): softmax_e(x ln 2) == softmax_2(x)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        split(q), split(k), split(v), scale=math.log(2.0)), 10)
    flops = 4.0 * n * heads * t * t * d
    nbytes = 4.0 * q.numel() * q.element_size()
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    row = {"shape": list(shape), "heads": heads, "d": d, **err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {kern.symbol} {tuple(shape)} d={d}: max_abs {err['max_abs_err']:.3e} "
        f"rms_err/rms_ref {err['rms_err_over_rms_ref']:.2e} tolerance ratio "
        f"{err['tolerance_ratio']:.3f} | {ms:.3f} ms ({row['tflops']:.1f} TFLOP/s) "
        f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


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


def make_params(UR, bridge, cfg, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frozen, trainable = UR.init(cfg, gen, device="cuda", dtype=dtype)
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
    """A seeded 512 px bf16 batch, and ``restore(cfg, steps)`` of it with seeded noise."""
    sched = UR.schedule(cfg, device="cuda")
    images = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda").to(torch.bfloat16)
    lat = (BATCH, RES // 8, RES // 8, cfg.vae.latent_channels)
    post = torch.randn(lat, generator=gen, device="cuda", dtype=torch.bfloat16)
    diff = torch.randn(lat, generator=gen, device="cuda", dtype=torch.bfloat16)

    def restore(c, steps):  # 512 px needs no resize or pad: restore_padded runs as is
        return UR.restore(frozen, trainable, c, sched, images, "ir",
                          num_inference_steps=steps, posterior_noise=post,
                          diffusion_noise=diff, device="cuda")

    return images, restore


def run_modes(UR, K, cfg, frozen, trainable, gen):
    images, restore = restore_inputs(UR, cfg, frozen, trainable, gen)
    t0 = time.perf_counter()
    restore(cfg, 1)  # warm-up: lazy library init, every shape once
    torch.cuda.synchronize()
    log(f"warm-up restore (1 step): {time.perf_counter() - t0:.2f} s")

    outs, results, launches = {}, {}, {kern.symbol: 0 for kern in K.KERNELS}
    for mode, stride, warmup in MODES:
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride, cache_warmup=warmup)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(c, STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = tuple(kern.launches for kern in K.KERNELS)
        for kern in K.KERNELS:
            launches[kern.symbol] += kern.launches
        if out.shape != images.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{mode}: output shape {tuple(out.shape)} or non-finite values")
        if counts != EXPECTED[mode]:
            raise AssertionError(f"{mode}: launches {counts} != expected {EXPECTED[mode]}")
        outs[mode] = out
        results[mode] = {"stride": stride, "warmup": warmup, "seconds": sec,
                         "img_per_s": BATCH / sec, "launches": counts,
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"restore {mode} (stride {stride}, warmup {warmup}): {sec:.3f} s, "
            f"{BATCH / sec:.3f} img/s, launches btc/bh/stream {counts}, "
            f"peak {results[mode]['peak_mem_gib']:.1f} GiB")
    for mode in ("encoder", "deep"):
        results[mode]["psnr_vs_exact"] = psnr_u8(outs["none"], outs[mode])
        log(f"{mode} PSNR vs exact: {results[mode]['psnr_vs_exact']:.2f} dB")
    return results, launches


def reference_check(UR, K, bridge, cfg):
    """Full widths, 256 px, fp32, 2 steps: card (kernels) vs CPU (plain versions)."""
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.rand((1, 256, 256, 3), generator=gen, device="cuda")
    lat = (1, 32, 32, cfg.vae.latent_channels)
    post = torch.randn(lat, generator=gen, device="cuda")
    diff = torch.randn(lat, generator=gen, device="cuda")

    def run(device, tree_f, tree_t):
        return UR.restore_padded(tree_f, tree_t, cfg, UR.schedule(cfg), images.to(device),
                                 "seg", num_inference_steps=2,
                                 posterior_noise=post.to(device),
                                 diffusion_noise=diff.to(device), device=device)

    def to_cpu(tree):
        return bridge.unflatten_like({k: v.cpu() for k, v in bridge.flatten(tree).items()},
                                     tree)

    K.reset_launches()
    gpu = run("cuda", frozen, trainable).cpu()
    counts = tuple(kern.launches for kern in K.KERNELS)
    t0 = time.perf_counter()
    cpu = run("cpu", to_cpu(frozen), to_cpu(trainable))
    err = (gpu - cpu).abs().max().item()
    log(f"reference 256 px fp32, 2 steps: card vs CPU max abs {err:.3e} "
        f"(tolerance {REFERENCE_ATOL}), card launches btc/bh/stream {counts}, "
        f"CPU {time.perf_counter() - t0:.1f} s")
    if not (torch.isfinite(gpu).all() and err <= REFERENCE_ATOL):
        raise AssertionError(f"card and CPU restores differ: max abs {err:.3e}")
    if min(counts) == 0:
        raise AssertionError(f"a kernel did not run in the reference restore: {counts}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from unirestore_torch import bridge
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.nn import attention_kernels as K

    # phase 1: environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = K.build()
    K.library()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
            log(f"  ptxas: {line.strip()}")

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {kern.symbol: [] for kern in K.KERNELS}
    with torch.inference_mode():
        for kern, shape, heads in kernel_shapes(K):
            rows[kern.symbol].append(check_kernel(K, kern, shape, heads, gen))
    torch.cuda.empty_cache()

    # phase 4: full-width restore in three modes
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    t0 = time.perf_counter()
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
    n_params = sum(v.numel() for tree in (frozen, trainable)
                   for v in bridge.flatten(tree).values())
    log(f"init {n_params / 1e6:.1f} M params (bf16) in {time.perf_counter() - t0:.1f} s")
    modes, launches = run_modes(UR, K, cfg, frozen, trainable, gen)
    del frozen, trainable
    torch.cuda.empty_cache()

    # phase 5: agreement with the CPU on a small input
    ref_err = reference_check(UR, K, bridge, cfg)

    # phase 6: report
    entries = []
    for kern in K.KERNELS:
        r = rows[kern.symbol]
        if launches[kern.symbol] == 0:
            raise AssertionError(f"{kern.symbol} never ran on the restore path")
        entries.append({
            "name": kern.symbol, "route": "cuda", "status": "ported",
            "source": "unirestore_torch/csrc/attention.cu", "replaces": kern.replaces,
            "launches": launches[kern.symbol],
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": sum(x["ms"] for x in r), "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": r[0]["bound_by"],
            "library_ms": sum(x["library_ms"] for x in r),
            "shapes": r,
        })
    log(json.dumps({"restore": {"batch": BATCH, "res": RES, "steps": STEPS, "dtype": "bf16",
                                "modes": modes, "reference_max_abs_err": ref_err}}))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
