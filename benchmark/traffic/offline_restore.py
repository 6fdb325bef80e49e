"""Offline restoration: a closed loop of batches, back to back.

A mix file (``benchmark/traffic/<mix>.json``, ``"driver": "offline_restore"``)
gives ``batch``, ``height``, ``width``, ``task``, ``steps``, ``pool`` (distinct
seeded image batches, cycled, each call with fresh seeded noise),
``trace_calls`` (calls in the traced window), ``sample_batches`` (batches the
reference recomputes after the window) and ``ref_block`` (images a reference
call takes).

Each call is what an offline user's call is: the uint8 batch from pinned host
memory to the card, the restore (``graphs.GraphedRestore``, the route users
turn on with ``serve --cuda-graphs``), the answer rounded to uint8 and copied
back to the host. ``restore_img_s`` is every image completed in the window
over the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..harness import clock, program, seeds
from ..harness import trace as TR
from ..harness import weights as W
from ..reference import flops as RF
from ..reference import kernels as RK
from ..reference import model as RM


def degraded_images(gen, n: int, b: int, h: int, w: int, device) -> torch.Tensor:
    """``n`` batches of ``b`` uint8 NHWC photos-like images: smooth colour
    fields (16 x 16 seeded cells, bicubic), blurred detail and sensor noise,
    drawn on the card; returned in pinned host memory."""
    base = torch.rand((n * b, 3, 16, 16), generator=gen, device=device)
    img = F.interpolate(base, size=(h, w), mode="bicubic", align_corners=False)
    detail = torch.randn((n * b, 3, h // 4, w // 4), generator=gen, device=device)
    img = img + 0.15 * F.interpolate(detail, size=(h, w), mode="bilinear", align_corners=False)
    img = img + 0.04 * torch.randn(img.shape, generator=gen, device=device)
    u8 = (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    host = u8.permute(0, 2, 3, 1).reshape(n, b, h, w, 3).cpu()
    return host.pin_memory() if torch.device(device).type == "cuda" else host


def quantised(images: torch.Tensor) -> torch.Tensor:
    """An answer as the user receives it: clamped to [0, 1], rounded to uint8."""
    return (images.float().clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)


def compare(outs_u8: torch.Tensor, ref: torch.Tensor) -> dict:
    """The answer (uint8) against the reference (float, [0, 1] once clamped),
    in uint8 levels: the rms over every pixel, the worst image's rms, the
    largest gap."""
    diff = outs_u8.double() - ref.double().clamp(0.0, 1.0) * 255.0
    per_image = diff.square().flatten(1).mean(dim=1).sqrt()
    return {"rms_levels": diff.square().mean().sqrt().item(),
            "worst_image_rms_levels": per_image.max().item(),
            "max_levels": diff.abs().max().item()}


class Run:
    """One run of an offline-restore cell: set-up on construction, then
    ``measure`` or ``traced``, ``release`` and ``check``."""

    def __init__(self, cell: dict, seed: int, device, restore_factory=None):
        mix, conf = cell["traffic"], cell["config"]
        self.cell, self.mix, self.spec, self.device = cell, mix, conf["model"], device
        self.batch, self.steps, self.task = mix["batch"], mix["steps"], mix["task"]
        self.seed = seed
        dt = program.dtype(conf["precision"])
        self.dtype = dt
        cfg = program.config(self.spec)
        template = program.template(cfg, device, dt)
        clock.mark("model layout")
        frozen, trainable = W.draw(template, conf["weights"],
                                   seeds.derive(seed, "weights"), device, (dt, dt), cell["root"])
        del template
        self.weights = (frozen, trainable)
        clock.mark("weights")
        gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "images"))
        self.pool = degraded_images(gen, mix["pool"], self.batch, mix["height"], mix["width"],
                                    device)
        clock.mark("input pool")
        self.noise_gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "noise"))
        make = restore_factory or program.graphed_restore
        self.restore = make(frozen, trainable, cfg, device)
        clock.mark("kernels")
        self.latent = program.latent_shape(cfg, (self.batch, mix["height"], mix["width"], 3))
        self.outs, self.noises = [], []
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        # set-up: capture and a first replay of the one shape, and the copies,
        # on inputs and noise the window does not use
        warm_gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "warm-up"))
        for label in ("warm-up and capture", "first replay"):
            self._call(0, warm_gen, keep=False)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            clock.mark(label)
        self.calls = 0

    def images(self, k: int) -> torch.Tensor:
        """Pool batch ``k`` on the card as the program takes it: bf16 in [0, 1]."""
        return self.pool[k].to(self.device, non_blocking=True).to(self.dtype) / 255.0

    def _call(self, i: int, gen, keep: bool = True) -> None:
        with record_function("bench.upload"):
            x = self.images(i % self.mix["pool"])
        with record_function("bench.noise"):
            post = torch.randn(self.latent, generator=gen, device=self.device, dtype=self.dtype)
            diff = torch.randn(self.latent, generator=gen, device=self.device, dtype=self.dtype)
        with record_function("bench.restore"):
            out = self.restore(x, self.task, self.steps, post, diff)
        with record_function("bench.download"):
            self.bad += (~torch.isfinite(out)).flatten(1).any(dim=1).sum()
            u8 = quantised(out).cpu()
        if keep:
            self.outs.append(u8)
            self.noises.append((post, diff))

    def measure(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self._call(self.calls, self.noise_gen)
            self.calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"restore_img_s": self.calls * self.batch / elapsed}

    def traced(self) -> dict:
        n = self.mix["trace_calls"]

        def step(i):
            self._call(self.calls + i, self.noise_gen)

        record = TR.traced(step, n)
        self.calls += n
        record["images"] = n * self.batch
        record["flops_per_call"], record["kernel_calls_per_call"] = self.work()
        record["notes"] = {"kernel_launches": {
            k: {"predicted": len(record["kernel_calls_per_call"].get(k, [])) * n,
                "traced": record["hand_kernels"].get(k, {}).get("count", 0)}
            for k in sorted(set(record["kernel_calls_per_call"]) | set(record["hand_kernels"]))}}
        return record

    def work(self) -> tuple:
        """(tensor-core FLOPs, {hand kernel: [(operations, bytes)]}) of one
        call, on ``meta`` through the reference."""
        frozen, trainable = (W.on_meta(t) for t in self.weights)
        shape = (self.batch, self.mix["height"], self.mix["width"], 3)
        images = torch.empty(shape, device="meta")
        noise = torch.empty(self.latent, device="meta")
        record = []
        flops = RF.count(lambda: RM.restore(RM.Arith(), self.spec, frozen, trainable, images,
                                            self.task, noise, noise, self.steps, record))
        return flops, RK.kernel_calls(record)

    @property
    def attempted(self) -> int:
        return self.calls * self.batch

    def failed(self) -> int:
        return int(self.bad.item())

    def release(self) -> None:
        """Free the program's graphs; the weights stay for the reference."""
        self.restore = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The batches the reference recomputes, drawn from the seed."""
        rng = np.random.default_rng(seeds.derive(self.seed, "sample"))
        k = min(self.mix["sample_batches"], len(self.outs))
        return sorted(int(i) for i in rng.choice(len(self.outs), size=k, replace=False))

    def reference(self, i: int, arith=None) -> torch.Tensor:
        """Batch ``i`` of the window recomputed by the reference (float32 on the card)."""
        frozen, trainable = self.reference_weights
        x = self.images(i % self.mix["pool"])
        post, diff = self.noises[i]
        arith = arith or RM.Arith()
        blk = self.mix["ref_block"]
        parts = []
        with torch.no_grad():
            for s in range(0, self.batch, blk):
                parts.append(RM.restore(arith, self.spec, frozen, trainable, x[s:s + blk],
                                        self.task, post[s:s + blk], diff[s:s + blk],
                                        self.steps).cpu())
        return torch.cat(parts)

    def check(self) -> dict:
        """The comparison numbers over the sampled batches of the window."""
        self.reference_weights = tuple(W.as_float32(t) for t in self.weights)
        self.picked = self.sample()
        self.refs = torch.cat([self.reference(i) for i in self.picked])
        out = compare(torch.cat([self.outs[i] for i in self.picked]), self.refs)
        out["nonfinite_images"] = float(self.failed())
        return out

    def control(self) -> dict:
        """The same numbers of the control on the batches ``check`` compared:
        the reference in float8 e4m3 in the program's place (after ``check``)."""
        low = torch.cat([quantised(self.reference(i, RM.Fp8Arith())) for i in self.picked])
        return compare(low, self.refs)


def build(cell: dict, seed: int, device, seconds: float, trace: bool,
          restore_factory=None) -> Run:
    """The run's set-up (``seconds`` and ``trace`` are the window's; the loop
    needs neither before it starts)."""
    return Run(cell, seed, device, restore_factory)
