"""The plain reference against the program's CPU path at the test widths.

The one place beside ``harness/program.py`` where the program is imported:
the reference itself imports nothing of it (checked here too).
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from benchmark.harness import program, seeds
from benchmark.harness import weights as W
from benchmark.reference import flops as RF
from benchmark.reference import kernels as RK
from benchmark.reference import model as RM
from benchmark.tests import tiny

REFERENCE = Path(RM.__file__).resolve().parent


def setup(config: str, seed: int = 11):
    conf = tiny.tiny_spec(config)
    cfg = program.config(conf["model"])
    frozen, trainable = W.draw(program.template(cfg), conf["weights"],
                               seeds.derive(seed, "weights"), tiny.CPU,
                               (torch.float32, torch.float32), tiny.REPO)
    gen = torch.Generator().manual_seed(seed)
    # 128 px: at 64 px the UNet's deepest level is 1 x 1, where GroupNorm
    # normalises groups of one or two values and magnifies rounding by ~300
    images = torch.rand((2, 128, 128, 3), generator=gen)
    lat = program.latent_shape(cfg, images.shape)
    post, diff = torch.randn(lat, generator=gen), torch.randn(lat, generator=gen)
    return conf, cfg, frozen, trainable, images, post, diff


@pytest.mark.parametrize("config,steps,task", [
    ("unirestore-sdturbo", 1, "ir"), ("unirestore-sdturbo", 2, "seg"),
    ("unirestore-sdturbo-spade", 4, "ir"), ("unirestore-sdturbo-spade", 1, "cls"),
])
def test_reference_is_the_programs_restore(config, steps, task):
    conf, cfg, frozen, trainable, images, post, diff = setup(config)
    got = program.eager_restore(frozen, trainable, cfg, tiny.CPU)(images, task, steps, post,
                                                                   diff)
    with torch.no_grad():
        ref = RM.restore(RM.Arith(), conf["model"], frozen, trainable, images, task, post, diff,
                         steps)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


def test_float8_control_departs_from_the_reference():
    conf, cfg, frozen, trainable, images, post, diff = setup("unirestore-sdturbo", 12)
    with torch.no_grad():
        ref = RM.restore(RM.Arith(), conf["model"], frozen, trainable, images, "ir", post,
                         diff, 1)
        low = RM.restore(RM.Fp8Arith(), conf["model"], frozen, trainable, images, "ir", post,
                         diff, 1)
    rel = ((low - ref).square().mean() / ref.square().mean()).sqrt().item()
    assert 1e-3 < rel < 0.5


def test_meta_count_matches_the_kernel_formulas():
    """FLOPs on meta: attention's share is the closed form of its calls."""
    conf = tiny.tiny_spec("unirestore-sdturbo")
    cfg = program.config(conf["model"])
    frozen, trainable = program.template(cfg)
    images = torch.empty((2, 64, 64, 3), device="meta")
    noise = torch.empty(program.latent_shape(cfg, images.shape), device="meta")
    record = []
    total = RF.count(lambda: RM.restore(RM.Arith(), conf["model"], frozen, trainable, images,
                                        "ir", noise, noise, 1, record))
    attn = [op for op in record if op["op"] == "attention"]
    assert total > sum(4 * a["b"] * a["heads"] * a["t"] * a["s"] * a["d"] for a in attn) > 0


def test_full_width_calls_reach_the_kernels():
    """At 512 px, batch 8, one step: the attention calls and grouped
    convolutions the program's routing sends to each hand kernel (PERF.md's
    launches per restore: 14 channel-flat, 7 head-major, 2 streaming, 3
    grouped conv), and the work of a batch (as `diagnostics/flops.py` counts it: encode 11.27
    + decode 23.48 + one step 7.29 TFLOP)."""
    import json
    conf = json.loads((tiny.REPO / "benchmark" / "configs" / "unirestore-sdturbo.json")
                      .read_text())
    cfg = program.config(conf["model"])
    frozen, trainable = program.template(cfg)
    images = torch.empty((8, 512, 512, 3), device="meta")
    noise = torch.empty(program.latent_shape(cfg, images.shape), device="meta")
    record = []
    total = RF.count(lambda: RM.restore(RM.Arith(), conf["model"], frozen, trainable, images,
                                        "ir", noise, noise, 1, record))
    calls = RK.kernel_calls(record)
    assert {k: len(v) for k, v in calls.items()} == {
        "attention_btc_sm90": 14, "attention_bh_sm90": 7, "attention_stream_sm90": 2,
        "gconv3_sm90": 3}
    assert abs(total / 1e12 - (11.27 + 23.48 + 7.29)) < 0.05


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("unirestore_torch", "unirestore_tpu", "jax",
                                                  "flax", "benchmark"), (path.name, name)
