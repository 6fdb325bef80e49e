"""The traffic drivers' draws for a fixed seed."""

from __future__ import annotations

import torch

from benchmark.harness import seeds
from benchmark.traffic import offline_restore as OR

BIG = 2**31 + 123456789  # the driver's seeds exceed 32 signed bits


def test_seeds_are_stable_and_distinct():
    assert seeds.derive(BIG, "images") == seeds.derive(BIG, "images")
    labels = ("weights", "images", "noise", "warm-up", "sample")
    assert len({seeds.derive(BIG, lab) for lab in labels}) == len(labels)
    assert seeds.derive(BIG, "noise") != seeds.derive(BIG + 1, "noise")
    assert 0 <= seeds.derive(2**40, "weights") < 2**63


def draw(seed):
    gen = torch.Generator().manual_seed(seeds.derive(seed, "images"))
    return OR.degraded_images(gen, 2, 3, 32, 48, "cpu")


def test_images_repeat_for_a_seed_and_differ_between_seeds():
    a, b, c = draw(BIG), draw(BIG), draw(BIG + 1)
    assert a.shape == (2, 3, 32, 48, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # the pool's batches differ
    assert 20 < a.float().std().item() < 120  # not flat, not noise alone


def test_compare_reads_levels():
    ref = torch.full((2, 4, 4, 3), 0.5)
    out = OR.quantised(ref)
    got = OR.compare(out, ref)
    assert abs(got["rms_levels"] - 0.5) < 1e-9  # 127.5 rounds to 128
    out[1] += 10
    got = OR.compare(out, ref)
    assert abs(got["worst_image_rms_levels"] - 10.5) < 1e-9
    assert abs(got["max_levels"] - 10.5) < 1e-9
