"""On the card: each cell's control (the reference in float8 e4m3 in the
program's place) fails its limits, and the program passes them, at the
cell's own size on three seeds.

Run on the card: ``python -m pytest --noconftest -m cuda benchmark/tests``.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import manifest as M

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in M.load()["workloads"]])
def test_control_fails_and_program_passes(card, name):
    cell = M.cell(name)
    limits = cell["limits"]["checks"]
    for seed in SEEDS:
        row = calibrate.readings(cell, seed, 2.0, card)
        assert all(row["program"][k] <= v for k, v in limits.items()), row
        assert any(row["control"][k] > v for k, v in limits.items()), row
        torch.cuda.empty_cache()
