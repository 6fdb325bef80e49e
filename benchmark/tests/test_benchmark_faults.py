"""A run with its timed path broken underneath must come out not correct.

Each test drives the rest of a run of a tiny cell on the CPU (the look for a
card skipped), with the cell's real limits, through a program that carries
one fault the cell can have: an answer altered where it is produced, and
half of the batch left out (its answers those of the other half). One chip,
so no exchange between chips to leave out; a restore keeps no state from
call to call, so there is no state to leave unchanged. The sound program
comes out correct.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import run as RUN
from benchmark.harness import manifest as M
from benchmark.harness import program
from benchmark.tests import tiny


def altered(make):
    def factory(*a):
        restore = make(*a)

        def call(x, task, steps, post, diff):
            out = restore(x, task, steps, post, diff).clone()
            out[-1, : out.shape[1] // 2] += 0.05  # half of one image, 12.75 levels
            return out
        return call
    return factory


def half_left_out(make):
    def factory(*a):
        restore = make(*a)

        def call(x, task, steps, post, diff):
            h = x.shape[0] // 2
            out = restore(x[:h], task, steps, post[:h], diff[:h])
            return torch.cat([out, out])
        return call
    return factory


@pytest.mark.parametrize("cell", list(tiny.CELLS))
@pytest.mark.parametrize("fault,correct", [(None, True), (altered, False),
                                           (half_left_out, False)])
def test_fault_comes_out_not_correct(tmp_path, cell, fault, correct):
    root, name = tiny.make_root(tmp_path, cell)
    factory = program.eager_restore if fault is None else fault(program.eager_restore)
    result = RUN.run_cell(M.cell(name, root), tiny.args(), tiny.CPU, restore_factory=factory)
    assert result["correct"] is correct, result["checks"]
