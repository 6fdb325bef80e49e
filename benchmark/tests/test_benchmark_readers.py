"""The per-layer readers on hand-made records."""

from __future__ import annotations

import pytest

from benchmark.metrics import _read as R
from benchmark.reference import kernels as RK

CALLS = {"attention_btc_sm90": [(4e12, 1e9)] * 2, "gconv3_sm90": [(1e9, 3.35e9)]}


def record(**launched):
    hand = {k: {"count": n, "seconds": 0.01 * n} for k, n in launched.items()}
    return {"calls": 3, "kernel_calls_per_call": CALLS, "hand_kernels": hand}


def test_roofline_prices_the_predicted_launches():
    got = R.hand_kernels_roofline(record(attention_btc_sm90=6, gconv3_sm90=3))
    least = 3 * (2 * RK.least_seconds(4e12, 1e9) + RK.least_seconds(1e9, 3.35e9))
    assert got == pytest.approx(100.0 * least / 0.09)


@pytest.mark.parametrize("launched", [
    {"attention_btc_sm90": 5, "gconv3_sm90": 3},  # a call routed elsewhere
    {"attention_btc_sm90": 6},  # a predicted kernel never launched
    {"attention_btc_sm90": 6, "gconv3_sm90": 3, "attention_out_sm90": 3},  # unpriced kernel
])
def test_roofline_reads_nothing_where_launches_differ(launched):
    assert R.hand_kernels_roofline(record(**launched)) is None


def test_roofline_reads_nothing_without_hand_kernels():
    assert R.hand_kernels_roofline(record()) is None
