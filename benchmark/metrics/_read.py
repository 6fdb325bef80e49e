"""What the per-layer readers share; each reader is its own file, named as
its metric, with ``read(record) -> float | None`` (None: nothing to read)."""

from __future__ import annotations

from ..reference import kernels as RK


def idle_pct(record: dict):
    """The share of the traced window in which no device operation ran."""
    if record.get("window_s", 0) <= 0 or record.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def norm_elementwise_ms_per_img(record: dict):
    """Device ms of elementwise work and norm statistics per image."""
    if not record.get("images"):
        return None
    sec = sum(record["family_s"].get(f, 0.0) for f in RK.NORM_ELEMENTWISE)
    return 1e3 * sec / record["images"] if sec > 0 else None


def mfu(record: dict):
    """Tensor-core work of the window's calls over the window at the bf16 peak."""
    if not record.get("flops_per_call") or record.get("window_s", 0) <= 0:
        return None
    return 100.0 * record["flops_per_call"] * record["calls"] / (
        record["window_s"] * RK.PEAK_BF16_FLOPS)


def hand_kernels_roofline(record: dict):
    """The least time of the hand kernels' launches (their operations and
    bytes at the card's peaks) over their device time. Every hand kernel's
    launches in the trace have to be the calls the reference routes to it;
    where any kernel's count differs (a change of routing, or a hand kernel
    the reference does not price), nothing is read, and the record's
    ``kernel_launches`` shows both counts."""
    predicted = record.get("kernel_calls_per_call")
    seen = record.get("hand_kernels", {})
    if not predicted or not seen:
        return None
    least = seconds = 0.0
    for kern in set(predicted) | set(seen):
        calls = predicted.get(kern, [])
        launched = seen.get(kern, {"count": 0, "seconds": 0.0})
        if launched["count"] != len(calls) * record["calls"]:
            return None
        least += record["calls"] * sum(RK.least_seconds(f, b) for f, b in calls)
        seconds += launched["seconds"]
    return 100.0 * least / seconds if seconds > 0 else None
