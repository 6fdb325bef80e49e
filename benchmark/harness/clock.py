"""The set-up clock: seconds since the process started, and the marks that
split a run's set-up into its stages (printed on standard error)."""

from __future__ import annotations

import os

MARKS: list = []


def process_age() -> float:
    """Seconds since this process started, its interpreter start included."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def mark(label: str) -> None:
    """Note that set-up stage ``label`` ended now."""
    MARKS.append((label, process_age()))


def stages() -> str:
    """The set-up's stages as one line: each stage's seconds."""
    out, last = [], 0.0
    for label, t in MARKS:
        out.append(f"{label} {t - last:.2f}")
        last = t
    return "set-up stages (s): " + ", ".join(out)
