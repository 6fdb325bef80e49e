#!/usr/bin/env python3
"""Readings that set a cell's correctness limits: the program's and the control's.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: the cell's set-up, a window of ``--seconds``,
then the comparison numbers of the program's answers against the float32
reference (the lower readings), and of the control's, the same reference
computed with every product's operands in float8 e4m3 in the program's place,
its answers delivered as the program's are (the upper readings). Prints
one JSON line a seed. Needs the card; the limits in
``benchmark/workloads/<cell>.json`` are set from these readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell: dict, seed: int, seconds: float, device) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    from benchmark.harness import manifest as M

    run = M.driver(cell["traffic"]["driver"]).build(cell, seed, device, seconds, False)
    run.measure(seconds)
    run.release()
    return {"seed": seed, "program": run.check(), "control": run.control()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import manifest as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = M.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = readings(cell, seed, args.seconds, device)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
