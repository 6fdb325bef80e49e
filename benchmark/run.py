#!/usr/bin/env python3
"""Run one cell of the benchmark of ``unirestore_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's number of CUDA
cards. With ``--trace 0`` it measures the cell's end-to-end metrics over a
window of ``--seconds``; with ``--trace 1`` its per-layer metrics over a
profiled window. Either way it then checks the window's answers against the
plain reference (``benchmark/reference``) and prints, as its last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (``breakdown`` and the driver's ``notes`` when
traced) and ``checks`` (each number compared with its limit), which also
close standard error. It exits
non-zero, printing no result, without the cards, without the program, or
with JAX or the JAX package loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def run_cell(cell: dict, args, device, **test_hooks) -> dict:
    """Set-up, the window, the check: the result line's object (without
    ``device`` beyond the memory peak, which the caller completes).
    ``test_hooks`` go to the driver's ``build`` (the CPU tests' broken paths)."""
    import torch

    from benchmark.harness import clock
    from benchmark.harness import manifest as M

    driver = M.driver(cell["traffic"]["driver"])
    clock.mark("harness and program imports")
    run = driver.build(cell, args.seed, device, args.seconds, bool(args.trace), **test_hooks)
    setup_s = clock.process_age()
    result = {"metrics": {}}
    if args.trace:
        record = run.traced()
        for metric in cell["per_layer"]:
            value = M.reader(metric["name"], cell["root"])(record)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["device_trace"] = {"busy_s": record["busy_s"], "window_s": record["window_s"]}
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}
        if "notes" in record:
            result["notes"] = record["notes"]
    else:
        measured = {**run.measure(args.seconds), "setup_s": setup_s}
        for metric in cell["end_to_end"]:
            result["metrics"][metric["name"]] = {"value": measured[metric["name"]],
                                                 "unit": metric["unit"]}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    result["attempted"], result["failed"] = run.attempted, run.failed()
    run.release()
    readings = run.check()
    limits = cell["limits"]["checks"]
    result["checks"] = {name: {"value": readings[name], "limit": limit}
                        for name, limit in limits.items()}
    result["correct"] = bool(limits) and all(
        readings[name] <= limit for name, limit in limits.items())
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    # the program's kernel caches stay at fixed paths inside the checkout
    # (its own nvcc builds: unirestore_torch/_build)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import clock

    clock.mark("interpreter start")
    import torch

    clock.mark("torch import")
    from benchmark.harness import guard
    from benchmark.harness import manifest as M

    cell = M.cell(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"cell {args.workload} needs {chips} CUDA card(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.zeros((), device=device)
    clock.mark("CUDA start")
    t0 = time.perf_counter()
    result = run_cell(cell, args, device)
    found = guard.forbidden_loaded()
    if found:
        return fail(f"the process loaded {', '.join(found)}; no result")
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": result.pop("memory_peak_bytes")}
    device_info.update(result.pop("device_trace", {}))
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"], "device": device_info}
    for key in ("breakdown", "notes"):
        if key in result:
            out[key] = result[key]
    out["checks"] = result["checks"]
    print(clock.stages(), file=sys.stderr)
    if "notes" in out:
        print(f"notes: {json.dumps(out['notes'])}", file=sys.stderr)
    print(f"run {time.perf_counter() - t0:.1f} s after set-up began", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
