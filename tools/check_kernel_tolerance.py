#!/usr/bin/env python3
"""Show that chip_smoke.py's bf16 kernel tolerance rejects planted kernel faults.

For each fault in ``FAULTS`` this copies ``unirestore_torch/`` and
``chip_smoke.py`` into ``WORKDIR/<fault>/``, plants the fault in the copy's
``csrc/attention.cu`` (the repository's own files are never changed), builds
every copy with ``nvcc`` at once, and then runs chip_smoke's kernel-vs-plain
comparison at every main-path shape (batch 8, bf16, the same seeded inputs)
against each copy in turn. It prints one JSON line per fault and shape, and
exits 0 only if the unchanged copy (``none``) agrees at every shape and every
planted fault is rejected at every shape. Run on a machine with one CUDA
device, with a work directory outside the repository:

    python3 tools/check_kernel_tolerance.py --workdir /tmp/kernel-faults
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# fault -> exact (old, new) edits of the bf16 tensor-core kernel in attention.cu
FAULTS = {
    "none": [],
    # every key of the last 64-key tile masked: the tile drops out of the softmax
    "last_key_tile_dropped": [
        ("if (k0 + kBK > seq) {", "if (k0 + kBK >= seq) {"),
        ("if (k0 + n * 8 + 2 * t4 + (e & 1) >= seq) s[n][e] = kNegBig;",
         "s[n][e] = kNegBig;"),
    ],
    # O is not rescaled when the running maximum grows
    "accumulator_not_rescaled": [
        ("acc[n][2 * r] *= corr;", "acc[n][2 * r] *= 1.f;"),
        ("acc[n][2 * r + 1] *= corr;", "acc[n][2 * r + 1] *= 1.f;"),
    ],
    # the row sum is not rescaled when the running maximum grows
    "row_sum_not_rescaled": [("l[r] = l[r] * corr + sum;", "l[r] = l[r] + sum;")],
}


def plant(root: Path, edits) -> None:
    src = root / "unirestore_torch" / "csrc" / "attention.cu"
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} occurs {text.count(old)} times in {src}")
        text = text.replace(old, new)
    src.write_text(text)


def child(root: Path) -> int:
    """Compare each kernel of the copy at ``root`` with its plain version."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as CS
    from unirestore_torch.nn import attention_kernels as K

    assert K.SOURCE.is_relative_to(root), K.SOURCE
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for kern, shape, heads in CS.kernel_shapes(K):
            q, k, v, _ = CS.kernel_inputs(K, kern, shape, heads, gen)
            err = CS.compare_kernel(K, kern, q, k, v)
            print(json.dumps({"kernel": kern.symbol, "shape": list(shape), **err}),
                  flush=True)
            del q, k, v
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", type=Path, help="where the copies go (outside the repo)")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    if args.workdir is None:
        ap.error("--workdir is required")
    work = args.workdir.resolve()
    if work.is_relative_to(REPO):
        ap.error("--workdir must lie outside the repository")

    roots = {}
    for fault, edits in FAULTS.items():
        root = work / fault
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "unirestore_torch", root / "unirestore_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy2(REPO / "chip_smoke.py", root / "chip_smoke.py")
        plant(root, edits)
        roots[fault] = root
    builds = {fault: subprocess.Popen(
        [sys.executable, "-c",
         "from unirestore_torch.nn import attention_kernels as K; K.build()"],
        cwd=root) for fault, root in roots.items()}
    for fault, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{fault}: build failed")

    ok = True
    for fault, root in roots.items():
        res = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True, check=True)
        for line in res.stdout.splitlines():
            row = json.loads(line)
            rejected = row["tolerance_ratio"] > 1.0
            ok &= rejected == (fault != "none")
            print(json.dumps({"fault": fault, "rejected": rejected, **row}), flush=True)
    print(json.dumps({"tolerance_rejects_every_fault_and_passes_the_kernel": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
