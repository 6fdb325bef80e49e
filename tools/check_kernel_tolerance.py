#!/usr/bin/env python3
"""Show that chip_smoke.py's bf16 kernel tolerances reject planted kernel faults.

For each fault in ``FAULTS`` this copies ``unirestore_torch/`` and
``chip_smoke.py`` into ``WORKDIR/<fault>/``, plants the fault in the copy's
CUDA source (the repository's own files are never changed), builds every
copy with ``nvcc`` at once, and then runs chip_smoke's kernel-vs-plain
comparisons at every main-path shape (batch 8, bf16, the same seeded inputs)
against each copy in turn: the four attention kernels (``csrc/attention.cu``)
and the grouped conv (``csrc/grouped_conv.cu``). It prints one JSON line per
fault, kernel and shape, and exits 0 only if the unchanged copy (``none``)
agrees at every shape and every planted fault is rejected at every shape of
the kernels it reaches: those of the source it was planted in, or the one
kernel a fault names. Run on a machine with one CUDA device, with a work
directory outside the repository:

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
ATTENTION, GCONV = "attention.cu", "grouped_conv.cu"

# fault -> (source in csrc/, exact (old, new) edits of its bf16 tensor-core
# kernel); a fault of one kernel only names it in ``ONLY``
FAULTS = {
    "none": (None, []),
    # every key of the last 64-key tile masked: the tile drops out of the softmax
    "last_key_tile_dropped": (ATTENTION, [
        ("if (k0 + kBK > seq) {", "if (k0 + kBK >= seq) {"),
        ("if (k0 + n * 8 + 2 * t4 + (e & 1) >= seq) s[n][e] = kNegBig;",
         "s[n][e] = kNegBig;"),
    ]),
    # O is not rescaled when the running maximum grows
    "accumulator_not_rescaled": (ATTENTION, [
        ("acc[n][2 * r] *= corr;", "acc[n][2 * r] *= 1.f;"),
        ("acc[n][2 * r + 1] *= corr;", "acc[n][2 * r + 1] *= 1.f;"),
    ]),
    # the row sum is not rescaled when the running maximum grows
    "row_sum_not_rescaled": (ATTENTION, [("l[r] = l[r] * corr + sum;", "l[r] = l[r] + sum;")]),
    # the out-projection-fused kernel: the first head's output left out of the
    # shared O tile (its slot holds zeros); the fault below drops the last
    # 64 rows of wo, so the two leave out different terms of the product
    "out_head_left_out": (ATTENTION, [
        ("attend_mma<64, 64>(q + base, k + base, v + base, q0, seq, inner, qs, ks, vs, acc, l);",
         "attend_mma<64, 64>(q + base, k + base, v + base, q0, seq, inner, qs, ks, vs, acc, l);\n"
         "    if (h == 0)\n"
         "      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;"),
    ]),
    # the out-projection-fused kernel: the last 64-row K-chunk of wo adds
    # nothing to the epilogue product
    "out_last_k_chunk_dropped": (ATTENTION, [
        ("for (int kk = 0; kk < kKC / 16; ++kk) {",
         "for (int kk = 0; kk < (kc == k_chunks - 1 ? 0 : kKC / 16); ++kk) {"),
    ]),
    # the last tap (dy = dx = 2) adds nothing
    "gconv_tap_dropped": (GCONV, [
        ("for (int kk = 0; kk < KS; ++kk) {", "for (int kk = 0; kk < (tap == 8 ? 0 : KS); ++kk) {"),
    ]),
    # the halo row below the tile is zero-filled (its bound off by one row)
    "gconv_halo_row_off_by_one": (GCONV, [
        ("const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;\n    cp_async16(",
         "const bool ok = yy >= 0 && yy < y0 + kTH && yy < H && xx >= 0 && xx < W;\n"
         "    cp_async16("),
    ]),
}
ONLY = {"out_head_left_out": "ur_attention_btc_out",
        "out_last_k_chunk_dropped": "ur_attention_btc_out"}


def plant(root: Path, source: str | None, edits) -> None:
    if source is None:
        return
    src = root / "unirestore_torch" / "csrc" / source
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
    from unirestore_torch.nn import grouped_conv as G

    assert K.SOURCE.is_relative_to(root) and G.SOURCE.is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for kern, shape, heads in CS.kernel_shapes(K):
            xs, _ = CS.kernel_inputs(K, kern, shape, heads, gen)
            err = CS.compare_kernel(kern, *xs)
            print(json.dumps({"kernel": kern.symbol, "source": ATTENTION, "shape": list(shape),
                              **err}), flush=True)
            del xs
        for shape in CS.gconv_shapes():
            err = CS.compare_gconv(G, *CS.gconv_inputs(shape, gen))
            print(json.dumps({"kernel": G.grouped_conv3.symbol, "source": GCONV,
                              "shape": list(shape), **err}), flush=True)
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
    for fault, (source, edits) in FAULTS.items():
        root = work / fault
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "unirestore_torch", root / "unirestore_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy2(REPO / "chip_smoke.py", root / "chip_smoke.py")
        plant(root, source, edits)
        roots[fault] = root
    builds = {fault: subprocess.Popen(
        [sys.executable, "-c", "from unirestore_torch.nn import kernels; kernels.build_all()"],
        cwd=root) for fault, root in roots.items()}
    for fault, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{fault}: build failed")

    ok = True
    for fault, root in roots.items():
        source = FAULTS[fault][0]
        res = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True, check=True)
        for line in res.stdout.splitlines():
            row = json.loads(line)
            if source is not None and row["source"] != source:
                continue  # the other source is unchanged in this copy
            if fault in ONLY and row["kernel"] != ONLY[fault]:
                continue  # the fault lies in another kernel's code
            rejected = row["tolerance_ratio"] > 1.0
            ok &= rejected == (fault != "none")
            print(json.dumps({"fault": fault, "rejected": rejected, **row}), flush=True)
    print(json.dumps({"tolerance_rejects_every_fault_and_passes_the_kernel": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
