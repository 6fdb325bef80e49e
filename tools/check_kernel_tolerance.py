#!/usr/bin/env python3
"""Show that chip_smoke.py's bf16 kernel tolerances reject planted kernel faults.

For each fault in ``FAULTS`` this copies ``unirestore_torch/`` and
``chip_smoke.py`` into ``WORKDIR/<fault>/``, plants the fault in the copy's
CUDA source (the repository's own files are never changed), builds every
copy with ``nvcc`` at once, and then runs chip_smoke's kernel-vs-plain
comparisons at every main-path shape (batch 8, bf16, the same seeded inputs),
and the head-major kernel also at ``MASKED_SHAPES``, against each copy in
turn: the four attention kernels (bf16 channel-flat launches in
``csrc/attention_sm90.cu``, bf16 wide-head launches in
``csrc/attention_stream_sm90.cu``, bf16 head-major launches in
``csrc/attention_bh_sm90.cu``, the others in ``csrc/attention.cu``) and, at
the three restore shapes, the grouped conv (its bf16 launches in
``csrc/grouped_conv_sm90.cu``) and the bf16 ``mma.sync`` entry of
``csrc/grouped_conv.cu`` that the Hopper kernel replaced, called directly
(``"entry": "prev"``), so that that source's faults stay checked. It prints
one JSON line per fault, kernel and shape, and exits 0 only if the unchanged
copy (``none``) agrees
at every shape and every planted fault is rejected at every shape of the
kernels it reaches: those whose bf16 launches run the source it was planted
in (the source each wrapper's bf16 entry names), or the ones a fault names
in ``ONLY``; a fault of the masked tail (``MASKED_ONLY``) reaches only the
shapes whose T is not a multiple of 64, since no other has keys to mask. A fault that stops a kernel it reaches with a CUDA
error, raised by that kernel's own launch or the synchronisation right
after it, counts as rejected, with the kernel and the error in its line
(the copy's later lines are lost with the CUDA context). Any other failure
of a copy (a Python error, an error in another kernel, a non-zero exit
without such a line) fails the check. Run on a machine with one CUDA
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
ATTENTION, ATTENTION_SM90, GCONV = "attention.cu", "attention_sm90.cu", "grouped_conv.cu"
ATTENTION_STREAM_SM90 = "attention_stream_sm90.cu"
ATTENTION_BH_SM90 = "attention_bh_sm90.cu"
GCONV_SM90 = "grouped_conv_sm90.cu"

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
    # ur_attention_btc_sm90: the last key tile's TMA load is not issued and
    # its full barrier is arrived on by hand, so its ring stage still holds
    # the tile kStages before it (the same wrong answer on every run)
    "sm90_last_tile_load_skipped": (ATTENTION_SM90, [
        ("        mbar_expect_tx(full_bar(s), 2 * kTileBytes);\n",
         "        if (j == n_tiles - 1) {\n"
         "          mbar_arrive(full_bar(s));\n"
         "          continue;\n"
         "        }\n"
         "        mbar_expect_tx(full_bar(s), 2 * kTileBytes);\n"),
    ]),
    # ur_attention_btc_sm90: V's descriptor strides 8-key groups by 512 bytes,
    # not 1024, so keys 8-15 of each 16-key step take V rows 4-11; every read
    # stays inside the V tile
    "sm90_v_descriptor_sbo_halved": (ATTENTION_SM90, [
        ("wgmma_m64n64k16_rs(oacc, p[kk], desc_sw128(v_tile(st) + 2048 * kk));",
         "wgmma_m64n64k16_rs(oacc, p[kk], (desc_sw128(v_tile(st) + 2048 * kk)"
         " & ~(0x3FFFull << 32)) | (uint64_t(512 >> 4) << 32));"),
    ]),
    # ur_attention_btc_sm90: O is not rescaled when the running maximum grows
    "sm90_accumulator_not_rescaled": (ATTENTION_SM90, [
        ("oacc[4 * n + 2 * r] *= corr[r];", "oacc[4 * n + 2 * r] *= 1.f;"),
        ("oacc[4 * n + 2 * r + 1] *= corr[r];", "oacc[4 * n + 2 * r + 1] *= 1.f;"),
    ]),
    # ur_attention_stream_sm90: the last K chunk (the last 64 columns of the
    # last key tile) is not loaded, so the K slot still holds the previous
    # tile's chunk there (the same wrong answer on every run)
    "stream_sm90_last_k_chunk_load_skipped": (ATTENTION_STREAM_SM90, [
        ("        mbar_expect_tx(full_k, kChunkBytes * NC);\n"
         "        for (int c = 0; c < NC; ++c)\n",
         "        const int nk = j == n_tiles - 1 ? NC - 1 : NC;\n"
         "        mbar_expect_tx(full_k, kChunkBytes * nk);\n"
         "        for (int c = 0; c < nk; ++c)\n"),
    ]),
    # ur_attention_stream_sm90: O is not rescaled when the running maximum grows
    "stream_sm90_accumulator_not_rescaled": (ATTENTION_STREAM_SM90, [
        ("oacc[i][4 * n + 2 * r] *= corr[r];", "oacc[i][4 * n + 2 * r] *= 1.f;"),
        ("oacc[i][4 * n + 2 * r + 1] *= corr[r];", "oacc[i][4 * n + 2 * r + 1] *= 1.f;"),
    ]),
    # ur_attention_stream_sm90: the second consumer's V chunks offset by one,
    # so its first column chunk is computed from the first consumer's last V
    # chunk (every read stays inside the tile's V chunks, which both
    # consumers hold until both products end)
    "stream_sm90_v_chunks_offset": (ATTENTION_STREAM_SM90, [
        ("const uint32_t base = v_slot(j) + kChunkBytes * (w * NO);",
         "const uint32_t base = v_slot(j) + kChunkBytes * (w * NO - w);"),
    ]),
    # ur_attention_stream_sm90: the second consumer does not add the first
    # one's partial S, so its softmax and columns see half of d
    "stream_sm90_partner_partial_not_added": (ATTENTION_STREAM_SM90, [
        ("for (int i = 0; i < 32; ++i) s[i] += other[128 * i];",
         "for (int i = 0; i < 32; ++i) s[i] += w == 1 ? 0.f : other[128 * i];"),
    ]),
    # ur_attention_bh_sm90: the keys past T in the zero-filled last tile are
    # not masked, so each counts at logit 0 (q . 0) in the row sum
    "bh_sm90_tail_keys_not_masked": (ATTENTION_BH_SM90, [
        ("      if (j * kBN + kBN > seq) mask_tail(s, j * kBN, seq, t4);\n", ""),
    ]),
    # ur_attention_bh_sm90: the last K/V tile's load is skipped and its stage
    # holds the tile before it (loaded in its place, so that every run gives
    # the same wrong answer)
    "bh_sm90_last_tile_stale": (ATTENTION_BH_SM90, [
        ("tma_load_3d(k_stage(st) + kChunkBytes * c, &tk, full_k(st), c * kChunk, j * kBN, bh);",
         "tma_load_3d(k_stage(st) + kChunkBytes * c, &tk, full_k(st), c * kChunk,\n"
         "                      (j == n_tiles - 1 ? j - 1 : j) * kBN, bh);"),
        ("tma_load_3d(v_stage(st) + kChunkBytes * c, &tv, full_v(st), c * kChunk, j * kBN, bh);",
         "tma_load_3d(v_stage(st) + kChunkBytes * c, &tv, full_v(st), c * kChunk,\n"
         "                      (j == n_tiles - 1 ? j - 1 : j) * kBN, bh);"),
    ]),
    # ur_attention_bh_sm90: O is not rescaled when the running maximum grows
    "bh_sm90_accumulator_not_rescaled": (ATTENTION_BH_SM90, [
        ("oacc[c][4 * n + 2 * r] *= corr[r];", "oacc[c][4 * n + 2 * r] *= 1.f;"),
        ("oacc[c][4 * n + 2 * r + 1] *= corr[r];", "oacc[c][4 * n + 2 * r + 1] *= 1.f;"),
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
    # ur_grouped_conv3_sm90: the last tap (dy = dx = 2) adds nothing (in
    # both of its kernels: M1 at cg <= 32, M2 above)
    "gconv_sm90_tap_dropped": (GCONV_SM90, [
        ("wgmma_rs<N>(acc[s], a[tap & 1], j, desc_b<CG>(bm));",
         "if (tap != 8) wgmma_rs<N>(acc[s], a[tap & 1], j, desc_b<CG>(bm));"),
        ("wgmma_ss_n144(acc, desc_b<CG>(a_tap + 32 * kk), desc_sw128_any(b_tap + 32 * kk));",
         "if (tap != 8)\n            wgmma_ss_n144(acc, desc_b<CG>(a_tap + 32 * kk),"
         " desc_sw128_any(b_tap + 32 * kk));"),
    ]),
    # ur_grouped_conv3_sm90: the halo box starts one row low (at y0, not
    # y0 - 1), so every tap reads the row below its own
    "gconv_sm90_halo_row_off_by_one": (GCONV_SM90, [
        ("tx, bars + 8 * st, c, x0 - 1, y0 - 1, b);", "tx, bars + 8 * st, c, x0 - 1, y0, b);"),
    ]),
    # ur_grouped_conv3_sm90: each group of a slot takes the next group's
    # weights
    "gconv_sm90_wrong_group_weights": (GCONV_SM90, [
        ("const int g = g0 + a;", "const int g = (g0 + a + 1) % groups;"),
    ]),
    # ur_grouped_conv3_sm90: the bias is not added
    "gconv_sm90_bias_skipped": (GCONV_SM90, [
        ("if (bias != nullptr && c_out0 + c < C) {",
         "if (bias == nullptr && c_out0 + c < C) {"),
        ("if (bias != nullptr && c_out0 + ch < C) {",
         "if (bias == nullptr && c_out0 + ch < C) {"),
    ]),
}
# the faults of attend_mma reach every kernel whose bf16 entry lies in
# csrc/attention.cu (each row names that source, so the channel-flat and
# wide-head kernels, whose bf16 entries are in csrc/attention_sm90.cu and
# csrc/attention_stream_sm90.cu, drop out); these two lie in one kernel's
# own code
ONLY = {"out_head_left_out": ("ur_attention_btc_out",),
        "out_last_k_chunk_dropped": ("ur_attention_btc_out",)}
# faults that only a T with a partial last 64-key tile can show
MASKED_ONLY = {"bh_sm90_tail_keys_not_masked"}
# head-major shapes whose last key tile is partial (T % 64 != 0), besides the
# main paths' (T = 256, 384): (q shape, heads)
MASKED_SHAPES = [((3, 264, 64), 1), ((2, 328, 128), 1)]


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


def judge(fault: str, returncode: int, stdout: str, stderr: str) -> tuple[bool, list[dict]]:
    """Whether the child run of one copy meets the check, and its report lines.

    A sound copy (``none``) must agree at every shape; a fault must be rejected
    at every shape of the kernels it reaches, by the tolerance or by a CUDA
    error of such a kernel's launch (the child's last line, before it exits
    non-zero). Anything else (a non-zero exit without that line, an error in
    a sound kernel or in one the fault does not reach) is a failed harness.
    """
    source = FAULTS[fault][0]
    rows = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    stopped = returncode != 0 and bool(rows) and "error" in rows[-1]
    ok, lines = True, []
    if returncode != 0 and not stopped:
        error = stderr.strip().splitlines()[-1:] or [f"exit {returncode}"]
        ok = False
        lines.append({"fault": fault, "harness_failed": True, "source": source,
                      "error": error[0]})
    for row in rows:
        reached = ((source is None or row["source"] == source)
                   and (fault not in ONLY or row["kernel"] in ONLY[fault])
                   and (fault not in MASKED_ONLY or row["shape"][1] % 64 != 0))
        if "error" in row and (fault == "none" or not reached):
            ok = False
            lines.append({"fault": fault, "harness_failed": True, **row})
        elif reached:  # else the fault lies in another source or kernel
            rejected = "error" in row or row["tolerance_ratio"] > 1.0
            ok &= rejected == (fault != "none")
            lines.append({"fault": fault, "rejected": rejected, **row})
    if fault != "none" and not any("rejected" in line for line in lines):
        ok = False  # a fault that no row reaches shows nothing
        lines.append({"fault": fault, "harness_failed": True, "source": source,
                      "error": "no kernel the fault reaches ran"})
    return ok, lines


def child(root: Path) -> int:
    """Compare each kernel of the copy at ``root`` with its plain version."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as CS
    from unirestore_torch.nn import attention_kernels as K
    from unirestore_torch.nn import grouped_conv as G

    assert all(s.is_relative_to(root) for s in (K.SOURCE, K.SOURCE_SM90, K.SOURCE_STREAM_SM90,
                                                 K.SOURCE_BH_SM90, G.SOURCE, G.SOURCE_SM90))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        masked = [(K.fused_attention_bh_prescaled, shape, heads) for shape, heads in MASKED_SHAPES]
        for kern, shape, heads in CS.kernel_shapes(K) + masked:
            xs, _ = CS.kernel_inputs(K, kern, shape, heads, gen)
            row = {"kernel": kern.symbol, "source": Path(CS.kernel_source(kern)).name,
                   "shape": list(shape)}
            try:  # a fault that stops the kernel shows here, named, not in a later call
                kern(*xs)
                torch.cuda.synchronize()
            except RuntimeError as e:
                if "CUDA error" not in str(e):
                    raise
                print(json.dumps({**row, "error": str(e).strip().splitlines()[0]}), flush=True)
                return 1
            print(json.dumps({**row, **CS.compare_kernel(kern, *xs)}), flush=True)
            del xs
        kern = G.grouped_conv3
        prev = getattr(G.library(), kern.symbol)
        for shape in [s for s in CS.gconv_shapes() if s[0] == CS.BATCH]:
            x, w, b = CS.gconv_inputs(shape, gen)
            ref = G.grouped_conv3_plain(x, w, b, 16)
            for entry, source, call in (
                    ("wrapper", Path(CS.kernel_source(kern)).name, lambda: kern(x, w, b, 16)),
                    ("prev", GCONV,
                     lambda: CS.direct_gconv(prev, x, G.pack_weights(w, 16), b))):
                row = {"kernel": kern.symbol, "entry": entry, "source": source,
                       "shape": list(shape)}
                try:
                    out = call()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    if "CUDA error" not in str(e):
                        raise
                    print(json.dumps({**row, "error": str(e).strip().splitlines()[0]}),
                          flush=True)
                    return 1
                print(json.dumps({**row, **CS.compare_gconv(G, out, ref)}), flush=True)
            del x, w, b, ref, out
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
        res = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True)
        fault_ok, lines = judge(fault, res.returncode, res.stdout, res.stderr)
        ok &= fault_ok
        for line in lines:
            print(json.dumps(line), flush=True)
    print(json.dumps({"tolerance_rejects_every_fault_and_passes_the_kernel": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
