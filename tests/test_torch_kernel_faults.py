"""The planted-fault check (``tools/check_kernel_tolerance.py``) on the CPU.

The check itself runs on a card; here its fault edits are planted into copies
of the CUDA sources, the source each kernel's rows are filed under is read
from the wrappers' routing, and ``judge`` is held to its rule: a fault is
rejected only by the tolerance or by a CUDA error of a kernel it reaches,
and any other failure of a copy fails the check.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import pytest
import torch

import chip_smoke
from unirestore_torch.nn import attention_kernels as K
from unirestore_torch.nn import grouped_conv as G

REPO = Path(__file__).resolve().parent.parent


def _tool():
    spec = importlib.util.spec_from_file_location(
        "check_kernel_tolerance", REPO / "tools" / "check_kernel_tolerance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CK = _tool()


@pytest.mark.parametrize("fault", [f for f in CK.FAULTS if f != "none"])
def test_each_fault_plants_into_its_source(tmp_path, fault):
    source, edits = CK.FAULTS[fault]
    csrc = tmp_path / "unirestore_torch" / "csrc"
    shutil.copytree(REPO / "unirestore_torch" / "csrc", csrc)
    before = (csrc / source).read_text()
    CK.plant(tmp_path, source, edits)
    after = (csrc / source).read_text()
    assert after != before
    for _, new in edits:
        assert new in after


def test_rows_are_filed_under_each_kernels_bf16_source():
    """The channel-flat kernel's bf16 entry is in attention_sm90.cu, the
    wide-head kernel's in attention_stream_sm90.cu, the head-major kernel's
    in attention_bh_sm90.cu, the out-projection-fused kernel's in
    attention_out_sm90.cu, the grouped conv's in grouped_conv_sm90.cu; the
    faults of attention.cu and grouped_conv.cu reach their mma.sync entries,
    called directly."""
    sources = {kern.symbol: Path(chip_smoke.kernel_source(kern)).name
               for kern in (*K.KERNELS, G.grouped_conv3)}
    assert sources == {"ur_attention_btc": CK.ATTENTION_SM90,
                       "ur_attention_bh": CK.ATTENTION_BH_SM90,
                       "ur_attention_stream": CK.ATTENTION_STREAM_SM90,
                       "ur_attention_btc_out": CK.ATTENTION_OUT_SM90,
                       "ur_grouped_conv3": CK.GCONV_SM90}
    for kern in (*K.KERNELS, G.grouped_conv3):
        assert kern.entry(torch.bfloat16)[2].name == sources[kern.symbol]
    assert G.grouped_conv3.entry(torch.float32)[2].name == CK.GCONV
    assert K.fused_attention_btc_out_prescaled.entry(torch.float32)[2].name == CK.ATTENTION
    assert {src for src, _ in CK.FAULTS.values()} >= {CK.ATTENTION, CK.ATTENTION_OUT_SM90,
                                                       CK.GCONV, CK.GCONV_SM90}


def _row(kernel, source, ratio=None, error=None, shape=(8, 4096, 320), **extra):
    row = {"kernel": kernel, "source": source, "shape": list(shape), **extra}
    if error is not None:
        return json.dumps({**row, "error": error})
    return json.dumps({**row, "max_abs_err": 0.0, "rms_err_over_rms_ref": 0.0,
                       "tolerance_ratio": ratio})


_SM90, _ATT = ("ur_attention_btc", "attention_sm90.cu"), ("ur_attention_btc_out", "attention.cu")
_BH = ("ur_attention_bh", "attention_bh_sm90.cu")
_MASKED, _WHOLE = (3, 264, 64), (160, 256, 64)
_GC = ("ur_grouped_conv3", "grouped_conv_sm90.cu")
_GC_PREV = ("ur_grouped_conv3", "grouped_conv.cu")
_GCS = (8, 256, 256, 512)
_OUT = ("ur_attention_btc_out", "attention_out_sm90.cu")
_CUDA = "ur_attention_btc_sm90: CUDA error 700"


@pytest.mark.parametrize("fault,rc,rows,stderr,ok", [
    # the sound copy agrees everywhere
    ("none", 0, [_row(*_SM90, 0.55), _row(*_ATT, 0.5)], "", True),
    # a sound kernel outside the tolerance
    ("none", 0, [_row(*_SM90, 1.5), _row(*_ATT, 0.5)], "", False),
    # a sound kernel that stops
    ("none", 1, [_row(*_SM90, error=_CUDA)], "", False),
    # rejected by the tolerance where it reaches; the other source ignored
    ("sm90_accumulator_not_rescaled", 0, [_row(*_SM90, 900.0), _row(*_ATT, 0.5)], "", True),
    # accepted at one reached shape
    ("sm90_accumulator_not_rescaled", 0, [_row(*_SM90, 900.0), _row(*_SM90, 0.9)], "", False),
    # stopped by a CUDA error of a kernel it reaches
    ("sm90_last_tile_load_skipped", 1, [_row(*_SM90, error=_CUDA)], "", True),
    # stopped in a kernel the fault does not reach
    ("sm90_last_tile_load_skipped", 1, [_row(*_ATT, error="CUDA error: 700")], "", False),
    # a Python error, an import error, an out-of-memory error: no error row
    ("sm90_last_tile_load_skipped", 1, [_row(*_SM90, 50.0)], "MemoryError", False),
    ("last_key_tile_dropped", 1, [], "ModuleNotFoundError: no module", False),
    # no row that the fault reaches
    ("out_head_left_out", 0, [_row(*_BH, 0.5)], "", False),
    # a masked-tail fault reaches only the shapes whose last key tile is partial
    ("bh_sm90_tail_keys_not_masked", 0,
     [_row(*_BH, 0.5, shape=_WHOLE), _row(*_BH, 8.0, shape=_MASKED)], "", True),
    ("bh_sm90_tail_keys_not_masked", 0,
     [_row(*_BH, 8.0, shape=_MASKED), _row(*_BH, 0.5, shape=(2, 328, 128))], "", False),
    ("bh_sm90_tail_keys_not_masked", 0, [_row(*_BH, 0.5, shape=_WHOLE)], "", False),
    # every other fault of the head-major kernel reaches every shape it runs
    ("bh_sm90_last_tile_stale", 0,
     [_row(*_BH, 90.0, shape=_WHOLE), _row(*_BH, 0.7, shape=_MASKED)], "", False),
    # a grouped_conv.cu fault reaches the mma.sync entry's rows, not the
    # Hopper kernel's, and the other way round
    ("gconv_tap_dropped", 0, [_row(*_GC, 0.5, shape=_GCS), _row(*_GC_PREV, 80.0, shape=_GCS)],
     "", True),
    ("gconv_tap_dropped", 0, [_row(*_GC, 80.0, shape=_GCS), _row(*_GC_PREV, 0.5, shape=_GCS)],
     "", False),
    ("gconv_sm90_bias_skipped", 0,
     [_row(*_GC, 30.0, shape=_GCS), _row(*_GC_PREV, 0.5, shape=_GCS)], "", True),
    # an attention.cu fault of the fused kernel reaches its mma.sync entry's
    # rows, not the Hopper kernel's
    ("out_head_left_out", 0, [_row(*_OUT, 0.5, cluster=2), _row(*_ATT, 30.0, entry="prev")],
     "", True),
    ("out_head_left_out", 0, [_row(*_OUT, 30.0, cluster=2), _row(*_ATT, 0.5, entry="prev")],
     "", False),
    # a fault of the cluster exchange reaches only the shapes that run a
    # cluster of two CTAs or more
    ("out_sm90_peer_slice_from_own_rank", 0,
     [_row(*_OUT, 0.5, cluster=1), _row(*_OUT, 40.0, cluster=2)], "", True),
    ("out_sm90_peer_slice_from_own_rank", 0,
     [_row(*_OUT, 0.5, cluster=1), _row(*_OUT, 0.5, cluster=6)], "", False),
    ("out_sm90_peer_slice_from_own_rank", 0, [_row(*_OUT, 0.5, cluster=1)], "", False),
    # every other fault of the fused kernel reaches every shape it runs
    ("out_sm90_column_share_offset", 0,
     [_row(*_OUT, 40.0, cluster=2), _row(*_OUT, 0.9, cluster=1)], "", False),
])
def test_judge_counts_only_kernel_errors_as_rejections(fault, rc, rows, stderr, ok):
    got, lines = CK.judge(fault, rc, "\n".join(rows) + "\n", stderr)
    assert got is ok
    assert all(line["fault"] == fault for line in lines)
    if not ok:
        assert any(line.get("harness_failed") or line.get("rejected") == (fault == "none")
                   for line in lines)
