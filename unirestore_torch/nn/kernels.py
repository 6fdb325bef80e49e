"""Every hand-written kernel of the port, for callers that count or build them all."""

from __future__ import annotations

from pathlib import Path

from . import attention_kernels as AK
from . import cuda_lib
from . import grouped_conv as GC

KERNELS = (*AK.KERNELS, GC.grouped_conv3)
SOURCES = (AK.SOURCE, AK.SOURCE_SM90, AK.SOURCE_STREAM_SM90, AK.SOURCE_BH_SM90,
           AK.SOURCE_OUT_SM90, GC.SOURCE, GC.SOURCE_SM90)


def reset_counts() -> None:
    for kern in KERNELS:
        kern.reset()


def build_all() -> list[Path]:
    """Compile every kernel source at once (one ``nvcc`` each) and load the libraries."""
    libs = cuda_lib.build_all(SOURCES)
    AK.library()
    AK.library_sm90()
    AK.library_stream_sm90()
    AK.library_bh_sm90()
    AK.library_out_sm90()
    GC.library()
    GC.library_sm90()
    return libs
