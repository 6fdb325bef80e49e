"""What the hand-written CUDA kernels share: build, launch count, tolerance.

Each ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``unirestore_torch/_build/`` (named by
the source's content hash, so an edited source is rebuilt) and bound with
``ctypes``. ``build_all`` starts one ``nvcc`` per missing library at once.

``KernelWrapper`` is the base of every kernel entry: it counts the kernel's
launches (``launches``), the part of them made while a rematerialised unit
recomputes its forward in the backward pass (``recompute_launches``, see
``nn/remat.py``), and the backward passes through its autograd function
(``backwards``; a backward is plain PyTorch, never a launch).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from collections.abc import Callable
from pathlib import Path

import torch

from . import remat

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{tag}.so"


def build_all(sources) -> list[Path]:
    """Compile every source whose library is missing, all ``nvcc`` runs at once.

    Returns the libraries' paths; each ``nvcc`` output (with ``-Xptxas -v``'s
    register and shared-memory report) is kept beside its library as ``.log``.
    """
    libs = [_library_path(Path(s)) for s in sources]
    jobs = {}
    for src, lib in zip(sources, libs):
        if lib.exists() or lib in jobs:
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[lib] = (proc, tmp)
    failed = []
    for lib, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


class KernelWrapper:
    """Launch and backward counts of one kernel; ``replaces`` is the TPU
    kernel's file:line.

    Launches go to C entry ``symbol`` of the library that ``base`` names as
    (library loader, source), except in the dtypes ``symbols`` lists, each
    with its own (C entry, library loader, source); ``entry`` gives that
    triple for a launch of a dtype, ``route`` the C entry and its loaded
    library.
    """

    symbol = ""
    replaces = ""
    base: tuple[Callable[[], ctypes.CDLL], Path] | None = None
    symbols: dict = {}

    def __init__(self):
        self.reset()

    def entry(self, dtype: torch.dtype) -> tuple[str, Callable[[], ctypes.CDLL], Path]:
        """(C entry, its library's loader, its source) of a launch in ``dtype``."""
        return self.symbols.get(dtype, (self.symbol, *self.base))

    def route(self, dtype: torch.dtype) -> tuple[str, ctypes.CDLL]:
        """(C entry, its library) of a launch in ``dtype``."""
        symbol, lib, _ = self.entry(dtype)
        return symbol, lib()

    def reset(self) -> None:
        self.launches = 0
        self.recompute_launches = 0
        self.backwards = 0

    def counted(self, rc: int, symbol: str | None = None) -> None:
        """Check the return code of C entry ``symbol`` (default ``self.symbol``;
        cudaGetLastError after the launch) and count the launch."""
        if rc != 0:
            raise RuntimeError(f"{symbol or self.symbol}: CUDA error {rc}")
        self.launches += 1
        if remat.recomputing():
            self.recompute_launches += 1


def tolerance_ratio(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol_rms: float) -> float:
    """max |out - ref| / (rtol |ref| + atol_rms rms(ref)); at most 1 to agree.

    NaN or infinity anywhere gives infinity.
    """
    out, ref = out.float(), ref.float()
    limit = rtol * ref.abs() + atol_rms * ref.square().mean().sqrt()
    ratio = ((out - ref).abs() / limit).max().item()
    return ratio if math.isfinite(ratio) else math.inf
