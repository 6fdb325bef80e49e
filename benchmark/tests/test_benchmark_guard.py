"""The run's refusals: JAX or the JAX package loaded, no card, no program."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from benchmark.harness import guard
from benchmark.tests import tiny


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["unirestore_torch.models.vae", "torch", "numpy"]) == []
    assert guard.forbidden_loaded(["unirestore_tpu.models"]) == ["unirestore_tpu"]
    assert guard.forbidden_loaded(["jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded(["jaxtyping", "flaxen", "unirestore_tpux"]) == []


def _run(cwd, *extra, env=None):
    cell = next(iter(tiny.CELLS))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(tiny.REPO, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_tiny_run_loads_no_jax():
    """A whole run of a tiny cell, in a fresh process: the program, the
    driver, the reference and the readers load neither JAX nor its package."""
    code = (
        "import sys, tempfile, pathlib\n"
        "from benchmark.harness import guard, manifest as M, program\n"
        "from benchmark import run as RUN\n"
        "from benchmark.tests import tiny\n"
        "root, name = tiny.make_root(pathlib.Path(tempfile.mkdtemp()))\n"
        "RUN.run_cell(M.cell(name, root), tiny.args(trace=1), tiny.CPU, restore_factory=program.eager_restore)\n"
        "print(guard.forbidden_loaded())\n")
    env = dict(os.environ, PYTHONPATH=str(tiny.REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
