"""BENCHMARK.json against the benchmark's contract, and a cell that exists
only as files in a temporary directory."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import manifest as M
from benchmark.tests import tiny

ROOT = tiny.REPO


def test_manifest_keeps_the_contract():
    assert M.problems(M.load()) == []


def test_names_units_and_moves():
    manifest = M.load()
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert M.NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert M.UNIT.match(entry["unit"]), entry["unit"]
    for metric in manifest["per_layer"]:
        for cell in M.per_layer_cells(manifest, metric):
            assert M.reports(e2e[metric["moves"]], cell), (metric["name"], cell)
    for cell in manifest["workloads"]:
        spec = M.cell(cell["name"])
        assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
        assert spec["per_layer"], cell["name"]
        assert spec["limits"]["checks"], f"{cell['name']} has no correctness limits"


@pytest.mark.parametrize("bad", [
    {"run_seconds": 52}, {"paths": ["/abs"]},
    {"end_to_end": [{"name": "x y", "unit": "s", "better": "lower", "bound": 0.1,
                     "source": "host_clock"}]},
])
def test_problems_finds_breaches(bad):
    manifest = dict(M.load(), **bad)
    assert M.problems(manifest)


def test_bound_and_source_checks():
    manifest = M.load()
    manifest["end_to_end"] = [dict(m, bound=0.3) if m["name"] == "setup_s" else m
                              for m in manifest["end_to_end"]]
    assert any("bound" in p for p in M.problems(manifest))


def test_a_cell_of_new_files_alone_loads_and_runs(tmp_path):
    """A configuration, a mix, a cell and the metrics' readers that exist only
    as files under a temporary checkout: found by name and run on the CPU."""
    from benchmark import run as RUN
    from benchmark.harness import program

    root, name = tiny.make_root(tmp_path)
    assert M.problems(M.load(root), root) == []
    cell = M.cell(name, root)
    assert cell["config"]["name"].startswith("tiny-")
    result = RUN.run_cell(cell, tiny.args(), tiny.CPU, restore_factory=program.eager_restore)
    assert set(result["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    traced = RUN.run_cell(cell, tiny.args(trace=1), tiny.CPU, restore_factory=program.eager_restore)
    assert "mfu.restore" in traced["metrics"]
    json.dumps(traced)
