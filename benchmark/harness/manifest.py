"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: its ``file`` (``benchmark/configs/<config>.json``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, data that names its
  driver, ``benchmark/traffic/<driver>.py``;
- a cell: ``benchmark/workloads/<cell>.json``, the limits of its correctness
  check;
- a per-layer metric: its reader, ``benchmark/metrics/<metric>.py``.

Nothing here knows a cell, a mix or a metric by name: a new one is new files
and manifest entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports an end-to-end ``metric``."""
    return "workloads" not in metric or cell in metric["workloads"]


def per_layer_cells(manifest: dict, metric: dict) -> list:
    """The cells a per-layer metric is read in: its ``workloads``, else every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return list(metric["workloads"])
    moved = next(m for m in manifest["end_to_end"] if m["name"] == metric["moves"])
    return [w["name"] for w in manifest["workloads"] if reports(moved, w["name"])]


def problems(manifest: dict, root: Path = ROOT) -> list:
    """What in ``manifest`` breaks the benchmark's contract, as messages."""
    out = []
    if set(manifest) != KEYS["top"]:
        out.append(f"top-level keys {sorted(manifest)}")
        return out
    cmd = manifest["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command")
    paths = manifest["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16
            and all(PATH.match(p) and ".." not in p.split("/") and not p.startswith("/")
                    for p in paths)):
        out.append(f"paths {paths}")
    rs = manifest["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append(f"run_seconds {rs}")
    names = {}
    for kind in ("config", "workload", "end_to_end", "per_layer"):
        group = manifest["configs" if kind == "config" else
                         "workloads" if kind == "workload" else kind]
        for entry in group:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            if not KEYS[kind] <= set(entry) <= KEYS[kind] | extra:
                out.append(f"{kind} {entry.get('name')}: keys {sorted(entry)}")
                continue
            if not NAME.match(str(entry["name"])):
                out.append(f"{kind} name {entry['name']!r}")
            names.setdefault(kind if kind in ("config", "workload") else "metric",
                             []).append(entry["name"])
            if kind in ("end_to_end", "per_layer"):
                if not UNIT.match(str(entry["unit"])):
                    out.append(f"{entry['name']}: unit {entry['unit']!r}")
                if entry["better"] not in ("lower", "higher"):
                    out.append(f"{entry['name']}: better {entry['better']!r}")
                if entry["source"] not in SOURCES:
                    out.append(f"{entry['name']}: source {entry['source']!r}")
    for kind, group in names.items():
        if len(group) != len(set(group)):
            out.append(f"duplicate {kind} names")
    cells = {w["name"]: w for w in manifest["workloads"]}
    configs = {c["name"]: c for c in manifest["configs"]}
    if not 1 <= len(configs) <= 24 or not 1 <= len(cells) <= 24:
        out.append("1 to 24 configurations and cells")
    for c in manifest["configs"]:
        if not (_line(c["source"]) and _line(c["why"])):
            out.append(f"config {c['name']}: source or why")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config {c['name']}: file outside paths")
        elif not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
                and all(NAME.match(k) for k in c["reduced"])):
            out.append(f"config {c['name']}: reduced")
        if not any(w["config"] == c["name"] for w in manifest["workloads"]):
            out.append(f"config {c['name']} is in no cell")
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a (config, traffic) pair appears twice")
    if sum(w["chips"] == 4 for w in manifest["workloads"]) > max(1, len(cells) // 4):
        out.append("too many four-chip cells")
    for w in manifest["workloads"]:
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4) or not _line(w["why"]) or not NAME.match(w["traffic"]):
            out.append(f"cell {w['name']}: chips, why or traffic")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    if "setup_s" not in e2e or not 1 <= len(e2e) <= 16:
        out.append("end_to_end: 1 to 16 metrics, setup_s among them")
    for m in manifest["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: end-to-end source {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"{m['name']}: unknown cell {cell}")
    if not 1 <= len(manifest["per_layer"]) <= 128:
        out.append("per_layer: 1 to 128 metrics")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown metric {m['moves']}")
            continue
        if not _line(m["layer"]):
            out.append(f"{m['name']}: layer")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"{m['name']}: unknown cell {cell}")
            elif not reports(e2e[m["moves"]], cell):
                out.append(f"{m['name']}: cell {cell} does not report {m['moves']}")
        if not (root / "benchmark" / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader")
    for cell in cells:
        reported = [m for m in manifest["end_to_end"] if reports(m, cell)]
        if len(reported) < 2:
            out.append(f"cell {cell}: setup_s and one more end-to-end metric")
        if not any(cell in per_layer_cells(manifest, m) for m in manifest["per_layer"]
                   if m["moves"] in e2e):
            out.append(f"cell {cell}: no per-layer metric")
        for path in (root / "benchmark" / "workloads" / f"{cell}.json",
                     root / "benchmark" / "traffic" / f"{cells[cell]['traffic']}.json"):
            if not path.is_file():
                out.append(f"cell {cell}: no file {path.relative_to(root)}")
    return out


def cell(name: str, root: Path = ROOT, manifest: dict | None = None) -> dict:
    """Everything one run of cell ``name`` reads: its manifest entry, its
    configuration's file, its traffic mix, its limits, and the metrics it
    reports (``end_to_end`` with ``--trace 0``, ``per_layer`` with 1)."""
    manifest = manifest if manifest is not None else load(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    bench = root / "benchmark"
    return {
        "name": name,
        "entry": entry,
        "config": json.loads((root / config["file"]).read_text()),
        "traffic": json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text()),
        "limits": json.loads((bench / "workloads" / f"{name}.json").read_text()),
        "end_to_end": [m for m in manifest["end_to_end"] if reports(m, name)],
        "per_layer": [m for m in manifest["per_layer"] if name in per_layer_cells(manifest, m)],
        "root": root,
    }


def reader(metric: str, root: Path = ROOT):
    """The ``read(record) -> float | None`` of per-layer ``metric``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    """The traffic driver module ``benchmark/traffic/<kind>.py``."""
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", kind):
        raise ValueError(f"driver name {kind!r}")
    return importlib.import_module(f"benchmark.traffic.{kind}")
