"""A tiny cell defined only in a temporary directory, for the CPU tests: the
real configuration's file with the test widths of the program's
``tiny_config``, float32, a 64 px batch of two, and the real cell's limits."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch


REPO = Path(__file__).resolve().parents[2]
TINY_WIDTHS = {
    "vae": {"block_out_channels": [16, 32, 64, 64], "cfrm_depths": [1, 1, 2],
            "norm_num_groups": 8},
    "unet": {"block_out_channels": [32, 64, 64, 64], "heads": [2, 2, 2, 2],
             "cross_attention_dim": 64, "control_channels": 32},
    "controller": {"model_channels": 32, "out_channels": 32, "num_heads": 2},
}


# the mix at the test widths' 64 px tile
TINY_MIXES = {
    "offline_restore": {"batch": 2, "height": 64, "width": 64, "pool": 2, "sample_batches": 2,
                        "ref_block": 1, "trace_calls": 2},
}


def tiny_spec(config: str = "unirestore-sdturbo") -> dict:
    conf = json.loads((REPO / "benchmark" / "configs" / f"{config}.json").read_text())
    for part, widths in TINY_WIDTHS.items():
        conf["model"][part].update(widths)
    conf["model"].update(min_size=64, pad_multiple=64)
    conf["precision"] = "float32"
    conf["weights"]["null_embedding"] = None
    conf["name"] = f"tiny-{config}"
    return conf


# each cell of the manifest: (configuration, traffic mix); its tiny copy takes its limits
CELLS = {w["name"]: (w["config"], w["traffic"])
         for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]}
# what each driver reports: its end-to-end metric and its per-layer readers
REPORTS = {
    "offline_restore": (("restore_img_s", "img/s", "higher"),
                        ("norm_elementwise_ms_per_img.restore", "hand_kernels_roofline.restore",
                         "mfu.restore", "device_idle_pct.restore")),
}


def make_root(tmp: Path, cell: str = next(iter(CELLS))) -> tuple:
    """A checkout holding only a manifest of one tiny cell and its files (the
    per-layer readers copied from the repository); (root, cell name)."""
    config, traffic = CELLS[cell]
    conf = tiny_spec(config)
    mix = json.loads((REPO / "benchmark" / "traffic" / f"{traffic}.json").read_text())
    mix.update(TINY_MIXES[mix["driver"]])
    name = f"tiny-{cell}"
    bench = tmp / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(REPO / "benchmark" / "metrics", bench / "metrics")
    (bench / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
    (bench / "traffic" / f"tiny-{traffic}.json").write_text(json.dumps(mix))
    shutil.copy(REPO / "benchmark" / "workloads" / f"{cell}.json",
                bench / "workloads" / f"{name}.json")
    (metric, unit, better), readers = REPORTS[mix["driver"]]
    layer = {"unit": "%", "better": "lower", "source": "device_trace", "layer": "tiny",
             "moves": metric}
    manifest = {
        "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"], "run_seconds": 10,
        "configs": [{"name": conf["name"], "source": conf["source"],
                     "file": f"benchmark/configs/{conf['name']}.json", "reduced": [],
                     "why": "test widths"}],
        "workloads": [{"name": name, "config": conf["name"], "traffic": f"tiny-{traffic}",
                       "chips": 1, "why": "a test cell"}],
        "end_to_end": [{"name": metric, "unit": unit, "better": better, "bound": 0.05,
                        "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [dict(layer, name=r) for r in readers],
    }
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp, name


def args(seed: int = 2**31 + 7, trace: int = 0, seconds: float = 0.5):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=trace)


CPU = torch.device("cpu")
