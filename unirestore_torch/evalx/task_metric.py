"""TaskMetric base: metric registry, flattening, pretty printing.

The port's own copy of ``unirestore_tpu/evalx/task_metric.py`` (numpy only; the port imports
nothing of the JAX package).

Mirrors the reference's TaskMetric surface (task.py:12-103): metrics keyed
per eval_type ("hq"/"lq"), flattened to ``"{prefix}_{eval_type}/{key}"``
floats at epoch end, pandas table printing on the host.
"""

from __future__ import annotations


class TaskMetric:
    def __init__(self, eval_types=("lq",)):
        self.eval_types = list(eval_types)
        # metrics[eval_type][name] -> metric object with update/compute/reset
        self.metrics: dict[str, dict[str, object]] = {
            t: {} for t in self.eval_types}

    def add_metric(self, name: str, factory):
        for t in self.eval_types:
            self.metrics[t][name] = factory()

    def compute_metrics(self, prefix: str = "val") -> dict[str, float]:
        out = {}
        for t in self.eval_types:
            for name, m in self.metrics[t].items():
                out[f"{prefix}_{t}/{name}"] = float(m.compute())
        return out

    def reset_metrics(self, **kwargs):
        for t in self.eval_types:
            for m in self.metrics[t].values():
                m.reset()

    def merge_metrics(self, other: "TaskMetric"):
        """Fold another rank's metric states into this one (torchmetrics
        dist_reduce_fx='sum' sync, eval_image_restoration.py:263)."""
        for t in self.eval_types:
            for name, m in self.metrics[t].items():
                m.merge(other.metrics[t][name])

    @staticmethod
    def print_metrics(metrics: dict[str, float]):
        try:
            import pandas as pd
            df = pd.DataFrame([metrics]).T
            df.columns = ["value"]
            print(df.to_string())
        except Exception:
            for k, v in sorted(metrics.items()):
                print(f"{k}: {v:.4f}")
