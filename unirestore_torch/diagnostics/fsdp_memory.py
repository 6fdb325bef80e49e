"""Persistent training state per card, replicated against FSDP (the port of
``tools/debug_fsdp_memory.py``).

    python -m unirestore_torch.diagnostics fsdp_memory [--devices 8]

Counts, without drawing a weight (every tree is built on the ``meta``
device), how many bytes of persistent state each card holds when every card
keeps a whole copy and when ``trainer.fsdp`` shards each large leaf over the
cards (``parallel/fsdp.py:fsdp_spec``: the largest axis the card count
divides; leaves under ``DEFAULT_MIN_SIZE`` elements stay whole). The model is
the JAX tool's, ``UniRestoreConfig(use_tfa=True, tasks=("ir", "cls",
"seg"))`` at sd-turbo width; the rows are its three:

- the frozen backbone in bf16;
- the trainable adapters in fp32 (the masters);
- the optimizer state: the port's AdamW (``train/optim.py:make_optimizer``)
  as ``init`` holds it, the ``mu`` and ``nu`` slots in fp32. Its step counts
  are host integers; optax keeps each ``count`` as an int32 leaf, which the
  JAX tool counts (4 bytes each).

Activations and temporaries are another budget (``train_memory``). This
tool measures nothing on a device and runs on any machine.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import bridge
from ..models import unirestore as UR
from ..parallel import fsdp as FSDP
from ..train import optim as OPT

MIB = 2 ** 20
GIB = 2 ** 30
ROWS = (("frozen_bf16", "frozen backbone (bf16)"),
        ("trainable_fp32", "trainable adapters (fp32 master)"),
        ("adamw_slots_fp32", "optimizer state (AdamW moments)"))


def state_trees() -> dict:
    """{row: flat {name: meta tensor}}: the frozen tree in bf16, the trainable
    tree in fp32 and AdamW's state over the trainable tree."""
    frozen, trainable = UR.init(UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg")),
                                device="meta")
    flat = bridge.flatten(trainable)
    state = OPT.make_optimizer(lr=1e-4).init(flat)
    slots = {f"{slot}//{k}": v for slot in ("mu", "nu") for k, v in state[slot].items()}
    return {"frozen_bf16": bridge.flatten(bridge.cast_tree(frozen, torch.bfloat16)),
            "trainable_fp32": flat, "adamw_slots_fp32": slots}


def replicated_bytes(leaves) -> int:
    """Bytes of the leaves (the JAX tool's ``_bytes``)."""
    return sum(v.numel() * v.element_size() for v in leaves)


def fsdp_bytes(leaves, n: int) -> int:
    """Bytes a card holds of the leaves sharded over ``n`` cards (the JAX
    tool's ``_fsdp_bytes``): a sharded leaf's bytes // n, a whole one's bytes."""
    total = 0
    for v in leaves:
        size = v.numel() * v.element_size()
        total += size // n if FSDP.fsdp_spec(v, n) else size
    return total


def table(n: int, trees: dict | None = None) -> dict:
    """{row: (replicated bytes, FSDP bytes)} at ``n`` cards, with ``total``."""
    trees = trees or state_trees()
    rows = {name: (replicated_bytes(t.values()), fsdp_bytes(t.values(), n))
            for name, t in trees.items()}
    rows["total"] = tuple(sum(r[i] for r in rows.values()) for i in range(2))
    return rows


def state_bytes(worlds=(2, 4, 8)) -> dict:
    """{n: {row: {"replicated_gib", "fsdp_gib"}}} at each card count in
    ``worlds`` (``chip_smoke.py`` phase 16 (c))."""
    trees = state_trees()
    return {n: {name: {"replicated_gib": r / GIB, "fsdp_gib": f / GIB}
                for name, (r, f) in table(n, trees).items()} for n in worlds}


def report(n: int, rows: dict) -> list:
    """The JAX tool's table (:70-80), in MB of 2^20 bytes."""
    lines = [f"{'state':<34} {'replicated/chip':>16} {'fsdp/chip':>12} "
             f"{'factor':>7}   (mesh = {n} devices)"]
    labels = dict(ROWS, total="TOTAL persistent state")
    for name, (r, f) in rows.items():
        lines.append(f"{labels[name]:<34} {r / MIB:>13.1f} MB {f / MIB:>9.1f} MB "
                     f"{r / max(f, 1):>6.1f}x")
    return lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m unirestore_torch.diagnostics fsdp_memory",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    print("\n".join(report(args.devices, table(args.devices))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
