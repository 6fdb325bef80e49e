#!/usr/bin/env python3
"""Eager restores with and without a copy of the attention gain to the card, in turns.

``nn/attention.py:_prescaled_linear`` multiplies the q projection by its gain
as a host scalar. It used to make a device tensor of the gain on every call:
a copy from host memory, after which the host waits for the stream to drain
(once per btc, bh and stream launch, 422 times per exact restore). This runs
the full-width exact restore of ``chip_smoke.py`` (sd-turbo widths, seeded
init, 512 px, batch 8, bf16, 20 DDIM steps) eagerly with that copy put back
(``copy``) and as the module has it (``host``), in turns copy, host, host,
copy, ``--rounds`` times, and prints the card's line and one JSON line of
seconds per restore. Run from the repository root on a machine with one CUDA
device:

    python3 tools/time_gain_copy.py [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402
from unirestore_torch import bridge  # noqa: E402
from unirestore_torch.models import unirestore as UR  # noqa: E402
from unirestore_torch.nn import attention as ATT  # noqa: E402


def prescaled_linear_with_copy(pp, x, gain: float):
    """The form before the repair: the gain as a device tensor made on every call."""
    g = torch.tensor(gain, dtype=x.dtype, device=x.device)
    y = x @ (pp["w"].to(x.dtype) * g)
    if "b" in pp:
        y = y + pp["b"].to(x.dtype) * g
    return y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_gain_copy: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    print(CS.card_line(), flush=True)
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    frozen, trainable = CS.make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
    _, _, restore = CS.restore_inputs(UR, cfg, frozen, trainable,
                                      torch.Generator(device="cuda").manual_seed(0))
    host_form = ATT._prescaled_linear
    forms = {"copy": prescaled_linear_with_copy, "host": host_form}
    restore(cfg, 1)  # warm-up
    seconds, outs = {name: [] for name in forms}, {}
    try:
        for _ in range(args.rounds):
            for name in ("copy", "host", "host", "copy"):
                ATT._prescaled_linear = forms[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = restore(cfg, CS.STEPS)
                torch.cuda.synchronize()
                seconds[name].append(time.perf_counter() - t0)
    finally:
        ATT._prescaled_linear = host_form
    mean = {name: sum(s) / len(s) for name, s in seconds.items()}
    print(json.dumps({"mode": "none", "batch": CS.BATCH, "res": CS.RES, "steps": CS.STEPS,
                      "seconds": seconds,
                      "img_per_s": {name: CS.BATCH / m for name, m in mean.items()},
                      "host_over_copy": mean["copy"] / mean["host"] - 1.0,
                      "outputs_equal": torch.equal(outs["copy"], outs["host"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
