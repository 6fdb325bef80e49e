"""``python -m unirestore_torch.diagnostics <tool> <arguments>``: one of the
five diagnostic tools with its own flags (``<tool> --help``)."""

from __future__ import annotations

import importlib
import sys

TOOLS = ("components", "shapes", "conv_chains", "train_memory", "fsdp_memory")


def main(argv: list) -> int:
    if not argv or argv[0] not in TOOLS:
        raise SystemExit(f"usage: python -m unirestore_torch.diagnostics {{{','.join(TOOLS)}}} "
                         "[<arguments>]")
    return importlib.import_module(f"{__package__}.{argv[0]}").main(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
