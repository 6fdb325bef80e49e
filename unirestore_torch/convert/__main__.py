"""``python -m unirestore_torch.convert <tool> <arguments>``: one of the four
converters with its tool's positional arguments.

    sd_turbo <src> [<dst>]                   (dst default ./weights)
    torchvision <kind> <checkpoint> [...]    (to $UNIRESTORE_WEIGHTS, default ./weights)
    classifiers <kind> <checkpoint> [<name>]
    iqa <kind> <checkpoint> [...]
"""

from __future__ import annotations

import importlib
import sys

TOOLS = ("sd_turbo", "torchvision", "classifiers", "iqa")


def main(argv: list) -> None:
    if not argv or argv[0] not in TOOLS or len(argv) < 2:
        raise SystemExit(f"usage: python -m unirestore_torch.convert {{{','.join(TOOLS)}}} "
                         "<arguments>")
    tool = importlib.import_module(f"{__package__}.{argv[0]}")
    if argv[0] == "sd_turbo":
        tool.main(*argv[1:3])
    else:
        tool.main(argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
