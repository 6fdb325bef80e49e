"""CLI entry point of the port: fit / validate / test / predict --config <yaml>.

The counterpart of the repository's ``main.py`` (its lines 20-77), with the
same commands, the same ``--tiny`` flag and the same dotted overrides,
applied onto the YAML document by ``config.load_config``:

    python -m unirestore_torch.main fit --config configs/train_stage1.yaml
    python -m unirestore_torch.main fit --config configs/train_stage2.yaml
    python -m unirestore_torch.main fit --config configs/train_stage3.yaml
    python -m unirestore_torch.main validate --config configs/val.yaml --trainer.logger null
    python -m unirestore_torch.main fit --config <smoke>/smoke.yaml --tiny --device cpu

``--device`` takes the place of ``--platform``: by default the current CUDA
device, which must exist (no device and no ``--device`` raises); the tests
pass ``--device cpu``. ``--distributed`` (or torchrun's environment alone, as
the JAX CLI's coordinator environment) starts a process group before the
config is built (``parallel.init_distributed``: NCCL on the card of each
rank's ``LOCAL_RANK``, gloo with ``--device cpu``), and ``fit`` trains
data-parallel over it (``--trainer.fsdp true``: sharded):

    torchrun --standalone --nproc_per_node 8 -m unirestore_torch.main fit \
        --config configs/train_stage1.yaml --distributed

``predict`` restores the val lists through ``restore_tiled_fn`` with task
``ir`` (for the ``mtl`` engine of stage 2: its ir, cls and seg lists) and
writes one PNG per image (``ops/png.py``) under ``<save_dir>/predict``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    """Runs the command; returns (engine, trainer) for callers that read them."""
    parser = argparse.ArgumentParser("unirestore-torch")
    parser.add_argument("command", choices=["fit", "validate", "test", "predict"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--tiny", action="store_true", help="scaled-down model for smoke runs")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device; 'cpu' for tests)")
    parser.add_argument("--distributed", action="store_true",
                        help="start a torch.distributed process group (under torchrun; its "
                             "environment alone also starts one): data-parallel training, "
                             "one rank per card")
    args, overrides = parser.parse_known_args(argv)

    from .parallel import distributed as DIST

    started = DIST.init_distributed(force=args.distributed, device=args.device)
    try:
        return _run(args, overrides)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, overrides):
    from . import config as C

    cfg = C.load_config(args.config, overrides)
    np.random.seed(cfg.get("seed_everything", 42))
    engine, trainer, data, evaluator_factory = C.build(cfg, tiny=args.tiny, device=args.device)

    if args.command == "fit":
        trainer.fit(engine, data, evaluator_factory)
    elif args.command in ("validate", "test"):
        trainer.validate(engine, data, evaluator_factory)
    elif args.command == "predict":
        trainer.write_once(lambda: _predict(engine, trainer, data))
    trainer.logger.close()
    return engine, trainer


def _predict(engine, trainer, data):
    """One PNG per val image under ``<save_dir>/predict``."""
    from .ops import png

    # tiled wrapper: inputs larger than the working tile restore as
    # fixed-shape tile batches; <= tile inputs pass straight through
    restore = engine.restore_tiled_fn()
    out_dir = os.path.join(trainer.root, "predict")
    os.makedirs(out_dir, exist_ok=True)
    loaders = data.val_dataloader()
    if not isinstance(loaders, (list, tuple)):
        loaders = [loaders]
    for loader in loaders:
        for batch in loader:
            preds = restore(batch["lq"], "ir")
            for img, name in zip(preds, batch["fname"]):
                arr = np.clip(np.asarray(img) * 255, 0, 255).astype("uint8")
                with open(os.path.join(out_dir, f"{name}.png"), "wb") as f:
                    f.write(png.encode(arr))
    print(f"[predict] wrote outputs to {out_dir}")


if __name__ == "__main__":
    main()
