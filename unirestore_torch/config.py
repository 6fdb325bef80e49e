"""YAML config system mirroring the reference's LightningCLI surface.

The port's counterpart of ``unirestore_tpu/config.py``: ``load_config``,
``_parse_scalar``, ``set_dotted``, ``ENGINE_ALIASES`` and ``engine_type`` are
copied as they are, so the reference YAMLs in ``configs/`` drive the port
unchanged (the ``unirestore_tpu.*`` and ``core.engine_unifie.*`` class paths
are accepted as strings). ``build`` covers the ``ir`` engine with the FR
evaluation (PSNR, SSIM, LPIPS) and the ``mtl`` engine of stage 2 with the
multi-task evaluation (the IR evaluator, the ``r50v1`` classification and
``dlv3pr50`` segmentation probes on the engine's critics). Not ported yet,
each raising ``NotImplementedError`` (ROADMAP Queue A 5): the ``cls`` and
``seg`` engines, which need their probe zoos, and the ``det`` engine, which
needs a detector; the NR ``eval_mode``; ``compute_fid``.

Same document shape as the reference configs (configs/train_stage*.yaml):
``seed_everything``, ``trainer{...}``, ``model{class_path, init_args}``,
``data{class_path, init_args}``; CLI dotted overrides
(``--trainer.logger null``, README.md:82) are applied on top.

Reference class_path strings are accepted as aliases so the reference YAMLs
drive this framework unchanged.
"""

from __future__ import annotations

import copy
import os
import re

import yaml

ENGINE_ALIASES = {
    "core.engine_unifie.LitUniFIE": "ir",
    "core.engine_unifie.LitUniFIEIR": "ir",
    "core.engine_unifie.LitUniFIEMTL": "mtl",
    "core.engine_unifie.LitUniFIECLF": "cls",
    "core.engine_unifie.LitUniFIESemseg": "seg",
    "core.engine_unifie.LitUniFIEDET": "det",
    "unirestore_tpu.ir": "ir",
    "unirestore_tpu.mtl": "mtl",
    "unirestore_tpu.cls": "cls",
    "unirestore_tpu.seg": "seg",
    "unirestore_tpu.det": "det",
}


def load_config(path: str, overrides: list[str] | None = None) -> dict:
    """Load YAML + apply dotted CLI overrides.

    Both LightningCLI forms work: ``--trainer.max_steps=100`` and
    ``--trainer.max_steps 100`` (flag followed by a separate value token).
    A flag with neither form sets the key to None (``--trainer.logger``).
    """
    with open(path) as f:
        cfg = yaml.safe_load(f)
    toks = list(overrides or [])
    i = 0
    while i < len(toks):
        ov = toks[i]
        i += 1
        if not ov.startswith("-"):
            raise ValueError(f"unexpected CLI token {ov!r} "
                             "(overrides look like --a.b.c=value)")
        key, eq, val = ov.partition("=")
        key = key.lstrip("-")
        if not eq and i < len(toks):
            nxt = toks[i]
            # a value token: anything not starting with '-', or a negative
            # number (incl. leading-dot floats and inf/nan, e.g.
            # `--trainer.limit_val_batches -1`, `--a.b -.5`, `--a.b -.inf`)
            if not nxt.startswith("-") or re.fullmatch(_NUMERIC, nxt,
                                                       re.IGNORECASE):
                val = nxt
                i += 1
            elif not nxt.startswith("--"):
                raise ValueError(
                    f"ambiguous token {nxt!r} after valueless flag "
                    f"{ov!r}: use --key=value for dash-leading values")
        set_dotted(cfg, key, _parse_scalar(val))
    return cfg


_NUMERIC = r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|[+-]?\.?(inf|nan)"


def _parse_scalar(text: str):
    """YAML-parse a CLI value, with a numeric fallback for forms YAML 1.1
    leaves as strings (leading-dot floats `-.5`, dotless exponents `2e-3`)."""
    if text == "":
        return None
    v = yaml.safe_load(text)
    if isinstance(v, str) and re.fullmatch(_NUMERIC, v, re.IGNORECASE):
        return float(v)
    return v


def set_dotted(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def engine_type(cfg: dict) -> str:
    cp = cfg.get("model", {}).get("class_path", "unirestore_tpu.ir")
    if cp not in ENGINE_ALIASES:
        raise KeyError(f"unknown model class_path: {cp}")
    return ENGINE_ALIASES[cp]


# engine types ``build`` refuses, and what each needs
NOT_PORTED = {"cls": "the classifier probe zoo (tasks/classifier_zoo.py)",
              "seg": "the segmentation probe zoo (tasks/seg_zoo.py, RefineNet)",
              "det": "the detector critics (RetinaNet, Faster R-CNN)"}


def build(cfg: dict, tiny: bool = False, device=None):
    """Returns (engine, trainer, data_engine, evaluator_factory) on ``device``
    (default: the current CUDA device, which must exist).

    The engine trains and restores in bf16 (fp32 trainable masters), in fp32
    with ``tiny``, as ``unirestore_torch.serve`` does.
    """
    from .data.engine import DatasetEngine
    from .device import resolve_device
    from .evalx import evaluators as EV
    from .train.engine import Trainer, UniFIEEngine

    dev = resolve_device(device)
    etype = engine_type(cfg)
    if etype in NOT_PORTED:
        raise NotImplementedError(f"engine type {etype!r} needs {NOT_PORTED[etype]}, which "
                                  "are not ported yet (ROADMAP Queue A 5)")
    m = copy.deepcopy(cfg.get("model", {}).get("init_args", {}))
    eval_mode = m.get("eval_mode", "FR")
    if etype == "ir" and eval_mode != "FR":
        raise NotImplementedError(
            f"eval_mode {eval_mode!r}: the NR metric suite is not ported yet "
            "(ROADMAP Queue A 5)")
    if etype == "ir" and m.get("compute_fid"):
        raise NotImplementedError("compute_fid: FID and its Inception network are not "
                                  "ported yet (ROADMAP Queue A 5)")
    engine = UniFIEEngine(
        model_kwargs=m.get("model_kwargs", {}),
        optimizer_kwargs=m.get("optimizer_kwargs"),
        lr_scheduler_kwargs=m.get("lr_scheduler_kwargs"),
        eval_mode=eval_mode,
        save_image=m.get("save_image", False),
        need_crop=m.get("need_crop", True),
        downstream=m.get("downstream"),
        tiny=tiny,
        seed=cfg.get("seed_everything", 42),
        compute_dtype="float32" if tiny else "bfloat16",
        device=dev,
    )
    engine.engine_type = etype

    t = cfg.get("trainer", {})
    logger = t.get("logger") or {}
    root = (logger.get("init_args", {}) or {}).get("save_dir", "logs")
    trainer = Trainer(
        max_steps=t.get("max_steps", 1000),
        val_check_interval=t.get("val_check_interval") or 0,
        log_every_n_steps=t.get("log_every_n_steps", 25),
        accumulate_grad_batches=t.get("accumulate_grad_batches", 1),
        default_root_dir=root,
        num_sanity_val_steps=t.get("num_sanity_val_steps", 0),
        limit_val_batches=t.get("limit_val_batches"),
        seed=cfg.get("seed_everything", 42),
        profiler=t.get("profiler"),
        resume=t.get("resume"),
        split_step=t.get("split_step"),
        fsdp=bool(t.get("fsdp", False)),
        stop_after=t.get("stop_after"),
    )

    d = cfg.get("data", {}).get("init_args", {})
    data = DatasetEngine(**d) if d else None

    # LPIPS and the critic probes are built once and reused across validate() epochs
    _eval_cache = {}

    def lpips():
        # the reference FR collection always includes LPIPS(alex)
        # (eval_image_restoration.py:184)
        if "lpips" not in _eval_cache:
            from .evalx.lpips import make_lpips
            _eval_cache["lpips"] = make_lpips(device=dev)
        return _eval_cache["lpips"]

    def evaluator_factory(eng):
        restore = eng.restore_fn()
        if etype == "mtl":
            if "mtl_probes" not in _eval_cache:
                critics = eng.build_critics()
                _eval_cache["mtl_probes"] = {task: EV.probe(task, critics[task], eng.device)
                                             for task in ("cls", "seg")}
            probes = _eval_cache["mtl_probes"]
            return EV.MultiTaskEvaluator(
                EV.ImageRestorationEvaluator(restore, lpips_fn=lpips()),
                EV.ClassificationEvaluator(restore, {"r50v1": probes["cls"]}),
                EV.SemanticSegmentationEvaluator(restore, {"dlv3pr50": probes["seg"]}))
        save_dir = os.path.join(root, "dumps") if m.get("save_image") else None
        return EV.ImageRestorationEvaluator(
            restore, need_crop=m.get("need_crop", True),
            save_dir=save_dir, lpips_fn=lpips())

    return engine, trainer, data, evaluator_factory
