"""YAML config system mirroring the reference's LightningCLI surface.

The port's counterpart of ``unirestore_tpu/config.py``: ``load_config``,
``_parse_scalar``, ``set_dotted``, ``ENGINE_ALIASES`` and ``engine_type`` are
copied as they are, so the reference YAMLs in ``configs/`` drive the port
unchanged (the ``unirestore_tpu.*`` and ``core.engine_unifie.*`` class paths
are accepted as strings). ``build`` covers every engine: ``ir`` with its
``eval_mode`` FR (PSNR, SSIM, LPIPS; FID with ``compute_fid``), NR (the
no-reference suite of ``evalx/nr_suite.py``, ``nr_metrics`` selecting its
members) or ALL (both); the ``mtl`` engine of stage 2 with the
multi-task evaluation (the IR evaluator, the ``r50v1`` classification and
``dlv3pr50`` segmentation probes on the engine's critics); ``cls`` and ``seg``
with the classification and segmentation probe zoos their ``eval_mode``
selects (``tasks/classifier_zoo.py``: ``single``, ``all``, ``all_ft``,
``CUB``, ``bare``; ``tasks/seg_zoo.py``: ``single``, ``all``, ``bare``); and
the ``det`` engine of stage 3 with the detection evaluation (mAP of the
critic, RetinaNet or, with ``downstream: fastrcnn``, Faster R-CNN).

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
    m = copy.deepcopy(cfg.get("model", {}).get("init_args", {}))
    t = cfg.get("trainer", {})
    eval_mode = m.get("eval_mode", "FR")
    # the graph route of the engine's restores, the train step and every
    # validation network the JAX package jits; refused on the CPU by the
    # engine, before any work
    graphs = bool(t.get("cuda_graphs", False))
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
        cuda_graphs=graphs,
    )
    engine.engine_type = etype
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
        # None, as the JAX config leaves it
        split_step=(None if t.get("split_step") is None else bool(t.get("split_step"))),
        fsdp=bool(t.get("fsdp", False)),
        stop_after=t.get("stop_after"),
        cuda_graphs=graphs,
    )

    d = cfg.get("data", {}).get("init_args", {})
    data = DatasetEngine(**d) if d else None

    # LPIPS, FID's Inception, the NR suite, the critic probes, the probe zoos
    # and the detector are built once, on the engine's device, and reused
    # across validate() epochs: every metric resets its state in epoch_end.
    # With trainer.cuda_graphs each network but the detector replays from
    # CUDA graphs, as the JAX package jits each (the detector's decode and
    # host NMS stay eager, as JAX's config.py:242-246 lambdas do)
    _eval_cache = {}

    def lpips():
        # the reference FR collection always includes LPIPS(alex)
        # (eval_image_restoration.py:184)
        if "lpips" not in _eval_cache:
            from .evalx.lpips import make_lpips
            _eval_cache["lpips"] = make_lpips(device=dev, cuda_graphs=graphs)
        return _eval_cache["lpips"]

    def evaluator_factory(eng):
        restore = eng.restore_fn()
        if etype == "mtl":
            if "mtl_probes" not in _eval_cache:
                critics = eng.build_critics()
                _eval_cache["mtl_probes"] = {task: EV.probe(task, critics[task], eng.device,
                                                            graphs)
                                             for task in ("cls", "seg")}
            probes = _eval_cache["mtl_probes"]
            return EV.MultiTaskEvaluator(
                EV.ImageRestorationEvaluator(restore, lpips_fn=lpips()),
                EV.ClassificationEvaluator(restore, {"r50v1": probes["cls"]}),
                EV.SemanticSegmentationEvaluator(restore, {"dlv3pr50": probes["seg"]}))
        # under data parallelism every rank validates and rank 0 alone dumps
        save_dir = (os.path.join(root, "dumps") if m.get("save_image") and trainer.rank == 0
                    else None)
        if etype == "cls":
            # eval_mode selects the probe set (eval_classification.py:36-48);
            # the monitor per :93-102
            mode = m.get("eval_mode", "single")
            if "cls_zoo" not in _eval_cache:
                from .tasks import classifier_zoo as CZ
                _eval_cache["cls_zoo"] = CZ.build_classifier_zoo(mode, device=eng.device,
                                                                 cuda_graphs=graphs)
            zoo = _eval_cache["cls_zoo"]
            monitor = {"all_ft": "r50v1_ft", "CUB": "cub_r50"}.get(mode, "r50v1" if zoo else None)
            return EV.ClassificationEvaluator(restore, zoo, monitor=monitor)
        if etype == "seg":
            # eval_mode selects the probe set (eval_semantic_segmentation.py:37-50);
            # the monitor is rflwr101 (:102)
            if "seg_zoo" not in _eval_cache:
                from .tasks import seg_zoo as SZ
                _eval_cache["seg_zoo"] = SZ.build_seg_zoo(m.get("eval_mode", "single"),
                                                          device=eng.device, cuda_graphs=graphs)
            zoo = _eval_cache["seg_zoo"]
            return EV.SemanticSegmentationEvaluator(
                restore, zoo, monitor="rflwr101" if "rflwr101" in zoo else None,
                save_dir=save_dir)
        if etype == "det":
            if "detector" not in _eval_cache:
                from .tasks import fasterrcnn as FRC
                from .tasks import retinanet as RET
                critic = eng.build_critics()["det"]
                detect = (FRC.fasterrcnn_detect if m.get("downstream") == "fastrcnn"
                          else RET.retinanet_detect)
                _eval_cache["detector"] = lambda imgs: detect(critic, imgs,
                                                              score_threshold=0.05)
            return EV.DetectionEvaluator(restore, _eval_cache["detector"],
                                         iou_thresholds=(0.1,), save_dir=save_dir)
        fid = None
        # FID is an FR-protocol metric: the reference builds it only for FR and
        # ALL (eval_image_restoration.py:180-187); NR has no target to give the
        # real features
        if m.get("compute_fid") and eval_mode in ("FR", "ALL"):
            if "fid" not in _eval_cache:
                from .evalx.fid import FID
                from .evalx.inception import make_fid_extractor
                extractor, dim = make_fid_extractor(device=eng.device, cuda_graphs=graphs)
                _eval_cache["fid"] = {t: FID(extractor, dim) for t in ("hq", "lq")}
            fid = _eval_cache["fid"]
        nr = None
        if eval_mode in ("NR", "ALL"):
            if "nr" not in _eval_cache:
                from .evalx.nr_suite import build_nr_suite
                _eval_cache["nr"] = build_nr_suite(m.get("nr_metrics"), device=eng.device,
                                                   cuda_graphs=graphs)
            nr = _eval_cache["nr"]
        return EV.ImageRestorationEvaluator(
            restore, eval_mode=eval_mode, need_crop=m.get("need_crop", True),
            save_dir=save_dir, lpips_fn=lpips() if eval_mode in ("FR", "ALL") else None,
            fid=fid, nr_metrics=nr)

    return engine, trainer, data, evaluator_factory
