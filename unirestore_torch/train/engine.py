"""Training and validation engine (the port of ``unirestore_tpu/train/engine.py``).

Maps the reference's YAML surface (model_kwargs {frenc, cnet, tedit},
optimizer_kwargs, lr_scheduler_kwargs; engine_unifie.py:19-133) onto the
port's pieces: ``UniRestoreConfig`` + (frozen, trainable) trees, the eager
train step of ``steps.py``, the optimizer ``optimizer_kwargs.opt`` names with
gradient accumulation (``optim.py``) and adapter-only checkpoints (``checkpoints.py``), on one
device or data-parallel over a process group (``parallel/``).

``UniFIEEngine`` builds the params (the port's seeded init with
``seed_everything`` as its seed, then the converted sd-turbo weights of
``zoo.py``, then stage-surgery ``ckpt_path`` files), the frozen critics of
stages 2 and 3 (``build_critics``: ResNet-50 for ``cls``, DeepLabV3+-ResNet-50
for ``seg``, RetinaNet or, with ``downstream: fastrcnn``, Faster R-CNN for
``det``, fp32, from ``weights/resnet50_v1.npz``,
``deeplabv3plus_resnet50.npz``, ``retinanet_resnet50.npz`` or
``fasterrcnn_resnet50.npz`` or, warned, a seeded init, as the JAX
``zoo.load_npz_tree`` falls back) with the task loss that runs through them
(``make_te_loss_fn``: 10·L1 ``ir``, 0.1·CE ``cls`` and ``seg`` under ``mtl``;
the detector's loss on padded targets under ``det``), and owns the restore
closures; ``Trainer.fit`` / ``Trainer.validate`` are the JAX loops: sanity
validation, micro-steps counted one per batch (so with accumulation 2 the
optimizer updates every second step and the OneCycle schedule spans
``max_steps`` micro-steps), a validation interval with top-k checkpoints and
``last.npz``, resume from ``auto`` / ``true`` / a path, log lines and
``[timing]``.

Differences from the JAX engine:

- The step noise comes from a ``torch.Generator`` on the device seeded from
  ``seed`` and the start step (``noise_generator``), the counterpart of
  ``fold_in(PRNGKey(seed), start_step)``: a resumed run draws fresh,
  deterministic noise. ``Trainer(noise_fn=...)`` injects the draws instead.
- Batches reach the device through ``data.loader.device_prefetch`` (pinned
  memory, a side stream, depth 2); the frozen weights are held in
  ``compute_dtype`` (bf16 by default) and the trainable masters in fp32, and
  each batch is cast to ``compute_dtype``.
- Restores run eagerly by default. With ``cuda_graphs`` (``trainer.cuda_graphs``)
  they replay from CUDA graphs (``graphs.GraphedRestore``), an LRU of
  ``UNIRESTORE_JIT_CACHE_SIZE`` graphs (default 8, at least 1), the JAX
  engine's LRU of compiled restores (``_jit_cache``); the train step then
  replays from CUDA graphs too (``graphs.GraphedTrainStep``), as JAX's is
  compiled, for every engine type, ``det`` included.
- The critics are built once per engine and shared by the fit and the
  evaluator. A ``det`` batch's ragged targets are padded to 64 boxes
  (``padded_targets``) before the batch is staged, so they reach the card
  with its images.
- ``split_step`` picks no step: the port has one, which runs the losses one
  at a time and frees each graph before the next forward (the JAX split
  step; JAX picks between its two steps by backend and flag). The port takes
  the key from JAX configs, and ``stop_after`` requires it, as JAX's does.
- Data parallelism is a process group, one rank per card (``torchrun``; the
  JAX trainer meshes every local device without a flag). Every rank loads the
  same global batch and keeps its rows before the device copy; the step
  averages the gradients over the group. Under ``fsdp`` the trees and the
  optimizer state are held in shards between steps and gathered by each
  step (``parallel/fsdp.py``), not just in time per layer.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import numpy as np
import torch

from .. import bridge, tasks, zoo
from .. import graphs as GR
from ..data.loader import device_prefetch
from ..device import resolve_device
from ..models import unirestore as UR
from ..parallel import distributed as DIST
from ..parallel import fsdp as FSDP
from ..parallel import mesh as MESH
from ..tasks import deeplab as DL
from ..tasks import fasterrcnn as FRC
from ..tasks import resnet as RN
from ..tasks import retinanet as RET
from . import checkpoints as CKPT
from . import optim as OPT
from . import steps as ST

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model_config(model_kwargs: dict) -> tuple[UR.UniRestoreConfig, ST.StageConfig]:
    frenc = model_kwargs.get("frenc")
    cnet = model_kwargs.get("cnet")
    tedit = model_kwargs.get("tedit")
    if frenc and frenc.get("type") not in ("CFRM", None):
        raise ValueError(f"Invalid fr_type {frenc.get('type')}")
    cfg = UR.UniRestoreConfig(
        use_cfrm=bool(frenc),
        control_type=(cnet or {}).get("type", "none") if cnet else "none",
        num_inference_steps=(cnet or {}).get("num_inference_steps", 1),
        use_tfa=bool(tedit),
        tasks=tuple((tedit or {}).get("task", ("ir",))),
        prompt_len=(tedit or {}).get("prompt_len", 1),
        # opt-in cached inference modes (cnet: cache_mode "none" | "encoder"
        # | "deep", cache_stride N); exact reference semantics by default
        cache_mode=(cnet or {}).get("cache_mode", "none"),
        cache_stride=(cnet or {}).get("cache_stride", 2),
        cache_warmup=(cnet or {}).get("cache_warmup", 0),
    )
    stage = ST.StageConfig(
        train_cfrm=bool(frenc and frenc.get("train")),
        train_cnet=bool(cnet and cnet.get("train")),
        train_tfa=bool(tedit and tedit.get("train")),
        tfa_prompts_only=bool(tedit and tedit.get("new_task_only", False)),
        multi_task=bool(tedit and len(tedit.get("task", [])) > 1),
    )
    return cfg, stage


CRITIC_TASKS = {"ir": (), "mtl": ("cls", "seg"), "cls": ("cls",), "seg": ("seg",),
                "det": ("det",)}
MAX_BOXES = 64  # detection targets padded per image (unirestore_tpu/train/engine.py:448-451)


def build_critics(engine_type: str, downstream: str | None = None, device=None,
                  weights_dir=None) -> dict:
    """The frozen critics of an engine type by task, fp32 on ``device``
    (``unirestore_tpu/train/engine.py:64-90``): the converted weights where the
    file exists, else the seeded init with a warning. ``downstream`` picks the
    detector of ``det``: Faster R-CNN for ``fastrcnn``, RetinaNet otherwise."""
    critics = {}
    for task in CRITIC_TASKS[engine_type]:
        name = tasks.CRITIC_WEIGHTS[tasks.critic_name(task, downstream)]
        p, _ = zoo.load_npz_tree(name, tasks.critic_init(task, device, downstream), weights_dir)
        critics[task] = bridge.unflatten_like(
            {k: v.contiguous(memory_format=torch.channels_last) if v.ndim == 4 else v
             for k, v in bridge.flatten(p).items()}, p)
    return critics


def make_te_loss_fn(engine_type: str, critics: dict | None = None,
                    downstream: str | None = None):
    """te_loss_fn(preds, hq, gt, task) for the train step
    (``unirestore_tpu/train/engine.py:93-132``): the critics see the
    predictions in fp32. Under ``det``, ``gt`` is the padded dict {"boxes",
    "labels", "mask"} and the loss is the detector's, through Faster R-CNN
    for ``downstream`` ``fastrcnn`` and RetinaNet otherwise."""
    if engine_type not in CRITIC_TASKS:
        raise KeyError(engine_type)

    def l1(p32, hq):
        return torch.mean(torch.abs(p32 - hq.float()))

    def ce(task, p32, gt):
        if task == "cls":
            return RN.cross_entropy_loss(RN.resnet_apply(critics["cls"], p32), gt)
        return DL.seg_cross_entropy_loss(DL.deeplabv3plus_apply(critics["seg"], p32), gt)

    def det(p32, gt):
        loss = FRC.fasterrcnn_loss if downstream == "fastrcnn" else RET.retinanet_loss
        return loss(critics["det"], p32, gt["boxes"], gt["labels"], gt["mask"])

    def fn(preds, hq, gt, task):
        p32 = preds.float()
        if engine_type == "mtl":
            if task == "ir":
                return 10.0 * l1(p32, hq)
            if task in ("cls", "seg"):
                return 0.1 * ce(task, p32, gt)
            raise KeyError(f"Task [{task}] is not defined!")
        if engine_type == "ir":
            return l1(p32, hq)
        if engine_type == "det":
            return det(p32, gt)
        return ce(engine_type, p32, gt)

    return fn


def padded_targets(batches):
    """The batches of a loader with each ``det`` batch's ragged ``gt`` list
    made the padded numpy dict {"boxes", "labels", "mask"} (``pad_targets``),
    so that its arrays travel with the batch's other arrays to the device."""
    for batch in batches:
        if batch.get("task") == "det" and isinstance(batch.get("gt"), list):
            boxes, labels, mask = RET.pad_targets(batch["gt"], MAX_BOXES)
            batch = {**batch, "gt": {"boxes": boxes, "labels": labels, "mask": mask}}
        yield batch


def noise_generator(seed: int, start_step: int, device) -> torch.Generator:
    """The step noise's generator for a run that starts at ``start_step``:
    seeded from both, so a resumed run draws fresh, deterministic noise."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(start_step)) & 0x7FFF_FFFF_FFFF_FFFF)


class UniFIEEngine:
    """Builds params, loads stage checkpoints, owns the restore closures.

    ``params``, if given, is the (frozen, trainable) pair to start from in
    place of the seeded init (the parity tests hand in the JAX init carried
    across by ``bridge``); the zoo weights and ``ckpt_path`` files still
    apply on top. ``critics``, if given, are the critics by task in place
    of ``build_critics``' (the parity tests hand in the JAX critics).

    ``cuda_graphs`` (off by default; refused on the CPU, under a process
    group, with FSDP shards and in a spatial context) restores
    through one ``graphs.GraphedRestore`` of ``restore_cache_size`` graphs:
    the engine keeps one cast of the trainable tree in ``compute_dtype``,
    whose addresses the graphs hold, and copies the trainable tree into it
    before each restore. ``frozen`` must not be rebound once a graph holds it.
    """

    engine_type = "ir"

    def __init__(self, model_kwargs: dict, optimizer_kwargs: dict | None = None,
                 lr_scheduler_kwargs: dict | None = None,
                 eval_mode: str = "FR", save_image: bool = False,
                 need_crop: bool = True, downstream: str | None = None,
                 tiny: bool = False, seed: int = 42,
                 compute_dtype: str = "bfloat16", device=None, params=None, critics=None,
                 cuda_graphs: bool = False):
        self.model_kwargs = model_kwargs or {}
        self.optimizer_kwargs = optimizer_kwargs or {
            "opt": "adamw", "base_lr": 1e-4, "base_bsz": 64}
        self.lr_scheduler_kwargs = lr_scheduler_kwargs
        self.eval_mode = eval_mode
        self.save_image = save_image
        self.need_crop = need_crop
        self.downstream = downstream
        self.seed = seed
        self.compute_dtype = DTYPES[compute_dtype]
        self.device = resolve_device(device)
        self.cuda_graphs = cuda_graphs
        # the graph-captured restores kept, as the JAX engine bounds its
        # compiled ones (a floor of 1)
        self.restore_cache_size = max(1, int(os.environ.get("UNIRESTORE_JIT_CACHE_SIZE", "8")))
        self._graphs = None  # (GraphedRestore, the cast trainable tree it holds)
        if cuda_graphs:
            GR.refuse_graph_route("the engine's graph-captured restores", self.device)

        cfg, stage = build_model_config(self.model_kwargs)
        if tiny:
            cfg = UR.tiny_config(use_tfa=cfg.use_tfa,
                                 control_type=cfg.control_type if cfg.use_cnet else "none",
                                 tasks=cfg.tasks)
        self.cfg = cfg
        self.stage = stage
        self.sched = UR.schedule(cfg, device=self.device)
        self.critics = critics
        self.configure_model(params)

    # -- model/param construction (engine_unifie.py:35-133) ---------------

    def configure_model(self, params=None):
        if params is None:
            frozen, trainable = UR.init(self.cfg, device=self.device, seed=self.seed)
        else:
            frozen, trainable = params
        frozen = zoo.load_frozen_backbone(frozen, self.cfg)

        mk = self.model_kwargs
        for family, keys in (("frenc", {"cfrm"}),
                             ("cnet", {"controller", "control"}),
                             ("tedit", {"tfa"})):
            d = mk.get(family)
            if d and d.get("ckpt_path") and "$" in str(d["ckpt_path"]):
                print(f"!!Skipping {family} ckpt placeholder {d['ckpt_path']!r}")
                d = dict(d, ckpt_path=None)
            if d and d.get("ckpt_path"):
                trainable = CKPT.load_subtree(d["ckpt_path"], trainable, keys)
                print(f"!!Loaded {family} from {d['ckpt_path']}")

        self.frozen = bridge.cast_tree(frozen, self.compute_dtype)
        self.trainable = bridge.cast_tree(trainable, torch.float32)

    def build_critics(self) -> dict:
        """The engine type's frozen critics, built on the first call and kept."""
        if self.critics is None:
            self.critics = build_critics(self.engine_type, self.downstream, self.device)
        return self.critics

    def te_loss_fn(self, critics: dict | None = None):
        """te_loss_fn(preds, hq, gt, task) for the train step, through
        ``critics`` (default: ``build_critics()``)."""
        critics = self.build_critics() if critics is None else critics
        return make_te_loss_fn(self.engine_type, critics, self.downstream)

    # -- inference ---------------------------------------------------------

    def restore_fn(self, num_inference_steps: int | None = None, noise_fn=None):
        """Host-callable restore: (B, H, W, 3) numpy in [0, 1] -> float32 numpy.

        Each call draws its noise from a generator seeded 0, as the JAX
        closure restores every call with ``PRNGKey(0)``; ``noise_fn(latent
        shape) -> (posterior, diffusion)`` supplies it instead."""
        dev, dt = self.device, self.compute_dtype
        if self.cuda_graphs:  # refused before any restore, not at the first
            self.graphed_restore()

        def run(images, task):
            graphed, tr = (self.graphed_restore() if self.cuda_graphs
                           else (None, bridge.cast_tree(self.trainable, dt)))
            x = torch.as_tensor(np.asarray(images), device=dev).to(dt).contiguous()
            noise = {}
            if noise_fn is not None:
                post, diff = noise_fn(UR.latent_shape(self.cfg, UR.padded_shape(x.shape,
                                                                                self.cfg)))
                noise = {"posterior_noise": torch.as_tensor(post, device=dev).to(dt),
                         "diffusion_noise": torch.as_tensor(diff, device=dev).to(dt)}
            gen = torch.Generator(device=dev).manual_seed(0)
            if graphed is not None:
                out = graphed(x, task, gen, num_inference_steps, **noise)
            else:
                out = UR.restore(self.frozen, tr, self.cfg, self.sched, x, task, gen,
                                 num_inference_steps, device=dev, **noise)
            return out.float().cpu().numpy()

        return run

    def graphed_restore(self):
        """(the engine's ``GraphedRestore``, the cast trainable tree it holds),
        that tree refreshed from ``trainable`` with ``copy_`` (the restore
        casts it anew on the eager route). A rebound ``frozen`` tree or a
        trainable tree of other leaves gets a new instance."""
        GR.refuse_graph_route("the engine's graph-captured restores", self.device,
                              trees=(self.frozen, self.trainable))
        flat = bridge.flatten(self.trainable)
        if (self._graphs is None or self._graphs[0].frozen is not self.frozen
                or bridge.flatten(self._graphs[1]).keys() != flat.keys()):
            cast = bridge.cast_tree(self.trainable, self.compute_dtype)
            self._graphs = (GR.GraphedRestore(self.frozen, cast, self.cfg, self.sched,
                                              self.device, max_graphs=self.restore_cache_size),
                            cast)
        graphed, cast = self._graphs
        for k, t in bridge.flatten(cast).items():
            t.copy_(flat[k])
        return graphed, cast

    def restore_tiled_fn(self, num_inference_steps: int | None = None,
                         tile: int | None = None, overlap: int = 64,
                         batch_tiles: int = 4):
        """Arbitrary-size restore: inputs larger than ``tile`` (default: the
        model's working resolution, cfg.min_size) are split into fixed-shape
        overlapping tile batches and re-composited with feather blending
        (ops/tiling.py); smaller inputs pass straight through ``restore_fn``."""
        from ..ops import tiling as TIL

        tile = tile or self.cfg.min_size
        base = self.restore_fn(num_inference_steps)

        def run(images, task):
            return TIL.restore_tiled(base, np.asarray(images), task, tile=tile,
                                     overlap=overlap, batch_tiles=batch_tiles)

        return run


class Trainer:
    """fit/validate loops (Lightning Trainer surface subset).

    ``noise_fn(step, batch) -> steps.StepNoise``, if given, supplies each
    micro-step's noise (``step`` counts from 0 at the run's first step)
    in place of the seeded generator's draws.

    ``split_step`` (``None`` means ``False``) changes no step: every task
    runs ``steps.make_train_step``, whose parts run in turn. ``stop_after``
    (one of ``steps.SPLIT_PARTS``; only with ``split_step``) ends each step
    after that part: nothing is updated, so the fit skips validation and
    writes no checkpoint.

    ``cuda_graphs`` (off by default, as ``serve --cuda-graphs``) makes each
    task's step a ``graphs.GraphedTrainStep`` (the steps of all tasks share
    one LRU and memory pool: stage 3's ``det`` micro-steps and stage 2's
    ir, cls and seg alike), which gives the eager step's bits; it is refused
    on the CPU, under a process group and with ``fsdp``. The engine's
    restores take their graph route when the engine was built with
    ``cuda_graphs`` (``config.build`` sets both, and gives the validation
    networks theirs).

    Under a process group (``parallel.init_distributed``) the trainer is
    data-parallel over its ``make_mesh()`` (``unirestore_tpu/train/engine.py:
    318-453``): the peak learning rate scales with the world size, as JAX's
    does with its device count; every rank starts from rank 0's state
    (``replicate``) or, with ``fsdp``, holds its shards of it
    (``fsdp_shard``); every rank loads the same global batch and keeps its
    ``process_local_rows``; the step noise is drawn at the global batch's
    shape from the shared seed and cut to the rank's rows (``noise_fn`` is
    called with the global batch). Every rank validates; rank 0 alone writes
    checkpoints and the logger's files, and the others wait for it.
    """

    def __init__(self, max_steps: int = 1000, val_check_interval: int = 0,
                 log_every_n_steps: int = 25, accumulate_grad_batches: int = 1,
                 default_root_dir: str = "logs", save_top_k: int = 5,
                 monitor_mode: str = "max", num_sanity_val_steps: int = 0,
                 limit_val_batches: int | None = None, seed: int = 42,
                 profiler: str | None = None,
                 resume: str | bool | None = None,
                 split_step: bool | None = None,
                 fsdp: bool = False,
                 stop_after: str | None = None,
                 cuda_graphs: bool = False,
                 noise_fn=None):
        self.split_step = bool(split_step)
        if cuda_graphs and fsdp:
            raise ValueError("trainer.cuda_graphs does not take trainer.fsdp: every step "
                             "gathers the shards over the process group")
        self.cuda_graphs = cuda_graphs
        if stop_after is not None and not self.split_step:
            raise ValueError("trainer.stop_after requires split_step")
        if stop_after is not None and stop_after not in ST.SPLIT_PARTS:
            raise ValueError(f"trainer.stop_after must be one of shared|fr|cn|te, "
                             f"got {stop_after!r}")
        self.stop_after = stop_after
        # FSDP (ZeRO-3): trainable, frozen and optimizer state held in shards
        # over the data axis between steps (parallel/fsdp.py)
        self.fsdp = fsdp
        self.max_steps = max_steps
        # restart-based recovery (Lightning ckpt_path resume): True/"auto"
        # resumes from <root>/checkpoints/last.npz when present; a path
        # resumes from that file. Restores trainable + optimizer state +
        # step counter (the reference delegates this to Lightning).
        self.resume = resume
        self.val_check_interval = val_check_interval
        self.log_every = log_every_n_steps
        self.accum = accumulate_grad_batches
        self.root = default_root_dir
        self.save_top_k = save_top_k
        self.monitor_mode = monitor_mode
        self.num_sanity_val_steps = num_sanity_val_steps
        self.limit_val_batches = limit_val_batches
        self.seed = seed
        self.profiler = profiler  # logdir for a torch.profiler trace, or None
        self.noise_fn = noise_fn
        self.mesh = MESH.make_mesh()
        self.group = self.mesh.get_group("data")
        self.rank = DIST.rank()
        self._global_batch = None  # the host batch of which this rank steps on a part
        self.logs = []
        self.timing = {}
        self.profile = {}
        from .logging import MetricLogger, NullLogger
        self.logger = MetricLogger(self.root, "train") if self.rank == 0 else NullLogger()

    def _log(self, step, logs):
        entry = {"step": step, **{k: float(v) for k, v in logs.items()}}
        self.logs.append(entry)
        self.logger.log_scalars(step, {k: v for k, v in entry.items() if k != "step"})
        msg = " ".join(f"{k}={v:.4f}" for k, v in entry.items() if k != "step")
        print(f"[step {step}] {msg}", flush=True)

    def _step(self, step_fn, trainable, opt_state, batch, step, draw):
        """One micro-step: its noise (``noise_fn`` or ``draw``), then ``step_fn``.
        Where this rank holds a part of the global batch, ``noise_fn`` is given
        the global one and its draws are cut to the rank's rows."""
        if self.noise_fn is None:
            noise = draw(batch)
        elif self._global_batch is None:
            noise = self.noise_fn(step, batch)
        else:
            g = self._global_batch
            noise = ST.local_noise(self.noise_fn(step, g),
                                   DIST.process_local_rows(g["hq"].shape[0]))
        return step_fn(trainable, opt_state, batch, noise)

    def write_once(self, write) -> None:
        """``write()`` on rank 0; every rank of the group waits for it."""
        if self.rank == 0:
            write()
        if self.group is not None:
            torch.distributed.barrier(self.group)

    def _save(self, path, trainable, step, opt_state, mgr=None, metric=None) -> None:
        """``last.npz`` (or, with ``mgr``, a top-k checkpoint) of the whole
        trees: under FSDP every rank gathers, rank 0 writes."""
        trainable = FSDP.gather_tree(trainable, self.group)
        opt_state = FSDP.gather_tree(opt_state, self.group)
        if mgr is not None:
            self.write_once(lambda: mgr.save(trainable, step, metric))
        self.write_once(lambda: CKPT.save_checkpoint(path, trainable, step, opt_state=opt_state))

    @contextlib.contextmanager
    def _whole(self, engine):
        """The engine holding its whole trees for the body (validation): under
        FSDP gathered from its shards, which it holds again afterwards."""
        sharded = engine.frozen, engine.trainable
        engine.frozen = FSDP.gather_tree(engine.frozen, self.group)
        engine.trainable = FSDP.gather_tree(engine.trainable, self.group)
        try:
            yield
        finally:
            engine.frozen, engine.trainable = sharded

    def _sanity(self, engine, data, evaluator_factory) -> None:
        """``num_sanity_val_steps`` validation batches, their metrics discarded."""
        evaluator = evaluator_factory(engine)
        loaders = data.val_dataloader()
        if not isinstance(loaders, (list, tuple)):
            loaders = [loaders]
        n = 0
        for loader in loaders:
            for b in loader:
                evaluator.validation_step(b)
                n += 1
                if n >= self.num_sanity_val_steps:
                    break
            if n >= self.num_sanity_val_steps:
                break
        evaluator.epoch_end()

    def fit(self, engine: UniFIEEngine, data, evaluator_factory=None):
        dev, dt = engine.device, engine.compute_dtype
        n_dev = self.mesh.size()
        train_loader = data.train_dataloader()
        batch_size = train_loader.batch_size  # the global batch: every rank loads it whole
        tx, peak = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs,
                             total_steps=self.max_steps, batch_size=batch_size,
                             accum_iter=self.accum, num_devices=n_dev)
        print(f"[optimizer] peak lr {peak:.2e} over {self.max_steps} steps")
        te_fn = engine.te_loss_fn(engine.build_critics()) if engine.cfg.use_tfa else None

        start_step = 0
        resume_path = self.resume
        if resume_path in (True, "auto", "true"):
            resume_path = os.path.join(self.root, "checkpoints", "last.npz")
        if resume_path and os.path.exists(str(resume_path)):
            engine.trainable, meta = CKPT.load_trainable(str(resume_path), engine.trainable)
            opt_state = CKPT.restore_opt_state(
                str(resume_path), tx.init(ST.trained_leaves(engine.stage, engine.trainable)))
            start_step = int(meta.get("step", 0))
            print(f"[resume] {resume_path} @ step {start_step}")
        else:
            if self.resume and resume_path and self.resume not in (True, "auto", "true"):
                # an EXPLICIT path that doesn't exist is a user error —
                # silently restarting would overwrite the state they
                # meant to continue
                raise FileNotFoundError(f"trainer.resume checkpoint not found: {resume_path}")
            if self.resume and resume_path:
                print(f"[resume] no checkpoint at {resume_path}; starting from scratch")
            opt_state = tx.init(ST.trained_leaves(engine.stage, engine.trainable))

        steps_by_task = {}
        graph_cache = GR.GraphCache()

        def get_step(task):
            if task not in steps_by_task and self.cuda_graphs:
                steps_by_task[task] = GR.GraphedTrainStep(
                    engine.frozen, engine.cfg, engine.sched, engine.stage, tx, task,
                    te_loss_fn=te_fn, stop_after=self.stop_after, device=dev, group=self.group,
                    cache=graph_cache)
            elif task not in steps_by_task:
                steps_by_task[task] = ST.make_train_step(
                    engine.frozen, engine.cfg, engine.sched, engine.stage, tx, task,
                    te_loss_fn=te_fn, group=self.group, stop_after=self.stop_after)
            return steps_by_task[task]

        # placement (JAX engine.py:377-388): every rank starts from rank 0's
        # state; under FSDP each then keeps its shards of it
        for tree in (engine.trainable, engine.frozen, opt_state):
            MESH.replicate(self.mesh, tree)
        if self.fsdp:
            engine.trainable = FSDP.fsdp_shard(self.mesh, engine.trainable)
            engine.frozen = FSDP.fsdp_shard(self.mesh, engine.frozen)
            rank = torch.distributed.get_rank(self.group) if self.group is not None else 0
            opt_state = tx.shard_state(opt_state, ST.trained_leaves(engine.stage,
                                                                    engine.trainable), rank)
            print(f"[fsdp] sharded {FSDP.sharded_fraction(engine.trainable):.0%} of trainable / "
                  f"{FSDP.sharded_fraction(engine.frozen):.0%} of frozen elements over {n_dev} "
                  "devices", flush=True)

        # sanity validation before fit (Lightning num_sanity_val_steps,
        # train_stage1.yaml:25)
        if self.num_sanity_val_steps and evaluator_factory and data:
            print(f"[sanity] running {self.num_sanity_val_steps} validation steps")
            with self._whole(engine):
                self._sanity(engine, data, evaluator_factory)

        mgr = CKPT.CheckpointManager(os.path.join(self.root, "checkpoints"), self.save_top_k,
                                     self.monitor_mode)
        from . import profiling as PROF
        timer = PROF.StepTimer(warmup=1)
        trace_window = None  # (start, stop) steps for the device trace
        if self.profiler:
            trace_window = (2, min(6, self.max_steps))
        gen = noise_generator(self.seed, start_step, dev)
        table = torch.tensor(UR.TRAIN_TIMESTEPS, dtype=torch.int32, device=dev)

        def draw(batch):
            return ST.draw_noise(engine.cfg, batch, gen, table, world=n_dev)

        held = collections.deque()  # the global batches in the prefetch, for noise_fn

        def local_batches():
            for b in padded_targets(train_loader):
                if self.noise_fn is not None and n_dev > 1:
                    held.append({k: torch.as_tensor(v) for k, v in b.items()
                                 if isinstance(v, np.ndarray)})
                yield MESH.shard_batch(self.mesh, b)

        step = start_step
        waits, prof = [], None
        t0 = time.time()
        it = device_prefetch(local_batches(), dev)
        with contextlib.ExitStack() as tracing:
            while step < self.max_steps:
                if trace_window and step + 1 == trace_window[0]:
                    prof = tracing.enter_context(PROF.trace(self.profiler))
                t_wait = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    it = device_prefetch(local_batches(), dev)
                    batch = next(it)
                waits.append(time.perf_counter() - t_wait)
                self._global_batch = held.popleft() if held else None
                task = batch.pop("task")
                batch.pop("fname", None)
                # integer labels keep their dtype: an ImageNet class above
                # 256 is not exact in bf16; detection targets stay as padded
                # (fp32 boxes, as in the JAX loop)
                dev_batch = {k: v.to(dt) if v.is_floating_point() else v
                             for k, v in batch.items() if isinstance(v, torch.Tensor)}
                if isinstance(batch.get("gt"), dict):
                    dev_batch["gt"] = batch["gt"]
                with timer:
                    _, opt_state, logs = self._step(get_step(task), engine.trainable, opt_state,
                                                    dev_batch, step - start_step, draw)
                    if self.profiler and dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                step += 1
                if prof is not None and step == trace_window[1]:
                    tracing.close()
                    self.profile = {"steps": [trace_window[0], step],
                                    **PROF.device_summary(prof)}
                    trace_window = prof = None
                    print(f"[profiler] trace written to {self.profiler}: {self.profile}",
                          flush=True)
                if step % self.log_every == 0 or step == 1:
                    logs = {k: float(v) for k, v in logs.items()}
                    logs["imgs_per_sec"] = batch_size * self.log_every / max(
                        time.time() - t0, 1e-9)
                    t0 = time.time()
                    self._log(step, logs)
                if self.val_check_interval and evaluator_factory and not self.stop_after \
                        and step % self.val_check_interval == 0:
                    with self._whole(engine):
                        metrics = self.validate(engine, data, evaluator_factory)
                    # crash-recovery state: at most one val interval is lost
                    self._save(os.path.join(self.root, "checkpoints", "last.npz"),
                               engine.trainable, step, opt_state, mgr,
                               metrics.get("val_monitor", 0.0))
        self._global_batch = None
        final = os.path.join(self.root, "checkpoints", "last.npz")
        if not self.stop_after:
            self._save(final, engine.trainable, step, opt_state)
        engine.frozen = FSDP.gather_tree(engine.frozen, self.group)
        engine.trainable = FSDP.gather_tree(engine.trainable, self.group)
        if self.stop_after:
            # the truncated steps updated nothing: a last.npz would be a
            # resume point that was never trained
            print(f"[fit] stop_after={self.stop_after} pass done at step {step}; "
                  "no checkpoint written", flush=True)
            return engine
        ts = timer.summary()
        self.timing = {**ts, "loader_wait_mean_s": sum(waits) / max(len(waits), 1),
                       "loader_waits_s": waits, "batch_size": batch_size}
        if ts:
            print(f"[timing] steps={ts['steps']} mean={ts['mean_s']:.3f}s "
                  f"p50={ts['p50_s']:.3f}s p90={ts['p90_s']:.3f}s "
                  f"({batch_size / ts['p50_s']:.2f} imgs/s); loader wait "
                  f"{self.timing['loader_wait_mean_s'] * 1e3:.1f} ms/step", flush=True)
        print(f"[fit] done at step {step}; saved {final}", flush=True)
        return engine

    def validate(self, engine: UniFIEEngine, data, evaluator_factory):
        evaluator = evaluator_factory(engine)
        if hasattr(evaluator, "set_logger"):
            evaluator.set_logger(self.logger)
        loaders = data.val_dataloader()
        if not isinstance(loaders, (list, tuple)):
            loaders = [loaders]
        n = 0
        for loader in loaders:
            for batch in loader:
                evaluator.validation_step(batch)
                n += 1
                if self.limit_val_batches and n >= self.limit_val_batches:
                    break
        metrics = evaluator.epoch_end()
        from ..evalx.task_metric import TaskMetric
        TaskMetric.print_metrics(metrics)
        return metrics
