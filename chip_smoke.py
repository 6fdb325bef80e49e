#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unirestore_torch``) once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. environment: card name, ``nvidia-smi`` name and power limit, TF32 off;
2. build the CUDA kernels from ``unirestore_torch/csrc/`` (one ``nvcc`` per
   source, all seven at once);
3. each kernel against its plain PyTorch version at every shape the 512 px
   batch-8 main paths give it, and the wide-head, head-major and
   out-projection-fused kernels also at the server's shapes (bf16), with
   kernel, plain, library (``scaled_dot_product_attention``;
   ``F.conv2d(groups=16)`` in ``channels_last``; timed as yardsticks only)
   and bound times; for the out-projection-fused kernel, which no single
   PyTorch call matches, the unfused pairs ``ur_attention_btc_sm90`` +
   cuBLAS and SDPA + ``torch.matmul`` instead, always by graph replay (the
   event readings beside them); for every kernel also the C
   entry of its bf16 launches called directly (``direct_ms``) and the
   ``mma.sync`` kernel it replaced, called directly in turns with it
   (``prev_ms``, a yardstick only, held to the plain version too):
   channel-flat ``ur_attention_btc_sm90`` (``csrc/attention_sm90.cu``),
   wide-head ``ur_attention_stream_sm90`` (``attention_stream_sm90.cu``),
   head-major ``ur_attention_bh_sm90`` (``attention_bh_sm90.cu``),
   out-projection-fused ``ur_attention_btc_out_sm90``
   (``attention_out_sm90.cu``) against the entries of the same names
   without ``_sm90`` in ``csrc/attention.cu``; the grouped conv's
   ``ur_grouped_conv3_sm90`` against ``ur_grouped_conv3``; with the host
   time of one call of each and of the wrapper (``*_host_us``). A kernel
   whose direct call takes under ``GRAPH_MS`` is timed again with the host
   out of the way: ``GRAPH_CALLS`` calls of the wrapper, of each C entry and
   of the library call captured in one CUDA graph each and replayed
   (``timer: "graph"``; the event readings stay beside them as
   ``*_event_ms``);
   and each attention kernel's gradient (its autograd function) against
   autograd through its plain version at one main-path shape;
4. the full-width restore (sd-turbo widths, seeded init, 512 px, batch 8,
   bf16, 20 DDIM steps) in the exact, encoder (stride 2) and deep (stride
   17, warmup 3) modes, and exact with the out-projection-fused attention
   (``fused_out_attention=True``) on the same inputs and noise, exact and
   fused twice each in turns: finite outputs, launch counts equal to the
   counts the routing implies, img/s, PSNR of each cached mode and of the
   fused route against exact; then the graph route
   (``unirestore_torch/graphs.py``): for exact, encoder, deep and fused, one
   ``GraphedRestore`` captures the whole restore (launch counts at capture
   equal to the eager counts), and eager restores and graph replays of one
   seeded batch run in turns (eager, graph, graph, eager), each eager one
   under ``torch.cuda.set_sync_debug_mode("error")`` (nothing in it may wait
   for the card or copy from the host) and each replay with no wrapper
   launch: img/s both ways, capture seconds, peak and held memory, and the
   graph's output against the eager one, raw and in uint8 levels (at most
   1);
5. the same widths on a 256 px input in fp32, on the card (unfused, fused,
   and unfused replayed from a CUDA graph) and on the CPU (where the kernels'
   plain versions run): the restores must agree. The CPU half of this check
   and of phases 7, 11, 12 and 15's runs in one worker process
   (``CpuReferences``) while the card phases go on: it draws the same seeded
   inputs on the card, copies them to the host and computes there; every
   such check is read before the report. Phases 5 and 7 run after 18 (a)-(c),
   and phase 15 starts its jobs after its timed restores and steps, so that
   phases 3, 4, 6, 18 and 15's restores and SPADE step are timed beside no
   job; the script waits for every job before phase 19 (b). The jobs can run
   beside phases 8-9 (those of 5 and 7), 12-14 (11 and 12), and 15's
   optimizers and backbones and phases 16-18 (d) (15's); the report gives
   each job's seconds of the script;
6. the stage-1 training step at full width (sd-turbo widths without TFA,
   512 px, batch 8, bf16 frozen weights and fp32 trainable masters, AdamW
   from the stage-1 YAML's kwargs, remat on) on a seeded synthetic pair: one
   warm-up and five timed steps with exact per-step launch counts (forward,
   remat recompute and backward counted apart), finite losses and gradient
   norms, every CFRM / Controller / SC-Tuner leaf changed, every frozen byte
   unchanged;
7. one stage-1 loss and gradient at full width, 256 px, batch 1, fp32, on the
   card and on the CPU: the losses and each family's gradient norm agree;
18. (its (a)-(c) run after phase 6, (d) after phase 15 while phases 16 and
   17 run their torchrun jobs) the train step's
   parts in turn (``make_train_step``, the JAX package's split step) on
   phase 6's cell, against ``monolithic_step`` (every loss in one backward,
   the design it replaced): (a) from one state, batches and noise, two
   micro-steps of each (one AdamW update): launches per step phase 6's, the
   logged losses and every trained leaf after the update bit-equal, each
   family's gradient norm within TRAIN_GRAD_RTOL; then the two in turns
   (SPLIT_TURNS) of SPLIT_TURN_STEPS synchronised steps: ms/step and each
   turn's peak memory; (b) at SPLIT_BIG_BATCH (or the largest multiple of 8
   at which (a)'s monolithic peak, extrapolated in the batch, fits the card)
   one warm-up step of each, then the same turns of SPLIT_BIG_STEPS steps:
   ms/step and peak; (c) the step ended after each part (``stop_after``): ms
   and peak memory up to it, the trained leaves and optimizer state
   bit-equal before and after; (d) phase 9's fit command with
   ``--trainer.split_step true`` for FIT_SPLIT_STEPS micro-steps without
   validation: launches per micro-step phase 6's, micro-step 2 under
   ``set_sync_debug_mode("error")``, every logged loss and every leaf of
   ``last.npz`` bit-equal to phase 9's, and with ``--trainer.stop_after fr``
   no ``last.npz``;
19. (its (a) and (c) run after 18 (a)-(c) and before 5, (b) after 17)
   the graph-captured step (``graphs.GraphedTrainStep``): (a) on phase 18's
   build of phase 6's cell, an accumulating and an applying micro-step eager
   and from the graphs from one state: every log, all 588 trained leaves and
   every optimizer slot bit-equal; launches at capture ``EXPECTED_TRAIN``,
   the first call's (two eager warm-ups and the capture) three times it, a
   replay none; warm-up and capture seconds, held and peak GiB; then eager and
   graph in turns (GRAPH_TRAIN_TURNS) of synchronised micro-steps, each
   under ``set_sync_debug_mode("error")``: ms a micro-step; and one pair of
   each under the profiler: the card's busy time, span and idle share; (b)
   phase 9's fit command with ``--trainer.cuda_graphs true``: every
   micro-step's logs and every array of ``last.npz`` bit-equal to phase 9's
   first fit, launches at micro-step 1 three times phase 6's and none after,
   every validation restore (replayed by the engine's ``GraphedRestore``)
   within one uint8 level of the eager route's, s/step over micro-steps 2-6
   and the loader's wait beside phase 9's timed eager fit; (c) the stage-2
   step at full width with the critics (batch 1, 512 px, accumulation 1), one
   ``GraphedTrainStep`` per task (ir, cls, seg) sharing one ``GraphCache``:
   eager repeats counted in the default mode (the critics' resizes
   differentiate through ``index_add_``'s atomic adds), then under
   ``torch.use_deterministic_algorithms(True)`` eager, eager and the graph
   from one state bit-equal, launches at capture ``EXPECTED_STAGE2``;
20. (after 19 (b), on phase 12's scratch tree) the graph route for stage 3 and
   for the validation networks: (a) one stage-3 micro-step of RetinaNet and of
   Faster R-CNN (full width with TFA's four tasks, batch 1, 512 px, three
   boxes, only the task prompts trained), eager and from a
   ``GraphedTrainStep``: two eager micro-steps compared in the default mode,
   then under deterministic algorithms eager, eager and the graph bit-equal
   (or, where an op names itself as having no deterministic kernel, within
   phase 12's card-vs-CPU limits), launches at capture ``EXPECTED_STAGE3``,
   none in a replay, ms a micro-step, warm-up and capture s, the GiB of the
   graphs' pool; (b) phase 12's RetinaNet fit command for 3 micro-steps at
   accumulation 3 under deterministic algorithms, eagerly and with
   ``--trainer.cuda_graphs true``: logs and ``last.npz`` bit-equal, launches
   three times ``EXPECTED_STAGE3`` at micro-step 1 and none after, validation
   restores within one uint8 level of eager; (c) every network the JAX
   package jits in validation (the zoos' probes, the stage-2 probes, LPIPS,
   the NR networks, Inception) eager and from a ``GraphedCall`` on one
   seeded batch: bit-equal under deterministic algorithms, no repo-kernel
   launch, ms a call, busy ms a call of each route, capture s, pool GiB; (d)
   phase 14's NR and phase 13's cls ``all_ft`` validate commands, the latter
   over three images of three sizes, eagerly (NR: phase 14's run) and with
   ``--trainer.cuda_graphs true``: keys and values equal, a second
   validation on the graph route all replays, captures per image and s per
   image of the first validation and of the second on each route;
21. (after 20) from a checkpoint file to a restore, without JAX: (a) in the
   reference worker (from phase 7 on, beside phases 8-15), a seeded
   full-width sd-turbo VAE and UNet written as a diffusers directory
   (``vae/`` and ``unet/diffusion_pytorch_model.safetensors``, fp32, the 248
   and 686 keys a real file has) by the script's own writer into a
   temporary directory outside the repository (free space checked first),
   then ``python -m unirestore_torch.convert sd_turbo``; in the script,
   ``zoo.load_frozen_backbone`` over the seed-0 init takes every VAE and
   UNet leaf from the converted files, bit-equal to the seeded tree; (b)
   ``cache_quality.sweep`` from the converted directory on exact, encoder
   (stride 2) and deep (stride 17, warmup 3) at 512 px, batch 4, 20 steps:
   each output bit-equal to ``restore_padded`` of the seeded tree with the
   same noise, launches per restore phase 4's of the mode; (c) the sweep as a
   user runs it, ``python -m unirestore_torch.cache_quality --modes deep
   --strides 17 --warmups 3`` (beside (a)'s check and (b)): its row equal to
   (b)'s deep row. Seconds, bytes and tensor counts of each step;
8. the restore server (``unirestore_torch.serve``) in this process on
   127.0.0.1 at an ephemeral port: full width, bf16, 20 steps, exact, batch
   4 tiles of 512 px with overlap 64, fused out-projection on. It answers
   ``/healthz``, an 800 x 1200 PNG (six tiles, two batches; sent twice, cold
   and warm), a 256 x 384 PNG (restored whole at 512 x 768) and an unknown
   task (400), each with the right status, size and per-request launch
   counts; the tiled answer equals the in-process call within one uint8
   level. Then the same server with ``--cuda-graphs`` answers the same
   requests: one capture per key (the tile batch's (task, steps) and the
   256 x 384 shape), each answer within one uint8 level of the eager
   in-process call;
9. fit through the CLI: ``unirestore_torch.main.main`` called in this
   process (so the launch counters can be read) with
   ``fit --config configs/train_stage1.yaml`` and dotted overrides only (the
   DIVF2KOST lists of the 576 px smoke tree that ``tools/make_smoke_data.py``
   makes, 6 micro-steps, validation every 3 over 2 batches, the log
   directory): full width, bf16 frozen and fp32 trainable, remat on, batch 3,
   accumulation 2, sanity validation, AdamW and OneCycle, 8 loader workers.
   Checks: finite logged losses; each micro-step's launches equal phase 6's;
   the validation restores' launches equal the routing's at one DDIM step;
   every CFRM / Controller / SC-Tuner leaf changed or, where its updates fell
   below its fp32 resolution, carrying a nonzero Adam first moment in
   ``last.npz``; every frozen byte as a fresh seeded build; ``step=3-...``,
   ``step=6-...`` and ``last.npz`` written; the first micro-step's losses
   bit-equal to ``make_train_step`` called directly on its batch and noise;
   one micro-step under
   ``torch.cuda.set_sync_debug_mode("error")``. Then ``--trainer.resume auto
   --trainer.max_steps 8`` (``last.npz`` at step 8), ``predict`` (one PNG per
   image, each its input's size), a run without validation timed over
   micro-steps 2-6 with the card synchronised at both ends, and a run of
   ``FIT_PROFILED_STEPS`` micro-steps profiled over steps 2-3
   (``--trainer.profiler``: device busy and idle share). Reported: the timed run's s/step and train img/s beside phase
   6's, the trainer's own ``[timing]`` p50 (the host time of a step call,
   which does not wait for the card), the loader wait per step, peak
   memory. Every (kernel, shape) the fit, resume and predict launched that
   phase 3 did not hold is then held to its plain version as phase 3 holds
   its own (rows with ``"path": "fit"``);
11. (run after phase 9, before the report) stage 2 through the CLI:
   ``unirestore_torch.main.main`` with ``fit --config
   configs/train_stage2.yaml`` and dotted overrides only (phase 9's smoke
   tree's ir, cls and seg lists, 12 micro-steps, validation every 6 over 2
   batches, 2 sanity batches, the log directory): the ``mtl`` engine at full
   width, TFA for ir / cls / seg trained through the frozen ResNet-50 and
   DeepLabV3+-ResNet-50 critics (seeded, fp32), CFRM / Controller / SC-Tuner
   frozen, batch 1, 512 px crops, accumulation 6, AdamW and OneCycle. Checks:
   the mixture gave micro-steps of all three tasks; every micro-step's losses
   finite; launches per micro-step and task as the routing implies, and the
   validation restores' as their image sizes route them; only ``tfa`` leaves
   changed, the frozen tree as a fresh build, both critics as a fresh build;
   each task's prompt moved or carries a nonzero Adam first moment after the
   first update; the first micro-step's losses bit-equal to a direct
   ``make_train_step`` with the same task loss; a seg and a cls micro-step
   under ``set_sync_debug_mode("error")``; the validation metrics hold
   ``val_ir_lq/psnr``, the ``r50v1`` accuracies and the ``dlv3pr50`` IoU, and
   ``val_monitor`` is the IR PSNR; ``step=6-...``, ``step=12-...`` and
   ``last.npz``; a resume to step 13. Reported: s per micro-step of each task
   (the card synchronised before and after each, each task's first left
   out), the loader wait, peak memory, and the critics' share of a cls and a
   seg micro-step's device time (profiled, by kernel family). Every (kernel,
   shape) it met that was not held yet is held to its plain version (rows
   with ``"path": "fit_stage2"``). Then one stage-2 loss for cls and one for
   seg and the TFA gradient norm at full width, 256 px, fp32, card vs CPU;
12. (run after phase 11, before the report) stage 3 through the CLI:
   ``unirestore_torch.main.main`` with ``fit --config
   configs/train_stage3.yaml`` and dotted overrides only (the smoke tree's
   COCO list; phase 9's ``last.npz`` for frenc and cnet and phase 11's for
   tedit, so the three stages chain; 12 micro-steps, validation every 6 over
   2 batches, the log directory): the ``det`` engine at full width, only the
   TFA task prompts trained through the frozen RetinaNet (seeded, fp32),
   batch 1, 512 px crops, accumulation 6. Checks: CFRM, Controller, control
   and the TFA editors bit-equal to the checkpoints they came from and the
   det prompt at its fresh init before step 1; after the fit only the task
   prompts changed (det and ir with gradients, cls and seg by weight decay
   alone, zero Adam first moments), the frozen tree and the critic as fresh
   builds; every micro-step's losses finite and step 1's bit-equal to a
   direct ``make_train_step``; a micro-step under
   ``set_sync_debug_mode("error")`` (the detector's loss reads nothing back
   to the host); launches per micro-step and per validation restore as the
   routing implies; the validation keys ``val_lq/map`` and ``val_monitor``;
   ``step=6-...``, ``step=12-...``, ``last.npz`` and a resume to step 13.
   Then the same with ``--model.init_args.downstream fastrcnn`` for 3
   micro-steps at accumulation 3 (one update, one validation of 2 batches, a
   micro-step under the sync check). Reported: s per micro-step (the card
   synchronised before and after each, the first left out), the loader wait,
   peak memory, and each detector's share of a micro-step's device time
   (profiled, by kernel family). Every (kernel, shape) it met that was not
   held yet is held to its plain version (rows with ``"path":
   "fit_stage3"``). Then the RetinaNet and
   the Faster R-CNN stage-3 losses and the prompts' gradient norm at full
   width, 256 px, fp32, card vs CPU;
13. (run after phase 12, before the report) the ``cls`` and ``seg`` engines
   and their probe zoos: every probe (each ``classifier_zoo._SPECS`` entry,
   ``dlv3pr50`` and ``rflwr101``) built seeded in fp32 on the card and run on
   one seeded batch (1 x 512 x 512 for the classifiers, resized to 224 px
   inside; 1 x 576 x 592 for the segmenters), its logits within 1e-4 of the
   largest |logit| of the same tree and batch on the CPU and no launch of
   the repo's kernels, with how far the input reaches the logits (their
   change against a blank image), ms per call, the device's kernels per call
   and busy ms by kernel family; then
   ``unirestore_torch.main.main`` with ``fit --config
   configs/train_stage2.yaml`` and dotted overrides only
   (``--model.class_path unirestore_tpu.cls --data.init_args.task cls
   --model.init_args.eval_mode all``; then ``...seg ... single``; phase 9's
   smoke tree, 6 micro-steps, one validation over 2 batches). Checks: finite
   losses; step 1 bit-equal to a direct ``make_train_step`` with the
   engine's task loss; only leaves the stage's filter selects changed, the
   engine's own prompt among them; the frozen tree and the critic as fresh
   builds; a micro-step under ``set_sync_debug_mode("error")``; launches per
   micro-step and per validation restore as the routing implies; the
   validation keys of every probe of the set (``val_hq`` and ``val_lq`` for
   cls, ``val_lq`` for seg) and ``val_monitor`` equal to ``val_lq/r50v1``
   (cls) or ``val_lq/rflwr101`` (seg); ``last.npz``. Then ``validate`` runs
   of the cls engine with ``all_ft`` (monitor ``r50v1_ft``) and ``CUB`` (a
   list of the tree's cls images, labels mod 200; monitor ``cub_r50``) and
   of the seg engine with ``all``: keys, monitor and launches. Reported: s
   per micro-step (the card synchronised before and after each, the first
   left out), validation s per image of each probe set, peak memory, the
   probes' share of a validation's device time (profiled). Every (kernel,
   shape) met that was not held yet is held to its plain version (rows with
   ``"path": "fit_cls"`` or ``"fit_seg"``);
14. (run after phase 13, before the report) validation with the no-reference
   suite and FID: ``unirestore_torch.main.main`` with ``validate --config
   configs/val.yaml`` and dotted overrides only (the smoke tree's IR val
   list, phase 9's ``last.npz`` for frenc and cnet and phase 11's for tedit,
   two images), once with ``--model.init_args.eval_mode ALL
   --model.init_args.compute_fid true`` and once with ``eval_mode NR``: the
   full-width restore in bf16 at one DDIM step, LPIPS, FID over the seeded
   InceptionV3, and the 10-metric NR suite (8 seeded fp32 networks on the
   card, NIQE and PI on the host from the committed ``weights/*.npz``).
   Checks: exactly the JAX evaluator's keys, all finite, ``val_monitor``
   equal to ``val_lq/psnr`` (ALL) or ``val_lq/niqe`` (NR); launches as 4 (ALL)
   or 2 (NR) validation restores route them, the NR networks launching none;
   NIQE and NRQM rerun on the run's uint8 predictions bit-equal; one call of
   each neural metric and of FID's extractor under
   ``set_sync_debug_mode("warn")`` makes at most one synchronisation (the
   read-back); every NR network and the Inception extractor seeded in fp32
   (BatchNorm statistics set from the batch for CLIP-IQA, NIMA and HyperIQA,
   whose seeded init erases the input) on one seeded 512 x 512 batch,
   card vs CPU, within 1e-4 of the largest |value| on the features before the
   head and on the score, with each one's reach. Reported: validation s per
   image in ALL and NR, FID's compute seconds, host s per image of NIQE and
   NRQM, ms per call of each network with the card's busy ms and kernels, a
   second NR validation's s (phase 20 (d)'s eager route), the NR networks'
   share of an NR validation's device time (profiled), peak
   memory, the phase's seconds. Every (kernel, shape) met that was not held
   yet is held to its plain version (rows with ``"path": "validate_nr"``);
15. (run after phase 14, before the report) the ``spade`` control type, the
   optimizers and the DeepLab backbones: phase 4's model, batch, noise and
   modes with ``control_type="spade"`` and ``UNetConfig(control_type=
   "spade")`` (22 SPADE blocks, 53.02 M more trainable parameters), each
   restore eagerly (under ``set_sync_debug_mode("error")``) and from one
   ``GraphedRestore`` graph: launches per restore equal to phase 4's of the
   mode, the replay within one uint8 level of the eager restore, img/s both
   ways, PSNR of each cached mode and the fused route against exact, and
   exact under ``scedit`` and ``spade`` in turns on both routes (SPADE's
   share of the restore); the SPADE restore (unfused, fused, graph) and one
   SPADE stage-1 loss with its per-family gradient norms at 256 px in fp32,
   card vs CPU, as phases 5 and 7; the full-width SPADE stage-1 step (512 px,
   batch 8, remat, bf16 frozen) with AdamW, ``lamb`` and ``adafactor``, one
   warm-up and two timed steps each: ms/step, train img/s, peak memory,
   launches per step (forward as phase 6's; recompute and backward over the
   whole UNet); every optimizer name of the JAX ``make_optimizer`` over a
   seeded tree (two updates, clip, accumulation 2), card vs CPU; every
   DeepLab name over MobileNetV2, Xception and HRNetV2-32 / -48, fp32 at
   512 x 512, card vs CPU with its reach and ms a call, no repo kernel
   launch. Every (kernel, shape) met that was not held yet is held to its
   plain version (rows with ``"path": "spade"``). To run it alone from a
   throwaway script: ``nn.kernels.build_all()``, then ``chip_smoke.run_phase15
   (UR, KN, GR, bridge, TS, OPT, gen, refs)`` with ``refs =
   chip_smoke.CpuReferences()``;
16. (run after phase 15, its torchrun jobs at once with phase 17's and with
   phase 18 (d) in the script's own process) data parallelism
   (``unirestore_torch/parallel``): (a) phase 9's first fit (its YAML,
   overrides and smoke tree; no validation) under ``python -m
   torch.distributed.run --standalone --nproc_per_node 1`` with
   ``--distributed`` (NCCL at world size 1) for 2 micro-steps, and at the same
   time with ``--trainer.fsdp true``: launches per micro-step as phase 6's, every logged
   loss bit-equal to phase 9's same micro-step, ``last.npz``'s trainable tree
   bit-equal to phase 9's after micro-step 2; (b) phase 6's cell at two ranks
   on the one card over gloo (NCCL takes one rank a device), global batch 8
   (2 x 4) with phase 6's seeds, DDP and then FSDP, 2 steps each: launches per
   rank and step as phase 6's, the global loss and gradient norm within
   ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_RTOL`` of phase 6's first two steps;
   each rank's ms per step, the gradient sync's and FSDP's gathers' ms, memory
   held and peak; (c) the restore cell's persistent bytes per rank, frozen
   bf16, trainable fp32 and AdamW slots, replicated and under FSDP
   (``fsdp_spec``) at 2, 4 and 8 ranks. The ranks are this script run as
   ``chip_smoke.py --worker fit|train ...`` by torchrun. Every (kernel, shape)
   they met that was not held yet is held to its plain version (rows with
   ``"path": "fit_ddp"`` / ``"train_ddp2"``);
17. (run at once with phase 16) the 2-D (data, spatial) mesh: ``restore_padded``
   with a ``spatial_batch_sharding`` of ``make_mesh_2d(1, 2)``, two ranks on
   the one card over gloo, each restoring half of the height (halo rows,
   partial sums and attention gathers by hand, ``parallel/spatial.py``): (a)
   full width, fp32, 256 px, batch 2, 2 steps, the assembled output against
   the single-process restore on the card within ``REFERENCE_ATOL``, launches
   per rank the single process's; (b) full width, bf16, 512 px, batch 4,
   exact at 5 steps and deep at 20 (its warm-up and stride need 20): finite,
   launches per rank phase 4's per step,
   seconds a restore per rank, peak and held memory per rank against the
   single-process restore's, the collectives by kind and (a one-step exact
   restore with the card synchronised around each) their seconds, the
   card's busy seconds by kernel family in a one-step restore on each rank
   and in the single-process one (each rank runs the whole image's
   attention), the assembled output in uint8 levels and PSNR against the
   single-process restore of the same batch and noise; uneven shards, whose
   levels from the first the ranks cannot split run whole on both
   (``models/unirestore.py:spatial_plan``): (c) full width, fp32, 320 px,
   batch 2, 2 steps (UNet level 3, 5 rows, whole) as (a); (d) full width,
   bf16, ``restore(..., sharding=)`` of four 500 x 375 originals (resized
   and padded to 704 x 512; UNet level 3, 11 rows, whole), exact, 5 steps:
   launches per rank and in one process (35, 70, 0, 0, 3), seconds a
   restore per rank against one process, collectives by kind (and their
   seconds in a one-step restore with the card synchronised around each), held and peak
   memory per rank against one process's peak, the most a whole level added
   to the card's memory in a one-step restore, uint8 levels and PSNR against
   one process, the first whole level. The ranks are this script run as
   ``chip_smoke.py --worker spatial ...`` by torchrun; every (kernel, shape)
   they met that was not held yet (the grouped conv on haloed slabs, the
   attention kernels at 704 x 512) is held to its plain version (rows with
   ``"path": "spatial"``);
10. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``. Per kernel,
   ``launches`` is the sum over the paths that drove it, which
   ``launches_by_path`` lists (``restore``: phase 4's exact, encoder and deep
   restores; ``restore_fused``: its fused ones; ``train``: phase 6's six
   steps; ``serve``: phase 8's requests; ``restore_graph``,
   ``restore_fused_graph`` and ``serve_graph`` the same on the graph route,
   each graph's launches at capture times its replays; ``fit``: phase 9's
   first fit, training and validation; ``fit_stage2``: phase 11's fit;
   ``fit_stage3``: phase 12's RetinaNet fit; ``fit_cls`` and ``fit_seg``:
   phase 13's fits of the two engines; ``validate_all`` and ``validate_nr``:
   phase 14's two validate runs; ``restore_spade_exact``, ``_encoder``,
   ``_deep``, ``_fused``: phase 15's eager restore of the mode plus its
   graph's launches at capture times its replays; ``train_spade``: phase
   15's twelve steps; ``fit_ddp`` and ``fit_fsdp``: phase 16's world-1 fits;
   ``train_ddp2`` and ``train_fsdp2``: phase 16's two-rank steps, both
   ranks; ``spatial_exact`` and ``spatial_deep``: phase 17's bf16 restores,
   both ranks; ``spatial_restore``: phase 17's (d), both ranks; ``train_split``:
   phase 18's full split steps of (a) and (b); ``fit_split``: phase 18's
   split fit; ``train_graph``: phase 19 (a)'s graph route, the first call's
   eager warm-ups and capture plus the launches at capture times the
   replays; ``fit_graph``: phase 19 (b)'s fit, the same with its restore
   graphs, less the eager restores it compares with; ``train_det_graph``:
   phase 20 (a)'s graph route of both detectors, as ``train_graph``;
   ``fit_stage3_graph``: phase 20 (b)'s fit, as ``fit_graph``;
   ``cache_quality``: phase 21 (b)'s three restores); each kernel must
   have run on every path that routes to it. ``ms``, ``plain_ms``,
   ``bound_ms`` and ``library_ms`` are sums of one call at each of its main-path shapes, which
   ``shapes`` lists one by one.

Each phase prints its seconds (``phase N: ... s (script ... s)``) and the
report a ``{"phase_seconds": ...}`` line. It needs one CUDA device and
imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
BATCH = 8
RES = 512
STEPS = 20
# phase 4's restores in the order they run: (name, cache mode, stride,
# warmup, fused out-projection); exact and fused twice each, in turns
RUNS = (("none", "none", 2, 0, False), ("fused", "none", 2, 0, True),
        ("encoder", "encoder", 2, 0, False), ("deep", "deep", 17, 3, False),
        ("fused", "none", 2, 0, True), ("none", "none", 2, 0, False))
# launches per 512 px restore at 20 steps, in the order of ``kernels.KERNELS``:
# (btc, bh, stream, btc_out, grouped conv); the grouped conv runs once per
# CFRM stage in the one encode. The fused route takes every btc launch: each
# channel-flat self-attention's out-projection is 320, 640 or 256 wide.
EXPECTED = {"none": (280, 140, 2, 0, 3), "encoder": (200, 100, 2, 0, 3),
            "deep": (136, 28, 2, 0, 3), "fused": (0, 140, 2, 280, 3)}
# phase 4's graph route: one captured restore of each distinct run, then
# eager and replayed restores in turns
GRAPH_RUNS = tuple({run[0]: run for run in RUNS}.values())
GRAPH_TURNS = ("eager", "graph", "graph", "eager")
# launches per stage-1 training step, (forward, remat recompute, backward):
# the Controller (btc 4, bh 2, not rematerialised) and the UNet (btc 10, bh 5)
# run once; only the UNet's up path carries gradients (SC-Tuner edits the
# skips after the down path and the mid block), and its units are
# rematerialised (btc 6, bh 3); the VAE mid-block attention runs in both
# encodes behind the latent path's detach; the three CFRM grouped convs run in
# the lq encode, each in a rematerialised AdaNAF block
EXPECTED_TRAIN = {"ur_attention_btc": (14, 6, 10), "ur_attention_bh": (7, 3, 5),
                  "ur_attention_stream": (2, 0, 0), "ur_attention_btc_out": (0, 0, 0),
                  "ur_grouped_conv3": (3, 3, 3)}
# phase 8: the server's flags, and per request (name, task, image H x W,
# HTTP status, launches in KERNELS order). 800 x 1200 makes six 512 px tiles
# at overlap 64 (rows 0/288, columns 0/448/688), two batch-4 restores; 256 x
# 384 restores whole at 512 x 768, where UNet level 0/1/2 run T = 6144 /
# 1536 / 384 and the VAE mid block T = 6144, the same routes as at 512 px.
SERVE_FLAGS = ["--host", "127.0.0.1", "--port", "0", "--tasks", "ir,cls,seg", "--steps", "20",
               "--cache-mode", "none", "--batch-tiles", "4", "--overlap", "64",
               "--fused-out-attn"]
SERVE_REQUESTS = (("tiled_cold", "ir", (800, 1200), 200, (0, 280, 4, 560, 6)),
                  ("tiled", "ir", (800, 1200), 200, (0, 280, 4, 560, 6)),
                  ("whole", "cls", (256, 384), 200, (0, 140, 2, 280, 3)),
                  ("unknown_task", "nope", (64, 64), 400, (0, 0, 0, 0, 0)))
# the server with --cuda-graphs: both keys (the batch of four tiles, task ir;
# the 256 x 384 image, task cls) capture one restore of the counts above; the
# first request of a key counts an eager warm-up restore and the capture, a
# replay counts nothing. Replays per key: two batches in each of two tiled
# requests, one whole restore.
SERVE_BATCH = (0, 140, 2, 280, 3)
GRAPH_SERVE_COUNTS = {"tiled_cold": (0, 280, 4, 560, 6), "tiled": (0, 0, 0, 0, 0),
                      "whole": (0, 280, 4, 560, 6), "unknown_task": (0, 0, 0, 0, 0)}
GRAPH_SERVE_REPLAYS = {(4, RES, RES, 3): 4, (1, 256, 384, 3): 1}
TRAIN_STEPS = 5
# phase 18: the step's parts in turn. (a) phase 6's cell, the port's step
# and ``monolithic_step`` from one state for two micro-steps, then in turns
# (SPLIT_TURNS) of SPLIT_TURN_STEPS synchronised steps; (b) SPLIT_BIG_BATCH,
# or the largest multiple of 8 below it at which (a)'s monolithic peak,
# extrapolated in the batch, stays under SPLIT_MEM_SHARE of the card, in the
# same turns of SPLIT_BIG_STEPS steps; (c) the step ended after each part,
# SPLIT_CUT_STEPS steps each; (d) phase 9's fit command with
# --trainer.split_step true for FIT_SPLIT_STEPS micro-steps
SPLIT_TURNS = ("mono", "split", "split", "mono")
SPLIT_TURN_STEPS = 2
SPLIT_BIG_BATCH = 32
SPLIT_BIG_STEPS = 1  # one step a turn: the 1200 s of the script hold phase 19 too
SPLIT_MEM_SHARE = 0.9
SPLIT_CUT_STEPS = 2
FIT_SPLIT_STEPS = 2
# phase 19: the graph-captured step (``graphs.GraphedTrainStep``). (a) phase
# 6's cell (phase 18's build), eager and graph from one state for one
# accumulating and one applying micro-step, then in turns (GRAPH_TRAIN_TURNS)
# of GRAPH_TURN_STEPS synchronised micro-steps, then one pair of each route
# under torch.profiler for the card's idle share; (b) phase 9's fit command
# with --trainer.cuda_graphs true: FIT_STEPS micro-steps, sanity validation,
# validation at FIT_STEPS over FIT_GRAPH_VAL_BATCHES batch; (c) one stage-2
# micro-step of each task (STAGE2_GRAPH_TASKS: batch 1, 512 px, the critics,
# accumulation 1 so that it applies) eager and from its graph, then in turns
GRAPH_TRAIN_TURNS = ("eager", "graph", "graph", "eager")
GRAPH_TURN_STEPS = 2
FIT_GRAPH_VAL_BATCHES = 1
STAGE2_GRAPH_TASKS = ("ir", "cls", "seg")
# phase 20: the graph route for stage 3 and for the validation networks. (a)
# one stage-3 micro-step of each detector (STAGE3_GRAPH_DETECTORS: batch 1,
# 512 px, three boxes, the full-width model with TFA's four tasks, only the
# task prompts trained, AdamW at accumulation 1 so that it applies) eager and
# from its graph, as phase 19 (c); (b) phase 12's RetinaNet fit command with
# --trainer.cuda_graphs true for FIT3_GRAPH_STEPS micro-steps at that
# accumulation (one update), validation at the last over
# FIT3_GRAPH_VAL_BATCHES batch, held to the same command run eagerly without
# validation, both under deterministic algorithms; (c) every validation
# network the JAX package jits, eager and from its graph on one seeded batch
# (GRAPH_NET_CALLS timed calls of each route); (d) phase 14's NR validate,
# and phase 13's cls all_ft validate over one image of each
# VAL20_MIXED_SIZES size (so that each network and the restore meets a new
# input shape at every image of the first validation), eagerly and with
# --trainer.cuda_graphs true: keys and values equal, captures per image and s
# per image of the first validation and of a second one on each route
STAGE3_GRAPH_DETECTORS = ("retinanet", "fastrcnn")
FIT3_GRAPH_STEPS, FIT3_GRAPH_VAL_BATCHES = 3, 1
GRAPH_NET_CALLS = 5
VAL20_MIXED_SIZES = ((576, 592), (512, 640), (544, 704))
# phase 21: the seeded sd-turbo tree written as a checkpoint (CONVERT_SEED;
# every leaf drawn, none left constant, so none equals the seed-0 init's), and
# the quality sweep's configurations with phase 4's mode of each
CONVERT_SEED = 21
SWEEP_BATCH = 4
SWEEP_SPECS = {"exact": "none", "encoder:2:0": "encoder", "deep:17:3": "deep"}
# free space phase 21 needs beside its two copies of the tree (the fp32
# safetensors source and the converted npz)
CONVERT_SPARE_BYTES = 2**30
# phase 9: ``python -m unirestore_torch.main fit`` from the stage-1 YAML on
# the smoke tree of tools/make_smoke_data.py at 576 px (576 x 592 images),
# with dotted overrides only: the DIVF2KOST lists, 6 micro-steps (three AdamW
# updates at accumulation 2), validation every 3 over 2 batches; then a
# resume to step 8 and ``predict``; then a run of FIT_PROFILED_STEPS
# micro-steps profiled over steps 2-3 (the trainer's trace window ends at the
# run's last step; over steps 2-6, 129k kernels, the profiled run took about
# five times as long as the same run unprofiled)
FIT_YAML = REPO / "configs" / "train_stage1.yaml"
FIT_RES = 576
FIT_STEPS, FIT_VAL_EVERY, FIT_VAL_BATCHES, FIT_RESUME_STEPS = 6, 3, 2, 8
FIT_PROFILED_STEPS = 3
# every micro-step of the fit launches phase 6's per-step counts; every
# validation restore (batch 1, 512 x 512 after the evaluator's center crop,
# one DDIM step) one step's Controller and UNet attention (btc 14, bh 7), the
# VAE mid block in the encode and the decode (stream 2) and the three CFRM
# grouped convs. The sanity check and each validation restore hq and lq of
# 2 batches each.
FIT_RESTORE = (14, 7, 2, 0, 3)
FIT_VAL_RESTORES = 2 * (2 + 2 * FIT_VAL_BATCHES)
FIT_SYNC_CHECK_STEP = 3  # the micro-step run under set_sync_debug_mode("error")
# phase 11: ``python -m unirestore_torch.main fit`` from the stage-2 YAML (the
# mtl engine: TFA for ir, cls and seg trained through the frozen ResNet-50
# and DeepLabV3+ critics; batch 1, accumulation 6) on phase 9's smoke tree,
# with dotted overrides only: its lists, 12 micro-steps (two AdamW updates),
# validation every 6 over 2 batches, 2 sanity batches. The data seed of the
# YAML (the loader's default, 0) draws from the mixture's weights [0.2, 10, 1]
# over the tree's 6 cls, 4 seg and 6 ir samples the tasks
# seg seg cls ir seg seg ir cls seg seg seg seg; then a resume to step 13
FIT2_YAML = REPO / "configs" / "train_stage2.yaml"
FIT2_LISTS = (("DIVF2KOST", "ir", ("train", "val")), ("ImageNet", "cls", ("train", "val")),
              ("FoggyCityscapes", "seg", ("train",)), ("Cityscapes", "seg", ("val",)))
FIT2_STEPS, FIT2_ACCUM, FIT2_VAL_EVERY, FIT2_VAL_BATCHES, FIT2_SANITY = 12, 6, 6, 2, 2
FIT2_RESUME_STEPS = 13
FIT2_SYNC_CHECK_STEPS = (4, 7)  # a seg and a cls micro-step, after each task's first
# launches (forward, recompute, backward) per stage-2 micro-step: no gradient
# reaches an attention or a grouped conv (CFRM, Controller and SC-Tuner are
# frozen; the TFA units come after the VAE mid block), so nothing is
# recomputed or differentiated; one step's Controller and UNet, the three
# CFRM grouped convs of the lq encode, the VAE mid block in two encodes and
# one decode, and on cls and seg one more decode (the auxiliary IR loss)
EXPECTED_STAGE2 = {"ir": {"ur_attention_btc": (14, 0, 0), "ur_attention_bh": (7, 0, 0),
                          "ur_attention_stream": (3, 0, 0), "ur_attention_btc_out": (0, 0, 0),
                          "ur_grouped_conv3": (3, 0, 0)}}
EXPECTED_STAGE2["cls"] = EXPECTED_STAGE2["seg"] = {**EXPECTED_STAGE2["ir"],
                                                   "ur_attention_stream": (4, 0, 0)}
# validation restores: the sanity check's 2 ir batches (hq and lq), then at
# steps 6 and 12 the 2-batch limit over the three loaders in turn: 2 ir
# batches (hq and lq), 1 cls (hq and lq), 1 seg (lq)
FIT2_VAL_RESTORES = {"ir": 2 * FIT2_SANITY + 2 * 2 * FIT2_VAL_BATCHES, "cls": 2 * 2, "seg": 2}
# launches per validation restore, by the loader's image size: ir 512 x 512
# after the evaluator's crop (latent T = 4096 / 1024 / 256, FIT_RESTORE); cls
# 512 x 526 (the short edge resized to 512), padded to 512 x 576 (T = 4608 /
# 1152 / 288: channel-flat attention only at T = 4608, T % 256 != 0 at 1152
# goes head-major, and the VAE mid block's 512-wide head at T = 4608, not a
# multiple of 1024, runs the plain version); seg 576 x 592, padded to 576 x
# 640 (T = 5760 / 1440 / 360: all head-major, the mid block plain)
FIT2_RESTORE = {"ir": FIT_RESTORE, "cls": (7, 14, 0, 0, 3), "seg": (0, 21, 0, 0, 3)}
# phase 12: ``python -m unirestore_torch.main fit`` from the stage-3 YAML (the
# det engine: only the TFA task prompts train, through the frozen RetinaNet;
# batch 1, 512 px crops, accumulation 6) on phase 9's smoke tree, with dotted
# overrides only: its COCO list (4 images of 120 x 140 px, one box each),
# phase 9's last.npz for frenc and cnet and phase 11's for tedit (the three
# stages chained), 12 micro-steps (two AdamW updates), validation every 6
# over 2 batches; then a resume to step 13, and a fit through Faster R-CNN
# (``downstream: fastrcnn``) of FIT3_FRCNN_STEPS micro-steps at that
# accumulation: one update, one validation (6 at the YAML's 6 until phase 20
# needed the seconds)
FIT3_YAML = REPO / "configs" / "train_stage3.yaml"
FIT3_STEPS, FIT3_ACCUM, FIT3_VAL_EVERY, FIT3_VAL_BATCHES = 12, 6, 6, 2
FIT3_RESUME_STEPS = 13
FIT3_FRCNN_STEPS = 3
FIT3_SYNC_CHECK_STEP = 2  # after the first micro-step has made the cached constants
# launches per stage-3 micro-step: those of a stage-2 cls or seg micro-step
# (the det decode and the auxiliary IR decode); no gradient reaches a kernel
EXPECTED_STAGE3 = EXPECTED_STAGE2["cls"]
# validation restores: the lq image of each batch; a 120 x 140 image upscales
# to 512 x 597 and pads to 512 x 640 (latent T = 5120 / 1280 / 320: channel-
# flat at 5120 and 1280, head-major at 320, the VAE mid block at T = 5120
# streaming), the routes of a 512 x 512 restore
FIT3_RESTORE = FIT_RESTORE
# phase 13: ``python -m unirestore_torch.main fit|validate`` from the stage-2
# YAML made the cls or the seg engine by dotted overrides only
# (``--model.class_path unirestore_tpu.cls|seg --data.init_args.task
# cls|seg --model.init_args.eval_mode <mode>``) on phase 9's smoke tree: 6
# micro-steps (one AdamW update at the YAML's accumulation 6) and one
# validation over 2 batches at step 6 with the probe set of FIT13_MODES; then
# validate runs with the other probe sets (VALIDATE13). Every probe of the
# zoos is first held to its CPU run on one seeded batch (PROBE_SHAPES)
FIT13_STEPS, FIT13_SYNC_CHECK_STEP = 6, 2
FIT13_MODES = {"cls": ("all", "r50v1"), "seg": ("single", "rflwr101")}
VALIDATE13 = (("cls", "all_ft", "r50v1_ft"), ("cls", "CUB", "cub_r50"), ("seg", "all", "rflwr101"))
# a validation batch restores hq and lq (cls) or lq alone (seg)
FIT13_RESTORES = {"cls": 2, "seg": 1}
PROBE_SHAPES = {"cls": (1, 512, 512, 3), "seg": (1, 576, 592, 3)}
# fp32 probe logits, card vs CPU, relative to the largest |logit|: other
# convolution algorithms and summation orders (about 1e-6 relative a layer)
# through up to 101 layers
PROBE_RTOL = 1e-4
# phase 14: ``python -m unirestore_torch.main validate`` from configs/val.yaml
# with dotted overrides only (the smoke tree's IR val list; phase 9's last.npz
# for frenc and cnet and phase 11's for tedit; two images): eval_mode ALL with
# compute_fid, then NR. A validation restores hq and lq (ALL) or lq alone (NR),
# each at 512 x 512 after the evaluator's crop, one DDIM step (FIT_RESTORE)
VAL14_YAML = REPO / "configs" / "val.yaml"
VAL14_RUNS = (("ALL", True), ("NR", False))
VAL14_IMAGES = 2
VAL14_RESTORES = {"ALL": 2 * VAL14_IMAGES, "NR": VAL14_IMAGES}
# each NR network and FID's Inception in fp32 on one seeded batch, card vs CPU,
# relative to the largest |value| of the features before the head and of the
# score: other convolution algorithms and summation orders (about 1e-6
# relative a layer) through up to 200 layers
NR_SHAPE = (1, RES, RES, 3)
NR_RTOL = 1e-4
# the networks compared with BatchNorm statistics set from the batch: at the
# seeded init's unit statistics their input reaches the score by 2.3e-5
# (clipiqa), 4.2e-4 (nima-koniq) and 8.8e-4 (hyperiqa) of its largest (CPU
# tests); the input moves Inception's pool3 features by 0.43 of their largest
# as seeded (CPU test), and with batch statistics its layers without residual
# scaling amplify the two devices' summation orders to 3.4e-4 of the largest
# feature, so it is compared as seeded
NR_CALIBRATED = ("clipiqa", "nima-koniq", "hyperiqa")
# phase 15: the restore under the ``spade`` control type in phase 4's modes
# (name, cache mode, stride, warmup, fused out-projection); the kernel paths
# of the kernels line by name. SPADE adds no attention and no grouped conv, so
# each restore launches phase 4's counts of its mode (EXPECTED).
SPADE_RUNS = (("none", "none", 2, 0, False), ("encoder", "encoder", 2, 0, False),
              ("deep", "deep", 17, 3, False), ("fused", "none", 2, 0, True))
SPADE_PATHS = {"none": "restore_spade_exact", "encoder": "restore_spade_encoder",
               "deep": "restore_spade_deep", "fused": "restore_spade_fused"}
# launches per stage-1 step under SPADE, (forward, remat recompute, backward):
# the forward is phase 6's; a SPADE in every UNet resnet puts trainable leaves
# in the down path and the mid block too, so every rematerialised UNet unit is
# recomputed (btc 10, bh 5; the mid block's T = 64 head runs plain) and every
# attention of the Controller and the UNet is differentiated (btc 14, bh 7)
EXPECTED_TRAIN_SPADE = {"ur_attention_btc": (14, 10, 14), "ur_attention_bh": (7, 5, 7),
                        "ur_attention_stream": (2, 0, 0), "ur_attention_btc_out": (0, 0, 0),
                        "ur_grouped_conv3": (3, 3, 3)}
# the SPADE step's optimizers: AdamW (the stage-1 YAML's) and the two names
# with the most work per step; one warm-up and SPADE_TRAIN_STEPS timed steps
# each (3 until phase 20 needed the seconds), accumulation 1 so that every
# step updates
SPADE_OPTS = ("adamw", "lamb", "adafactor")
SPADE_TRAIN_STEPS = 2
# every name of the JAX ``make_optimizer``; two updates (accumulation 2, clip,
# OneCycle) card vs CPU in float64, where the comparison reads the port's
# arithmetic: in fp32 an element whose coupled-decay input cancels to within
# Adam's eps flips its step when the clip factor moves by one ulp (a sum in
# another order), which puts fp32 6.3e-4 of a leaf's largest from fp64 on one
# CPU for ``adam`` (9.3e-4 ``nadam``); the limit is the CPU tests' against optax
OPT_NAMES = ("adamw", "nadamw", "radam", "lamb", "lion", "adafactor", "lars", "sgdw",
             "adam", "nadam", "adamax", "sgd", "momentum", "rmsprop", "adagrad", "adadelta")
OPT_SHAPES = {"norm//b": (320,), "lin//w": (1280, 320), "conv//w": (640, 320, 3, 3)}
OPT_RTOL = 1e-5
# every DeepLab name the port's factory builds beyond the ResNets, fp32, one
# seeded 512 x 512 image, card vs CPU relative to the largest |logit|
DEEPLAB_NAMES = tuple(f"deeplabv3{plus}_{b}" for b in ("mobilenet", "xception", "hrnetv2_32",
                                                        "hrnetv2_48") for plus in ("", "plus"))
DEEPLAB_RTOL = 1e-4

# phase 16: data parallelism through torch.distributed. (a) phase 9's first
# fit (its YAML, overrides and smoke tree) under ``torch.distributed.run
# --standalone --nproc_per_node 1 ... fit --distributed`` (NCCL at world size
# 1) for DDP_STEPS micro-steps, and at once with ``--trainer.fsdp true``; (b)
# phase 6's stage-1 cell (full width, bf16 frozen, 512 px, AdamW) at two
# ranks on the one card over gloo (NCCL refuses two ranks on one device),
# global batch BATCH (2 x 4), DDP and FSDP, DDP_STEPS steps each, against
# phase 6's first DDP_STEPS steps on the same 8 rows and noise; (c) the
# per-rank persistent state bytes, replicated vs FSDP, of the restore cell's
# trees at STATE_WORLDS ranks (the port's counterpart of
# tools/debug_fsdp_memory.py)
DDP_STEPS, DDP_WORLD = 2, 2
STATE_WORLDS = (2, 4, 8)
DDP_TIMEOUT = 300
# phase 17: the 2-D (data, spatial) mesh, ``make_mesh_2d(1, SPATIAL_WORLD)``:
# SPATIAL_WORLD ranks on the one card over gloo, each restoring a slab of the
# height (``restore_padded(..., sharding=)``). (a) full width, fp32, 256 px,
# batch SPATIAL_REF_BATCH, 2 DDIM steps, the assembled output against the
# single-process fp32 restore of the same inputs and noise on the card within
# REFERENCE_ATOL; (b) full width, bf16, 512 px, batch SPATIAL_BATCH, in
# SPATIAL_MODES (phase 4's stride and warmup; exact at SPATIAL_STEPS steps, deep
# at phase 4's STEPS, the fewest at which its stride makes followers): seconds a restore per
# rank, peak and held memory per rank against the single-process restore's,
# collectives by kind and, in a one-step exact restore with the card
# synchronised around each, their seconds; in a profiled one-step restore,
# the card's busy seconds by kernel family (and one process's); the assembled
# output in uint8 levels and PSNR against the single-process restore of the
# same batch and noise; launches per rank as phase 4's per restore (attention
# runs on the gathered sequence, the grouped conv on haloed slabs; an exact
# restore's per step, so that at SPATIAL_STEPS they are exact_launches's)
# Uneven shards (run inside the same ranks): (c) full width, fp32, 320 px,
# batch SPATIAL_REF_BATCH, 2 steps, whose 5-row UNet level 3 two ranks cannot
# split, so it runs whole on both: the assembled output against one process
# on the card within REFERENCE_ATOL, launches per rank one process's; (d) full
# width, bf16, ``restore(..., sharding=)`` of SPATIAL_BATCH originals of
# SPATIAL_ORIGINALS (a 500 x 375 photo: resized to 683 x 512 and padded to
# 704 x 512, whose 11-row UNet level 3 runs whole), exact, SPATIAL_STEPS steps: s a
# restore per rank against one process, collectives by kind (their seconds in
# a one-step restore with the card synchronised around each), held and peak
# memory per rank against one process's peak, the most a whole level added
# to the card's memory, uint8 levels and PSNR against one process, the first
# whole level; launches per rank SPATIAL_RESTORE_EXPECTED's at SPATIAL_STEPS
# (exact_launches), one process's
SPATIAL_WORLD = 2
SPATIAL_REF_BATCH, SPATIAL_REF_RES = 2, 256
SPATIAL_UNEVEN_RES = 320
SPATIAL_BATCH = 4
# the exact restores' DDIM steps: gloo's host collectives make a sharded
# step take about 0.7 s, and the script's 1200 s hold phase 20 too
SPATIAL_STEPS = 5
SPATIAL_MODES = (("none", "none", 2, 0, SPATIAL_STEPS), ("deep", "deep", 17, 3, STEPS))
SPATIAL_PATHS = {"none": "spatial_exact", "deep": "spatial_deep", "restore": "spatial_restore"}
SPATIAL_ORIGINALS = (500, 375)
# launches per 704 x 512 exact restore at STEPS steps, (btc, bh, stream,
# btc_out, grouped conv): a step's channel-flat self-attentions are the
# UNet's five and the Controller's two at latent / 1 (T = 5632); at latent / 2
# (T = 1408, not a multiple of 256) the UNet's five and the Controller's two
# take the head-major kernel, as at latent / 4 (T = 352) the UNet's five and
# the Controller's two; the VAE's mid-block attention (T = 5632, not a
# multiple of 1024) runs plain, as it does in one process
SPATIAL_RESTORE_EXPECTED = (140, 280, 0, 0, 3)


def exact_launches(at_steps: tuple, steps: int) -> tuple:
    """An exact restore's launches (btc, bh, stream, btc_out, grouped conv) at
    ``steps`` DDIM steps from those at STEPS: every step runs the same
    attentions; the VAE (stream) and the CFRM (grouped conv) run once."""
    btc, bh, stream, out, gconv = at_steps
    if any(n % STEPS for n in (btc, bh, out)):
        raise ValueError(f"{at_steps} is not an exact restore's at {STEPS} steps")
    return (btc // STEPS * steps, bh // STEPS * steps, stream, out // STEPS * steps, gconv)

# the stage-1 YAML's optimizer surface (configs/train_stage1.yaml): AdamW,
# base_lr 1e-4 at base batch 64, weight decay 1e-2, OneCycle, 200k steps,
# gradient accumulation 2
STAGE1_OPT = {"opt": "adamw", "base_lr": "1e-4", "base_bsz": 64, "weight_decay": "1e-2"}
STAGE1_SCHED = {"sched": "onecycle"}
STAGE1_MAX_STEPS, STAGE1_ACCUM = 200000, 2
# bf16 kernel vs plain: each attention wrapper's ``bf16_tolerance_ratio``
# (``attention_kernels.bf16_tolerance_ratio``, ``bf16_out_tolerance_ratio`` for
# the fused kernel) and ``grouped_conv.bf16_tolerance_ratio`` <= 1,
# elementwise limits of a few bf16 ulps of the output (the reasoning is beside
# each).
# bf16 attention gradients vs autograd through the plain version: rms of the
# difference over rms of the plain gradient <= 2^-6 per input. The two
# backward functions round at other places (the probabilities before or after
# the division by the row sum, 2^-9 relative each, and the bf16 gradients
# themselves); sound runs read a few 1e-3, a wrong scale (ln 2) or a dropped
# query chunk reads 0.3 or more.
BWD_RMS_TOL = 2.0 ** -6
# fp32 card vs CPU over the whole restore: other conv algorithms and summation
# orders (about 1e-6 relative), amplified by the t=999 DDIM update
# (1/sqrt(alpha_bar)); sound runs read about 4e-6.
REFERENCE_ATOL = 1e-4
# fp32 card vs CPU over one stage-1 loss and gradient: the same 1e-6-level
# differences through a forward and a backward pass at t up to 999; relative
# limits on each loss term and on each family's gradient norm.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# the milestone of each Hopper redesign that ships (its source's head comment)
SM90_DESIGNS = {"attention_sm90.cu": "M2", "attention_stream_sm90.cu": "M2",
                "attention_bh_sm90.cu": "M1", "attention_out_sm90.cu": "M2",
                "grouped_conv_sm90.cu": "M2"}
# a call shorter than GRAPH_MS is timed by replaying GRAPH_CALLS captured
# calls: one ctypes call costs 4-9 us of host time and a wrapper call 40-115
# us, so back-to-back calls of a short kernel measure the host's launch rate
GRAPH_MS = 0.05
GRAPH_CALLS = 100
# the reference worker's CPU threads (``CpuReferences``): the host's other
# cores stay with the main process, its loaders and the gloo ranks
REFERENCE_THREADS = 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3


def log(msg: str) -> None:
    print(msg, flush=True)


def process_age() -> float:
    """Seconds since this process started (its interpreter start included)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """Device ms per call of ``fn`` with the host out of the way: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between two
    events. ``fn`` takes its stream from ``torch.cuda.current_stream()`` when
    called, so that the capture records it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_us(fn, reps: int = 20) -> float:
    """Host microseconds per call of ``fn``: the loop does not synchronise, so
    the card's time stays hidden while the queue of launches has room."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    return sec / reps * 1e6


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms, what bounds it) at the card's peak bf16 rate and memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rms_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()


# ---------------------------------------------------------------------------
# the CPU halves of the card-vs-CPU checks (phases 5, 7, 11, 12, 15)
# ---------------------------------------------------------------------------


def reference_worker(jobs, results) -> None:
    """The reference process: runs each job ``(name, function name, args)``
    of this module as it arrives and puts ``(name, ok, result or traceback,
    start, end)``, the last two on the wall clock."""
    torch.set_num_threads(REFERENCE_THREADS)
    for name, fn, args in iter(jobs.get, None):
        start = time.time()
        try:
            out = (True, globals()[fn](*args))
        except BaseException:
            import traceback
            out = (False, traceback.format_exc())
        results.put((name, *out, start, time.time()))


class CpuReferences:
    """One worker process for the CPU halves of the card-vs-CPU checks: the
    card halves and the other phases go on while the host computes them. A job
    draws its seeded inputs on the card as the card half does (the same seeds
    in the same order, so the same values), copies them to the host and runs
    there; ``result(name)`` waits for its answer, ``idle()`` for every job
    submitted, so that a timed window after it runs beside no job. ``spans``
    holds each finished job's (start, end) in seconds of the script."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.jobs, self.results = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=reference_worker, args=(self.jobs, self.results),
                                daemon=True)
        self.proc.start()
        self.done, self.pending, self.spans = {}, set(), {}

    def submit(self, name: str, fn, *args) -> None:
        self.jobs.put((name, fn.__name__, args))
        self.pending.add(name)

    def _take(self, name: str) -> None:
        """Read answers until ``name``'s has come."""
        import queue

        zero = time.time() - process_age()
        while name not in self.done:
            try:
                got, ok, value, start, end = self.results.get(timeout=10)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise AssertionError(f"the reference worker died (exit code "
                                         f"{self.proc.exitcode}) before {name}") from None
                continue
            self.done[got] = (ok, value)
            self.spans[got] = (start - zero, end - zero)
            self.pending.discard(got)

    def idle(self) -> float:
        """Wait until every submitted job has ended; returns the seconds waited."""
        t0 = time.perf_counter()
        for name in sorted(self.pending):
            self._take(name)
        return time.perf_counter() - t0

    def result(self, name: str):
        self._take(name)
        ok, value = self.done.pop(name)
        if not ok:
            raise AssertionError(f"CPU reference {name} failed:\n{value}")
        return value

    def close(self, wait: bool = True) -> None:
        """Stop the worker: after its jobs (``wait``) or at once."""
        import queue

        if wait and self.proc.is_alive():
            self.jobs.put(None)
            for _ in range(60):  # a worker exits only once what it put was read
                self.proc.join(0.5)
                if not self.proc.is_alive():
                    break
                with contextlib.suppress(queue.Empty):
                    while True:
                        self.results.get_nowait()
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_shapes(K):
    """(kernel, q shape, heads) at every shape the 512 px main paths give each kernel."""
    b = BATCH
    return [
        (K.fused_attention_btc_prescaled, (b, 4096, 320), 5),   # UNet level 0
        (K.fused_attention_btc_prescaled, (b, 1024, 640), 10),  # UNet level 1
        (K.fused_attention_btc_prescaled, (b, 4096, 256), 4),   # Controller stage 0
        (K.fused_attention_btc_prescaled, (b, 1024, 256), 4),   # Controller stage 1
        (K.fused_attention_bh_prescaled, (b * 20, 256, 64), 1),  # UNet level 2
        (K.fused_attention_bh_prescaled, (b * 4, 256, 128), 1),  # Controller stage 2
        # the server's: a batch of four 512 px tiles, and a 256 x 384 image
        # whole at 512 x 768 (T = 384)
        (K.fused_attention_bh_prescaled, (80, 256, 64), 1),
        (K.fused_attention_bh_prescaled, (16, 256, 128), 1),
        (K.fused_attention_bh_prescaled, (20, 384, 64), 1),
        (K.fused_attention_bh_prescaled, (4, 384, 128), 1),
        (K.streaming_attention_bh_prescaled, (b, 4096, 512), 1),  # VAE mid block
        # the server's: a batch of four 512 px tiles, a 256 x 384 image whole
        # at 512 x 768
        (K.streaming_attention_bh_prescaled, (4, 4096, 512), 1),
        (K.streaming_attention_bh_prescaled, (1, 6144, 512), 1),
        # the fused route's shapes are the channel-flat ones, each with its
        # out-projection C = inner
        (K.fused_attention_btc_out_prescaled, (b, 4096, 320), 5),
        (K.fused_attention_btc_out_prescaled, (b, 1024, 640), 10),
        (K.fused_attention_btc_out_prescaled, (b, 4096, 256), 4),
        (K.fused_attention_btc_out_prescaled, (b, 1024, 256), 4),
        # the server's (phase 8 runs it on the fused route): a batch of four
        # 512 px tiles, a 256 x 384 image whole at 512 x 768
        (K.fused_attention_btc_out_prescaled, (4, 4096, 320), 5),
        (K.fused_attention_btc_out_prescaled, (4, 1024, 640), 10),
        (K.fused_attention_btc_out_prescaled, (4, 4096, 256), 4),
        (K.fused_attention_btc_out_prescaled, (4, 1024, 256), 4),
        (K.fused_attention_btc_out_prescaled, (1, 6144, 320), 5),
        (K.fused_attention_btc_out_prescaled, (1, 1536, 640), 10),
        (K.fused_attention_btc_out_prescaled, (1, 6144, 256), 4),
        (K.fused_attention_btc_out_prescaled, (1, 1536, 256), 4),
    ]


def backward_shapes(K):
    """One main-path shape per attention kernel for the gradient check."""
    return [(K.fused_attention_btc_prescaled, (BATCH, 4096, 320), 5),
            (K.fused_attention_bh_prescaled, (BATCH * 20, 256, 64), 1),
            (K.streaming_attention_bh_prescaled, (BATCH, 4096, 512), 1),
            (K.fused_attention_btc_out_prescaled, (BATCH, 4096, 320), 5)]


def gconv_shapes():
    """x shapes of the CFRM grouped conv (dw = 4 x 128/256/512) on every main
    path: the 512 px batch-8 restore and training step; the server's batch
    of four 512 px tiles; a 256 x 384 image restored whole at 512 x 768."""
    return [(BATCH, 256, 256, 512), (BATCH, 128, 128, 1024), (BATCH, 64, 64, 2048),
            (4, 256, 256, 512), (4, 128, 128, 1024), (4, 64, 64, 2048),
            (1, 256, 384, 512), (1, 128, 192, 1024), (1, 64, 96, 2048)]


def kernel_inputs(K, kern, shape, heads, gen):
    """Seeded bf16 inputs on the card and the head width d: q (prescaled by
    d^-1/2 log2 e), k, v, and for the fused kernel an (inner, inner)
    out-projection weight with unit-variance outputs."""
    flat = kern in (K.fused_attention_btc_prescaled, K.fused_attention_btc_out_prescaled)
    d = shape[2] // heads if flat else shape[2]
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    xs = [(q.float() * (d ** -0.5 * K.LOG2E)).to(torch.bfloat16), k, v]
    if kern is K.fused_attention_btc_out_prescaled:
        wo = torch.randn((shape[2], shape[2]), generator=gen, device="cuda") * shape[2] ** -0.5
        xs.append(wo.to(torch.bfloat16))
    return xs, d


def gconv_inputs(shape, gen, dtype=torch.bfloat16):
    """Seeded x, OIHW weights (unit-variance outputs) and bias for the grouped conv."""
    c = shape[-1]
    cg = c // 16
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = (torch.randn((c, cg, 3, 3), generator=gen, device="cuda") * (9 * cg) ** -0.5).to(dtype)
    b = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
    return x, w.contiguous(memory_format=torch.channels_last), b


def kernel_source(kern) -> str:
    """The source, in the repository, of a kernel's bf16 main-path launches:
    its wrapper's bf16 entry."""
    return str(kern.entry(torch.bfloat16)[2].relative_to(REPO))


def direct(entry, q, k, v, out=None, wo=None):
    """An attention C entry called directly through ctypes, without the
    wrapper's checks and autograd: the entry of a wrapper's bf16 launches, or
    the ``mma.sync`` kernel of csrc/attention.cu that a redesigned kernel
    replaced (a yardstick, never routed). Its signature is (q, k, v, o, three
    dims, dtype, stream), or with the out-projection ``wo`` (q, k, v, wo,
    out, four dims, dtype, stream)."""
    xs, dims = (q, k, v), tuple(q.shape)
    if wo is not None:
        xs, dims = (*xs, wo), (*dims, wo.shape[1])
    if out is None:
        out = torch.empty_like(q) if wo is None else q.new_empty((*q.shape[:2], wo.shape[1]))
    rc = entry(*(x.data_ptr() for x in xs), out.data_ptr(), *dims,
               1 if q.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")
    return out


def time_in_turns(call, host_call, new, prev=None) -> dict:
    """C entry ``new`` (``direct_ms``, ``direct_host_us``) and, where given,
    the entry ``prev`` it replaced, in turns (new, previous, previous, new;
    ``prev_ms``, ``prev_host_us``). ``call(e)`` runs entry ``e`` into a
    preallocated output; ``host_call(e)`` is the bare ctypes call, so the
    host times are the entries' own host work. Where the direct call takes
    under ``GRAPH_MS`` both are graph replays (``timer``), the event readings
    kept as ``direct_event_ms`` and ``prev_event_ms``."""
    order = (new,) if prev is None else (new, prev, prev, new)
    ms = [cuda_ms(lambda e=e: call(e), 10) for e in order]
    host = [host_us(lambda e=e: host_call(e)) for e in order]
    res = {"direct_ms": (ms[0] + ms[-1]) / 2, "direct_host_us": (host[0] + host[-1]) / 2}
    if prev is not None:
        res["prev_ms"], res["prev_host_us"] = (ms[1] + ms[2]) / 2, (host[1] + host[2]) / 2
    res["timer"] = "events"
    if res["direct_ms"] < GRAPH_MS:
        res["timer"] = "graph"
        graph = [graph_ms(lambda e=e: call(e)) for e in order]
        res["direct_event_ms"], res["direct_ms"] = res["direct_ms"], (graph[0] + graph[-1]) / 2
        if prev is not None:
            res["prev_event_ms"], res["prev_ms"] = res["prev_ms"], (graph[1] + graph[2]) / 2
    return res


def time_entries(K, kern, xs) -> dict:
    """``time_in_turns`` for the C entry of ``kern``'s bf16 launches, and the
    wrapper's host time per call (``wrapper_host_us``). Where that entry is
    not the wrapper's base symbol, the base symbol's ``mma.sync`` kernel in
    csrc/attention.cu is what it replaced: it is timed in turns and held to
    the plain version too (``prev_tolerance_ratio``). At T = 1024 the
    wrapper's host time per call exceeds a kernel's. ``xs`` is q, k, v and,
    for the out-projection-fused kernel, wo."""
    symbol, lib = kern.route(torch.bfloat16)
    new, prev, res = getattr(lib, symbol), None, {}
    wo = dict(zip(("wo",), xs[3:]))  # the out-projection-fused kernel's fourth input
    if symbol != kern.symbol:
        prev = getattr(K.library(), kern.symbol)
        res["prev_tolerance_ratio"] = kern.bf16_tolerance_ratio(direct(prev, *xs[:3], **wo),
                                                                kern.plain(*xs))
        if res["prev_tolerance_ratio"] > 1.0:
            raise AssertionError(f"{kern.symbol} {tuple(xs[0].shape)}: disagrees with the plain "
                                 "version")
    out = torch.empty(kern.out_shape(*xs), dtype=xs[0].dtype, device=xs[0].device)
    ints = (*xs[0].shape, *(x.shape[1] for x in xs[3:]))
    args = (*(x.data_ptr() for x in xs), out.data_ptr(), *ints, 1,
            torch.cuda.current_stream().cuda_stream)
    res.update(time_in_turns(lambda e: direct(e, *xs[:3], out, **wo), lambda e: e(*args), new,
                             prev))
    res["wrapper_host_us"] = host_us(lambda: kern(*xs))
    return res


def compare_output(kern, out, ref) -> dict:
    """A bf16 output of an attention kernel against its plain version's ``ref``."""
    diff = out.float() - ref.float()
    return {"max_abs_err": diff.abs().max().item(), "rms_err_over_rms_ref": rms_rel(out, ref),
            "tolerance_ratio": kern.bf16_tolerance_ratio(out, ref)}


def compare_kernel(kern, *xs) -> dict:
    """The kernel against its plain version on the same inputs."""
    return compare_output(kern, kern(*xs), kern.plain(*xs))


def direct_gconv(entry, x, wp, b, out=None):
    """A grouped-conv C entry of the (x, w, bias, y, B, H, W, C, cg, dtype,
    stream) signature called directly through ctypes with weights ``wp``
    already packed: the entry of the wrapper's bf16 launches, or the
    ``mma.sync`` kernel of csrc/grouped_conv.cu that it replaced (a
    yardstick, never routed)."""
    out = torch.empty_like(x) if out is None else out
    rc = entry(x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(), *x.shape,
               wp.shape[-1], 1 if x.dtype == torch.bfloat16 else 0,
               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")
    return out


def time_gconv_entries(G, x, w, b, ref) -> dict:
    """``time_in_turns`` for the grouped conv's bf16 C entry with the weights
    packed once and the ``mma.sync`` entry it replaced (``ur_grouped_conv3``'s
    bf16 body), held to the plain version ``ref`` too
    (``prev_tolerance_ratio``), and the wrapper's host time per call."""
    kern = G.grouped_conv3
    symbol, lib = kern.route(torch.bfloat16)
    new, prev = getattr(lib, symbol), getattr(G.library(), kern.symbol)
    wp = G.pack_weights(w, 16)
    res = {"prev_tolerance_ratio": G.bf16_tolerance_ratio(direct_gconv(prev, x, wp, b), ref)}
    if res["prev_tolerance_ratio"] > 1.0:
        raise AssertionError(f"{kern.symbol} {tuple(x.shape)}: the mma.sync entry disagrees "
                             "with the plain version")
    out = torch.empty_like(x)
    args = (x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(), *x.shape,
            wp.shape[-1], 1, torch.cuda.current_stream().cuda_stream)
    res.update(time_in_turns(lambda e: direct_gconv(e, x, wp, b, out), lambda e: e(*args), new,
                             prev))
    res["wrapper_host_us"] = host_us(lambda: kern(x, w, b, 16))
    return res


def compare_gconv(G, out, ref) -> dict:
    """A bf16 grouped-conv output against the plain version's ``ref``."""
    return {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "rms_err_over_rms_ref": rms_rel(out, ref),
            "tolerance_ratio": G.bf16_tolerance_ratio(out, ref)}


def check_kernel(K, kern, shape, heads, gen):
    n, t, _ = shape
    xs, d = kernel_inputs(K, kern, shape, heads, gen)
    q, k, v = xs[:3]
    err = compare_kernel(kern, *xs)
    if err["tolerance_ratio"] > 1.0:
        raise AssertionError(f"{kern.symbol} {shape}: kernel and plain version disagree: "
                             f"{err}")

    def split(x):  # (n, t, heads*d) -> (n, heads, t, d)
        return x.view(n, t, heads, d).transpose(1, 2)

    def sdpa():  # q is prescaled by d^-1/2 log2(e): softmax_e(x ln 2) == softmax_2(x)
        return F.scaled_dot_product_attention(split(q), split(k), split(v), scale=math.log(2.0))

    extra = time_entries(K, kern, xs)
    ms = cuda_ms(lambda: kern(*xs), 10)
    plain_ms = cuda_ms(lambda: kern.plain(*xs), 3)
    flops = 4.0 * n * heads * t * t * d
    nbytes = 4.0 * q.numel() * q.element_size()
    if kern is K.fused_attention_btc_out_prescaled:
        wo = xs[3]
        flops += 2.0 * n * t * shape[2] * wo.shape[1]
        nbytes += (wo.numel() + n * t * wo.shape[1] - q.numel()) * q.element_size()
        # no one PyTorch call computes attention and its out-projection: the
        # unfused pairs are the yardsticks
        library_ms = None

        def unfused():
            return K.fused_attention_btc_prescaled(q, k, v) @ wo

        def sdpa_matmul():
            return sdpa().transpose(1, 2).reshape(n, t, shape[2]) @ wo

        # by graph replay at every shape: each pair is two launches, and the
        # channel-flat wrapper's 45-90 us of host time would set the pace of
        # back-to-back calls at T <= 1536; the event readings stay beside them
        for key, pair in (("unfused", unfused), ("sdpa_matmul", sdpa_matmul)):
            extra[f"{key}_event_ms"] = cuda_ms(pair, 10)
            extra[f"{key}_ms"] = graph_ms(pair)
    else:
        library_ms = cuda_ms(sdpa, 10)
    if extra["timer"] == "graph":  # the wrapper and SDPA as the C entries
        extra["event_ms"], ms = ms, graph_ms(lambda: kern(*xs))
        if library_ms is not None:
            extra["library_event_ms"], library_ms = library_ms, graph_ms(sdpa)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"shape": list(shape), "heads": heads, "d": d, **err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, **extra, "bound_ms": bound_ms,
           "bound_by": bound_by, "tflops": flops / (ms * 1e-3) / 1e12}
    yardsticks = (f"library {library_ms:.3f} ms" if library_ms is not None else
                  f"btc+matmul {extra['unfused_ms']:.4f} ms sdpa+matmul "
                  f"{extra['sdpa_matmul_ms']:.4f} ms (graph; events "
                  f"{extra['unfused_event_ms']:.4f} / {extra['sdpa_matmul_event_ms']:.4f} ms)")
    if "direct_ms" in extra:
        prev, prev_host = "", ""
        if "prev_ms" in extra:
            prev = (f", prev (mma.sync) {extra['prev_ms']:.4f} ms, its tolerance ratio "
                    f"{extra['prev_tolerance_ratio']:.3f}")
            prev_host = f", prev {extra['prev_host_us']:.1f} us"
        yardsticks += (f" | direct call {extra['direct_ms']:.4f} ms{prev} | host per call: C "
                       f"entry {extra['direct_host_us']:.1f} us{prev_host}, wrapper "
                       f"{extra['wrapper_host_us']:.1f} us | timer {extra['timer']}")
        if extra["timer"] == "graph":
            yardsticks += (f" (events: wrapper {extra['event_ms']:.4f} ms, direct "
                           f"{extra['direct_event_ms']:.4f} ms"
                           + (f", prev {extra['prev_event_ms']:.4f} ms" if "prev_ms" in extra
                              else "")
                           + (f", library {extra['library_event_ms']:.4f} ms" if library_ms
                              is not None else "") + ")")
    log(f"kernel {kern.symbol} {tuple(shape)} d={d}: max_abs {err['max_abs_err']:.3e} "
        f"rms_err/rms_ref {err['rms_err_over_rms_ref']:.2e} tolerance ratio "
        f"{err['tolerance_ratio']:.3f} | {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s) "
        f"plain {plain_ms:.3f} ms {yardsticks} bound {bound_ms:.4f} ms ({bound_by})")
    return row


def check_gconv(G, shape, gen):
    x, w, b = gconv_inputs(shape, gen)
    ref = G.grouped_conv3_plain(x, w, b, 16)
    err = compare_gconv(G, G.grouped_conv3(x, w, b, 16), ref)
    if err["tolerance_ratio"] > 1.0:
        raise AssertionError(f"{G.grouped_conv3.symbol} {shape}: kernel and plain version "
                             f"disagree: {err}")
    extra = time_gconv_entries(G, x, w, b, ref)
    ms = cuda_ms(lambda: G.grouped_conv3(x, w, b, 16), 10)
    plain_ms = cuda_ms(lambda: G.grouped_conv3_plain(x, w, b, 16), 3)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory

    def cudnn():
        return F.conv2d(xc, w, b, padding=1, groups=16)

    library_ms = cuda_ms(cudnn, 10)
    if extra["timer"] == "graph":  # the wrapper and cuDNN as the C entries
        extra["event_ms"], ms = ms, graph_ms(lambda: G.grouped_conv3(x, w, b, 16))
        extra["library_event_ms"], library_ms = library_ms, graph_ms(cudnn)
    bsz, h, wd, c = shape
    flops = 2.0 * bsz * h * wd * c * 9 * (c // 16)
    nbytes = (2 * x.numel() + w.numel() + b.numel()) * x.element_size()
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"shape": list(shape), "groups": 16, **err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **extra, "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {G.grouped_conv3.symbol} {tuple(shape)} cg={c // 16}: max_abs "
        f"{err['max_abs_err']:.3e} rms_err/rms_ref {err['rms_err_over_rms_ref']:.2e} "
        f"tolerance ratio {err['tolerance_ratio']:.3f} | {ms:.4f} ms "
        f"({row['tflops']:.1f} TFLOP/s) plain {plain_ms:.3f} ms library {library_ms:.4f} ms "
        f"| direct call {extra['direct_ms']:.4f} ms, prev (mma.sync) {extra['prev_ms']:.4f} ms, "
        f"its tolerance ratio {extra['prev_tolerance_ratio']:.3f} | host per call: C entry "
        f"{extra['direct_host_us']:.1f} us, prev {extra['prev_host_us']:.1f} us, wrapper "
        f"{extra['wrapper_host_us']:.1f} us | timer {extra['timer']} bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return row


def check_backward(K, kern, shape, heads, gen) -> dict:
    """The kernel's autograd function against autograd through its plain version."""
    xs, _ = kernel_inputs(K, kern, shape, heads, gen)
    g = torch.randn(kern.out_shape(*xs), generator=gen, device="cuda", dtype=torch.bfloat16)

    def grads(fn):
        leaves = [x.detach().requires_grad_() for x in xs]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    ours, ref = grads(kern), grads(kern.plain)
    errs = {name: rms_rel(a, b) for name, a, b in zip(("dq", "dk", "dv", "dwo"), ours, ref)}
    finite = all(torch.isfinite(x).all() for x in ours)
    if not finite or max(errs.values()) > BWD_RMS_TOL:
        raise AssertionError(f"{kern.symbol} {shape}: gradients disagree with autograd "
                             f"through the plain version: {errs} (finite {finite})")
    del ours, ref
    bwd_ms = cuda_ms(lambda: kern.vjp(*xs, g), 3)
    log(f"backward {kern.symbol} {tuple(shape)}: rms err/rms ref "
        + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (limit {BWD_RMS_TOL:.3e}) | recompute backward {bwd_ms:.3f} ms")
    return {"shape": list(shape), "rms_err_over_rms_ref": errs, "ms": bwd_ms}


# ---------------------------------------------------------------------------
# phases 4-5: the restore path
# ---------------------------------------------------------------------------


def fill_zero_leaves(bridge, tree, gen, std=1e-2):
    """Zero-initialised adapter leaves (Controller zero convs, NAF beta/gamma,
    TFA prompts) get small seeded values, so those paths do real work."""
    for leaf in bridge.flatten(tree).values():
        if not leaf.any():
            leaf.normal_(0.0, std, generator=gen)
    return tree


def make_params(UR, bridge, cfg, dtype, seed, trainable_dtype=None):
    """Seeded (frozen, trainable) on the card; trainable in ``trainable_dtype`` if given."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frozen, trainable = UR.init(cfg, gen, device="cuda", dtype=trainable_dtype or dtype)
    if trainable_dtype is not None:
        frozen = bridge.unflatten_like({k: v.to(dtype) for k, v in
                                        bridge.flatten(frozen).items()}, frozen)
    frozen["null_emb"] = bridge.load_null_embedding(REPO / "weights" / "sd_null_emb.npy",
                                                    device="cuda", dtype=dtype)
    return frozen, fill_zero_leaves(bridge, trainable, gen)


def psnr_u8(a, b) -> float:
    """PSNR after uint8-level rounding (the repo's eval protocol), capped at 99 dB."""
    qa = (a.float() * 255).round().clamp(0, 255) / 255
    qb = (b.float() * 255).round().clamp(0, 255) / 255
    mse = ((qa.double() - qb.double()) ** 2).mean().item()
    return 99.0 if mse == 0 else min(10 * math.log10(1.0 / mse), 99.0)


def restore_inputs(UR, cfg, frozen, trainable, gen):
    """A seeded 512 px bf16 batch, its seeded noise (``posterior_noise`` and
    ``diffusion_noise``), and ``restore(cfg, steps)`` of it with that noise."""
    sched = UR.schedule(cfg, device="cuda")
    images = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda").to(torch.bfloat16)
    post, diff = UR.restore_noise(cfg, images.shape, images.dtype, gen, "cuda")
    noise = {"posterior_noise": post, "diffusion_noise": diff}

    def restore(c, steps):  # 512 px needs no resize or pad: restore_padded runs as is
        return UR.restore(frozen, trainable, c, sched, images, "ir",
                          num_inference_steps=steps, device="cuda", **noise)

    return images, noise, restore


def counts_of(KN) -> tuple:
    return tuple(kern.launches for kern in KN.KERNELS)


def run_modes(UR, KN, cfg, frozen, trainable, gen):
    """Phase 4: the restores of ``RUNS`` on one seeded batch with one noise draw.

    Returns (results by name, launches by path): ``restore`` sums the
    unfused runs' launches, ``restore_fused`` the fused ones'."""
    images, _, restore = restore_inputs(UR, cfg, frozen, trainable, gen)
    t0 = time.perf_counter()
    restore(cfg, 1)  # warm-up: lazy library init, every shape once
    restore(dataclasses.replace(cfg, fused_out_attention=True), 1)
    torch.cuda.synchronize()
    log(f"warm-up restores (1 step, unfused and fused): {time.perf_counter() - t0:.2f} s")

    outs, results = {}, {}
    launches = {path: {kern.symbol: 0 for kern in KN.KERNELS}
                for path in ("restore", "restore_fused")}
    for name, mode, stride, warmup, fused in RUNS:
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride, cache_warmup=warmup,
                                fused_out_attention=fused)
        torch.cuda.reset_peak_memory_stats()
        KN.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(c, STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = counts_of(KN)
        path = launches["restore_fused" if fused else "restore"]
        for kern in KN.KERNELS:
            path[kern.symbol] += kern.launches
        if out.shape != images.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: output shape {tuple(out.shape)} or non-finite values")
        if counts != EXPECTED[name]:
            raise AssertionError(f"{name}: launches {counts} != expected {EXPECTED[name]}")
        if name in outs and not torch.equal(out, outs[name]):
            log(f"{name}: the repeat differs from the first run by max abs "
                f"{(out.float() - outs[name].float()).abs().max().item():.3e}")
        outs.setdefault(name, out)
        row = results.setdefault(name, {"mode": mode, "stride": stride, "warmup": warmup,
                                        "fused_out_attention": fused, "seconds": [],
                                        "launches": counts})
        row["seconds"].append(sec)
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"restore {name} (mode {mode}, stride {stride}, warmup {warmup}, fused out-projection "
            f"{fused}): {sec:.3f} s, {BATCH / sec:.3f} img/s, launches "
            f"btc/bh/stream/btc_out/gconv {counts}, peak {row['peak_mem_gib']:.1f} GiB")
    for row in results.values():
        row["img_per_s"] = [BATCH / sec for sec in row["seconds"]]
    for name in ("encoder", "deep", "fused"):
        results[name]["psnr_vs_exact"] = psnr_u8(outs["none"], outs[name])
        log(f"{name} PSNR vs exact: {results[name]['psnr_vs_exact']:.2f} dB")
    ex, fu = (sum(results[n]["seconds"]) / len(results[n]["seconds"]) for n in ("none", "fused"))
    log(f"exact restore, unfused vs fused out-projection (two runs each, in turns): "
        f"{BATCH / ex:.3f} vs {BATCH / fu:.3f} img/s ({(ex / fu - 1) * 100:+.1f} % for fused)")
    return results, launches


def uint8_levels(a, b) -> int:
    """The largest difference of two outputs in uint8 levels, each rounded as
    the eval protocol rounds (``psnr_u8``)."""
    qa, qb = ((x.float() * 255).round().clamp(0, 255) for x in (a, b))
    return int((qa - qb).abs().max().item())


def run_graph_modes(UR, KN, GR, cfg, frozen, trainable, gen):
    """Phase 4 on the graph route: for each of ``GRAPH_RUNS`` one
    ``GraphedRestore`` captures the restore of one seeded batch, then eager
    restores and graph replays of it run in ``GRAPH_TURNS``. Each eager
    restore runs under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises at any wait for the card or copy from the host.

    Returns (results by name, launches by path): ``restore_graph`` sums the
    unfused graphs' launches at capture times their replays,
    ``restore_fused_graph`` the fused one's."""
    images, noise, restore = restore_inputs(UR, cfg, frozen, trainable, gen)
    sched = UR.schedule(cfg, device="cuda")
    results = {}
    launches = {path: {kern.symbol: 0 for kern in KN.KERNELS}
                for path in ("restore_graph", "restore_fused_graph")}
    for name, mode, stride, warmup, fused in GRAPH_RUNS:
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride, cache_warmup=warmup,
                                fused_out_attention=fused)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        graphed = GR.GraphedRestore(frozen, trainable, c, sched, device="cuda")
        t0 = time.perf_counter()
        first = graphed(images, "ir", num_inference_steps=STEPS, **noise)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        (stats,) = graphed.stats.values()
        captured = tuple(stats.launches[kern.symbol] for kern in KN.KERNELS)
        if captured != EXPECTED[name]:
            raise AssertionError(f"graph {name}: launches at capture {captured} != expected "
                                 f"{EXPECTED[name]}")
        row = {"mode": mode, "stride": stride, "warmup": warmup, "fused_out_attention": fused,
               "first_call_seconds": first_s, "warmup_seconds": stats.warmup_seconds,
               "capture_seconds": stats.capture_seconds, "launches_at_capture": captured,
               "peak_mem_gib_first_call": torch.cuda.max_memory_allocated() / 2**30,
               "eager": {"seconds": [], "peak_mem_gib": []},
               "graph": {"seconds": [], "peak_mem_gib": []}}
        torch.cuda.empty_cache()
        row["graph_held_gib"] = (torch.cuda.memory_reserved() - reserved) / 2**30
        outs = {"eager": [], "graph": [first]}
        for route in GRAPH_TURNS:
            torch.cuda.reset_peak_memory_stats()
            KN.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "eager":
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = restore(c, STEPS)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                out = graphed(images, "ir", num_inference_steps=STEPS, **noise)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = counts_of(KN)
            want = EXPECTED[name] if route == "eager" else (0,) * len(KN.KERNELS)
            if counts != want:
                raise AssertionError(f"{route} {name}: launches {counts} != {want}")
            if out.shape != images.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{route} {name}: output shape {tuple(out.shape)} or "
                                     "non-finite values")
            row[route]["seconds"].append(sec)
            row[route]["peak_mem_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            outs[route].append(out)
        for route in ("eager", "graph"):
            row[route]["img_per_s"] = [BATCH / sec for sec in row[route]["seconds"]]
        row["replays"] = stats.replays
        row["graph_vs_eager_max_abs"] = (outs["graph"][1].float()
                                         - outs["eager"][0].float()).abs().max().item()
        row["graph_vs_eager_uint8_levels"] = uint8_levels(outs["graph"][1], outs["eager"][0])
        row["graph_repeats_equal"] = all(torch.equal(o, first) for o in outs["graph"])
        row["eager_repeats_equal"] = torch.equal(*outs["eager"])
        results[name] = row
        eager_s, graph_s = (sum(row[r]["seconds"]) / 2 for r in ("eager", "graph"))
        log(f"graph {name} (mode {mode}, stride {stride}, warmup {warmup}, fused out-projection "
            f"{fused}): first call {first_s:.3f} s (eager warm-up {stats.warmup_seconds:.3f} s, "
            f"capture + instantiate {stats.capture_seconds:.3f} s), launches at capture "
            f"{captured}; in turns eager {BATCH / eager_s:.3f} img/s, graph "
            f"{BATCH / graph_s:.3f} img/s ({(eager_s / graph_s - 1) * 100:+.1f} %; seconds "
            f"eager {row['eager']['seconds']}, graph {row['graph']['seconds']}); peak GiB eager "
            f"{max(row['eager']['peak_mem_gib']):.2f}, replay "
            f"{max(row['graph']['peak_mem_gib']):.2f}, first call "
            f"{row['peak_mem_gib_first_call']:.2f}, held by the graph "
            f"{row['graph_held_gib']:.2f}; graph vs eager max abs "
            f"{row['graph_vs_eager_max_abs']:.3e}, {row['graph_vs_eager_uint8_levels']} uint8 "
            f"levels (limit 1); replays equal {row['graph_repeats_equal']}, eager repeats equal "
            f"{row['eager_repeats_equal']}")
        if row["graph_vs_eager_uint8_levels"] > 1:
            raise AssertionError(f"graph {name}: {row['graph_vs_eager_uint8_levels']} uint8 "
                                 "levels from the eager restore")
        path = launches["restore_fused_graph" if fused else "restore_graph"]
        for kern in KN.KERNELS:
            path[kern.symbol] += stats.launches[kern.symbol] * stats.replays
        del graphed, outs, first, out
    torch.cuda.empty_cache()
    return results, launches


def to_cpu(bridge, tree):
    return bridge.unflatten_like({k: v.detach().cpu() for k, v in bridge.flatten(tree).items()},
                                 tree)


def restore_reference_inputs(UR, bridge, cfg):
    """Phase 5's seeded inputs on the card: full-width fp32 parameters, a
    256 px image and the restore's noise."""
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.rand((1, 256, 256, 3), generator=gen, device="cuda")
    lat = (1, 32, 32, cfg.vae.latent_channels)
    post = torch.randn(lat, generator=gen, device="cuda")
    diff = torch.randn(lat, generator=gen, device="cuda")
    return frozen, trainable, images, post, diff


def restore_reference_run(UR, device, cfg, frozen, trainable, images, post, diff):
    """The 2-step 256 px restore of phase 5 on ``device``."""
    return UR.restore_padded(frozen, trainable, cfg, UR.schedule(cfg), images.to(device), "seg",
                             num_inference_steps=2, posterior_noise=post.to(device),
                             diffusion_noise=diff.to(device), device=device)


def restore_reference_cpu(cfg) -> tuple:
    """Reference job: phase 5's restore (under ``cfg``) on the host, from
    inputs drawn on the card as the card half draws them. Returns (output,
    CPU seconds)."""
    from unirestore_torch import bridge
    from unirestore_torch.models import unirestore as UR

    frozen, trainable, *xs = restore_reference_inputs(UR, bridge, cfg)
    frozen, trainable, xs = to_cpu(bridge, frozen), to_cpu(bridge, trainable), [x.cpu() for x in xs]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = restore_reference_run(UR, "cpu", cfg, frozen, trainable, *xs)
    return out.numpy(), time.perf_counter() - t0


def reference_check(UR, KN, GR, bridge, cfg, refs, name="phase 5"):
    """Full widths, 256 px, fp32, 2 steps: card (kernels; unfused, fused
    out-projection, and unfused replayed from a CUDA graph) vs CPU (plain
    versions). The CPU half runs in ``refs``' worker; returns the check,
    which waits for it and returns the result."""
    frozen, trainable, images, post, diff = restore_reference_inputs(UR, bridge, cfg)
    refs.submit(name, restore_reference_cpu, cfg)
    gpu, counts = {}, {}
    for fused in (False, True):
        KN.reset_counts()
        gpu[fused] = restore_reference_run(UR, "cuda", dataclasses.replace(
            cfg, fused_out_attention=fused), frozen, trainable, images, post, diff).cpu()
        counts[fused] = dict(zip((kern.symbol for kern in KN.KERNELS), counts_of(KN)))
    # the graph route runs ``restore``: at min_size 256 a 256 px input is
    # neither resized nor padded, so it restores as ``restore_padded`` does
    c256 = dataclasses.replace(cfg, min_size=256)
    graphed = GR.GraphedRestore(frozen, trainable, c256, UR.schedule(c256), device="cuda")
    gpu["graph"] = graphed(images, "seg", num_inference_steps=2, posterior_noise=post,
                           diffusion_noise=diff).cpu()
    (graph_stats,) = graphed.stats.values()
    del graphed, frozen, trainable

    def check():
        cpu, cpu_s = refs.result(name)
        cpu = torch.from_numpy(cpu)
        errs = {fused: (out - cpu).abs().max().item() for fused, out in gpu.items()}
        log(f"reference 256 px fp32, 2 steps: card vs CPU max abs {errs[False]:.3e} unfused, "
            f"{errs[True]:.3e} fused out-projection, {errs['graph']:.3e} unfused from a CUDA "
            f"graph (tolerance {REFERENCE_ATOL}); card launches unfused {counts[False]}, fused "
            f"{counts[True]}, graph at capture {graph_stats.launches} (capture + instantiate "
            f"{graph_stats.capture_seconds:.3f} s); CPU {cpu_s:.1f} s in the reference worker")
        for fused, out in gpu.items():
            if not (torch.isfinite(out).all() and errs[fused] <= REFERENCE_ATOL):
                raise AssertionError(f"card and CPU restores differ (fused {fused}): "
                                     f"max abs {errs[fused]:.3e}")
        return {"max_abs_err": errs[False], "max_abs_err_fused": errs[True],
                "max_abs_err_graph": errs["graph"], "launches": counts[False],
                "launches_fused": counts[True],
                "graph_launches_at_capture": graph_stats.launches,
                "graph_capture_seconds": graph_stats.capture_seconds, "cpu_seconds": cpu_s}

    # at 256 px UNet level 0 and Controller stage 0 run T = 1024 (btc, or btc_out
    # when fused), UNet level 1 and Controller stage 1 T = 256 (bh)
    unfused_ran = [s for s, n in counts[False].items() if n == 0 and s != "ur_attention_btc_out"]
    if unfused_ran or counts[False]["ur_attention_btc_out"]:
        raise AssertionError(f"unfused reference restore launches {counts[False]}")
    if counts[True]["ur_attention_btc"] or not counts[True]["ur_attention_btc_out"]:
        raise AssertionError(f"fused reference restore launches {counts[True]}")
    if graph_stats.launches != counts[False]:
        raise AssertionError(f"graph reference restore launches at capture "
                             f"{graph_stats.launches} != eager {counts[False]}")
    return check


# ---------------------------------------------------------------------------
# phases 6-7: the stage-1 training step
# ---------------------------------------------------------------------------


def synthetic_pair(gen, batch: int, res: int, dtype) -> dict:
    """A seeded smooth image ``hq`` and its degradation ``lq`` (2x blur, Gaussian
    noise of sigma 0.05), NHWC in [0, 1] on the card."""
    coarse = torch.rand((batch, 3, res // 16, res // 16), generator=gen, device="cuda")
    hq = F.interpolate(coarse, size=(res, res), mode="bicubic", align_corners=False)
    hq = (hq + 0.05 * torch.randn(hq.shape, generator=gen, device="cuda")).clamp(0, 1)
    blur = F.interpolate(F.avg_pool2d(hq, 2), size=(res, res), mode="bilinear",
                         align_corners=False)
    lq = (blur + 0.05 * torch.randn(hq.shape, generator=gen, device="cuda")).clamp(0, 1)
    return {"hq": hq.permute(0, 2, 3, 1).contiguous().to(dtype),
            "lq": lq.permute(0, 2, 3, 1).contiguous().to(dtype)}


def train_counts(KN) -> dict:
    return {kern.symbol: (kern.launches - kern.recompute_launches, kern.recompute_launches,
                          kern.backwards) for kern in KN.KERNELS}


def train_setup(UR, bridge, TS, OPT):
    """The stage-1 setup of phase 6: sd-turbo widths without TFA, bf16 frozen
    weights, fp32 trainable masters, AdamW from the stage-1 YAML's kwargs,
    remat on. Returns (frozen, trainable, stage, peak lr, next_inputs, run):
    ``next_inputs()`` makes a seeded synthetic batch and its noise, and
    ``run(batch, noise)`` takes one step (updating ``trainable`` and the
    optimizer state in place) and returns its logs."""
    cfg = UR.UniRestoreConfig()
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=3,
                                    trainable_dtype=torch.float32)
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
    tx, peak_lr = OPT.build(STAGE1_OPT, STAGE1_SCHED, STAGE1_MAX_STEPS, BATCH, STAGE1_ACCUM, 1)
    opt_state = tx.init(TS.trained_leaves(stage, trainable))
    step = TS.make_train_step(frozen, cfg, UR.schedule(cfg, device="cuda"), stage, tx, "ir",
                              remat=True)
    gen = torch.Generator(device="cuda").manual_seed(4)

    def next_inputs():
        batch = synthetic_pair(gen, BATCH, RES, torch.bfloat16)
        return batch, TS.draw_noise(cfg, batch, gen)

    def run(batch, noise):
        return step(trainable, opt_state, batch, noise)[2]

    return frozen, trainable, stage, peak_lr, next_inputs, run


def run_training(UR, KN, bridge, TS, OPT):
    """Phase 6: the full-width stage-1 step, one warm-up and TRAIN_STEPS timed."""
    frozen, trainable, stage, peak_lr, next_inputs, run = train_setup(UR, bridge, TS, OPT)
    frozen_before = {k: v.clone() for k, v in bridge.flatten(frozen).items()}
    trained_before = {k: v.clone() for k, v in TS.trained_leaves(stage, trainable).items()}
    n_trained = sum(v.numel() for v in trained_before.values())
    log(f"training: stage 1, {n_trained / 1e6:.1f} M trainable fp32 params, frozen bf16, "
        f"AdamW peak lr {peak_lr:.3e}, accumulation {STAGE1_ACCUM}, remat on")

    rows, launches = [], {kern.symbol: 0 for kern in KN.KERNELS}
    for i in range(1 + TRAIN_STEPS):
        batch, noise = next_inputs()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        KN.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = run(batch, noise)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = train_counts(KN)
        for kern in KN.KERNELS:
            launches[kern.symbol] += kern.launches
        logs = {k: v.item() for k, v in logs.items()}
        log(f"train step {i}{' (warm-up)' if i == 0 else ''}: {sec * 1e3:.1f} ms, "
            + " ".join(f"{k.split('/')[-1]} {v:.5g}" for k, v in logs.items())
            + " | launches (forward, recompute, backward) "
            + " ".join(f"{s.split('_', 1)[1]} {c}" for s, c in counts.items()))
        if not all(math.isfinite(v) for v in logs.values()):
            raise AssertionError(f"train step {i}: non-finite loss or gradient norm {logs}")
        if counts != EXPECTED_TRAIN:
            raise AssertionError(f"train step {i}: launches {counts} != {EXPECTED_TRAIN}")
        rows.append({"seconds": sec, "logs": logs})
    peak = torch.cuda.max_memory_allocated() / 2**30

    unchanged = [k for k, v in TS.trained_leaves(stage, trainable).items()
                 if torch.equal(v, trained_before[k])]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} trainable leaves did not change: {unchanged[:5]}")
    touched = [k for k, v in bridge.flatten(frozen).items() if not torch.equal(v, frozen_before[k])]
    if touched:
        raise AssertionError(f"frozen leaves changed: {touched[:5]}")
    sec = [r["seconds"] for r in rows[1:]]
    mean = sum(sec) / len(sec)
    result = {"batch": BATCH, "res": RES, "steps_timed": TRAIN_STEPS, "ms_per_step": mean * 1e3,
              "ms_per_step_each": [s * 1e3 for s in sec], "train_img_per_s": BATCH / mean,
              "peak_mem_gib": peak, "launches_per_step": EXPECTED_TRAIN,
              "losses": [r["logs"] for r in rows]}
    log(f"training: {mean * 1e3:.1f} ms/step over {TRAIN_STEPS} steps "
        f"({min(sec) * 1e3:.1f}-{max(sec) * 1e3:.1f}), {BATCH / mean:.3f} train img/s, "
        f"peak {peak:.1f} GiB; every trained leaf changed, frozen bytes unchanged")
    return result, launches


def train_reference_inputs(UR, bridge, TS, cfg):
    """Phase 7's seeded inputs on the card: full-width fp32 parameters, a
    256 px pair and its noise."""
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = synthetic_pair(gen, 1, 256, torch.float32)
    return frozen, trainable, batch, TS.draw_noise(cfg, batch, gen)


def train_reference_run(UR, TS, cfg, device, frozen, trainable, batch, noise) -> tuple:
    """Phase 7's stage-1 losses and gradient norms by family on ``device``."""
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
    leaves = TS.trained_leaves(stage, trainable)
    for p in leaves.values():
        p.requires_grad_(True)
    nz = TS.StepNoise(noise.hq.to(device), noise.lq.to(device),
                      noise.diffusion.to(device), noise.timesteps.to(device))
    loss, logs = TS.compute_losses(frozen, trainable, TS.with_remat(cfg),
                                   UR.schedule(cfg, device=device), stage,
                                   {k: v.to(device) for k, v in batch.items()}, nz, "ir")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    norms = {}
    for k, g in zip(leaves, grads):
        fam = k.split("//")[0]
        norms[fam] = norms.get(fam, 0.0) + g.double().square().sum().item()
    return {k: v.item() for k, v in logs.items()}, {f: n ** 0.5 for f, n in norms.items()}


def train_reference_cpu(cfg) -> tuple:
    """Reference job: phase 7's step (under ``cfg``) on the host. Returns
    (logs, norms, CPU seconds)."""
    from unirestore_torch import bridge
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.train import steps as TS

    frozen, trainable, batch, noise = train_reference_inputs(UR, bridge, TS, cfg)
    frozen, trainable = to_cpu(bridge, frozen), to_cpu(bridge, trainable)
    batch = {k: v.cpu() for k, v in batch.items()}
    noise = TS.StepNoise(*(x.cpu() for x in (noise.hq, noise.lq, noise.diffusion,
                                             noise.timesteps)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    logs, norms = train_reference_run(UR, TS, cfg, "cpu", frozen, trainable, batch, noise)
    return logs, norms, time.perf_counter() - t0


def train_reference_check(UR, KN, bridge, TS, refs, cfg=None, name="phase 7"):
    """Phase 7: one stage-1 loss and gradient, full widths, 256 px, fp32, card vs
    CPU (``cfg``: ``UniRestoreConfig()``, unless given). The CPU half runs in
    ``refs``' worker; returns the check, which waits for it."""
    cfg = cfg or UR.UniRestoreConfig()
    inputs = train_reference_inputs(UR, bridge, TS, cfg)
    refs.submit(name, train_reference_cpu, cfg)
    KN.reset_counts()
    gpu_logs, gpu_norms = train_reference_run(UR, TS, cfg, "cuda", *inputs)
    counts = train_counts(KN)
    del inputs
    if any(counts[s][0] == 0 for s, c in EXPECTED_TRAIN.items() if c[0]):
        raise AssertionError(f"a kernel did not run in the reference training step: {counts}")

    def check():
        cpu_logs, cpu_norms, cpu_s = refs.result(name)
        loss_err = max(abs(gpu_logs[k] - cpu_logs[k]) / abs(cpu_logs[k]) for k in cpu_logs)
        grad_err = max(abs(gpu_norms[f] - cpu_norms[f]) / cpu_norms[f] for f in cpu_norms)
        log(f"training reference 256 px fp32: card vs CPU max relative loss error "
            f"{loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), gradient norm error {grad_err:.3e} "
            f"(limit {TRAIN_GRAD_RTOL}); norms card {gpu_norms} CPU {cpu_norms}; "
            f"card launches {counts}; CPU {cpu_s:.1f} s in the reference worker")
        finite = all(math.isfinite(v) for v in (*gpu_logs.values(), *gpu_norms.values()))
        if not finite or loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
            raise AssertionError("card and CPU training steps differ")
        return {"loss_rel_err": loss_err, "grad_norm_rel_err": grad_err, "cpu_seconds": cpu_s}

    return check


# ---------------------------------------------------------------------------
# phase 8: the restore server
# ---------------------------------------------------------------------------


def smooth_image(gen, h: int, w: int):
    """A seeded smooth uint8 RGB image (bicubic upsampling of 16x coarser noise), on the host."""
    coarse = torch.rand((1, 3, max(h // 16, 2), max(w // 16, 2)), generator=gen, device="cuda")
    img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False).clamp(0, 1)
    return (img[0].permute(1, 2, 0) * 255).round().to(torch.uint8).cpu().numpy()


def levels(a, b) -> int:
    """The largest difference of two uint8 images in levels."""
    return int(abs(a.astype("int16") - b.astype("int16")).max())


def post(url: str, body: bytes, timeout: float = 600.0) -> tuple[int, bytes]:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def run_serving(KN, serve, png, reference=None):
    """Phase 8: the server in this process, answering real HTTP requests.

    Without ``reference``: the eager server; returns (result, launches by
    kernel, its in-process answers to the tiled and whole images). With
    ``reference`` (those answers): the server with ``--cuda-graphs``, each
    answer held to them; launches are each graph's at capture times its
    replays."""
    import numpy as np

    from unirestore_torch.ops import tiling as TIL

    graphs = reference is not None
    flags = SERVE_FLAGS + (["--cuda-graphs"] if graphs else [])
    args = serve.parse_args(flags + ["--weights-dir", str(REPO / "weights")])
    t0 = time.perf_counter()
    restore, cfg = serve.build_restore(args)
    server = serve.make_server(args, restore, cfg)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    log(f"server up on {url} in {time.perf_counter() - t0:.1f} s: {' '.join(flags)}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, launches = {}, {kern.symbol: 0 for kern in KN.KERNELS}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        want = {"status": "ok", "tasks": ["ir", "cls", "seg"], "served": 0, "cache_mode": "none"}
        if r.status != 200 or health != want:
            raise AssertionError(f"/healthz: {r.status} {health}, want 200 {want}")
        log(f"GET /healthz: {r.status} {health}")
        images, sent = {}, {}
        for name, task, (h, w), status, want_counts in SERVE_REQUESTS:
            if graphs:
                want_counts = GRAPH_SERVE_COUNTS[name]
            img = sent[name] = images.setdefault((h, w), smooth_image(gen, h, w))
            body = png.encode(img)
            KN.reset_counts()
            t0 = time.perf_counter()
            code, answer = post(f"{url}/restore?task={task}", body)
            sec = time.perf_counter() - t0
            counts = counts_of(KN)
            for kern in KN.KERNELS:
                launches[kern.symbol] += kern.launches
            row = {"task": task, "size": [h, w], "status": code, "seconds": sec,
                   "launches": counts}
            if code == 200:
                out = png.decode(answer)
                row["out_size"] = list(out.shape[:2])
                if out.shape != img.shape:
                    raise AssertionError(f"{name}: answer {out.shape}, sent {img.shape}")
                if h > cfg.min_size or w > cfg.min_size:
                    tiles = len(TIL.plan_tiles(h, w, cfg.min_size, args.overlap))
                    row.update(tiles=tiles, tiles_per_s=tiles / sec)
                rows[name] = row
                rows[name]["answer"] = out
            else:
                row["error"] = json.loads(answer).get("error")
                rows[name] = row
            log(f"POST /restore?task={task} {h}x{w}: {code} in {sec:.3f} s"
                + (f", {row['tiles']} tiles, {row['tiles_per_s']:.3f} tiles/s"
                   if "tiles" in row else "")
                + f", launches btc/bh/stream/btc_out/gconv {counts}")
            if code != status or counts != want_counts:
                raise AssertionError(f"{name}: status {code} launches {counts}, want "
                                     f"{status} {want_counts}")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            served = json.loads(r.read())["served"]
        if served != 3:
            raise AssertionError(f"/healthz counts {served} served requests, want 3")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()

    result = {"flags": flags, "healthz": health, "requests": rows}
    if graphs:
        return serve_graph_checks(KN, restore.graphs, rows, reference, result)

    # the answers of the same function called in this process, and the host's
    # share of a request: PNG decode and encode of the same image
    in_process = {}
    for name in ("tiled", "whole"):
        t0 = time.perf_counter()
        out = restore(np.asarray(sent[name], np.float32)[None] / 255.0,
                      rows[name]["task"])[0]
        result[f"in_process_{name}_seconds"] = time.perf_counter() - t0
        in_process[name] = np.clip(out * 255.0, 0, 255).astype(np.uint8)
    direct, direct_s = in_process["tiled"], result["in_process_tiled_seconds"]
    body = png.encode(sent["tiled"])
    t0 = time.perf_counter()
    png.decode(body)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    png.encode(direct)
    encode_s = time.perf_counter() - t0
    apart = levels(direct, rows["tiled"]["answer"])
    cold = levels(rows["tiled_cold"]["answer"], rows["tiled"]["answer"])
    log(f"tiled answer vs in-process restore_tiled: max {apart} uint8 levels apart (limit 1); "
        f"cold vs warm answer {cold} levels; in-process call {direct_s:.3f} s, PNG decode "
        f"{decode_s:.3f} s, encode {encode_s:.3f} s (the warm request took "
        f"{rows['tiled']['seconds']:.3f} s)")
    if apart > 1:
        raise AssertionError(f"tiled answer differs from the in-process call by {apart} levels")
    for row in rows.values():
        row.pop("answer", None)
    result.update({"uint8_levels_vs_in_process": apart, "uint8_levels_cold_vs_warm": cold,
                   "in_process_seconds": direct_s, "png_decode_seconds": decode_s,
                   "png_encode_seconds": encode_s})
    return result, launches, in_process


def serve_graph_checks(KN, graphs, rows, reference, result):
    """Phase 8's checks of the server with ``--cuda-graphs``: one capture of
    ``SERVE_BATCH`` launches per key, ``GRAPH_SERVE_REPLAYS`` replays, each
    answer within one uint8 level of the eager in-process ``reference``."""
    stats = {key[0]: st for key, st in graphs.stats.items()}
    launches = {kern.symbol: 0 for kern in KN.KERNELS}
    result["graphs"] = {}
    for shape, st in stats.items():
        captured = tuple(st.launches[kern.symbol] for kern in KN.KERNELS)
        result["graphs"][str(list(shape))] = {
            "captures": st.captures, "replays": st.replays, "launches_at_capture": captured,
            "warmup_seconds": st.warmup_seconds, "capture_seconds": st.capture_seconds}
        log(f"server graph {list(shape)}: {st.captures} capture(s), {st.replays} replays, "
            f"launches at capture {captured}, eager warm-up {st.warmup_seconds:.3f} s, capture "
            f"+ instantiate {st.capture_seconds:.3f} s")
        if st.captures != 1 or captured != SERVE_BATCH:
            raise AssertionError(f"server graph {shape}: {st.captures} captures, launches "
                                 f"{captured}, want 1 and {SERVE_BATCH}")
        for kern in KN.KERNELS:
            launches[kern.symbol] += st.launches[kern.symbol] * st.replays
    replays = {shape: st.replays for shape, st in stats.items()}
    if replays != GRAPH_SERVE_REPLAYS:
        raise AssertionError(f"server graphs: replays {replays}, want {GRAPH_SERVE_REPLAYS}")
    apart = {name: levels(rows[name]["answer"], reference[ref])
             for name, ref in (("tiled_cold", "tiled"), ("tiled", "tiled"), ("whole", "whole"))}
    log(f"graph server answers vs the eager in-process calls: {apart} uint8 levels (limit 1)")
    if max(apart.values()) > 1:
        raise AssertionError(f"graph server answers differ from the eager calls: {apart}")
    for row in rows.values():
        row.pop("answer", None)
    result["uint8_levels_vs_eager_in_process"] = apart
    return result, launches, None


# ---------------------------------------------------------------------------
# phase 9: fit through the CLI
# ---------------------------------------------------------------------------


class StepProbe:
    """Wraps ``Trainer._step`` and ``Trainer.validate`` for one fit: per
    micro-step launch counts (forward, recompute, backward) and task, the
    first micro-step's trainable tree, batch, noise and task (for the direct
    step), the first batch and noise of each task, what each validation
    returned and its seconds with the card synchronised at both ends (and
    the last one's arguments), and the micro-steps ``sync_steps`` run under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the noise draw,
    the step or the optimizer update may wait for the card or copy from the
    host. The prefetch's own copies run outside it. With ``timed``, each
    micro-step is timed with the card synchronised before and after it, and
    its losses are read (``logs``); with
    ``keep_after`` the trainable tree and the Adam first moments after that
    micro-step are kept. Every micro-step's logged tensors are kept
    (``step_logs``), read after the fit, and each task's step function
    (``step_fns``)."""

    def __init__(self, TE, KN, bridge, sync_steps=(FIT_SYNC_CHECK_STEP,), timed=False,
                 keep_after=None):
        self.TE, self.KN, self.bridge = TE, KN, bridge
        self.sync_steps, self.timed, self.keep_after = sync_steps, timed, keep_after
        self.counts, self.tasks, self.seconds, self.metrics, self.logs = [], [], [], [], []
        self.step_logs, self.step_fns = [], {}
        self.first, self.first_by_task, self.after = None, {}, None
        self.val_seconds, self.val_args = [], None

    def __enter__(self):
        probe, orig, orig_validate = self, self.TE.Trainer._step, self.TE.Trainer.validate
        self.orig, self.orig_validate = orig, orig_validate

        def step(trainer, step_fn, trainable, opt_state, batch, i, draw):
            before = train_counts(probe.KN)
            drawn = []
            task = getattr(step_fn, "task", "ir")

            def draw_kept(b):
                drawn.append(draw(b))
                return drawn[-1]

            kept = {"batch": clone_batch(batch), "task": task}
            if i == 0:
                probe.first = {"trainable": clone_tree(probe.bridge, trainable), **kept}
            if probe.timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if i in probe.sync_steps:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(trainer, step_fn, trainable, opt_state, batch, i, draw_kept)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if probe.timed:
                torch.cuda.synchronize()
                probe.seconds.append(time.perf_counter() - t0)
                probe.logs.append({k: v.item() for k, v in out[2].items()})
            after = train_counts(probe.KN)
            probe.step_logs.append(out[2])
            probe.step_fns[task] = step_fn
            probe.counts.append({s: tuple(a - b for a, b in zip(after[s], before[s]))
                                 for s in after})
            probe.tasks.append(task)
            if i == 0:
                probe.first["noise"] = drawn[0]
            if task not in probe.first_by_task:
                probe.first_by_task[task] = {**kept, "noise": drawn[0]}
            if i == probe.keep_after:
                probe.after = {"trainable": clone_tree(probe.bridge, out[0]),
                               "mu": {k: v.clone() for k, v in out[1]["mu"].items()}}
            return out

        def validate(trainer, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe.metrics.append(orig_validate(trainer, *args, **kwargs))
            torch.cuda.synchronize()
            probe.val_seconds.append(time.perf_counter() - t0)
            probe.val_args = args
            return probe.metrics[-1]

        self.TE.Trainer._step = step
        self.TE.Trainer.validate = validate
        return self

    def __exit__(self, *exc):
        self.TE.Trainer._step = self.orig
        self.TE.Trainer.validate = self.orig_validate
        return False


class WindowTimer:
    """Wraps ``Trainer._step`` for one fit of ``steps`` micro-steps: the wall
    time from the end of micro-step 1 to the end of the last, the card
    synchronised at both ends. It spans ``steps - 1`` whole loop iterations:
    the loader wait, the batch's cast and the step."""

    def __init__(self, TE, steps: int):
        self.TE, self.steps, self.marks = TE, steps, []

    def __enter__(self):
        timer, orig = self, self.TE.Trainer._step
        self.orig = orig

        def step(trainer, step_fn, trainable, opt_state, batch, i, draw):
            out = orig(trainer, step_fn, trainable, opt_state, batch, i, draw)
            if i in (0, timer.steps - 1):
                torch.cuda.synchronize()
                timer.marks.append(time.perf_counter())
            return out

        self.TE.Trainer._step = step
        return self

    def __exit__(self, *exc):
        self.TE.Trainer._step = self.orig
        return False

    @property
    def seconds(self) -> float:
        if len(self.marks) != 2:
            raise AssertionError(f"timed fit: {len(self.marks)} window marks, want 2")
        return self.marks[1] - self.marks[0]


def clone_batch(batch: dict) -> dict:
    """A batch's tensors cloned, those of a nested dict (detection targets) too."""
    return {k: clone_batch(v) if isinstance(v, dict) else v.clone() for k, v in batch.items()}


def clone_tree(bridge, tree):
    return bridge.unflatten_like({k: v.detach().clone() for k, v in bridge.flatten(tree).items()},
                                 tree)


def kernel_shapes_met(KN) -> dict:
    """{kernel symbol: {(shape, dtype)}} of the launches since the last reset."""
    return {kern.symbol: set(kern.shapes) for kern in KN.KERNELS}


def fit_argv(command, data_dir: Path, root: Path, *extra) -> list:
    """``unirestore_torch.main`` arguments: the stage-1 YAML with dotted overrides only."""
    ir_list = str(data_dir / "lists" / "ir.list")
    return [command, "--config", str(FIT_YAML),
            "--data.init_args.dataset_dict.DIVF2KOST.train", ir_list,
            "--data.init_args.dataset_dict.DIVF2KOST.val", ir_list,
            "--trainer.max_steps", str(FIT_STEPS),
            "--trainer.val_check_interval", str(FIT_VAL_EVERY),
            "--trainer.limit_val_batches", str(FIT_VAL_BATCHES),
            "--trainer.logger.init_args.save_dir", str(root), *extra]


def direct_step_check(bridge, TS, OPT, engine, trainer, first, te_loss_fn=None) -> dict:
    """The fit's first micro-step against ``make_train_step`` called directly
    on the same trainable values, batch, noise, task and task loss: the losses
    bit-equal."""
    tx, _ = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs, trainer.max_steps,
                      first["batch"]["hq"].shape[0], trainer.accum, 1)
    tr = first["trainable"]
    step = TS.make_train_step(engine.frozen, engine.cfg, engine.sched, engine.stage, tx,
                              first["task"], te_loss_fn=te_loss_fn)
    logs = step(tr, tx.init(TS.trained_leaves(engine.stage, tr)), first["batch"],
                first["noise"])[2]
    logs = {k: v.item() for k, v in logs.items()}
    fit = trainer.logs[0]
    losses = [k for k in logs if k.startswith("train/loss")]
    unequal = {k: (fit[k], logs[k]) for k in losses if fit[k] != logs[k]}
    log(f"fit step 1 ({first['task']}) vs a direct make_train_step call on its batch and "
        f"noise: {len(losses) - len(unequal)} of {len(losses)} losses bit-equal; grad norm "
        f"{fit['train/grad_norm']!r} vs {logs['train/grad_norm']!r}")
    if unequal:
        raise AssertionError(f"fit step 1 losses differ from the direct step: {unequal}")
    return {"task": first["task"], "losses_bit_equal": len(losses),
            "grad_norm_fit": fit["train/grad_norm"], "grad_norm_direct": logs["train/grad_norm"]}


def run_fit(KN, bridge, TE, TS, OPT, main_fn, png, work: Path):
    """Phase 9: ``unirestore_torch.main.main`` fit, resume and predict at full
    width on the 576 px smoke tree it makes under ``work/data``, then a timed
    and a profiled fit. Returns (result, launches by kernel of the first fit,
    the (shape, dtype) each kernel met, phase 16's reference: the first
    fit's losses of its first ``DDP_STEPS`` micro-steps and its trainable
    tree after them, in the checkpoint's layout)."""
    return fit_in(KN, bridge, TE, TS, OPT, main_fn, png, work)


def fit_in(KN, bridge, TE, TS, OPT, main_fn, png, work: Path):
    """``run_fit`` in the scratch directory ``work``."""
    from unirestore_torch.data.corruption import native

    data_dir, root = work / "data", work / "logs"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(REPO / "tools" / "make_smoke_data.py"), str(data_dir),
                    str(FIT_RES)], check=True, capture_output=True, text=True, timeout=300)
    log(f"fit data: smoke tree at {FIT_RES} px in {time.perf_counter() - t0:.1f} s; native "
        f"corruption kernels loaded: {native.available()}")

    # first fit: sanity validation, 6 micro-steps, validation at 3 and 6
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepProbe(TE, KN, bridge, keep_after=DDP_STEPS - 1) as probe:
        engine, trainer = main_fn(fit_argv("fit", data_dir, root))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # phase 16's, 18's and 19's reference: the first micro-steps' logs and the
    # trainable tree after them; every micro-step's logs and a copy of
    # last.npz (the resume below overwrites it)
    logs_all = [{k: v.item() for k, v in e.items()} for e in probe.step_logs]
    reference16 = {"logs": logs_all[:DDP_STEPS], "logs_all": logs_all,
                   "trainable": bridge.flatten(bridge.to_numpy_tree(probe.after["trainable"])),
                   "last_npz": work / "phase9_last.npz"}
    shutil.copyfile(root / "checkpoints" / "last.npz", reference16["last_npz"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    shapes = kernel_shapes_met(KN)
    for i, c in enumerate(probe.counts):
        if c != EXPECTED_TRAIN:
            raise AssertionError(f"fit micro-step {i + 1}: launches {c} != {EXPECTED_TRAIN}")
    if len(probe.counts) != FIT_STEPS:
        raise AssertionError(f"fit ran {len(probe.counts)} micro-steps, want {FIT_STEPS}")
    val = tuple(launches[kern.symbol] - FIT_STEPS * sum(EXPECTED_TRAIN[kern.symbol][:2])
                for kern in KN.KERNELS)
    want_val = tuple(FIT_VAL_RESTORES * n for n in FIT_RESTORE)
    log(f"fit: launches per micro-step {probe.counts[0]} (all {FIT_STEPS} equal phase 6's); "
        f"validation launches {val} = {FIT_VAL_RESTORES} restores x {FIT_RESTORE}: "
        f"{val == want_val}")
    if val != want_val:
        raise AssertionError(f"fit validation launches {val} != {want_val}")
    logged = list(trainer.logs)
    if not logged or not all(math.isfinite(v) for e in logged for v in e.values()):
        raise AssertionError(f"fit: non-finite or missing logged losses {logged}")
    moved = trained_leaves_moved(bridge, TS, OPT, engine, trainer, probe.first["trainable"],
                                 root / "checkpoints" / "last.npz")
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    if (len(ckpts) != 3 or ckpts[0] != "last.npz"
            or not ckpts[1].startswith(f"step={FIT_VAL_EVERY}-val=")
            or not ckpts[2].startswith(f"step={FIT_STEPS}-val=")):
        raise AssertionError(f"fit checkpoints {ckpts}")
    direct = direct_step_check(bridge, TS, OPT, engine, trainer, probe.first)
    timing = {k: v for k, v in trainer.timing.items() if k != "loader_waits_s"}
    log(f"fit: {fit_s:.1f} s in all; host time of a step call (not synchronised) p50 "
        f"{timing['p50_s']:.4f} s (mean {timing['mean_s']:.4f}, {timing['steps']} steps "
        f"after the first); loader wait "
        f"{timing['loader_wait_mean_s'] * 1e3:.2f} ms/step (each "
        f"{[round(w * 1e3, 2) for w in trainer.timing['loader_waits_s']]}); peak "
        f"{peak:.1f} GiB; checkpoints {ckpts}")
    n_frozen_check = frozen_unchanged(bridge, engine)
    del probe, engine, trainer
    torch.cuda.empty_cache()

    # resume to step 8
    KN.reset_counts()
    t0 = time.perf_counter()
    engine, trainer = main_fn(fit_argv("fit", data_dir, root, "--trainer.resume", "auto",
                                       "--trainer.max_steps", str(FIT_RESUME_STEPS)))
    resume_s = time.perf_counter() - t0
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    from unirestore_torch.train import checkpoints as CKPT
    meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]
    ran = len(trainer.timing["loader_waits_s"])
    if meta["step"] != FIT_RESUME_STEPS or ran != FIT_RESUME_STEPS - FIT_STEPS:
        raise AssertionError(f"resume: {ran} steps run, last.npz at step {meta['step']}; want "
                             f"{FIT_RESUME_STEPS - FIT_STEPS} steps from step {FIT_STEPS}")
    log(f"resume: {ran} steps from step {FIT_STEPS} in {resume_s:.1f} s; last.npz step "
        f"{meta['step']}")
    del engine, trainer
    torch.cuda.empty_cache()

    # predict: one PNG per val image, each the size of its input
    KN.reset_counts()
    t0 = time.perf_counter()
    main_fn(fit_argv("predict", data_dir, root))
    predict_s = time.perf_counter() - t0
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    pngs = sorted((root / "predict").iterdir())
    sizes = {tuple(png.decode(p.read_bytes()).shape) for p in pngs}
    log(f"predict: {len(pngs)} PNGs in {predict_s:.1f} s, sizes {sizes}")
    if len(pngs) != 6 or sizes != {(FIT_RES, FIT_RES + 16, 3)}:
        raise AssertionError(f"predict wrote {len(pngs)} PNGs of sizes {sizes}")
    torch.cuda.empty_cache()

    # timed: micro-steps 2-6 synchronised at both ends, no validation
    KN.reset_counts()
    no_val = ("--trainer.val_check_interval", "0", "--trainer.num_sanity_val_steps", "0")
    with WindowTimer(TE, FIT_STEPS) as window:
        _, timed = main_fn(fit_argv("fit", data_dir, work / "timed", *no_val))
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    n, batch = FIT_STEPS - 1, timed.timing["batch_size"]
    waits = timed.timing["loader_waits_s"][1:]
    timed = {"steps": n, "batch_size": batch, "wall_s": window.seconds,
             "s_per_step": window.seconds / n, "train_img_s": n * batch / window.seconds,
             "loader_wait_mean_s": sum(waits) / len(waits),
             "host_step_call_p50_s": timed.timing["p50_s"]}
    log(f"timed fit, micro-steps 2-{FIT_STEPS} (card synchronised at both ends): "
        f"{timed['wall_s']:.4f} s, {timed['s_per_step']:.4f} s/step, "
        f"{timed['train_img_s']:.3f} train img/s at batch {batch}; loader wait "
        f"{timed['loader_wait_mean_s'] * 1e3:.2f} ms/step; host time of a step call p50 "
        f"{timed['host_step_call_p50_s']:.4f} s")
    torch.cuda.empty_cache()

    # profiled: steps 2-3 under torch.profiler (trainer.profiler), no validation
    KN.reset_counts()
    _, profiled = main_fn(fit_argv("fit", data_dir, work / "profiled", "--trainer.profiler",
                                   str(work / "trace"), "--trainer.max_steps",
                                   str(FIT_PROFILED_STEPS), *no_val))
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    prof = profiled.profile
    log(f"profiled fit, steps {prof.get('steps')}: device busy "
        f"{prof.get('device_busy_s', float('nan')):.4f} s of "
        f"{prof.get('device_span_s', float('nan')):.4f} s, "
        f"idle share {prof.get('device_idle_share')}, {prof.get('kernels')} kernels; p50 "
        f"{profiled.timing['p50_s']:.4f} s/step under the profiler")
    if not prof.get("kernels"):
        raise AssertionError(f"the profiled fit recorded no device activity: {prof}")
    torch.cuda.empty_cache()
    result = {"res": FIT_RES, "steps": FIT_STEPS, "fit_seconds": fit_s, "peak_mem_gib": peak,
              "timing": timing, "timed": timed, "logs": logged, "checkpoints": ckpts,
              "direct_step": direct,
              "launches_per_micro_step": EXPECTED_TRAIN, "validation_launches": val,
              "trained_leaves": moved,
              "frozen_leaves_checked": n_frozen_check, "resume_seconds": resume_s,
              "predict_seconds": predict_s, "predict_pngs": len(pngs),
              "profile": {**prof, "p50_s_profiled": profiled.timing["p50_s"]}}
    return result, launches, shapes, reference16


def trained_leaves_moved(bridge, TS, OPT, engine, trainer, before, last) -> dict:
    """Every CFRM / Controller / SC-Tuner leaf after the fit against its value
    before the first step. A leaf may keep its value only where its updates
    fell below its fp32 resolution: a zero-initialised NAF ``beta`` / ``gamma``
    or zero conv gates the branch behind it, so at the YAML's first OneCycle
    rates (peak / 10) that branch's 1-D leaves get gradients near 1e-9 and
    Adam moves them by far less than one ulp of 1.0. Such a leaf must still
    have had a gradient: its Adam first moment in ``last.npz`` is not zero."""
    from unirestore_torch.train import checkpoints as CKPT
    trained = TS.trained_leaves(engine.stage, engine.trainable)
    before = bridge.flatten(before)
    unchanged = [k for k, v in trained.items() if torch.equal(v, before[k])]
    tx, _ = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs, trainer.max_steps,
                      trainer.timing["batch_size"], trainer.accum, 1)
    mu = CKPT.restore_opt_state(str(last), tx.init(trained))["mu"]
    silent = [k for k in unchanged if not mu[k].any()]
    mu_max = max((mu[k].abs().max().item() for k in unchanged), default=0.0)
    log(f"fit: {len(trained) - len(unchanged)} of {len(trained)} trained leaves changed; "
        f"{len(unchanged)} kept their values with nonzero first moments (largest |mu| "
        f"{mu_max:.3e}): {unchanged[:6]}{' ...' if len(unchanged) > 6 else ''}")
    if silent:
        raise AssertionError(f"fit: {len(silent)} trained leaves got no gradient: {silent[:5]}")
    return {"count": len(trained), "changed": len(trained) - len(unchanged),
            "below_resolution": unchanged, "largest_first_moment_of_those": mu_max}


def frozen_unchanged(bridge, engine) -> int:
    """The frozen tree after the fit against a fresh seeded build of it: every byte equal."""
    from unirestore_torch import zoo
    from unirestore_torch.models import unirestore as UR
    fresh, _ = UR.init(engine.cfg, device=engine.device, seed=engine.seed)
    fresh = zoo.load_frozen_backbone(fresh, engine.cfg)
    fresh = bridge.flatten(fresh)
    touched = [k for k, v in bridge.flatten(engine.frozen).items()
               if not torch.equal(v, fresh[k].to(v.dtype))]
    if touched:
        raise AssertionError(f"fit: frozen leaves changed: {touched[:5]}")
    return len(fresh)


def merge_shapes(a: dict, b: dict) -> dict:
    return {k: a[k] | b[k] for k in a}


def check_fit_shapes(K, G, KN, shapes, rows, gen, path: str = "fit") -> int:
    """Phase 3's comparison at every (shape, dtype) a fit gave a kernel that
    phase 3's lists and the rows already held do not hold (rows marked
    ``"path": path``). Returns how many shapes it added."""
    held = {(kern.symbol, tuple(shape)) for kern, shape, _ in kernel_shapes(K)}
    held |= {(G.grouped_conv3.symbol, tuple(s)) for s in gconv_shapes()}
    held |= {(symbol, tuple(row["shape"])) for symbol, rs in rows.items() for row in rs}
    added = 0
    with torch.inference_mode():
        for kern in KN.KERNELS:
            for shape, dtype in sorted(shapes[kern.symbol], key=str):
                if (kern.symbol, shape) in held:
                    continue
                if dtype != torch.bfloat16:
                    raise AssertionError(f"{kern.symbol}: the {path} launched it in {dtype} at "
                                         f"{shape}; phase 3 holds bf16 launches only")
                if kern is G.grouped_conv3:
                    row = check_gconv(G, shape, gen)
                else:
                    heads = shape[2] // 64 if kern is K.fused_attention_btc_prescaled else 1
                    row = check_kernel(K, kern, shape, heads, gen)
                row["path"] = path
                rows[kern.symbol].append(row)
                held.add((kern.symbol, shape))
                added += 1
    return added


# ---------------------------------------------------------------------------
# phase 11: the stage-2 fit through the CLI
# ---------------------------------------------------------------------------


def fit2_argv(command, data_dir: Path, root: Path, *extra, steps: int = FIT2_STEPS,
              val_every: int = FIT2_VAL_EVERY, sanity: int = FIT2_SANITY) -> list:
    """``unirestore_torch.main`` arguments: the stage-2 YAML with dotted overrides only
    (the smoke tree's lists, the step counts, validation and the log directory)."""
    lists = data_dir / "lists"
    argv = [command, "--config", str(FIT2_YAML)]
    for name, lst, splits in FIT2_LISTS:
        for split in splits:
            argv += [f"--data.init_args.dataset_dict.{name}.{split}", str(lists / f"{lst}.list")]
    return argv + ["--trainer.max_steps", str(steps),
                   "--trainer.val_check_interval", str(val_every),
                   "--trainer.limit_val_batches", str(FIT2_VAL_BATCHES),
                   "--trainer.num_sanity_val_steps", str(sanity),
                   "--trainer.logger.init_args.save_dir", str(root), *extra]


def profiled_device(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: the card's busy seconds, by
    kernel family (``tools/profile_torch_restore.py:family``) and in all, the
    number of kernels, and the eight kernel names that took the most time.
    The card's events are read from the profiler's raw kineto results: the
    ``prof.events()`` tree of a validation's 50k kernels takes seconds of host
    time to build, the raw list a tenth of it."""
    import importlib.util

    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location("profile_torch_restore",
                                                  REPO / "tools" / "profile_torch_restore.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_family, by_name, n = {}, {}, 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation():
            name, sec = evt.name(), evt.duration_ns() / 1e9
            fam = tool.family(name)
            by_family[fam] = by_family.get(fam, 0.0) + sec
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + sec
            n += 1
    return {"device_busy_s": sum(by_family.values()), "kernels": n,
            "device_s_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
            "top_kernels_s": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def critic_share(bridge, TS, OPT, engine, trainer, probe, tasks=("cls", "seg"),
                 label="stage-2") -> dict:
    """The critics' share of a micro-step's device time for each of ``tasks``:
    the card's busy time in the critic's forward and backward pass alone (the
    task loss on fp32 predictions of the micro-step's shape, differentiated to
    the predictions) over its busy time in a whole micro-step on the task's
    first batch and noise of the fit, both profiled after a warm-up."""
    te_fn = engine.te_loss_fn()
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for task in tasks:
        first = probe.first_by_task[task]
        batch, noise = first["batch"], first["noise"]
        tr = clone_tree(bridge, engine.trainable)
        tx, _ = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs,
                          trainer.max_steps, batch["hq"].shape[0], trainer.accum, 1)
        state = tx.init(TS.trained_leaves(engine.stage, tr))
        step = TS.make_train_step(engine.frozen, engine.cfg, engine.sched, engine.stage, tx,
                                  task, te_loss_fn=te_fn)
        preds = torch.rand(batch["hq"].shape, generator=gen, device="cuda")

        def micro_step():
            step(tr, state, batch, noise)

        def critic():
            p = preds.clone().requires_grad_(True)
            with torch.enable_grad():
                torch.autograd.grad(te_fn(p, batch["hq"], batch["gt"], task), [p])

        micro_step()
        critic()
        whole, alone = profiled_device(micro_step), profiled_device(critic)
        share = alone["device_busy_s"] / whole["device_busy_s"]
        out[task] = {"micro_step": whole, "critic": alone, "critic_share": share}
        log(f"{label} {task} micro-step, profiled: device busy {whole['device_busy_s']:.4f} s "
            f"({whole['kernels']} kernels); the critic's forward and backward alone "
            f"{alone['device_busy_s']:.4f} s ({alone['kernels']} kernels): share {share:.3f}; "
            f"micro-step by family {whole['device_s_by_family']}; the critic by family "
            f"{alone['device_s_by_family']}, its top kernels {alone['top_kernels_s'][:4]}")
    return out


def run_fit_stage2(KN, bridge, TE, TS, OPT, main_fn, work: Path):
    """Phase 11: ``unirestore_torch.main.main`` fit from the stage-2 YAML on
    phase 9's smoke tree under ``work/data``, its checks, the critics' share
    of a micro-step, and a resume. Returns (result, launches by kernel of the
    fit, the (shape, dtype) each kernel met)."""
    data_dir, root = work / "data", work / "stage2"
    symbols = [kern.symbol for kern in KN.KERNELS]
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepProbe(TE, KN, bridge, sync_steps=FIT2_SYNC_CHECK_STEPS, timed=True,
                   keep_after=FIT2_ACCUM - 1) as probe:
        engine, trainer = main_fn(fit2_argv("fit", data_dir, root))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    shapes = kernel_shapes_met(KN)

    tasks = tuple(probe.tasks)
    log(f"stage-2 fit: micro-step tasks {tasks}")
    if len(tasks) != FIT2_STEPS or set(tasks) != {"ir", "cls", "seg"}:
        raise AssertionError(f"stage-2 fit: micro-steps {tasks}; want {FIT2_STEPS} covering "
                             "ir, cls and seg")
    for i, (task, counts) in enumerate(zip(tasks, probe.counts)):
        if counts != EXPECTED_STAGE2[task]:
            raise AssertionError(f"stage-2 micro-step {i + 1} ({task}): launches {counts} != "
                                 f"{EXPECTED_STAGE2[task]}")
    val = tuple(launches[s] - sum(EXPECTED_STAGE2[t][s][0] for t in tasks) for s in symbols)
    want_val = tuple(sum(FIT2_VAL_RESTORES[t] * FIT2_RESTORE[t][i] for t in FIT2_RESTORE)
                     for i in range(len(symbols)))
    log(f"stage-2 fit: launches per micro-step as the routing implies for every task "
        f"({ {t: EXPECTED_STAGE2[t]['ur_attention_stream'] for t in ('ir', 'cls', 'seg')} } "
        f"wide-head); validation launches {val} = restores {FIT2_VAL_RESTORES} x "
        f"{FIT2_RESTORE}: {val == want_val}")
    if val != want_val:
        raise AssertionError(f"stage-2 validation launches {val} != {want_val}")
    logged = probe.logs
    if len(logged) != FIT2_STEPS or not all(math.isfinite(v) for e in logged
                                            for v in e.values()):
        raise AssertionError(f"stage-2 fit: non-finite or missing losses {logged}")

    # only the TFA leaves train; the frozen tree and both critics stay as built
    before, now = bridge.flatten(probe.first["trainable"]), bridge.flatten(engine.trainable)
    changed = [k for k in now if not torch.equal(now[k], before[k])]
    families = sorted({k.split("//")[0] for k in changed})
    n_tfa = sum(k.startswith("tfa//") for k in now)
    log(f"stage-2 fit: {len(changed)} of {n_tfa} TFA leaves changed; families changed "
        f"{families}")
    if families != ["tfa"]:
        raise AssertionError(f"stage-2 fit changed {families}; only tfa may change")
    n_frozen = frozen_unchanged(bridge, engine)
    fresh = bridge.flatten(TE.build_critics("mtl", device=engine.device))
    critics = bridge.flatten(engine.critics)
    touched = [k for k in fresh if not torch.equal(fresh[k], critics[k])]
    if touched or fresh.keys() != critics.keys():
        raise AssertionError(f"stage-2 fit changed the critics: {touched[:5]}")

    # CE reaches each task's prompt: after the first update each prompt moved
    # or carries a nonzero first moment
    prompts = {}
    for task in ("ir", "cls", "seg"):
        k = f"tfa//task_prompts//{task}"
        moved = not torch.equal(bridge.flatten(probe.after["trainable"])[k], before[k])
        mu = probe.after["mu"][k].abs().max().item()
        prompts[task] = {"moved": moved, "max_abs_first_moment": mu}
        if not moved and mu == 0.0:
            raise AssertionError(f"stage-2 fit: the {task} prompt got no gradient before the "
                                 "first update")
    log(f"stage-2 fit: task prompts after the first update {prompts}")

    direct = direct_step_check(bridge, TS, OPT, engine, trainer, probe.first,
                               te_loss_fn=engine.te_loss_fn())
    metrics = probe.metrics
    need = {"val_ir_lq/psnr", "val_cls_lq/r50v1", "val_cls_hq/r50v1", "val_seg_lq/dlv3pr50",
            "val_monitor"}
    if len(metrics) != FIT2_STEPS // FIT2_VAL_EVERY or any(
            not need <= m.keys() or m["val_monitor"] != m["val_ir_lq/psnr"] for m in metrics):
        raise AssertionError(f"stage-2 validation metrics {metrics}")
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    if (len(ckpts) != 3 or ckpts[0] != "last.npz"
            or not ckpts[1].startswith(f"step={FIT2_STEPS}-val=")
            or not ckpts[2].startswith(f"step={FIT2_VAL_EVERY}-val=")):
        raise AssertionError(f"stage-2 fit checkpoints {ckpts}")

    # s per micro-step of each task, the card synchronised before and after
    # each; each task's first micro-step is its warm-up
    per_task = {}
    for task in ("ir", "cls", "seg"):
        secs = [s for t, s in zip(tasks, probe.seconds) if t == task]
        per_task[task] = {"micro_steps": len(secs), "first_s": secs[0],
                          "s_per_step": sum(secs[1:]) / len(secs[1:]), "each_s": secs}
    waits = trainer.timing["loader_waits_s"]
    share = critic_share(bridge, TS, OPT, engine, trainer, probe)
    log(f"stage-2 fit: {fit_s:.1f} s in all; s per micro-step after each task's first "
        f"(synchronised) " + ", ".join(f"{t} {v['s_per_step']:.4f} ({v['micro_steps'] - 1})"
                                       for t, v in per_task.items())
        + f"; loader wait {sum(waits) / len(waits) * 1e3:.2f} ms/step (each "
        f"{[round(w * 1e3, 2) for w in waits]}); peak {peak:.2f} GiB; checkpoints {ckpts}; "
        f"validation {metrics[-1]}")
    del probe, engine, trainer
    torch.cuda.empty_cache()

    # resume to a later step
    KN.reset_counts()
    t0 = time.perf_counter()
    _, trainer = main_fn(fit2_argv("fit", data_dir, root, "--trainer.resume", "auto",
                                   "--trainer.max_steps", str(FIT2_RESUME_STEPS),
                                   "--trainer.num_sanity_val_steps", "0"))
    resume_s = time.perf_counter() - t0
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    from unirestore_torch.train import checkpoints as CKPT
    meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]
    ran = len(trainer.timing["loader_waits_s"])
    if meta["step"] != FIT2_RESUME_STEPS or ran != FIT2_RESUME_STEPS - FIT2_STEPS:
        raise AssertionError(f"stage-2 resume: {ran} steps run, last.npz at step "
                             f"{meta['step']}; want {FIT2_RESUME_STEPS - FIT2_STEPS} from step "
                             f"{FIT2_STEPS}")
    log(f"stage-2 resume: {ran} step from step {FIT2_STEPS} in {resume_s:.1f} s; last.npz step "
        f"{meta['step']}")
    del trainer
    torch.cuda.empty_cache()
    result = {"res": FIT_RES, "steps": FIT2_STEPS, "accumulation": FIT2_ACCUM, "tasks": tasks,
              "fit_seconds": fit_s, "peak_mem_gib": peak, "s_per_micro_step": per_task,
              "loader_wait_mean_s": sum(waits) / len(waits), "loader_waits_s": waits,
              "logs": logged, "validation": metrics, "checkpoints": ckpts,
              "direct_step": direct, "launches_per_micro_step": EXPECTED_STAGE2,
              "validation_launches": val, "tfa_leaves_changed": len(changed),
              "tfa_leaves": n_tfa, "prompts_after_first_update": prompts,
              "frozen_leaves_checked": n_frozen, "critic_leaves_checked": len(fresh),
              "critic_share": share, "resume_seconds": resume_s}
    return result, launches, shapes


STAGE2_REF_TASKS = ("cls", "seg")


def train2_reference_inputs(UR, bridge, TS, TE):
    """Phase 11's seeded inputs on the card: the full-width fp32 model with
    TFA, the critics, and a 256 px pair with labels and its noise for each of
    ``STAGE2_REF_TASKS``, drawn in turn."""
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=11)
    critics = TE.build_critics("mtl", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    inputs = {}
    for task in STAGE2_REF_TASKS:
        batch = synthetic_pair(gen, 1, 256, torch.float32)
        if task == "cls":
            batch["gt"] = torch.tensor([417], device="cuda")
        else:
            labels = torch.randint(0, 19, (1, 256, 256), generator=gen, device="cuda")
            labels[:, :32] = 255
            batch["gt"] = labels
        inputs[task] = (batch, TS.draw_noise(cfg, batch, gen))
    return cfg, (frozen, trainable, critics), inputs


def train2_reference_run(UR, TS, TE, cfg, device, trees, batch, noise, task) -> tuple:
    """Phase 11's stage-2 losses of ``task`` and the TFA gradient norm on ``device``."""
    tree_f, tree_t, crit = trees
    stage = TS.StageConfig(train_cfrm=False, train_cnet=False, train_tfa=True, multi_task=True)
    leaves = TS.trained_leaves(stage, tree_t)
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        nz = TS.StepNoise(*(x.to(device) for x in (noise.hq, noise.lq, noise.diffusion,
                                                   noise.timesteps)))
        loss, logs = TS.compute_losses(tree_f, tree_t, TS.with_remat(cfg),
                                       UR.schedule(cfg, device=device), stage,
                                       {k: v.to(device) for k, v in batch.items()}, nz, task,
                                       TE.make_te_loss_fn("mtl", crit))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    finally:
        for p in leaves.values():
            p.requires_grad_(False)
    norm = sum(g.double().square().sum().item() for g in grads if g is not None) ** 0.5
    return {k: v.item() for k, v in logs.items()}, norm


def train2_reference_cpu() -> dict:
    """Reference job: phase 11's two stage-2 steps on the host. Returns
    {task: (logs, norm, CPU seconds)}."""
    from unirestore_torch import bridge
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.train import engine as TE
    from unirestore_torch.train import steps as TS

    cfg, trees, inputs = train2_reference_inputs(UR, bridge, TS, TE)
    trees = tuple(to_cpu(bridge, t) for t in trees)
    inputs = {task: ({k: v.cpu() for k, v in b.items()},
                     TS.StepNoise(*(x.cpu() for x in (n.hq, n.lq, n.diffusion, n.timesteps))))
              for task, (b, n) in inputs.items()}
    torch.cuda.empty_cache()
    out = {}
    for task, (batch, noise) in inputs.items():
        t0 = time.perf_counter()
        logs, norm = train2_reference_run(UR, TS, TE, cfg, "cpu", trees, batch, noise, task)
        out[task] = (logs, norm, time.perf_counter() - t0)
    return out


def train2_reference_check(UR, KN, bridge, TS, TE, refs):
    """Phase 11: one stage-2 loss for ``cls`` and one for ``seg`` and the TFA
    gradient norm, full widths with the critics, 256 px, fp32, card vs CPU.
    The CPU half runs in ``refs``' worker; returns the check, which waits
    for it."""
    cfg, trees, inputs = train2_reference_inputs(UR, bridge, TS, TE)
    refs.submit("phase 11", train2_reference_cpu)
    gpu = {}
    for task, (batch, noise) in inputs.items():
        KN.reset_counts()
        gpu[task] = (*train2_reference_run(UR, TS, TE, cfg, "cuda", trees, batch, noise, task),
                     train_counts(KN))
        counts = gpu[task][2]
        if any(counts[s][0] == 0 for s, c in EXPECTED_STAGE2[task].items() if c[0]):
            raise AssertionError(f"a kernel did not run in the stage-2 reference: {counts}")
    del trees, inputs

    def check():
        cpu = refs.result("phase 11")
        out = {}
        for task, (gpu_logs, gpu_norm, counts) in gpu.items():
            cpu_logs, cpu_norm, cpu_s = cpu[task]
            loss_err = max(abs(gpu_logs[k] - cpu_logs[k]) / abs(cpu_logs[k]) for k in cpu_logs)
            grad_err = abs(gpu_norm - cpu_norm) / cpu_norm
            log(f"stage-2 reference {task}, 256 px fp32: card vs CPU max relative loss error "
                f"{loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), TFA gradient norm {gpu_norm:.6g} vs "
                f"{cpu_norm:.6g}, error {grad_err:.3e} (limit {TRAIN_GRAD_RTOL}); losses card "
                f"{gpu_logs} CPU {cpu_logs}; card launches {counts}; CPU {cpu_s:.1f} s in the "
                "reference worker")
            finite = all(math.isfinite(v) for v in (*gpu_logs.values(), gpu_norm))
            if not finite or loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
                raise AssertionError(f"card and CPU stage-2 {task} steps differ")
            out[task] = {"loss_rel_err": loss_err, "grad_norm_rel_err": grad_err,
                         "tfa_grad_norm_card": gpu_norm, "tfa_grad_norm_cpu": cpu_norm,
                         "cpu_seconds": cpu_s}
        return out

    return check


# ---------------------------------------------------------------------------
# phase 12: the stage-3 fit through the CLI
# ---------------------------------------------------------------------------


def fit3_argv(command, work: Path, root: Path, *extra) -> list:
    """``unirestore_torch.main`` arguments: the stage-3 YAML with dotted overrides only
    (the smoke tree's COCO list, the stage-1 and stage-2 checkpoints of phases 9
    and 11, the step counts, validation and the log directory)."""
    det_list = str(work / "data" / "lists" / "det.list")
    stage1, stage2 = (str(work / d / "checkpoints" / "last.npz") for d in ("logs", "stage2"))
    kwargs = "--model.init_args.model_kwargs"
    return [command, "--config", str(FIT3_YAML),
            "--data.init_args.dataset_dict.COCO.train", det_list,
            "--data.init_args.dataset_dict.COCO.val", det_list,
            f"{kwargs}.frenc.ckpt_path", stage1, f"{kwargs}.cnet.ckpt_path", stage1,
            f"{kwargs}.tedit.ckpt_path", stage2,
            "--trainer.max_steps", str(FIT3_STEPS),
            "--trainer.val_check_interval", str(FIT3_VAL_EVERY),
            "--trainer.limit_val_batches", str(FIT3_VAL_BATCHES),
            "--trainer.logger.init_args.save_dir", str(root), *extra]


def stage3_surgery_check(bridge, engine, first, work: Path) -> dict:
    """The trainable tree before the first micro-step: CFRM, Controller and
    control bit-equal to phase 9's last.npz, the TFA editors and the ir, cls
    and seg prompts to phase 11's, the det prompt to its fresh init."""
    from unirestore_torch.train import checkpoints as CKPT
    stage1 = CKPT.load_checkpoint(str(work / "logs" / "checkpoints" / "last.npz"))[0]
    stage2 = CKPT.load_checkpoint(str(work / "stage2" / "checkpoints" / "last.npz"))[0]
    from unirestore_torch.models import tfa as TFA
    from unirestore_torch.nn.init import make_init
    counts = {"stage1": 0, "stage2": 0, "fresh": 0}
    for k, v in bridge.flatten(bridge.to_numpy_tree(first)).items():
        if k.split("//")[0] in ("cfrm", "controller", "control"):
            source, want = "stage1", stage1[f"trainable//{k}"]
        elif k == "tfa//task_prompts//det":
            if f"trainable//{k}" in stage2:
                raise AssertionError("the stage-2 checkpoint has a det prompt")
            source = "fresh"
            want = TFA.task_prompts_init(make_init(None, "cpu", seed=engine.seed), ("det",),
                                         engine.cfg.prompt_len, v.shape[-1])["det"].numpy()
        else:
            source, want = "stage2", stage2[f"trainable//{k}"]
        if v.shape != want.shape or not (v == want).all():
            raise AssertionError(f"stage-3 surgery: {k} differs from its {source} source")
        counts[source] += 1
    log(f"stage-3 surgery: {counts['stage1']} CFRM / Controller / control leaves bit-equal to "
        f"phase 9's last.npz, {counts['stage2']} TFA leaves to phase 11's, the det prompt at "
        f"its fresh init")
    return counts


def stage3_prompts_check(bridge, TS, OPT, engine, trainer, before, last: Path) -> dict:
    """After the fit only ``tfa//task_prompts//*`` changed, the det prompt
    among them; the det and ir prompts carry nonzero Adam first moments (their
    gradients), the cls and seg prompts zero ones: weight decay alone moves
    them, by less than one fp32 step where the rate is small."""
    from unirestore_torch.train import checkpoints as CKPT
    before, now = bridge.flatten(before), bridge.flatten(engine.trainable)
    changed = sorted(k for k in now if not torch.equal(now[k], before[k]))
    prompts = sorted(f"tfa//task_prompts//{t}" for t in engine.cfg.tasks)
    tx, _ = OPT.build(engine.optimizer_kwargs, engine.lr_scheduler_kwargs, trainer.max_steps,
                      trainer.timing["batch_size"], trainer.accum, 1)
    trained = TS.trained_leaves(engine.stage, engine.trainable)
    mu = CKPT.restore_opt_state(str(last), tx.init(trained))["mu"]
    first_moment = {k.rsplit("//", 1)[1]: mu[k].abs().max().item() for k in prompts}
    log(f"stage-3 fit: changed leaves {changed}; largest |Adam first moment| per prompt "
        f"{first_moment}")
    if not set(changed) <= set(prompts) or "tfa//task_prompts//det" not in changed \
            or sorted(trained) != prompts:
        raise AssertionError(f"stage-3 fit changed {changed}, trains {sorted(trained)}; only "
                             f"the task prompts {prompts} may, the det prompt among them")
    if not (first_moment["det"] and first_moment["ir"]) or first_moment["cls"] or \
            first_moment["seg"]:
        raise AssertionError(f"stage-3 prompt gradients {first_moment}: want det and ir only")
    return {"changed": changed, "max_abs_first_moment": first_moment}


def run_fit_stage3(KN, bridge, TE, TS, OPT, main_fn, work: Path):
    """Phase 12: ``unirestore_torch.main.main`` fit from the stage-3 YAML on
    phase 9's smoke tree, chained to the checkpoints of phases 9 and 11, its
    checks, the critic's share of a micro-step, a resume, and a fit through
    Faster R-CNN. Returns (result, launches by kernel of the RetinaNet fit,
    the (shape, dtype) each kernel met in phase 12, the RetinaNet fit's s per
    micro-step, which phase 20 (b) reports beside its own)."""
    root = work / "stage3"
    symbols = [kern.symbol for kern in KN.KERNELS]
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepProbe(TE, KN, bridge, sync_steps=(FIT3_SYNC_CHECK_STEP,), timed=True) as probe:
        engine, trainer = main_fn(fit3_argv("fit", work, root))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    shapes = kernel_shapes_met(KN)

    if engine.engine_type != "det" or engine.downstream != "retinanet" or \
            probe.tasks != ["det"] * FIT3_STEPS:
        raise AssertionError(f"stage-3 fit: engine {engine.engine_type} / {engine.downstream}, "
                             f"micro-steps {probe.tasks}")
    surgery = stage3_surgery_check(bridge, engine, probe.first["trainable"], work)
    for i, counts in enumerate(probe.counts):
        if counts != EXPECTED_STAGE3:
            raise AssertionError(f"stage-3 micro-step {i + 1}: launches {counts} != "
                                 f"{EXPECTED_STAGE3}")
    val = tuple(launches[s] - FIT3_STEPS * EXPECTED_STAGE3[s][0] for s in symbols)
    restores = FIT3_STEPS // FIT3_VAL_EVERY * FIT3_VAL_BATCHES
    want_val = tuple(restores * n for n in FIT3_RESTORE)
    log(f"stage-3 fit: launches per micro-step {EXPECTED_STAGE3} for all {FIT3_STEPS}; "
        f"validation launches {val} = {restores} restores x {FIT3_RESTORE}: {val == want_val}")
    if val != want_val:
        raise AssertionError(f"stage-3 validation launches {val} != {want_val}")
    logged = probe.logs
    if len(logged) != FIT3_STEPS or not all(math.isfinite(v) for e in logged
                                            for v in e.values()):
        raise AssertionError(f"stage-3 fit: non-finite or missing losses {logged}")
    prompts = stage3_prompts_check(bridge, TS, OPT, engine, trainer, probe.first["trainable"],
                                   root / "checkpoints" / "last.npz")
    n_frozen = frozen_unchanged(bridge, engine)
    fresh = bridge.flatten(TE.build_critics("det", "retinanet", device=engine.device))
    critic = bridge.flatten(engine.critics)
    touched = [k for k in fresh if not torch.equal(fresh[k], critic[k])]
    if touched or fresh.keys() != critic.keys():
        raise AssertionError(f"stage-3 fit changed the critic: {touched[:5]}")
    direct = direct_step_check(bridge, TS, OPT, engine, trainer, probe.first,
                               te_loss_fn=engine.te_loss_fn())
    metrics = probe.metrics
    if len(metrics) != FIT3_STEPS // FIT3_VAL_EVERY or any(
            set(m) != {"val_lq/map", "val_monitor"} or m["val_monitor"] != m["val_lq/map"]
            for m in metrics):
        raise AssertionError(f"stage-3 validation metrics {metrics}")
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    if (len(ckpts) != 3 or ckpts[0] != "last.npz"
            or not ckpts[1].startswith(f"step={FIT3_STEPS}-val=")
            or not ckpts[2].startswith(f"step={FIT3_VAL_EVERY}-val=")):
        raise AssertionError(f"stage-3 fit checkpoints {ckpts}")
    secs = probe.seconds
    timing = {"micro_steps": len(secs), "first_s": secs[0],
              "s_per_micro_step": sum(secs[1:]) / len(secs[1:]), "each_s": secs}
    waits = trainer.timing["loader_waits_s"]
    share = critic_share(bridge, TS, OPT, engine, trainer, probe, ("det",), "stage-3 RetinaNet")
    log(f"stage-3 fit: {fit_s:.1f} s in all; {timing['s_per_micro_step']:.4f} s per micro-step "
        f"after the first ({timing['first_s']:.4f} s; card synchronised before and after each); "
        f"loader wait {sum(waits) / len(waits) * 1e3:.2f} ms/step (each "
        f"{[round(w * 1e3, 2) for w in waits]}); peak {peak:.2f} GiB; checkpoints {ckpts}; "
        f"validation {metrics}; losses {[round(e['train/loss'], 4) for e in logged]}")
    del probe, engine, trainer
    torch.cuda.empty_cache()

    # resume to a later step
    KN.reset_counts()
    t0 = time.perf_counter()
    _, trainer = main_fn(fit3_argv("fit", work, root, "--trainer.resume", "auto",
                                   "--trainer.max_steps", str(FIT3_RESUME_STEPS)))
    resume_s = time.perf_counter() - t0
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    from unirestore_torch.train import checkpoints as CKPT
    meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]
    ran = len(trainer.timing["loader_waits_s"])
    if meta["step"] != FIT3_RESUME_STEPS or ran != FIT3_RESUME_STEPS - FIT3_STEPS:
        raise AssertionError(f"stage-3 resume: {ran} steps run, last.npz at step "
                             f"{meta['step']}; want {FIT3_RESUME_STEPS - FIT3_STEPS} from step "
                             f"{FIT3_STEPS}")
    log(f"stage-3 resume: {ran} step from step {FIT3_STEPS} in {resume_s:.1f} s; last.npz step "
        f"{meta['step']}")
    del trainer
    torch.cuda.empty_cache()

    # Faster R-CNN: one update, one validation
    KN.reset_counts()
    frcnn_root = work / "stage3_fastrcnn"
    t0 = time.perf_counter()
    with StepProbe(TE, KN, bridge, sync_steps=(FIT3_SYNC_CHECK_STEP,), timed=True) as probe:
        engine, trainer = main_fn(fit3_argv(
            "fit", work, frcnn_root, "--model.init_args.downstream", "fastrcnn",
            "--trainer.max_steps", str(FIT3_FRCNN_STEPS), "--trainer.accumulate_grad_batches",
            str(FIT3_FRCNN_STEPS), "--trainer.val_check_interval", str(FIT3_FRCNN_STEPS)))
    torch.cuda.synchronize()
    frcnn_s = time.perf_counter() - t0
    frcnn_launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    shapes = merge_shapes(shapes, kernel_shapes_met(KN))
    if "rpn" not in engine.critics["det"] or any(c != EXPECTED_STAGE3 for c in probe.counts):
        raise AssertionError(f"Faster R-CNN fit: critic keys {sorted(engine.critics['det'])}, "
                             f"launches {probe.counts}")
    frcnn_val = tuple(frcnn_launches[s] - FIT3_FRCNN_STEPS * EXPECTED_STAGE3[s][0]
                      for s in symbols)
    if frcnn_val != tuple(FIT3_VAL_BATCHES * n for n in FIT3_RESTORE):
        raise AssertionError(f"Faster R-CNN fit validation launches {frcnn_val}")
    frcnn_logs, frcnn_metrics = probe.logs, probe.metrics
    if len(frcnn_logs) != FIT3_FRCNN_STEPS or not all(
            math.isfinite(v) for e in frcnn_logs for v in e.values()):
        raise AssertionError(f"Faster R-CNN fit: non-finite or missing losses {frcnn_logs}")
    if len(frcnn_metrics) != 1 or set(frcnn_metrics[0]) != {"val_lq/map", "val_monitor"}:
        raise AssertionError(f"Faster R-CNN fit validation metrics {frcnn_metrics}")
    frcnn_prompts = stage3_prompts_check(bridge, TS, OPT, engine, trainer,
                                         probe.first["trainable"],
                                         frcnn_root / "checkpoints" / "last.npz")
    fdirect = direct_step_check(bridge, TS, OPT, engine, trainer, probe.first,
                                te_loss_fn=engine.te_loss_fn())
    fsecs = probe.seconds
    frcnn_share = critic_share(bridge, TS, OPT, engine, trainer, probe, ("det",),
                               "stage-3 Faster R-CNN")
    log(f"stage-3 Faster R-CNN fit: {frcnn_s:.1f} s in all; "
        f"{sum(fsecs[1:]) / len(fsecs[1:]):.4f} s per micro-step after the first "
        f"({fsecs[0]:.4f} s); validation {frcnn_metrics}; losses "
        f"{[round(e['train/loss'], 4) for e in frcnn_logs]}")
    del probe, engine, trainer
    torch.cuda.empty_cache()
    result = {"res": FIT_RES, "steps": FIT3_STEPS, "accumulation": FIT3_ACCUM,
              "fit_seconds": fit_s, "peak_mem_gib": peak, "timing": timing,
              "loader_wait_mean_s": sum(waits) / len(waits), "loader_waits_s": waits,
              "logs": logged, "validation": metrics, "checkpoints": ckpts,
              "surgery": surgery, "prompts": prompts, "direct_step": direct,
              "launches_per_micro_step": EXPECTED_STAGE3, "validation_launches": val,
              "frozen_leaves_checked": n_frozen, "critic_leaves_checked": len(fresh),
              "critic_share": share, "resume_seconds": resume_s,
              "fastrcnn": {"steps": FIT3_FRCNN_STEPS, "fit_seconds": frcnn_s,
                           "s_per_micro_step": sum(fsecs[1:]) / len(fsecs[1:]),
                           "each_s": fsecs, "logs": frcnn_logs, "validation": frcnn_metrics,
                           "validation_launches": frcnn_val, "prompts": frcnn_prompts,
                           "direct_step": fdirect, "critic_share": frcnn_share}}
    return result, launches, shapes, timing["s_per_micro_step"]


def to_device(batch: dict, device) -> dict:
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in batch.items()}


STAGE3_REF_DETECTORS = ("retinanet", "fastrcnn")


def train3_reference_inputs(UR, bridge, TS):
    """Phase 12's seeded inputs on the card: the full-width fp32 model with
    TFA's four tasks and a 256 px pair with three boxes and its noise."""
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg", "det"))
    frozen, trainable = make_params(UR, bridge, cfg, torch.float32, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(14)
    batch = synthetic_pair(gen, 1, 256, torch.float32)
    boxes = torch.zeros((1, 64, 4), device="cuda")
    boxes[0, :3] = torch.tensor([[16.0, 24.0, 120.0, 140.0], [100.0, 40.0, 230.0, 200.0],
                                 [30.0, 150.0, 90.0, 250.0]])
    mask = torch.zeros((1, 64), dtype=torch.bool, device="cuda")
    mask[0, :3] = True
    labels = torch.zeros((1, 64), dtype=torch.int64, device="cuda")
    labels[0, :3] = torch.tensor([1, 3, 18])
    batch["gt"] = {"boxes": boxes, "labels": labels, "mask": mask}
    return cfg, frozen, trainable, batch, TS.draw_noise(cfg, batch, gen)


def train3_reference_run(UR, TS, TE, cfg, device, frozen, trainable, crit, batch, noise,
                         downstream) -> tuple:
    """Phase 12's stage-3 losses through ``downstream`` and the prompts'
    gradient norm on ``device``."""
    stage = TS.StageConfig(train_cfrm=False, train_cnet=False, train_tfa=True,
                           tfa_prompts_only=True, multi_task=True)
    leaves = TS.trained_leaves(stage, trainable)
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        nz = TS.StepNoise(*(x.to(device) for x in (noise.hq, noise.lq, noise.diffusion,
                                                   noise.timesteps)))
        loss, logs = TS.compute_losses(frozen, trainable, TS.with_remat(cfg),
                                       UR.schedule(cfg, device=device), stage,
                                       to_device(batch, device), nz, "det",
                                       TE.make_te_loss_fn("det", crit, downstream))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    finally:
        for p in leaves.values():
            p.requires_grad_(False)
    norm = sum(g.double().square().sum().item() for g in grads if g is not None) ** 0.5
    return {k: v.item() for k, v in logs.items()}, norm


def train3_reference_cpu() -> dict:
    """Reference job: phase 12's two stage-3 steps on the host, the Faster
    R-CNN sampling draws from the CPU generator (``loss_uniforms`` on the
    host). Returns {detector: (logs, norm, CPU seconds)}."""
    from unirestore_torch import bridge
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.train import engine as TE
    from unirestore_torch.train import steps as TS

    cfg, frozen, trainable, batch, noise = train3_reference_inputs(UR, bridge, TS)
    frozen, trainable = to_cpu(bridge, frozen), to_cpu(bridge, trainable)
    batch = to_device(batch, "cpu")
    noise = TS.StepNoise(*(x.cpu() for x in (noise.hq, noise.lq, noise.diffusion,
                                             noise.timesteps)))
    out = {}
    for downstream in STAGE3_REF_DETECTORS:
        critics = to_cpu(bridge, TE.build_critics("det", downstream, device="cuda"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        logs, norm = train3_reference_run(UR, TS, TE, cfg, "cpu", frozen, trainable, critics,
                                          batch, noise, downstream)
        out[downstream] = (logs, norm, time.perf_counter() - t0)
    return out


def train3_reference_check(UR, KN, bridge, TS, TE, refs):
    """Phase 12: one stage-3 loss through RetinaNet and one through Faster
    R-CNN and the task prompts' gradient norm, full widths with the critic,
    256 px, fp32, card vs CPU. The Faster R-CNN sampling draws are the CPU
    generator's on both sides (``tasks.fasterrcnn.loss_uniforms`` is patched
    for the card half), as a CUDA generator draws other numbers. The CPU half
    runs in ``refs``' worker; returns the check, which waits for it."""
    from unirestore_torch.tasks import fasterrcnn as FRC

    cfg, frozen, trainable, batch, noise = train3_reference_inputs(UR, bridge, TS)
    refs.submit("phase 12", train3_reference_cpu)
    gpu = {}
    draw = FRC.loss_uniforms
    FRC.loss_uniforms = lambda b, h, w, device: tuple(u.to(device) for u in draw(b, h, w, "cpu"))
    try:
        for downstream in STAGE3_REF_DETECTORS:
            critics = TE.build_critics("det", downstream, device="cuda")
            KN.reset_counts()
            gpu[downstream] = (*train3_reference_run(UR, TS, TE, cfg, "cuda", frozen, trainable,
                                                     critics, batch, noise, downstream),
                               train_counts(KN))
            counts = gpu[downstream][2]
            if any(counts[s][0] == 0 for s, c in EXPECTED_STAGE3.items() if c[0]):
                raise AssertionError(f"a kernel did not run in the stage-3 reference: {counts}")
            del critics
            torch.cuda.empty_cache()
    finally:
        FRC.loss_uniforms = draw
    del frozen, trainable, batch, noise

    def check():
        cpu = refs.result("phase 12")
        out = {}
        for downstream, (gpu_logs, gpu_norm, counts) in gpu.items():
            cpu_logs, cpu_norm, cpu_s = cpu[downstream]
            loss_err = max(abs(gpu_logs[k] - cpu_logs[k]) / abs(cpu_logs[k]) for k in cpu_logs)
            grad_err = abs(gpu_norm - cpu_norm) / cpu_norm
            log(f"stage-3 reference {downstream}, 256 px fp32: card vs CPU max relative loss "
                f"error {loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), prompt gradient norm "
                f"{gpu_norm:.6g} vs {cpu_norm:.6g}, error {grad_err:.3e} (limit "
                f"{TRAIN_GRAD_RTOL}); losses card {gpu_logs} CPU {cpu_logs}; card launches "
                f"{counts}; CPU {cpu_s:.1f} s in the reference worker")
            finite = all(math.isfinite(v) for v in (*gpu_logs.values(), gpu_norm))
            if not finite or loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
                raise AssertionError(f"card and CPU stage-3 {downstream} losses differ")
            out[downstream] = {"loss_rel_err": loss_err, "grad_norm_rel_err": grad_err,
                               "prompt_grad_norm_card": gpu_norm,
                               "prompt_grad_norm_cpu": cpu_norm, "cpu_seconds": cpu_s}
        return out

    return check


# ---------------------------------------------------------------------------
# phase 13: the cls and seg engines and their probe zoos
# ---------------------------------------------------------------------------


def probe_names() -> list:
    from unirestore_torch.tasks import classifier_zoo as CZ
    from unirestore_torch.tasks import seg_zoo as SZ
    return [*CZ._SPECS, *(n for n in SZ._WEIGHTS if not n.endswith(("_ft", "_fifo")))]


def probe_apply(name):
    """``apply(p, images)`` of a zoo probe, on tensors."""
    from unirestore_torch.tasks import classifier_zoo as CZ
    from unirestore_torch.tasks import seg_zoo as SZ
    if name in SZ._WEIGHTS:
        return lambda p, x: SZ.seg_probe_apply(name, p, x)
    return lambda p, x: CZ.classifier_apply(name, p, x)


def check_probes(KN, bridge, gen) -> dict:
    """Phase 13: every probe of the zoos (each classifier spec, ``dlv3pr50``
    and ``rflwr101``) built seeded in fp32 on the card and run on one seeded
    batch (PROBE_SHAPES), against the same tree and batch on the CPU: logits
    within PROBE_RTOL of the largest |logit|. Reported beside it, how far the
    input reaches the logits (their largest change against a blank image,
    over the largest |logit|): with the seeded init's unit BatchNorm
    statistics a deep stack of convolutions can shrink the signal until the
    logits are the head's bias, and then the comparison holds the head alone.
    Per probe: ms per call (events,
    or graph replay under GRAPH_MS), the repo's kernel launches in a call (0:
    the probes' attention is einsum, fp32 softmax, einsum), and the device's
    kernels per call and busy ms by kernel family (profiled)."""
    from unirestore_torch.tasks import seg_zoo as SZ
    out = {}
    for name in probe_names():
        apply = probe_apply(name)
        kind = "seg" if name in SZ._WEIGHTS else "cls"
        tree = bridge.probe_init(name, "cuda")
        x = torch.rand(PROBE_SHAPES[kind], generator=gen, device="cuda")
        with torch.inference_mode():
            KN.reset_counts()
            got = apply(tree, x)
            launches = sum(kern.launches for kern in KN.KERNELS)
            ms, timer = cuda_ms(lambda: apply(tree, x), 5), "events"
            if ms < GRAPH_MS:
                ms, timer = graph_ms(lambda: apply(tree, x)), "graph"
            prof = profiled_device(lambda: apply(tree, x))
            blank = apply(tree, torch.zeros_like(x))
            t0 = time.perf_counter()
            ref = apply(to_cpu(bridge, tree), x.cpu())
            cpu_s = time.perf_counter() - t0
        scale = ref.abs().max().item()
        err = (got.cpu() - ref).abs().max().item()
        reach = (got - blank).abs().max().item() / scale
        n_params = sum(v.numel() for v in bridge.flatten(tree).values())
        row = {"shape": list(x.shape), "logits": list(got.shape), "params_m": n_params / 1e6,
               "max_abs_err": err, "max_abs_logit": scale, "rel_err": err / scale,
               "input_reach": reach,
               "ms": ms, "timer": timer, "repo_kernel_launches": launches,
               "device_kernels_per_call": prof["kernels"],
               "device_ms_by_family": {k: v * 1e3 for k, v in prof["device_s_by_family"].items()},
               "cpu_s": cpu_s}
        log(f"probe {name}: {tuple(x.shape)} -> {tuple(got.shape)}, {n_params / 1e6:.1f} M "
            f"params; card vs CPU max abs {err:.3e} of |logit| {scale:.4g} (rel {err / scale:.2e}, "
            f"limit {PROBE_RTOL}); the input moves the logits by {reach:.3g} of the largest "
            f"(against a blank image); {ms:.4f} ms a call ({timer}); {prof['kernels']} device "
            f"kernels a call, busy {prof['device_busy_s'] * 1e3:.4f} ms "
            f"{ {k: round(v, 4) for k, v in row['device_ms_by_family'].items()} }; repo kernel "
            f"launches {launches}; CPU {cpu_s:.2f} s")
        if not (err <= PROBE_RTOL * scale and torch.isfinite(got).all()) or launches:
            raise AssertionError(f"probe {name}: card vs CPU {err} > {PROBE_RTOL} x {scale}, or "
                                 f"{launches} repo kernel launches")
        out[name] = row
        del tree, got, ref
        torch.cuda.empty_cache()
    return out


def fit13_argv(command, work: Path, root: Path, task: str, mode: str, *extra) -> list:
    """``unirestore_torch.main`` arguments: the stage-2 YAML made the ``task``
    engine with probe set ``mode`` by dotted overrides only (the smoke tree's
    lists, the step counts, validation and the log directory)."""
    return fit2_argv(command, work / "data", root, "--model.class_path",
                     f"unirestore_tpu.{task}", "--data.init_args.task", task,
                     "--model.init_args.eval_mode", mode, *extra, steps=FIT13_STEPS,
                     val_every=FIT13_STEPS, sanity=0)


def validation_keys(task: str, mode: str) -> set:
    from unirestore_torch.tasks import classifier_zoo as CZ
    from unirestore_torch.tasks import seg_zoo as SZ
    if task == "cls":
        return {f"val_{e}/{p}" for p in CZ.model_types_for(mode) for e in ("hq", "lq")}
    return {f"val_lq/{p}" for p in SZ.model_types_for(mode)}


def check_validation(task, mode, monitor, metrics, launches) -> dict:
    """One validation's keys and monitor, and its restores' launches."""
    want = validation_keys(task, mode) | {"val_monitor"}
    if len(metrics) != 1 or set(metrics[0]) != want or \
            metrics[0]["val_monitor"] != metrics[0][f"val_lq/{monitor}"]:
        raise AssertionError(f"{task} {mode} validation: {metrics}; want the keys {sorted(want)} "
                             f"and val_monitor = val_lq/{monitor}")
    restores = FIT13_RESTORES[task] * FIT2_VAL_BATCHES
    want_val = tuple(restores * n for n in FIT2_RESTORE[task])
    if launches != want_val:
        raise AssertionError(f"{task} {mode} validation launches {launches} != {want_val}")
    return metrics[0]


def probes_share(task, trainer, val_args) -> dict:
    """The probes' share of a validation's device time: one validation
    (``Trainer.validate`` with the fit's engine, data and evaluator factory)
    profiled, against the evaluator's own probe calls alone on images of its
    first batch's size, as many as the validation makes (cls: hq and lq per
    batch; seg: the three-scale TTA of ``_predict_logits``)."""
    import numpy as np

    from unirestore_torch.evalx import evaluators as EV

    engine, data, factory = val_args
    whole = profiled_device(lambda: trainer.validate(engine, data, factory))
    evaluator = factory(engine)
    batch = next(iter(data.val_dataloader()))
    imgs = EV.center_crop(np.asarray(batch["lq"], np.float32), 960, 1664)
    calls = FIT13_RESTORES[task] * FIT2_VAL_BATCHES

    def probes():
        for _ in range(calls):
            if task == "cls":
                for clf in evaluator.classifiers.values():
                    clf(imgs)
            else:
                for model in evaluator.seg_models.values():
                    evaluator._predict_logits(model, imgs)

    probes()
    alone = profiled_device(probes)
    share = alone["device_busy_s"] / whole["device_busy_s"]
    log(f"{task} validation, profiled: device busy {whole['device_busy_s']:.4f} s "
        f"({whole['kernels']} kernels) by family {whole['device_s_by_family']}; the probes "
        f"alone on {calls} images of {imgs.shape[1:3]}: {alone['device_busy_s']:.4f} s "
        f"({alone['kernels']} kernels): share {share:.3f}")
    return {"validation": whole, "probes": alone, "probes_share": share,
            "image": list(imgs.shape[1:3])}


def run_engine_fit(KN, bridge, TE, TS, OPT, main_fn, work: Path, task: str):
    """Phase 13: a fit of the ``task`` engine from the stage-2 YAML, its checks,
    timings and the probes' share of its validation. Returns (result, launches
    by kernel of the fit, the (shape, dtype) each kernel met)."""
    mode, monitor = FIT13_MODES[task]
    root = work / f"engine_{task}"
    symbols = [kern.symbol for kern in KN.KERNELS]
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepProbe(TE, KN, bridge, sync_steps=(FIT13_SYNC_CHECK_STEP,), timed=True) as probe:
        engine, trainer = main_fn(fit13_argv("fit", work, root, task, mode))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    shapes = kernel_shapes_met(KN)

    if engine.engine_type != task or probe.tasks != [task] * FIT13_STEPS:
        raise AssertionError(f"{task} engine fit: engine {engine.engine_type}, micro-steps "
                             f"{probe.tasks}")
    for i, counts in enumerate(probe.counts):
        if counts != EXPECTED_STAGE2[task]:
            raise AssertionError(f"{task} engine micro-step {i + 1}: launches {counts} != "
                                 f"{EXPECTED_STAGE2[task]}")
    val = tuple(launches[s] - FIT13_STEPS * EXPECTED_STAGE2[task][s][0] for s in symbols)
    metrics = check_validation(task, mode, monitor, probe.metrics, val)
    logged = probe.logs
    if len(logged) != FIT13_STEPS or not all(math.isfinite(v) for e in logged
                                             for v in e.values()):
        raise AssertionError(f"{task} engine fit: non-finite or missing losses {logged}")

    # only the leaves the stage's filter selects move; the frozen tree and the
    # critic stay as built
    trained = TS.trained_leaves(engine.stage, engine.trainable)
    before, now = bridge.flatten(probe.first["trainable"]), bridge.flatten(engine.trainable)
    changed = sorted(k for k in now if not torch.equal(now[k], before[k]))
    if not changed or not set(changed) <= set(trained) or \
            f"tfa//task_prompts//{task}" not in changed:
        raise AssertionError(f"{task} engine fit changed {changed[:8]} ({len(changed)}); "
                             f"trains {len(trained)} leaves")
    n_frozen = frozen_unchanged(bridge, engine)
    fresh = bridge.flatten(TE.build_critics(task, device=engine.device))
    critic = bridge.flatten(engine.critics)
    touched = [k for k in fresh if not torch.equal(fresh[k], critic[k])]
    if touched or fresh.keys() != critic.keys():
        raise AssertionError(f"{task} engine fit changed the critic: {touched[:5]}")
    direct = direct_step_check(bridge, TS, OPT, engine, trainer, probe.first,
                               te_loss_fn=engine.te_loss_fn())
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    if "last.npz" not in ckpts:
        raise AssertionError(f"{task} engine fit checkpoints {ckpts}")
    secs = probe.seconds
    timing = {"micro_steps": len(secs), "first_s": secs[0],
              "s_per_micro_step": sum(secs[1:]) / len(secs[1:]), "each_s": secs}
    images = FIT2_VAL_BATCHES
    val_s = probe.val_seconds[0]
    share = probes_share(task, trainer, probe.val_args)
    log(f"{task} engine fit ({mode}): {fit_s:.1f} s in all; {timing['s_per_micro_step']:.4f} s "
        f"per micro-step after the first ({timing['first_s']:.4f} s; card synchronised before "
        f"and after each); launches per micro-step {EXPECTED_STAGE2[task]} for all "
        f"{FIT13_STEPS}, validation launches {val}; {len(changed)} of {len(trained)} trained "
        f"leaves changed; validation {val_s:.3f} s, {val_s / images:.3f} s per image; peak "
        f"{peak:.2f} GiB; checkpoints {ckpts}; validation {metrics}")
    del probe, engine, trainer
    torch.cuda.empty_cache()
    result = {"eval_mode": mode, "monitor": monitor, "steps": FIT13_STEPS,
              "fit_seconds": fit_s, "peak_mem_gib": peak, "timing": timing,
              "logs": logged, "validation": metrics, "validation_seconds": val_s,
              "validation_s_per_image": val_s / images, "checkpoints": ckpts,
              "direct_step": direct, "launches_per_micro_step": EXPECTED_STAGE2[task],
              "validation_launches": val, "leaves_changed": len(changed),
              "leaves_trained": len(trained), "frozen_leaves_checked": n_frozen,
              "critic_leaves_checked": len(fresh), "probes_share": share}
    return result, launches, shapes


def run_validates(KN, TE, bridge, main_fn, work: Path):
    """Phase 13: ``validate`` of the cls engine with ``all_ft`` and ``CUB`` (a
    list of the smoke tree's cls images, labels mod 200) and of the seg engine
    with ``all``: keys, monitors, launches, s per image. Returns (results, the
    (shape, dtype) each kernel met)."""
    lists = work / "data" / "lists"
    rows = (lists / "cls.list").read_text().splitlines()
    cub = lists / "cub.list"
    cub.write_text("\n".join(" ".join([*r.split()[:2], str(int(r.split()[2]) % 200)])
                             for r in rows))
    shapes, out = {kern.symbol: set() for kern in KN.KERNELS}, {}
    for task, mode, monitor in VALIDATE13:
        extra = (("--data.init_args.val.type", "CUB",
                  "--data.init_args.dataset_dict.CUB.val", str(cub)) if mode == "CUB" else ())
        KN.reset_counts()
        t0 = time.perf_counter()
        with StepProbe(TE, KN, bridge) as probe:
            main_fn(fit13_argv("validate", work, work / f"validate_{mode}", task, mode, *extra))
        run_s = time.perf_counter() - t0
        shapes = merge_shapes(shapes, kernel_shapes_met(KN))
        launches = tuple(kern.launches for kern in KN.KERNELS)
        metrics = check_validation(task, mode, monitor, probe.metrics, launches)
        val_s = probe.val_seconds[0]
        log(f"{task} validate ({mode}, monitor {monitor}): {run_s:.1f} s in all, validation "
            f"{val_s:.3f} s, {val_s / FIT2_VAL_BATCHES:.3f} s per image; launches {launches}; "
            f"{metrics}")
        out[f"{task}_{mode}"] = {"run_seconds": run_s, "validation_seconds": val_s,
                                 "validation_s_per_image": val_s / FIT2_VAL_BATCHES,
                                 "launches": launches, "validation": metrics}
        del probe
        torch.cuda.empty_cache()
    return out, shapes


# ---------------------------------------------------------------------------
# phase 14: validate with the NR metric suite and FID through the CLI
# ---------------------------------------------------------------------------


def val14_argv(work: Path, root: Path, mode: str, fid: bool) -> list:
    """``unirestore_torch.main validate`` arguments: ``configs/val.yaml`` with
    dotted overrides only (the smoke tree's IR val list, phase 9's
    ``last.npz`` for frenc and cnet and phase 11's for tedit, the eval mode,
    FID, two images and the log directory)."""
    stage1, stage2 = (str(work / d / "checkpoints" / "last.npz") for d in ("logs", "stage2"))
    kwargs = "--model.init_args.model_kwargs"
    argv = ["validate", "--config", str(VAL14_YAML),
            "--data.init_args.dataset_dict.DIVF2KOST.val", str(work / "data" / "lists" / "ir.list"),
            f"{kwargs}.frenc.ckpt_path", stage1, f"{kwargs}.cnet.ckpt_path", stage1,
            f"{kwargs}.tedit.ckpt_path", stage2, "--model.init_args.eval_mode", mode,
            "--trainer.limit_val_batches", str(VAL14_IMAGES),
            "--trainer.logger.init_args.save_dir", str(root)]
    return argv + (["--model.init_args.compute_fid", "true"] if fid else [])


def val14_keys(mode: str, fid: bool) -> set:
    """The JAX evaluator's keys (``unirestore_tpu/evalx/evaluators.py:131-166``)."""
    from unirestore_torch.evalx.nr_suite import DEFAULT_NR_METRICS
    names = list(DEFAULT_NR_METRICS)
    if mode != "NR":
        names += ["psnr", "ssim", "lpips"] + (["fid"] if fid else [])
    etypes = ("lq",) if mode == "NR" else ("hq", "lq")
    return {f"val_{e}/{n}" for e in etypes for n in names} | {"val_monitor"}


class HostMetricProbe:
    """Wraps ``NIQEMetric.update``, ``NRQMMetric.update`` and ``FID.compute``:
    per call the images (uint8 levels, as the evaluator quantised them), the
    metric's running total before and after it and its host seconds; FID's
    compute seconds."""

    def __enter__(self):
        import numpy as np

        from unirestore_torch.evalx import fid, niqe, nrqm
        self.calls = {"niqe": [], "nrqm": []}
        self.fid_s = []
        self.orig = [(niqe.NIQEMetric, "update", niqe.NIQEMetric.update),
                     (nrqm.NRQMMetric, "update", nrqm.NRQMMetric.update),
                     (fid.FID, "compute", fid.FID.compute)]
        probe = self

        def wrap(key, orig):
            def update(m, images):
                before, t0 = m.total, time.perf_counter()
                orig(m, images)
                probe.calls[key].append({"images": np.array(images, copy=True),
                                         "before": before, "after": m.total,
                                         "s": time.perf_counter() - t0})
            return update

        def compute(m, orig=fid.FID.compute):
            t0 = time.perf_counter()
            out = orig(m)
            probe.fid_s.append(time.perf_counter() - t0)
            return out

        niqe.NIQEMetric.update = wrap("niqe", niqe.NIQEMetric.update)
        nrqm.NRQMMetric.update = wrap("nrqm", nrqm.NRQMMetric.update)
        fid.FID.compute = compute
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.orig:
            setattr(cls, name, fn)
        return False


def nr_parts(name: str):
    """``fn(p, images) -> (the features before the head, the score)`` of a
    network of the suite; for ``inception``, (the pool3 features, their mean)."""
    from unirestore_torch.evalx import clipiqa as CIQ
    from unirestore_torch.evalx import hyperiqa as HIQ
    from unirestore_torch.evalx import inception as INC
    from unirestore_torch.evalx import maniqa as MAN
    from unirestore_torch.evalx import musiq as MUS
    from unirestore_torch.evalx import nima as NIM

    if name == "clipiqa":
        return lambda p, x: (CIQ.image_features(p, x), CIQ.clipiqa_score(p, x))
    if name.startswith("musiq"):
        n = 10 if name == "musiq-ava" else 1
        return lambda p, x: (lambda cls: (cls, MUS.musiq_head(p, cls, n)))(
            MUS.musiq_tokens(p, x)[:, 0])
    if name == "nima-koniq":
        return lambda p, x: (lambda f: (f, NIM.nima_head(p, f, 1)))(NIM.nima_features(p, x))
    if name == "maniqa":
        return lambda p, x: (lambda f: (f, MAN.maniqa_head(p, f)))(MAN.maniqa_features(p, x))
    if name == "hyperiqa":
        return lambda p, x: (HIQ.hyperiqa_content(p, x)[1].mean(dim=(1, 2)),
                             HIQ.hyperiqa_score(p, x))
    return lambda p, x: (lambda f: (f, f.mean(dim=-1)))(INC.inception_v3_features(p, x))


def calibrate_bn(TRN, fn, tree, x) -> int:
    """Every BatchNorm's running statistics of ``tree`` set to those of its input
    in one pass of ``fn`` on ``x`` (per channel over batch and space): with the
    seeded init's unit statistics the deep stacks shrink the input away, and the
    comparison would hold the heads alone. Returns how many were set."""
    norm, seen = TRN.batch_norm, []

    def calibrating(p, h, eps=1e-5):
        if h[..., 0].numel() > 1:
            p["mean"].copy_(h.mean(dim=(0, 1, 2)))
            p["var"].copy_(h.var(dim=(0, 1, 2), unbiased=False))
            seen.append(1)
        return norm(p, h, eps)

    TRN.batch_norm = calibrating
    try:
        with torch.no_grad():
            fn(tree, x)
    finally:
        TRN.batch_norm = norm
    return len(seen)


def check_nr_nets(KN, bridge, gen) -> dict:
    """Phase 14: every network of the NR suite and FID's Inception, seeded in
    fp32 (BatchNorm statistics set from the batch for NR_CALIBRATED), on one
    seeded 512 x 512
    batch on the card and on the CPU: the features before the head and the
    score within NR_RTOL of their largest |value| on the CPU, no launch of the
    repo's kernels. Reported beside it, each one's reach (the change of the
    compared quantity between the batch and a smooth ramp, over its largest
    magnitude), ms per call (events), and the device's kernels and busy ms per
    call (profiled)."""
    from unirestore_torch.evalx import nr_suite as NRS
    from unirestore_torch.tasks import resnet as TRN
    x = torch.rand(NR_SHAPE, generator=gen, device="cuda")
    yy = torch.linspace(0, 1, NR_SHAPE[1], device="cuda")[:, None, None]
    xx = torch.linspace(0, 1, NR_SHAPE[2], device="cuda")[None, :, None]
    ramp = ((0.7 * yy + 0.3 * xx + 0.2 * torch.arange(3, device="cuda")) % 1.0)[None]
    out = {}
    for name in NRS.NETS:
        parts = nr_parts(name)
        tree = bridge.nr_init(name, "cuda")
        n_bn = calibrate_bn(TRN, parts, tree, x) if name in NR_CALIBRATED else 0
        with torch.inference_mode():
            KN.reset_counts()
            feats, score = parts(tree, x)
            launches = sum(kern.launches for kern in KN.KERNELS)
            feats2, score2 = parts(tree, ramp)
            ms = cuda_ms(lambda: parts(tree, x), 5)
            prof = profiled_device(lambda: parts(tree, x))
            t0 = time.perf_counter()
            ref_f, ref_s = parts(to_cpu(bridge, tree), x.cpu())
            cpu_s = time.perf_counter() - t0
        row = {"features": list(feats.shape), "batchnorms_calibrated": n_bn, "ms": ms,
               "device_kernels_per_call": prof["kernels"],
               "device_busy_ms": prof["device_busy_s"] * 1e3,
               "repo_kernel_launches": launches, "cpu_s": cpu_s}
        for what, got, ref, other in (("features", feats, ref_f, feats2),
                                      ("score", score, ref_s, score2)):
            scale = ref.abs().max().item()
            err = (got.cpu() - ref).abs().max().item()
            row[what] = {"max_abs_err": err, "max_abs": scale, "rel_err": err / scale,
                         "reach": (got - other).abs().max().item() / scale,
                         "value": got.flatten()[:4].tolist() if what == "score" else None}
            if not (err <= NR_RTOL * scale and torch.isfinite(got).all()):
                raise AssertionError(f"NR net {name} {what}: card vs CPU {err} > {NR_RTOL} x "
                                     f"{scale}")
        if launches:
            raise AssertionError(f"NR net {name}: {launches} launches of the repo's kernels")
        log(f"NR net {name}: {tuple(x.shape)} -> features {tuple(feats.shape)}; card vs CPU "
            f"features rel {row['features']['rel_err']:.2e} (reach "
            f"{row['features']['reach']:.3g}), score rel {row['score']['rel_err']:.2e} (reach "
            f"{row['score']['reach']:.3g}), limit {NR_RTOL}; {ms:.3f} ms a call; "
            f"{prof['kernels']} device kernels, busy {prof['device_busy_s'] * 1e3:.3f} ms; "
            f"{n_bn} BatchNorms calibrated; CPU {cpu_s:.2f} s")
        out[name] = row
        del tree, feats, score, ref_f, ref_s
        torch.cuda.empty_cache()
    return out


def neural_calls(calls: dict, image) -> dict:
    """Phase 14: per call (a neural metric's ``update``, FID's extractor) on a
    512 x 512 prediction: host ms of the whole call (upload, network, the one
    read-back), the card's busy ms and kernels (one call profiled), and the
    synchronisations one call makes under ``torch.cuda.set_sync_debug_mode
    ("warn")`` (the design: one, the read-back)."""
    import warnings

    out = {}
    for name, call in calls.items():
        call(image)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            call(image)
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        prof = profiled_device(lambda: call(image))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:  # only the call's own warnings are counted, not the mode switch's
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call(image)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        out[name] = {"host_ms": host_ms, "device_busy_ms": prof["device_busy_s"] * 1e3,
                     "device_kernels": prof["kernels"], "syncs": len(where), "sync_at": where}
        log(f"NR call {name}: {host_ms:.3f} ms a call (host clock, to the read-back), device "
            f"busy {prof['device_busy_s'] * 1e3:.3f} ms in {prof['kernels']} kernels; "
            f"{len(where)} synchronisation(s) under the sync debug mode, at {where}")
        if len(where) > 1:
            raise AssertionError(f"NR call {name}: synchronisations at {where}, want one "
                                 "read-back")
    return out


def run_validate_nr(KN, TE, bridge, main_fn, work: Path, gen):
    """Phase 14: ``validate`` from ``configs/val.yaml`` in ALL with FID and in NR
    (two images each): keys, monitors and launches; NIQE and NRQM rerun on the
    run's predictions bit for bit; each neural metric's and the extractor's
    call timed and checked for syncs; a second NR validation timed with the
    card synchronised at both ends (phase 20 (d)'s eager route); the NR
    networks' share of an NR validation's device time; then every network
    card vs CPU. Returns (result,
    launches by path, the (shape, dtype) each kernel met)."""
    from unirestore_torch.evalx import niqe, nrqm
    from unirestore_torch.evalx.nr_suite import NeuralNR
    t_phase = time.perf_counter()
    symbols = [kern.symbol for kern in KN.KERNELS]
    shapes, out, paths = {s: set() for s in symbols}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for mode, fid in VAL14_RUNS:
        KN.reset_counts()
        t0 = time.perf_counter()
        with StepProbe(TE, KN, bridge) as probe, HostMetricProbe() as host:
            engine, trainer = main_fn(val14_argv(work, work / f"validate14_{mode}", mode, fid))
        run_s = time.perf_counter() - t0
        shapes = merge_shapes(shapes, kernel_shapes_met(KN))
        launches = tuple(kern.launches for kern in KN.KERNELS)
        want = tuple(VAL14_RESTORES[mode] * n for n in FIT_RESTORE)
        (metrics,) = probe.metrics
        keys = val14_keys(mode, fid)
        monitor = "val_lq/niqe" if mode == "NR" else "val_lq/psnr"
        if set(metrics) != keys or metrics["val_monitor"] != metrics[monitor] or \
                not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"validate {mode}: {metrics}; want the keys {sorted(keys)}, "
                                 f"finite, and val_monitor = {monitor}")
        if launches != want:
            raise AssertionError(f"validate {mode}: launches {launches} != {want}")
        # NIQE and NRQM are host code: rerun on the same uint8 predictions from
        # the same running total, they must land on the same bits
        for key, cls in (("niqe", niqe.NIQEMetric), ("nrqm", nrqm.NRQMMetric)):
            for call in host.calls[key]:
                fresh = cls(weights_dir=str(REPO / "weights"))
                fresh.total = call["before"]
                fresh.update(call["images"])
                if fresh.total != call["after"]:
                    raise AssertionError(f"{key} rerun {fresh.total!r} != {call['after']!r}")
        images = {k: sum(len(c["images"]) for c in v) for k, v in host.calls.items()}
        host_s = {k: sum(c["s"] for c in v) / max(images[k], 1) for k, v in host.calls.items()}
        val_s = probe.val_seconds[0]
        row = {"run_seconds": run_s, "validation_seconds": val_s,
               "validation_s_per_image": val_s / VAL14_IMAGES, "launches": launches,
               "validation": metrics, "host_s_per_image": host_s, "host_images": images,
               "fid_compute_s": host.fid_s}
        log(f"validate {mode}{' with FID' if fid else ''}: {run_s:.1f} s in all, validation "
            f"{val_s:.3f} s, {val_s / VAL14_IMAGES:.3f} s per image; launches {launches}; host "
            f"s per image {host_s} over {images} images, NIQE and NRQM rerun bit-equal; FID "
            f"compute {host.fid_s} s; {monitor} = {metrics['val_monitor']:.4f}; {metrics}")
        engine, data, factory = probe.val_args
        evaluator = factory(engine)
        pred = host.calls["niqe"][0]["images"]
        if fid:
            row["calls"] = neural_calls({"inception": evaluator.fid["lq"].extractor}, pred)
        else:
            nets = {k: m for k, m in evaluator.nr["lq"].items() if isinstance(m, NeuralNR)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.validate(engine, data, factory)
            torch.cuda.synchronize()
            row["validation_seconds_second"] = time.perf_counter() - t0
            whole = profiled_device(lambda: trainer.validate(engine, data, factory))
            alone = profiled_device(lambda: [m.scores(pred) for m in nets.values()
                                             for _ in range(VAL14_IMAGES)])
            row["nr_share"] = {"validation_busy_s": whole["device_busy_s"],
                               "nr_busy_s": alone["device_busy_s"],
                               "share": alone["device_busy_s"] / whole["device_busy_s"],
                               "validation_by_family": whole["device_s_by_family"]}
            log(f"NR validation, profiled: device busy {whole['device_busy_s']:.4f} s "
                f"({whole['kernels']} kernels) by family {whole['device_s_by_family']}; the NR "
                f"networks alone on {VAL14_IMAGES} images: {alone['device_busy_s']:.4f} s "
                f"({alone['kernels']} kernels): share {row['nr_share']['share']:.3f}")
            row["calls"] = neural_calls({k: m.update for k, m in nets.items()}, pred)
        out[mode] = row
        paths[f"validate_{mode.lower()}"] = dict(zip(symbols, launches))
        del probe, host, engine, trainer, data, factory, evaluator
        torch.cuda.empty_cache()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["nets"] = check_nr_nets(KN, bridge, gen)
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out, paths, shapes


# ---------------------------------------------------------------------------
# phase 15: SPADE control, the optimizers, the DeepLab backbones
# ---------------------------------------------------------------------------


def spade_config(UR, cfg=None):
    """``cfg`` (phase 4's model) under the ``spade`` control type: the UNet
    built with SPADE (``UNetConfig(control_type="spade")``), which
    ``UniRestoreConfig(control_type="spade")`` alone does not do."""
    cfg = cfg or UR.UniRestoreConfig()
    return dataclasses.replace(cfg, control_type="spade",
                               unet=dataclasses.replace(cfg.unet, control_type="spade"))


def timed(KN, fn) -> tuple:
    """(output, seconds, launches in KERNELS order) of ``fn()`` with the card
    synchronised before and after and the counters reset before."""
    KN.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, counts_of(KN)


def run_spade_restores(UR, KN, GR, bridge, gen):
    """Phase 15's restores: phase 4's model, batch and noise under SPADE, each
    of SPADE_RUNS eagerly (under ``set_sync_debug_mode("error")``), then
    captured in one ``GraphedRestore`` and replayed once; exact also under
    ``scedit`` (phase 4's model) eagerly and from a graph, in turns with SPADE
    (its exact graph the one captured above), for SPADE's share of the
    restore. Returns (result, launches by path, the
    (shape, dtype) each kernel met)."""
    base = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    cfg = spade_config(UR, base)
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
    n_spade = sum(v.numel() for v in bridge.flatten(trainable["control"]).values())
    images, noise, restore = restore_inputs(UR, cfg, frozen, trainable, gen)
    sched = UR.schedule(cfg, device="cuda")
    symbols = [kern.symbol for kern in KN.KERNELS]
    shapes, outs, paths, result = {s: set() for s in symbols}, {}, {}, {}
    restore(cfg, 1)  # warm-up: every shape once
    restore(dataclasses.replace(cfg, fused_out_attention=True), 1)
    exact_graph = None
    for name, mode, stride, warmup, fused in SPADE_RUNS:
        c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride, cache_warmup=warmup,
                                fused_out_attention=fused)
        torch.cuda.reset_peak_memory_stats()
        KN.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = restore(c, STEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        eager_s, counts = time.perf_counter() - t0, counts_of(KN)
        shapes = merge_shapes(shapes, kernel_shapes_met(KN))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if eager.shape != images.shape or not torch.isfinite(eager).all():
            raise AssertionError(f"spade {name}: output {tuple(eager.shape)} or non-finite values")
        if counts != EXPECTED[name]:
            raise AssertionError(f"spade {name}: launches {counts} != phase 4's {EXPECTED[name]}")
        KN.reset_counts()
        graphed = GR.GraphedRestore(frozen, trainable, c, sched, device="cuda")
        graphed(images, "ir", num_inference_steps=STEPS, **noise)  # warm-up and capture
        shapes = merge_shapes(shapes, kernel_shapes_met(KN))
        (stats,) = graphed.stats.values()
        captured = tuple(stats.launches[s] for s in symbols)
        replay, graph_s, replay_counts = timed(
            KN, lambda: graphed(images, "ir", num_inference_steps=STEPS, **noise))
        if captured != EXPECTED[name] or any(replay_counts):
            raise AssertionError(f"spade graph {name}: launches at capture {captured}, in a "
                                 f"replay {replay_counts}; want {EXPECTED[name]} and none")
        levels = uint8_levels(replay, eager)
        if levels > 1:
            raise AssertionError(f"spade graph {name}: {levels} uint8 levels from eager")
        paths[SPADE_PATHS[name]] = {s: n + stats.launches[s] * stats.replays
                                    for s, n in zip(symbols, counts)}
        outs[name] = eager
        result[name] = {"mode": mode, "stride": stride, "warmup": warmup,
                        "fused_out_attention": fused, "launches": counts,
                        "eager_seconds": eager_s, "eager_img_per_s": BATCH / eager_s,
                        "graph_seconds": graph_s, "graph_img_per_s": BATCH / graph_s,
                        "capture_seconds": stats.capture_seconds,
                        "warmup_seconds": stats.warmup_seconds, "peak_mem_gib_eager": peak,
                        "graph_vs_eager_uint8_levels": levels,
                        "graph_vs_eager_max_abs": (replay.float() - eager.float()).abs()
                        .max().item()}
        log(f"spade restore {name} (mode {mode}, stride {stride}, warmup {warmup}, fused "
            f"out-projection {fused}): eager {eager_s:.3f} s, {BATCH / eager_s:.3f} img/s; graph "
            f"{graph_s:.3f} s, {BATCH / graph_s:.3f} img/s (capture + instantiate "
            f"{stats.capture_seconds:.3f} s); launches {counts} (phase 4's), graph vs eager "
            f"{levels} uint8 levels; eager peak {peak:.2f} GiB")
        if name == "none":
            exact_graph = graphed
        del graphed, replay
        torch.cuda.empty_cache()
    for name in ("encoder", "deep", "fused"):
        result[name]["psnr_vs_exact"] = psnr_u8(outs["none"], outs[name])
    log("spade PSNR vs exact: " + ", ".join(f"{n} {result[n]['psnr_vs_exact']:.2f} dB"
                                            for n in ("encoder", "deep", "fused")))
    del outs

    # SPADE's share of an exact restore: phase 4's scedit model on the same
    # batch and noise, in turns with SPADE (scedit, spade, spade, scedit) per route
    frozen_s, trainable_s = make_params(UR, bridge, base, torch.bfloat16, seed=1)
    graphs = {"scedit": GR.GraphedRestore(frozen_s, trainable_s, base, sched, device="cuda"),
              "spade": exact_graph}
    calls = {("scedit", "eager"): lambda: UR.restore(frozen_s, trainable_s, base, sched, images,
                                                     "ir", num_inference_steps=STEPS,
                                                     device="cuda", **noise),
             ("spade", "eager"): lambda: restore(cfg, STEPS),
             ("scedit", "graph"): lambda: graphs["scedit"](images, "ir",
                                                           num_inference_steps=STEPS, **noise),
             ("spade", "graph"): lambda: graphs["spade"](images, "ir",
                                                         num_inference_steps=STEPS, **noise)}
    calls[("scedit", "graph")]()  # capture
    sec = {k: [] for k in calls}
    for route in ("eager", "graph"):
        for model in ("scedit", "spade", "spade", "scedit"):
            sec[(model, route)].append(timed(KN, calls[(model, route)])[1])
    share = {}
    for route in ("eager", "graph"):
        t_sc, t_sp = (sum(sec[(m, route)]) / 2 for m in ("scedit", "spade"))
        share[route] = {"scedit_s": t_sc, "spade_s": t_sp, "spade_share": (t_sp - t_sc) / t_sp}
    log(f"spade share of an exact restore (in turns with scedit): {share}")
    del graphs, calls, frozen_s, trainable_s, exact_graph
    torch.cuda.empty_cache()
    result["spade_params_m"] = n_spade / 1e6
    result["share_of_exact"] = share
    return result, paths, shapes


def run_spade_training(UR, KN, bridge, TS, OPT, gen):
    """The full-width stage-1 step under SPADE (sd-turbo widths without TFA, bf16
    frozen, fp32 trainable, remat on, 512 px, batch 8) with each of SPADE_OPTS
    from the stage-1 YAML's kwargs at accumulation 1: one warm-up and
    SPADE_TRAIN_STEPS timed steps each, launches per step EXPECTED_TRAIN_SPADE,
    finite logs; after AdamW every trained leaf changed or holds a nonzero first
    moment (phase 9's rule), the frozen bytes as built.
    Returns (result, launches, the (shape, dtype) each kernel met)."""
    cfg = spade_config(UR)
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=3,
                                    trainable_dtype=torch.float32)
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
    sched = UR.schedule(cfg, device="cuda")
    frozen_before = {k: v.clone() for k, v in bridge.flatten(frozen).items()}
    symbols = [kern.symbol for kern in KN.KERNELS]
    launches, shapes, result = dict.fromkeys(symbols, 0), {s: set() for s in symbols}, {}
    n_trained = sum(v.numel() for v in TS.trained_leaves(stage, trainable).values())
    for name in SPADE_OPTS:
        tx, peak_lr = OPT.build({**STAGE1_OPT, "opt": name}, STAGE1_SCHED, STAGE1_MAX_STEPS,
                                BATCH, 1, 1)
        state = tx.init(TS.trained_leaves(stage, trainable))
        step = TS.make_train_step(frozen, cfg, sched, stage, tx, "ir", remat=True)
        before = {k: v.clone() for k, v in TS.trained_leaves(stage, trainable).items()}
        rows = []
        for i in range(1 + SPADE_TRAIN_STEPS):
            batch = synthetic_pair(gen, BATCH, RES, torch.bfloat16)
            noise = TS.draw_noise(cfg, batch, gen)
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            logs, sec, _ = timed(KN, lambda: step(trainable, state, batch, noise)[2])
            counts = train_counts(KN)
            shapes = merge_shapes(shapes, kernel_shapes_met(KN))
            for kern in KN.KERNELS:
                launches[kern.symbol] += kern.launches
            logs = {k: v.item() for k, v in logs.items()}
            if not all(math.isfinite(v) for v in logs.values()):
                raise AssertionError(f"spade {name} step {i}: non-finite logs {logs}")
            if counts != EXPECTED_TRAIN_SPADE:
                raise AssertionError(f"spade {name} step {i}: launches {counts} != "
                                     f"{EXPECTED_TRAIN_SPADE}")
            rows.append({"seconds": sec, "logs": logs})
        if name == "adamw":  # as phase 9: a leaf whose update is below its ulp (a gradient
            # of about 1e-11 behind a NAF gate) holds a nonzero first moment
            unchanged = [k for k, v in TS.trained_leaves(stage, trainable).items()
                         if torch.equal(v, before[k])]
            stuck = [k for k in unchanged if not state["mu"][k].any()]
            if stuck:
                raise AssertionError(f"spade adamw: {len(stuck)} trained leaves neither changed "
                                     f"nor hold a first moment: {stuck[:5]}")
            result["adamw_unchanged_with_moment"] = len(unchanged)
        sec = [r["seconds"] for r in rows[1:]]
        mean = sum(sec) / len(sec)
        result[name] = {"ms_per_step": mean * 1e3, "ms_per_step_each": [x * 1e3 for x in sec],
                        "train_img_per_s": BATCH / mean, "peak_lr": peak_lr,
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "losses": [r["logs"] for r in rows]}
        log(f"spade training, {name}: {mean * 1e3:.1f} ms/step over {SPADE_TRAIN_STEPS} steps "
            f"({min(sec) * 1e3:.1f}-{max(sec) * 1e3:.1f}), {BATCH / mean:.3f} train img/s, peak "
            f"{result[name]['peak_mem_gib']:.2f} GiB; launches per step {counts}; loss "
            f"{rows[-1]['logs'].get('train/loss', float('nan')):.5g}")
        del state, step
        torch.cuda.empty_cache()
    touched = [k for k, v in bridge.flatten(frozen).items() if not torch.equal(v, frozen_before[k])]
    if touched:
        raise AssertionError(f"spade training changed frozen leaves: {touched[:5]}")
    result.update(batch=BATCH, res=RES, steps_timed=SPADE_TRAIN_STEPS, accumulation=1,
                  trained_params_m=n_trained / 1e6, launches_per_step=EXPECTED_TRAIN_SPADE)
    return result, launches, shapes


def check_optimizers(OPT) -> dict:
    """Every name of OPT_NAMES: two updates (accumulation 2, global-norm clip 5,
    OneCycle from 1e-2, weight decay 0.1) over one seeded tree with a 1-D leaf,
    a 1280 x 320 matrix and a 640 x 320 x 3 x 3 conv kernel (``adafactor``
    factors both), in float64 on the card and on the CPU: each leaf within
    OPT_RTOL of its largest |value|; then ms per fp32 update on the card
    (accumulation 1)."""
    gen = torch.Generator().manual_seed(15)
    params = {k: 0.5 * torch.randn(s, generator=gen) for k, s in OPT_SHAPES.items()}
    grads = [{k: torch.randn(s, generator=gen) for k, s in OPT_SHAPES.items()} for _ in range(4)]
    out = {}
    for name in OPT_NAMES:
        got = {}
        for dev in ("cuda", "cpu"):
            tx = OPT.make_optimizer(name, lr=OPT.make_lr_schedule("onecycle", 1e-2, 6),
                                    weight_decay=0.1, accum_iter=2, grad_clip=5.0)
            p = {k: v.to(dev, torch.float64, copy=True) for k, v in params.items()}
            st = tx.init(p)
            for g in grads:
                tx.update(st, p, {k: v.to(dev, torch.float64) for k, v in g.items()})
            got[dev] = p
        err = max(((got["cuda"][k].cpu() - v).abs().max() / v.abs().max()).item()
                  for k, v in got["cpu"].items())
        moved = all(not torch.equal(got["cpu"][k].float(), params[k]) for k in params)
        tx = OPT.make_optimizer(name, lr=1e-3, weight_decay=0.1, grad_clip=5.0)
        p = {k: v.float() for k, v in got["cuda"].items()}
        g = {k: v.cuda() for k, v in grads[0].items()}
        st = tx.init(p)
        ms = cuda_ms(lambda: tx.update(st, p, g), 5)
        out[name] = {"rel_err": err, "ms_per_update": ms}
        log(f"optimizer {name}: card vs CPU {err:.2e} of each leaf's largest (limit {OPT_RTOL}); "
            f"{ms:.3f} ms an update on the card")
        if not (err <= OPT_RTOL and moved):
            raise AssertionError(f"optimizer {name}: card vs CPU {err} > {OPT_RTOL}, or a leaf "
                                 "did not move")
    return out


def deeplab_reference_cpu(name: str, x: np.ndarray) -> tuple:
    """``check_deeplab``'s CPU half, in the reference worker: ``name``'s tree
    built as the card half builds it (seeded on the card), copied to the host
    and run there on ``x``. Returns (logits, seconds of the CPU call)."""
    from unirestore_torch import bridge
    from unirestore_torch.nn.init import make_init
    from unirestore_torch.tasks import deeplab as DL
    init_fn, apply_fn = DL.deeplab_factory(name)
    tree = to_cpu(bridge, init_fn(make_init(device="cuda", seed=16)))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = apply_fn(tree, torch.from_numpy(x))
        return ref.numpy(), time.perf_counter() - t0


def check_deeplab(KN, bridge, gen, refs) -> tuple:
    """Every name of DEEPLAB_NAMES built seeded in fp32 on the card (unit
    BatchNorm statistics) and run on one seeded 512 x 512 image, against the
    same tree and image on the CPU (``deeplab_reference_cpu`` in ``refs``'
    worker): logits within DEEPLAB_RTOL of the largest |logit|, no launch of
    the repo's kernels; the input's reach (the logits' largest change against
    a blank image over the largest |logit|), ms per call. Returns (the card
    halves by name, the check: it reads the CPU halves and returns the rows)."""
    from unirestore_torch.nn.init import make_init
    from unirestore_torch.tasks import deeplab as DL
    card = {}
    for name in DEEPLAB_NAMES:
        init_fn, apply_fn = DL.deeplab_factory(name)
        tree = init_fn(make_init(device="cuda", seed=16))
        x = torch.rand((1, 512, 512, 3), generator=gen, device="cuda")
        refs.submit(f"phase 15 deeplab {name}", deeplab_reference_cpu, name, x.cpu().numpy())
        with torch.inference_mode():
            got, _, counts = timed(KN, lambda: apply_fn(tree, x))
            ms, timer = cuda_ms(lambda: apply_fn(tree, x), 5), "events"
            blank = apply_fn(tree, torch.zeros_like(x))
        n_params = sum(v.numel() for v in bridge.flatten(tree).values())
        card[name] = {"got": got.cpu(), "moved": (got - blank).abs().max().item(),
                      "finite": bool(torch.isfinite(got).all()), "counts": counts, "ms": ms,
                      "timer": timer, "params_m": n_params / 1e6, "shape": tuple(x.shape)}
        del tree, got, blank
        torch.cuda.empty_cache()

    def check() -> dict:
        out = {}
        for name, c in card.items():
            ref, cpu_s = refs.result(f"phase 15 deeplab {name}")
            ref = torch.from_numpy(ref)
            got, counts = c["got"], c["counts"]
            scale = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            reach = c["moved"] / scale
            out[name] = {"params_m": c["params_m"], "logits": list(got.shape),
                         "max_abs_err": err, "max_abs_logit": scale, "rel_err": err / scale,
                         "input_reach": reach, "ms": c["ms"], "timer": c["timer"],
                         "repo_kernel_launches": sum(counts), "cpu_s": cpu_s}
            log(f"deeplab {name}: {c['params_m']:.1f} M params, {c['shape']} -> "
                f"{tuple(got.shape)}; card vs CPU {err:.3e} of |logit| {scale:.4g} (rel "
                f"{err / scale:.2e}, limit {DEEPLAB_RTOL}); reach {reach:.3g}; {c['ms']:.3f} ms a "
                f"call; repo kernel launches {sum(counts)}; CPU {cpu_s:.2f} s "
                f"({REFERENCE_THREADS} threads, reference worker)")
            if not (err <= DEEPLAB_RTOL * scale and c["finite"]) or any(counts):
                raise AssertionError(f"deeplab {name}: card vs CPU {err} > {DEEPLAB_RTOL} x "
                                     f"{scale}, or repo kernel launches {counts}")
        return out

    return card, check


def run_phase15(UR, KN, GR, bridge, TS, OPT, gen, refs, train_ms_scedit=None):
    """Phase 15: the SPADE restores (``run_spade_restores``), the SPADE step
    (``run_spade_training``, beside phase 6's ``train_ms_scedit`` when given),
    the SPADE restore and stage-1 loss and gradient card vs CPU
    (``reference_check``, ``train_reference_check`` under ``spade_config``;
    their CPU halves in ``refs``' worker, their checks returned as
    ``checks``), every optimizer and every DeepLab backbone card vs CPU (the
    backbones' CPU halves in the worker too, their check ``checks["deeplab"]``).
    Returns (result, launches by path, the (shape, dtype) each kernel met,
    checks)."""
    t0 = time.perf_counter()
    out, paths, shapes = run_spade_restores(UR, KN, GR, bridge, gen)
    torch.cuda.empty_cache()
    out["training"], paths["train_spade"], train_shapes = run_spade_training(UR, KN, bridge, TS,
                                                                              OPT, gen)
    shapes = merge_shapes(shapes, train_shapes)
    if train_ms_scedit is not None:
        spade_ms = out["training"]["adamw"]["ms_per_step"]
        out["training"]["scedit_ms_per_step_phase6"] = train_ms_scedit
        out["training"]["spade_share_of_step"] = (spade_ms - train_ms_scedit) / spade_ms
    torch.cuda.empty_cache()
    # the CPU halves start after the timed restores and steps
    checks = {"reference": reference_check(UR, KN, GR, bridge, spade_config(
        UR, UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))), refs,
        name="phase 15 restore")}
    torch.cuda.empty_cache()
    checks["training"] = train_reference_check(UR, KN, bridge, TS, refs, spade_config(UR),
                                               name="phase 15 training")
    torch.cuda.empty_cache()
    out["optimizers"] = check_optimizers(OPT)
    _, checks["deeplab"] = check_deeplab(KN, bridge, gen, refs)
    out["phase_seconds"] = time.perf_counter() - t0
    log(f"phase 15 took {out['phase_seconds']:.1f} s")
    return out, paths, shapes, checks

# ---------------------------------------------------------------------------
# phase 16: data parallelism
# ---------------------------------------------------------------------------


def torchrun_start(*jobs) -> dict:
    """Each job ``(nproc, args, log_path)`` as ``python -m torch.distributed.run
    --standalone --nproc_per_node nproc args`` (a local rendezvous on a free
    port), all started at once, each one's output in its ``log_path``.
    Returns the handle that ``torchrun_wait`` and ``torchrun_stop`` take."""
    running = []
    for nproc, args, log_path in jobs:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), *args]
        with open(log_path, "w") as out:
            running.append((subprocess.Popen(cmd, cwd=REPO, stdout=out,
                                             stderr=subprocess.STDOUT), args, log_path))
    return {"t0": time.perf_counter(), "running": running}


def torchrun_stop(handle: dict) -> None:
    """Stop every job of ``handle`` still running (torchrun stops its ranks)."""
    for proc, _, _ in handle["running"]:
        if proc.poll() is None:
            proc.terminate()
    for proc, _, _ in handle["running"]:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def torchrun_wait(handle: dict) -> list:
    """Waits for every job of ``handle``. Returns, in the jobs' order, [(output,
    seconds from the start until it was seen to end)], each end polled every
    0.2 s; fails with a failed job's output tail. Jobs still running
    ``DDP_TIMEOUT`` s after the start are stopped."""
    t0, running = handle["t0"], handle["running"]
    ended = {}
    while len(ended) < len(running):
        for i, (proc, _, _) in enumerate(running):
            if i not in ended and proc.poll() is not None:
                ended[i] = (proc.returncode, time.perf_counter() - t0)
        if len(ended) < len(running):
            if time.perf_counter() - t0 > DDP_TIMEOUT:
                torchrun_stop(handle)
                for i, (proc, _, _) in enumerate(running):
                    ended.setdefault(i, (f"timeout after {DDP_TIMEOUT} s",
                                         time.perf_counter() - t0))
                break
            time.sleep(0.2)
    results, failed = [], []
    for i, (_, args, log_path) in enumerate(running):
        rc, sec = ended[i]
        output = log_path.read_text()
        results.append((output, sec))
        if rc != 0:
            failed.append(f"torchrun of {args[:3]} exited {rc}:\n{output[-3000:]}")
    if failed:
        raise AssertionError("\n".join(failed))
    return results


def shapes_to_json(KN) -> dict:
    return {s: [[list(shape), str(dt).removeprefix("torch.")] for shape, dt in met]
            for s, met in kernel_shapes_met(KN).items()}


def shapes_from_json(met: dict) -> dict:
    return {s: {(tuple(shape), getattr(torch, dt)) for shape, dt in v} for s, v in met.items()}


def fit_worker(out: str, argv: list) -> None:
    """Phase 16 (a), one rank under torchrun: ``unirestore_torch.main.main(argv)``
    with each micro-step's launches counted (``Trainer._step`` wrapped, as
    ``StepProbe`` does); writes ``<out>.<rank>.json``: the counts, the logged
    losses, the run's launches and (shape, dtype)s, peak memory, timing."""
    from unirestore_torch import main as TMAIN
    from unirestore_torch.nn import kernels as KN
    from unirestore_torch.train import engine as TE

    KN.build_all()
    counts, orig = [], TE.Trainer._step

    def step(trainer, *args):
        before = train_counts(KN)
        result = orig(trainer, *args)
        after = train_counts(KN)
        counts.append({s: [a - b for a, b in zip(after[s], before[s])] for s in after})
        return result

    TE.Trainer._step = step
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    _, trainer = TMAIN.main(argv)
    timing = {k: v for k, v in trainer.timing.items() if k != "loader_waits_s"}
    Path(f"{out}.{os.environ['RANK']}.json").write_text(json.dumps({
        "counts": counts, "logs": trainer.logs, "timing": timing,
        "launches": {kern.symbol: kern.launches for kern in KN.KERNELS},
        "shapes": shapes_to_json(KN), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))


def train_worker(out: str) -> None:
    """Phase 16 (b), one of ``DDP_WORLD`` ranks on the one card over gloo:
    phase 6's parameters, optimizer and inputs (the same seeds), this rank's
    rows of each global batch and of its noise, ``DDP_STEPS`` steps of the
    step with the process group, replicated (DDP) and then, from a fresh
    build, in shards (FSDP). The learning rate is phase 6's (one device): the
    update after step 2 is then phase 6's. The collectives are timed with the
    card synchronised around each (``reduce_gradients``: the gradient sync;
    ``gather_tree``: FSDP's gathers). Writes ``<out>.<rank>.json``: by mode,
    each step's seconds, logs, launch counts, (shape, dtype)s and
    collective seconds, the memory held between steps and the peak."""
    import torch.distributed as dist

    from unirestore_torch import bridge
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.nn import kernels as KN
    from unirestore_torch.parallel import distributed as DIST
    from unirestore_torch.parallel import fsdp as FSDP
    from unirestore_torch.parallel import mesh as MESH
    from unirestore_torch.train import optim as OPT
    from unirestore_torch.train import steps as TS

    DIST.init_distributed(force=True, backend="gloo", device="cuda:0")
    try:
        KN.build_all()
        rank, mesh = DIST.rank(), MESH.make_mesh()
        group = mesh.get_group("data")
        cfg = UR.UniRestoreConfig()
        stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
        rows_of = DIST.process_local_rows(BATCH)
        timers = {"reduce_gradients": [], "gather_tree": []}

        def timed(name):
            fn = getattr(FSDP, name)

            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = fn(*args)
                torch.cuda.synchronize()
                timers[name].append(time.perf_counter() - t0)
                return result
            return run

        for name in timers:
            setattr(FSDP, name, timed(name))

        def run(mode: str) -> dict:
            frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=3,
                                            trainable_dtype=torch.float32)
            tx, _ = OPT.build(STAGE1_OPT, STAGE1_SCHED, STAGE1_MAX_STEPS, BATCH, STAGE1_ACCUM, 1)
            MESH.replicate(mesh, trainable)
            state = tx.init(TS.trained_leaves(stage, trainable))
            fractions = None
            if mode == "fsdp":
                frozen = FSDP.fsdp_shard(mesh, frozen)
                trainable = FSDP.fsdp_shard(mesh, trainable)
                state = tx.shard_state(state, TS.trained_leaves(stage, trainable), rank)
                fractions = [FSDP.sharded_fraction(trainable), FSDP.sharded_fraction(frozen)]
            torch.cuda.empty_cache()
            held_gib = torch.cuda.memory_allocated() / 2**30
            step = TS.make_train_step(frozen, cfg, UR.schedule(cfg, device="cuda"), stage, tx,
                                      "ir", remat=True, group=group)
            gen = torch.Generator(device="cuda").manual_seed(4)
            steps = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(DDP_STEPS):
                batch = synthetic_pair(gen, BATCH, RES, torch.bfloat16)
                noise = TS.draw_noise(cfg, batch, gen)  # phase 6's global draws
                local = {k: v[rows_of] for k, v in batch.items()}
                KN.reset_counts()
                n_sync = len(timers["reduce_gradients"]), len(timers["gather_tree"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logs = step(trainable, state, local, TS.local_noise(noise, rows_of))[2]
                torch.cuda.synchronize()
                steps.append({"seconds": time.perf_counter() - t0,
                              "logs": {k: v.item() for k, v in logs.items()},
                              "counts": train_counts(KN), "shapes": shapes_to_json(KN),
                              "sync_s": sum(timers["reduce_gradients"][n_sync[0]:]),
                              "gather_s": sum(timers["gather_tree"][n_sync[1]:]),
                              "launches": {kern.symbol: kern.launches for kern in KN.KERNELS}})
            return {"steps": steps, "fractions": fractions, "held_gib": held_gib,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}

        result = {mode: run(mode) for mode in ("ddp", "fsdp")}
        result["backend"] = dist.get_backend(group)
        Path(f"{out}.{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def worker(args: list) -> int:
    """A rank of phase 16 or 17 under torchrun: ``fit <out> <main argv...>``,
    ``train <out>`` or ``spatial <out>``."""
    kind, out, *rest = args
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if kind == "fit":
        fit_worker(out, rest)
    elif kind == "train":
        train_worker(out)
    else:
        spatial_worker(out)
    return 0


FIT_DDP_MODES = (("ddp", ()), ("fsdp", ("--trainer.fsdp", "true")))


def fit_ddp_jobs(work: Path) -> list:
    """Phase 16 (a)'s torchrun jobs: phase 9's first fit at world size 1 over
    NCCL for ``DDP_STEPS`` micro-steps, replicated and with ``--trainer.fsdp
    true``."""
    jobs = []
    for mode, extra in FIT_DDP_MODES:
        argv = fit_argv("fit", work / "data", work / f"fit_{mode}", "--trainer.max_steps",
                        str(DDP_STEPS), "--trainer.val_check_interval", "0",
                        "--trainer.num_sanity_val_steps", "0", "--trainer.log_every_n_steps",
                        "1", "--distributed", *extra)
        jobs.append((1, [str(REPO / "chip_smoke.py"), "--worker", "fit",
                         str(work / f"fit_{mode}_rank"), *argv], work / f"fit_{mode}.log"))
    return jobs


def run_fit_ddp(KN, TE, reference16, work: Path, runs: list) -> tuple:
    """Phase 16 (a) from its jobs' ``runs`` (``fit_ddp_jobs``): each
    micro-step's launches equal phase 6's, its logged losses are bit-equal to
    phase 9's same micro-step, and ``last.npz`` holds phase 9's trainable tree
    after those micro-steps bit for bit."""
    from unirestore_torch.train import checkpoints as CKPT

    result, paths, shapes = {}, {}, {kern.symbol: set() for kern in KN.KERNELS}
    for (mode, _), (stdout, sec) in zip(FIT_DDP_MODES, runs):
        root, out = work / f"fit_{mode}", work / f"fit_{mode}_rank"
        rank0 = json.loads(Path(f"{out}.0.json").read_text())
        counts = [{s: tuple(c) for s, c in e.items()} for e in rank0["counts"]]
        if len(counts) != DDP_STEPS or any(c != EXPECTED_TRAIN for c in counts):
            raise AssertionError(f"fit_{mode}: launches per micro-step {counts} != "
                                 f"{EXPECTED_TRAIN}")
        if "[distributed] process 0/1" not in stdout or (mode == "fsdp"
                                                       and "[fsdp] sharded" not in stdout):
            raise AssertionError(f"fit_{mode}: no process group or FSDP line:\n{stdout[-2000:]}")
        unequal = {}
        for i, (got, want) in enumerate(zip(rank0["logs"], reference16["logs"])):
            for k, v in want.items():
                if k.startswith("train/loss") and got[k] != v:
                    unequal[f"{i + 1} {k}"] = (got[k], v)
        flat, meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))
        differ = [k for k, v in reference16["trainable"].items()
                  if not np.array_equal(flat[f"trainable//{k}"], v)]
        grad_norms = [(e["train/grad_norm"], w["train/grad_norm"])
                      for e, w in zip(rank0["logs"], reference16["logs"])]
        log(f"fit_{mode} (torchrun, NCCL, world 1; beside phase 16 (b) and 17): {sec:.1f} s; "
            f"launches "
            f"per micro-step equal phase 6's; logged losses of micro-steps 1-{DDP_STEPS} vs phase 9's: "
            f"{'bit-equal' if not unequal else unequal}; last.npz at step {meta['step']}: "
            f"{len(reference16['trainable']) - len(differ)} of {len(reference16['trainable'])} "
            f"trainable leaves bit-equal to phase 9's after micro-step {DDP_STEPS}; grad norms "
            f"(run, phase 9) {grad_norms}; peak {rank0['peak_mem_gib']:.2f} GiB")
        if unequal or differ or meta["step"] != DDP_STEPS:
            raise AssertionError(f"fit_{mode} differs from phase 9: losses {unequal}, "
                                 f"leaves {differ[:5]}, step {meta['step']}")
        paths[f"fit_{mode}"] = rank0["launches"]
        shapes = merge_shapes(shapes, shapes_from_json(rank0["shapes"]))
        result[mode] = {"seconds": sec, "losses_bit_equal": True, "leaves_bit_equal":
                        len(reference16["trainable"]), "grad_norms_run_phase9": grad_norms,
                        "peak_mem_gib": rank0["peak_mem_gib"], "timing": rank0["timing"]}
    return result, paths, shapes


def train_ddp2_job(work: Path) -> tuple:
    """Phase 16 (b)'s torchrun job: phase 6's cell at ``DDP_WORLD`` ranks on
    the one card over gloo, DDP and then FSDP."""
    return (DDP_WORLD, [str(REPO / "chip_smoke.py"), "--worker", "train",
                        str(work / "train_ddp2_rank")], work / "train_ddp2.log")


def run_train_ddp2(KN, training: dict, work: Path, sec: float) -> tuple:
    """Phase 16 (b) from its job (``train_ddp2_job``), which ran ``sec`` s:
    launches per rank and step equal phase 6's, the global loss and gradient
    norm within ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_RTOL`` of phase 6's first
    ``DDP_STEPS`` steps on the same 8 rows and noise."""
    result, paths, shapes = {}, {}, {kern.symbol: set() for kern in KN.KERNELS}
    out = work / "train_ddp2_rank"
    by_rank = [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(DDP_WORLD)]
    backend = by_rank[0]["backend"]
    log(f"two ranks on one card ({backend}): DDP then FSDP in one torchrun, {sec:.1f} s "
        f"(beside phase 16 (a) and 17)")
    result["seconds"] = sec
    for mode in ("ddp", "fsdp"):
        ranks = [res[mode] for res in by_rank]
        launches = {kern.symbol: 0 for kern in KN.KERNELS}
        errors = []
        for r, res in enumerate(ranks):
            for i, st in enumerate(res["steps"]):
                counts = {s: tuple(c) for s, c in st["counts"].items()}
                if counts != EXPECTED_TRAIN:
                    raise AssertionError(f"train_{mode}2 rank {r} step {i}: launches {counts} "
                                         f"!= {EXPECTED_TRAIN}")
                for s, n in st["launches"].items():
                    launches[s] += n
                shapes = merge_shapes(shapes, shapes_from_json(st["shapes"]))
                want = training["losses"][i]
                loss_err = abs(st["logs"]["train/loss"] - want["train/loss"]) / abs(
                    want["train/loss"])
                grad_err = abs(st["logs"]["train/grad_norm"] - want["train/grad_norm"]) / abs(
                    want["train/grad_norm"])
                errors.append((loss_err, grad_err))
                if st["logs"] != ranks[0]["steps"][i]["logs"]:
                    raise AssertionError(f"train_{mode}2 step {i}: ranks log different values")
        loss_err = max(e[0] for e in errors)
        grad_err = max(e[1] for e in errors)
        ms = [[st["seconds"] * 1e3 for st in res["steps"]] for res in ranks]
        sync = [[st["sync_s"] * 1e3 for st in res["steps"]] for res in ranks]
        gather = [[st["gather_s"] * 1e3 for st in res["steps"]] for res in ranks]
        peak = [res["peak_mem_gib"] for res in ranks]
        log(f"train_{mode}2 ({DDP_WORLD} ranks on one card, {backend}, batch "
            f"{DDP_WORLD} x {BATCH // DDP_WORLD}): ms per step by rank {ms}; "
            f"gradient sync ms {sync}; gathers ms {gather}; vs phase 6 (one rank, batch "
            f"{BATCH}): loss {loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), grad norm "
            f"{grad_err:.3e} (limit {TRAIN_GRAD_RTOL}); held {ranks[0]['held_gib']:.2f} GiB, "
            f"peak {peak} GiB; sharded fractions {ranks[0]['fractions']}; launches per rank "
            f"and step equal phase 6's")
        if loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"train_{mode}2 differs from phase 6: loss {loss_err}, "
                                 f"grad norm {grad_err}")
        paths[f"train_{mode}2"] = launches
        result[mode] = {"ms_per_step_by_rank": ms, "sync_ms_by_rank": sync,
                        "gather_ms_by_rank": gather, "loss_rel_err": loss_err,
                        "grad_norm_rel_err": grad_err, "held_gib": ranks[0]["held_gib"],
                        "peak_mem_gib_by_rank": peak, "sharded_fractions": ranks[0]["fractions"],
                        "logs": [st["logs"] for st in ranks[0]["steps"]]}
    return result, paths, shapes


def state_bytes(UR, FSDP) -> dict:
    """Phase 16 (c): persistent bytes per rank of the restore cell's trees,
    replicated against FSDP (``fsdp_spec``), at each of ``STATE_WORLDS`` ranks:
    the frozen tree in bf16, the trainable tree in fp32 and AdamW's two fp32
    slots over it (as ``tools/debug_fsdp_memory.py`` counts them)."""
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    frozen, trainable = UR.init(cfg, device="meta")
    trees = {"frozen_bf16": (frozen, 2), "trainable_fp32": (trainable, 4),
             "adamw_slots_fp32": (trainable, 8)}
    from unirestore_torch import bridge
    out = {}
    for n in STATE_WORLDS:
        rows = {}
        for name, (tree, nbytes) in trees.items():
            leaves = list(bridge.flatten(tree).values())
            rep = sum(v.numel() for v in leaves) * nbytes
            sharded = sum((v.numel() // n if FSDP.fsdp_spec(v, n) else v.numel())
                          for v in leaves) * nbytes
            rows[name] = {"replicated_gib": rep / 2**30, "fsdp_gib": sharded / 2**30}
        rows["total"] = {k: sum(r[k] for r in rows.values())
                         for k in ("replicated_gib", "fsdp_gib")}
        out[n] = rows
    log("state bytes per rank (GiB, replicated -> FSDP): " + "; ".join(
        f"n={n}: " + ", ".join(f"{k} {v['replicated_gib']:.3f} -> {v['fsdp_gib']:.3f}"
                               for k, v in rows.items()) for n, rows in out.items()))
    return out


def run_phase16(K, G, KN, TE, UR, rows, gen, reference16, training, work: Path,
                runs: list) -> tuple:
    """Phase 16: (a) and (b) from their jobs' ``runs`` (``fit_ddp_jobs``, then
    ``train_ddp2_job``), and (c); then phase 3's comparison at every (kernel,
    shape) they met that was not held yet. Returns (result, launches by path)."""
    from unirestore_torch.parallel import fsdp as FSDP

    t0 = time.perf_counter()
    result = {}
    result["fit"], paths, shapes = run_fit_ddp(KN, TE, reference16, work, runs[:2])
    result["fit"]["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, shapes, rows, gen,
                                                               path="fit_ddp")
    result["train"], train_paths, shapes = run_train_ddp2(KN, training, work, runs[2][1])
    paths.update(train_paths)
    result["train"]["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, shapes, rows, gen,
                                                                 path="train_ddp2")
    result["state_bytes"] = state_bytes(UR, FSDP)
    result["phase_seconds"] = time.perf_counter() - t0
    log(f"data parallelism: (kernel, shape) pairs held to their plain versions after the "
        f"world-1 fits {result['fit']['shapes_added_to_phase3']}, the two-rank steps "
        f"{result['train']['shapes_added_to_phase3']}; phase 16 took "
        f"{result['phase_seconds']:.1f} s")
    return result, paths



# ---------------------------------------------------------------------------
# phase 17: the 2-D (data, spatial) mesh
# ---------------------------------------------------------------------------


def spatial_worker(out: str) -> None:
    """Phase 17, one of ``SPATIAL_WORLD`` ranks on the one card over gloo, on
    ``make_mesh_2d(1, SPATIAL_WORLD)``: (a), (c), (b) of ``SPATIAL_MODES`` and
    (d); rank 0 runs the single-process restores of the same inputs and noise
    while the other ranks wait. Writes ``<out>.<rank>.json``."""
    import torch.distributed as dist

    from unirestore_torch import bridge
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.nn import kernels as KN
    from unirestore_torch.parallel import distributed as DIST
    from unirestore_torch.parallel import mesh as MESH
    from unirestore_torch.parallel import spatial as SP

    DIST.init_distributed(force=True, backend="gloo", device="cuda:0")
    try:
        t_start = time.perf_counter()
        KN.build_all()
        rank = DIST.rank()
        sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, SPATIAL_WORLD))
        timed = MESH.spatial_batch_sharding(sharding.mesh, timed=True)
        cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
        result = {"coordinate": sharding.coordinate, "backend": dist.get_backend()}

        def restore(c, trees, images, noise, steps, task, sh=None):
            x = images if sh is None else sh.local(images)
            return UR.restore_padded(*trees, c, UR.schedule(c), x, task, num_inference_steps=steps,
                                     posterior_noise=noise[0], diffusion_noise=noise[1],
                                     device="cuda", sharding=sh)

        def against_single(res, steps, seed):
            """The fp32 restore of a seeded batch of ``res`` px, 2 steps,
            assembled, against rank 0's single-process restore."""
            gen = torch.Generator(device="cuda").manual_seed(seed)
            images = torch.rand((SPATIAL_REF_BATCH, res, res, 3), generator=gen, device="cuda")
            noise = UR.restore_noise(cfg, images.shape, images.dtype, gen, "cuda")
            KN.reset_counts()
            got = sharding.assemble(restore(cfg, trees, images, noise, steps, "seg", sharding))
            ctx = sharding.last_context
            row = {"launches": list(counts_of(KN)), "collectives": dict(ctx.counts),
                   "whole_level": ctx.whole_level}
            if rank == 0:
                KN.reset_counts()
                want = restore(cfg, trees, images, noise, steps, "seg")
                row.update(max_abs_err=(got - want).abs().max().item(),
                           finite=bool(torch.isfinite(got).all()),
                           single_launches=list(counts_of(KN)))
            dist.barrier()
            return row

        # (a) fp32 at 256 px and (c) at 320 px, uneven, against one process on the card
        trees = make_params(UR, bridge, cfg, torch.float32, seed=5)
        result["reference"] = against_single(SPATIAL_REF_RES, 2, 6)
        result["uneven"] = against_single(SPATIAL_UNEVEN_RES, 2, 8)
        del trees
        torch.cuda.empty_cache()

        # (b) bf16 at 512 px: the sharded restores, then rank 0's single-process ones
        trees = make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
        gen = torch.Generator(device="cuda").manual_seed(7)
        images = torch.rand((SPATIAL_BATCH, RES, RES, 3), generator=gen,
                            device="cuda").to(torch.bfloat16)
        noise = UR.restore_noise(cfg, images.shape, images.dtype, gen, "cuda")
        restore(cfg, trees, images, noise, 1, "ir", sharding)  # warm-up: every shape once
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        result["held_gib"] = torch.cuda.memory_allocated() / 2**30
        result["setup_seconds"] = time.perf_counter() - t_start
        modes, outs = {}, {}
        for name, mode, stride, warmup, steps in SPATIAL_MODES:
            c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride, cache_warmup=warmup)
            KN.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_local = restore(c, trees, images, noise, steps, "ir", sharding)
            torch.cuda.synchronize()
            row = {"seconds": time.perf_counter() - t0, "launches": list(counts_of(KN)),
                   "launches_by_kernel": {kern.symbol: kern.launches for kern in KN.KERNELS},
                   "shapes": shapes_to_json(KN),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "collectives": dict(sharding.last_context.counts),
                   "collective_host_s_untimed": sum(sharding.last_context.seconds.values())}
            outs[name] = sharding.assemble(out_local)
            row["finite"] = bool(torch.isfinite(outs[name]).all())
            if name == "none":  # the collectives alone: the card synchronised around each,
                # in a one-step restore
                dist.barrier()
                t0 = time.perf_counter()
                restore(c, trees, images, noise, 1, "ir", timed)
                torch.cuda.synchronize()
                ctx = timed.last_context
                row.update(timed_restore_seconds=time.perf_counter() - t0,
                           timed_collectives=dict(ctx.counts),
                           collective_seconds=dict(ctx.seconds))
                # the card's busy time by kernel family in a one-step restore
                # (the profiler's cost grows with the collectives): each rank
                # runs the attention of the whole image
                dist.barrier()
                row["profile"] = spatial_profile(lambda: restore(c, trees, images, noise, 1,
                                                                 "ir", sharding))
            modes[name] = row
        dist.barrier()
        if rank == 0:
            for name, mode, stride, warmup, steps in SPATIAL_MODES:
                c = dataclasses.replace(cfg, cache_mode=mode, cache_stride=stride,
                                        cache_warmup=warmup)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = restore(c, trees, images, noise, steps, "ir")
                torch.cuda.synchronize()
                modes[name].update(single_seconds=time.perf_counter() - t0,
                                   single_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                   uint8_levels=uint8_levels(outs[name], want),
                                   max_abs_vs_single=(outs[name].float() - want.float()).abs()
                                   .max().item(),
                                   psnr_vs_single=psnr_u8(outs[name], want))
                if "profile" in modes[name]:
                    modes[name]["single_profile"] = spatial_profile(
                        lambda: restore(c, trees, images, noise, 1, "ir"))
        dist.barrier()
        result["modes"] = modes
        del outs, out_local
        torch.cuda.empty_cache()
        result["restore"] = spatial_full_restore(UR, KN, SP, dist, cfg, trees, sharding, timed,
                                                 rank)
        Path(f"{out}.{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


class WholeLevelMemory:
    """Within the block, the card's memory around every level a sharded
    restore runs whole: ``parallel.spatial.whole`` is wrapped to read the
    allocator's peak since the last reading at its entry and exit.
    ``peak_gib``: the block's peak; ``whole_peak_gib``: the highest allocation
    while a whole level ran; ``whole_added_gib``: the most one whole level
    allocated above what was allocated at its entry."""

    def __init__(self, SP):
        self.SP, self.orig = SP, SP.whole
        self.peak = self.whole_peak = self.added = 0

    def _read(self) -> int:
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.peak = max(self.peak, peak)
        return peak

    def __enter__(self):
        orig = self.orig

        @contextlib.contextmanager
        def whole():
            self._read()
            at_entry = torch.cuda.memory_allocated()
            with orig():
                yield
            peak = self._read()
            self.whole_peak = max(self.whole_peak, peak)
            self.added = max(self.added, peak - at_entry)

        torch.cuda.reset_peak_memory_stats()
        self.SP.whole = whole
        return self

    def __exit__(self, *exc):
        self.SP.whole = self.orig
        self._read()

    def gib(self) -> dict:
        return {"peak_gib": self.peak / 2**30, "whole_peak_gib": self.whole_peak / 2**30,
                "whole_added_gib": self.added / 2**30}


def spatial_full_restore(UR, KN, SP, dist, cfg, trees, sharding, timed, rank) -> dict:
    """Phase 17 (d): ``restore(..., sharding=)`` of ``SPATIAL_BATCH`` bf16
    originals of ``SPATIAL_ORIGINALS``, exact, ``SPATIAL_STEPS`` steps; a one-step
    restore first (every shape once) with the memory of its whole levels
    read (``WholeLevelMemory``), then the timed one, then a one-step restore
    with the card synchronised around each collective (``timed``); rank 0
    then restores the same batch and noise in one process (a one-step
    warm-up first)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    images = torch.rand((SPATIAL_BATCH, *SPATIAL_ORIGINALS, 3), generator=gen,
                        device="cuda").to(torch.bfloat16)
    padded = UR.padded_shape(images.shape, cfg)
    noise = UR.restore_noise(cfg, padded, images.dtype, gen, "cuda")

    def restore(steps, sh=None):
        x = images if sh is None else sh.local(images)
        return UR.restore(*trees, cfg, UR.schedule(cfg), x, "ir", num_inference_steps=steps,
                          posterior_noise=noise[0], diffusion_noise=noise[1], device="cuda",
                          sharding=sh)

    dist.barrier()
    with WholeLevelMemory(SP) as mem:
        restore(1, sharding)
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    KN.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_local = restore(SPATIAL_STEPS, sharding)
    torch.cuda.synchronize()
    ctx = sharding.last_context
    row = {"padded": list(padded), "whole_level": ctx.whole_level,
           "seconds": time.perf_counter() - t0, "launches": list(counts_of(KN)),
           "launches_by_kernel": {kern.symbol: kern.launches for kern in KN.KERNELS},
           "shapes": shapes_to_json(KN), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "held_gib": torch.cuda.memory_allocated() / 2**30, "collectives": dict(ctx.counts),
           "one_step_memory": mem.gib()}
    got = sharding.assemble(out_local)
    row["finite"] = bool(torch.isfinite(got).all())
    row["shape"] = list(got.shape)
    dist.barrier()
    t0 = time.perf_counter()
    restore(1, timed)
    torch.cuda.synchronize()
    row.update(timed_one_step_seconds=time.perf_counter() - t0,
               timed_collectives=dict(timed.last_context.counts),
               collective_seconds=dict(timed.last_context.seconds))
    dist.barrier()
    if rank == 0:
        restore(1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        KN.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        want = restore(SPATIAL_STEPS)
        torch.cuda.synchronize()
        row.update(single_seconds=time.perf_counter() - t0,
                   single_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   single_launches=list(counts_of(KN)),
                   uint8_levels=uint8_levels(got, want),
                   max_abs_vs_single=(got.float() - want.float()).abs().max().item(),
                   psnr_vs_single=psnr_u8(got, want))
    dist.barrier()
    return row


def spatial_profile(fn) -> dict:
    """``profiled_device(fn)``: the card's busy seconds, those of the repo's
    attention kernels, and the busy seconds by kernel family."""
    prof = profiled_device(fn)
    return {"device_busy_s": prof["device_busy_s"],
            "attention_s": sum(v for k, v in prof["device_s_by_family"].items()
                               if "attention" in k),
            "device_s_by_family": prof["device_s_by_family"]}


def check_against_single(ranks, key: str, what: str) -> dict:
    """(a) or (c): the assembled fp32 restore within ``REFERENCE_ATOL`` of one
    process on the card, each rank's launches one process's."""
    ref = ranks[0][key]
    if not (ref["finite"] and ref["max_abs_err"] <= REFERENCE_ATOL):
        raise AssertionError(f"spatial {what}: sharded and single-process restores differ: {ref}")
    if any(r[key]["launches"] != ref["single_launches"] for r in ranks):
        raise AssertionError(f"spatial {what}: launches per rank "
                             f"{[r[key]['launches'] for r in ranks]} != single "
                             f"{ref['single_launches']}")
    return ref


def spatial_job(work: Path) -> tuple:
    """Phase 17's torchrun job: (a)-(d) on ``SPATIAL_WORLD`` ranks."""
    return (SPATIAL_WORLD, [str(REPO / "chip_smoke.py"), "--worker", "spatial",
                            str(work / "spatial_rank")], work / "spatial.log")


def run_phase17(K, G, KN, rows, gen, work: Path, sec: float) -> tuple:
    """Phase 17 from its job (``spatial_job``), which ran ``sec`` s; then
    phase 3's comparison at every (kernel, shape) (b) and (d) met that was
    not held yet (the grouped conv on haloed slabs, the attention kernels at
    704 x 512). Returns (result, launches by path)."""
    t0 = time.perf_counter()
    out = work / "spatial_rank"
    ranks = [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(SPATIAL_WORLD)]
    r0 = ranks[0]
    for key, what, res in (("reference", "(a)", SPATIAL_REF_RES),
                           ("uneven", "(c)", SPATIAL_UNEVEN_RES)):
        ref = r0[key]
        log(f"spatial {what} fp32 {res} px batch {SPATIAL_REF_BATCH}, 2 steps, "
            f"make_mesh_2d(1, {SPATIAL_WORLD}) over {r0['backend']}, first whole level "
            f"{ref['whole_level']}: assembled vs single-process on the card max abs "
            f"{ref['max_abs_err']:.3e} (limit {REFERENCE_ATOL}); launches per rank "
            f"{[r[key]['launches'] for r in ranks]}, single {ref['single_launches']}; "
            f"collectives per rank {ref['collectives']}")
        check_against_single(ranks, key, what)
    if r0["uneven"]["whole_level"] != "UNet level 3 (latent / 8)":
        raise AssertionError(f"spatial (c): first whole level {r0['uneven']['whole_level']}")
    result = {"world": SPATIAL_WORLD, "backend": r0["backend"], "reference": r0["reference"],
              "uneven": r0["uneven"],
              "held_gib_by_rank": [r["held_gib"] for r in ranks],
              "setup_seconds_by_rank": [r["setup_seconds"] for r in ranks], "modes": {}}
    paths, shapes = {}, {kern.symbol: set() for kern in KN.KERNELS}
    for name, mode, stride, warmup, steps in SPATIAL_MODES:
        rows_ = [r["modes"][name] for r in ranks]
        want = list(EXPECTED[name] if steps == STEPS else exact_launches(EXPECTED[name], steps))
        bad = [row["launches"] for row in rows_ if row["launches"] != want]
        if bad or not all(row["finite"] for row in rows_):
            raise AssertionError(f"spatial {name}: launches per rank "
                                 f"{[row['launches'] for row in rows_]} (expected {want}) or "
                                 f"non-finite output")
        paths[SPATIAL_PATHS[name]] = {s: sum(row["launches_by_kernel"][s] for row in rows_)
                                      for s in rows_[0]["launches_by_kernel"]}
        for row in rows_:
            shapes = merge_shapes(shapes, shapes_from_json(row["shapes"]))
        m = rows_[0]
        entry = {"mode": mode, "stride": stride, "warmup": warmup, "steps": steps,
                 "seconds_by_rank": [row["seconds"] for row in rows_],
                 "img_per_s": SPATIAL_BATCH / max(row["seconds"] for row in rows_),
                 "peak_gib_by_rank": [row["peak_gib"] for row in rows_],
                 "single_seconds": m["single_seconds"], "single_peak_gib": m["single_peak_gib"],
                 "collectives_per_rank": m["collectives"], "launches_per_rank": m["launches"],
                 "uint8_levels_vs_single": m["uint8_levels"],
                 "max_abs_vs_single": m["max_abs_vs_single"],
                 "psnr_vs_single": m["psnr_vs_single"]}
        if "collective_seconds" in m:
            entry.update(timed_one_step_restore_seconds_by_rank=[row["timed_restore_seconds"]
                                                                 for row in rows_],
                         timed_collectives_per_rank=m["timed_collectives"],
                         collective_seconds_by_rank=[row["collective_seconds"] for row in rows_],
                         collective_share_by_rank=[sum(row["collective_seconds"].values())
                                                   / row["timed_restore_seconds"]
                                                   for row in rows_],
                         profile_by_rank=[row["profile"] for row in rows_],
                         single_profile=m["single_profile"])
        result["modes"][name] = entry
        log(f"spatial (b) {name} bf16 {RES} px batch {SPATIAL_BATCH}, {steps} steps: s per "
            f"restore by rank {entry['seconds_by_rank']} (single process "
            f"{entry['single_seconds']:.3f} s); peak GiB by rank {entry['peak_gib_by_rank']}, "
            f"held {result['held_gib_by_rank']}, single-process peak "
            f"{entry['single_peak_gib']:.2f}; collectives per rank and restore "
            f"{entry['collectives_per_rank']}"
            + (f"; with the card synchronised around each, in a one-step restore: "
               f"{entry['collective_seconds_by_rank']} s of "
               f"{entry['timed_one_step_restore_seconds_by_rank']} s (share "
               f"{entry['collective_share_by_rank']}); one-step restore profiled: the card "
               f"busy {[p['device_busy_s'] for p in entry['profile_by_rank']]} s by rank, "
               f"attention kernels {[p['attention_s'] for p in entry['profile_by_rank']]} s "
               f"(single process: busy {entry['single_profile']['device_busy_s']:.4f} s, "
               f"attention {entry['single_profile']['attention_s']:.4f} s)"
               if "collective_seconds" in m else "")
            + f"; vs single process: {entry['uint8_levels_vs_single']} uint8 levels, max abs "
            f"{entry['max_abs_vs_single']:.3e}, PSNR {entry['psnr_vs_single']:.2f} dB; launches "
            f"per rank {entry['launches_per_rank']} (phase 4's at {steps} steps)")
    rows_ = [r["restore"] for r in ranks]
    d = rows_[0]
    want = list(exact_launches(SPATIAL_RESTORE_EXPECTED, SPATIAL_STEPS))
    if (any(row["launches"] != want for row in rows_) or d["single_launches"] != want
            or not all(row["finite"] for row in rows_)
            or d["shape"] != [SPATIAL_BATCH, *SPATIAL_ORIGINALS, 3]
            or d["whole_level"] != "UNet level 3 (latent / 8)"):
        raise AssertionError(f"spatial (d): launches per rank {[row['launches'] for row in rows_]}"
                             f", single {d['single_launches']} (expected {want}), shape "
                             f"{d['shape']}, first whole level {d['whole_level']} or non-finite "
                             f"output")
    paths[SPATIAL_PATHS["restore"]] = {s: sum(row["launches_by_kernel"][s] for row in rows_)
                                       for s in rows_[0]["launches_by_kernel"]}
    for row in rows_:
        shapes = merge_shapes(shapes, shapes_from_json(row["shapes"]))
    peak = max(row["peak_gib"] for row in rows_)
    result["restore"] = entry = {
        "originals": [SPATIAL_BATCH, *SPATIAL_ORIGINALS, 3], "padded": d["padded"],
        "whole_level": d["whole_level"], "steps": SPATIAL_STEPS,
        "seconds_by_rank": [row["seconds"] for row in rows_],
        "img_per_s": SPATIAL_BATCH / max(row["seconds"] for row in rows_),
        "single_seconds": d["single_seconds"], "collectives_per_rank": d["collectives"],
        "held_gib_by_rank": [row["held_gib"] for row in rows_],
        "peak_gib_by_rank": [row["peak_gib"] for row in rows_],
        "single_peak_gib": d["single_peak_gib"],
        "one_step_memory_by_rank": [row["one_step_memory"] for row in rows_],
        "whole_added_share_of_peak": max(row["one_step_memory"]["whole_added_gib"]
                                         for row in rows_) / peak,
        "timed_one_step_seconds_by_rank": [row["timed_one_step_seconds"] for row in rows_],
        "timed_collectives_per_rank": d["timed_collectives"],
        "collective_seconds_by_rank": [row["collective_seconds"] for row in rows_],
        "collective_share_by_rank": [sum(row["collective_seconds"].values())
                                     / row["timed_one_step_seconds"] for row in rows_],
        "launches_per_rank": d["launches"], "uint8_levels_vs_single": d["uint8_levels"],
        "max_abs_vs_single": d["max_abs_vs_single"], "psnr_vs_single": d["psnr_vs_single"]}
    log(f"spatial (d) restore(sharding=) bf16 {SPATIAL_BATCH} x {SPATIAL_ORIGINALS} originals "
        f"(padded {d['padded'][1:3]}), exact, {SPATIAL_STEPS} steps, first whole level "
        f"{entry['whole_level']}: s per restore by rank {entry['seconds_by_rank']} (single "
        f"process {entry['single_seconds']:.3f} s); collectives per rank "
        f"{entry['collectives_per_rank']}; peak GiB by rank {entry['peak_gib_by_rank']}, held "
        f"{entry['held_gib_by_rank']}, single-process peak {entry['single_peak_gib']:.2f}; a "
        f"whole level added at most "
        f"{[m['whole_added_gib'] for m in entry['one_step_memory_by_rank']]} GiB (share of the "
        f"peak {entry['whole_added_share_of_peak']:.3f}); with the card synchronised around "
        f"each, in a one-step restore: {entry['collective_seconds_by_rank']} s of "
        f"{entry['timed_one_step_seconds_by_rank']} s (share "
        f"{entry['collective_share_by_rank']}); vs single process: "
        f"{entry['uint8_levels_vs_single']} uint8 levels, max abs "
        f"{entry['max_abs_vs_single']:.3e}, PSNR {entry['psnr_vs_single']:.2f} dB; launches per "
        f"rank {entry['launches_per_rank']} (one process's)")
    result["torchrun_seconds"] = sec
    result["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, shapes, rows, gen,
                                                        path="spatial")
    result["phase_seconds"] = time.perf_counter() - t0
    log(f"spatial: {result['shapes_added_to_phase3']} (kernel, shape) pairs held to their plain "
        f"versions after phase 17; torchrun {sec:.1f} s, phase 17 took "
        f"{result['phase_seconds']:.1f} s")
    return result, paths


# ---------------------------------------------------------------------------
# phase 18: the split train step
# ---------------------------------------------------------------------------


def split_state_snapshot(TS, stage, trainable, opt_state) -> dict:
    """Clones of the trained leaves and of every tensor of the optimizer state."""
    out = {f"trainable/{k}": v.clone() for k, v in TS.trained_leaves(stage, trainable).items()}
    for name, sub in opt_state.items():
        if isinstance(sub, dict):
            out.update({f"{name}/{k}": v.clone() for k, v in sub.items()})
        else:
            out[name] = sub
    return out


def snapshot_equal(a: dict, b: dict) -> list:
    """The keys whose values differ between two snapshots."""
    return [k for k in a if not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                                 else a[k] == b[k])]


def monolithic_step(frozen, cfg, sched, stage, tx, task, te_loss_fn=None, remat=True,
                    group=None):
    """The train step with every loss in one backward, the design the port's
    step (``steps.make_train_step``) replaced: ``compute_losses``' sum
    differentiated once over all trained leaves, then the step's own
    optimizer tail. Its backward starts with every part's saved activations;
    phase 18 measures what running the parts in turn saves against it, and
    the CPU tests hold the step to it bit for bit."""
    from unirestore_torch.parallel import fsdp as FSDP
    from unirestore_torch.train import steps as TS

    cfg = TS.with_remat(cfg) if remat else cfg

    def step(trainable, opt_state, batch, noise):
        full_frozen = FSDP.gather_tree(frozen, group)
        full = FSDP.gather_tree(trainable, group)
        params = TS.trained_leaves(stage, full)
        with TS._tracking(params):
            loss, logs = TS.compute_losses(full_frozen, full, cfg, sched, stage, batch, noise,
                                           task, te_loss_fn)
            grads = TS._grads(loss, params)
        return TS._apply(stage, tx, group, trainable, opt_state, params, grads, logs)

    step.task = task
    return step


def stage1_cell(UR, bridge, TS, OPT) -> dict:
    """Phase 6's cell as phases 18 and 19 (a) share it: ``UniRestoreConfig()``
    at full width, bf16 frozen and fp32 trainable leaves seeded 3, AdamW from
    the stage-1 YAML's kwargs at accumulation 2, and its state."""
    cfg = UR.UniRestoreConfig()
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=3,
                                    trainable_dtype=torch.float32)
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
    tx, _ = OPT.build(STAGE1_OPT, STAGE1_SCHED, STAGE1_MAX_STEPS, BATCH, STAGE1_ACCUM, 1)
    return {"cfg": cfg, "frozen": frozen, "trainable": trainable, "stage": stage, "tx": tx,
            "opt_state": tx.init(TS.trained_leaves(stage, trainable)),
            "sched": UR.schedule(cfg, device="cuda")}


def run_split_training(UR, KN, bridge, TS, OPT, cell):
    """Phase 18 (a)-(c): phase 6's cell under the port's step
    (``make_train_step``, "split": its parts in turn) and ``monolithic_step``
    ("mono"). (a) from one set of parameters, batches and noise, two
    micro-steps of each (one AdamW update at accumulation 2): the logged
    losses and every trained leaf after the update bit-equal, each family's
    gradient norm within TRAIN_GRAD_RTOL; then the two in turns (SPLIT_TURNS)
    of SPLIT_TURN_STEPS steps, each synchronised, with the peak memory of each
    turn; (b) at SPLIT_BIG_BATCH, or at the largest multiple of 8 below it at
    which (a)'s monolithic peak, extrapolated in the batch, fits the card, one
    warm-up step of each and then the same turns of SPLIT_BIG_STEPS steps; (c)
    the step ended after each part at batch 8: its seconds, and the trained
    leaves and optimizer state unchanged. Every full step launches
    EXPECTED_TRAIN. Runs beside no reference job, on ``cell`` (``stage1_cell``),
    whose trainable leaves and optimizer state it moves. Returns (result,
    launches of the port's step by kernel)."""
    t_phase = time.perf_counter()
    cfg, frozen, trainable, stage, tx, opt_state, sched = (
        cell[k] for k in ("cfg", "frozen", "trainable", "stage", "tx", "opt_state", "sched"))
    steps = {"mono": monolithic_step(frozen, cfg, sched, stage, tx, "ir"),
             "split": TS.make_train_step(frozen, cfg, sched, stage, tx, "ir")}
    gen = torch.Generator(device="cuda").manual_seed(18)
    norms, update = [], tx.update

    def recording(state, params, grads, group=None):
        """``tx.update``, with each family's gradient norm kept in ``norms``."""
        fam = {}
        for k, g in grads.items():
            f = k.split("//")[0]
            fam[f] = fam.get(f, 0.0) + g.double().square().sum()
        norms.append({f: v.sqrt().item() for f, v in fam.items()})
        return update(state, params, grads, group)

    def inputs(batch_size=BATCH):
        batch = synthetic_pair(gen, batch_size, RES, torch.bfloat16)
        return batch, TS.draw_noise(cfg, batch, gen)

    launches = {kern.symbol: 0 for kern in KN.KERNELS}

    def run(kind, tr, state, batch, noise, check=True):
        """One synchronised step: (seconds, logs as floats)."""
        KN.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = steps[kind](tr, state, batch, noise)[2]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = train_counts(KN)
        if check and counts != EXPECTED_TRAIN:
            raise AssertionError(f"{kind} step: launches {counts} != {EXPECTED_TRAIN}")
        if kind != "mono":
            for kern in KN.KERNELS:
                launches[kern.symbol] += kern.launches
        logs = {k: v.item() for k, v in logs.items()}
        if not all(math.isfinite(v) for v in logs.values()):
            raise AssertionError(f"{kind} step: non-finite logs {logs}")
        return sec, logs

    def in_turns(batch_size, n):
        """SPLIT_TURNS of ``n`` steps each: (ms/step, seconds, peak GiB) by kind."""
        sec, peak = {"mono": [], "split": []}, {"mono": 0.0, "split": 0.0}
        for kind in SPLIT_TURNS:
            torch.cuda.reset_peak_memory_stats()
            for _ in range(n):
                sec[kind].append(run(kind, trainable, opt_state, *inputs(batch_size))[0])
            peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated() / 2**30)
        return {k: 1e3 * sum(v) / len(v) for k, v in sec.items()}, sec, peak

    def spread(sec):
        return ", ".join(f"{k} {[round(x * 1e3, 1) for x in v]}" for k, v in sec.items())

    # (a) the same two micro-steps from the same state
    pairs = [inputs() for _ in range(STAGE1_ACCUM)]
    start = {k: v.clone() for k, v in TS.trained_leaves(stage, trainable).items()}
    twin = clone_tree(bridge, trainable)
    twin_state = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                  for k, v in opt_state.items()}
    tx.update = recording
    got = {"mono": [], "split": []}
    for kind, tr, state in (("mono", trainable, opt_state), ("split", twin, twin_state)):
        for batch, noise in pairs:
            got[kind].append(run(kind, tr, state, batch, noise)[1])
    tx.update = update
    norms_by_kind = {"mono": norms[:STAGE1_ACCUM], "split": norms[STAGE1_ACCUM:]}
    loss_keys = [k for k in got["mono"][0] if k.startswith("train/loss")]
    unequal = [(i + 1, k, m[k], s[k]) for i, (m, s) in enumerate(zip(got["mono"], got["split"]))
               for k in loss_keys if m[k] != s[k]]
    grad_err = max(abs(s[f] - m[f]) / m[f] for m, s in zip(norms_by_kind["mono"],
                                                          norms_by_kind["split"]) for f in m)
    mono_leaves = TS.trained_leaves(stage, trainable)
    split_leaves = TS.trained_leaves(stage, twin)
    bit_equal = sum(torch.equal(mono_leaves[k], split_leaves[k]) for k in mono_leaves)
    moved = sum(not torch.equal(mono_leaves[k], start[k]) for k in mono_leaves)
    log(f"split step (a), from one state, two micro-steps (one AdamW update): logged losses "
        f"{'bit-equal' if not unequal else f'differ: {unequal}'}; per-family gradient norms "
        f"mono {norms_by_kind['mono']} split {norms_by_kind['split']}, largest relative "
        f"difference {grad_err:.3e} (limit {TRAIN_GRAD_RTOL}); trained leaves after the update "
        f"bit-equal {bit_equal} of {len(mono_leaves)} ({moved} moved); launches per step "
        f"{EXPECTED_TRAIN} (both)")
    if unequal or bit_equal != len(mono_leaves):
        raise AssertionError(f"the step and monolithic_step differ: losses {unequal}, "
                             f"{len(mono_leaves) - bit_equal} trained leaves")
    if grad_err > TRAIN_GRAD_RTOL or not moved:
        raise AssertionError(f"split and monolithic gradients differ ({grad_err}) or nothing "
                             f"moved ({moved})")
    check = {"losses_bit_equal": True, "losses": got, "family_grad_norms": norms_by_kind,
             "grad_norm_rel_err": grad_err, "trained_leaves": len(mono_leaves),
             "leaves_bit_equal_after_update": bit_equal, "leaves_moved": moved}
    # the cache keeps its blocks, so that the first turn grows no memory
    del twin, twin_state, start, pairs, mono_leaves, split_leaves

    # (a) the two in turns, each turn's peak
    static = torch.cuda.memory_allocated() / 2**30
    ms, sec, peak = in_turns(BATCH, SPLIT_TURN_STEPS)
    log(f"split step (a), batch {BATCH}, turns {SPLIT_TURNS} of {SPLIT_TURN_STEPS} steps: "
        f"mono {ms['mono']:.1f} ms/step, peak {peak['mono']:.2f} GiB; split "
        f"{ms['split']:.1f} ms/step, peak {peak['split']:.2f} GiB; each step ({spread(sec)}); "
        f"held before the steps {static:.2f} GiB")
    result_cell = {"batch": BATCH, "res": RES, "ms_per_step": ms, "ms_each": sec,
                   "peak_mem_gib": peak, "held_gib": static, "check": check}

    # (b) the memory a user buys: the largest batch (a)'s monolithic peak allows
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    per_8 = peak["mono"] - static
    big = next(b for b in range(SPLIT_BIG_BATCH, 0, -8)
               if static + per_8 * b / BATCH <= SPLIT_MEM_SHARE * total)
    torch.cuda.empty_cache()
    for kind in ("mono", "split"):  # warm-up
        run(kind, trainable, opt_state, *inputs(big))
    ms_big, sec_big, peak_big = in_turns(big, SPLIT_BIG_STEPS)
    result_big = {"batch": big, "estimated_mono_peak_gib": static + per_8 * big / BATCH,
                  "card_gib": total, "ms_per_step": ms_big, "ms_each": sec_big,
                  "peak_mem_gib": peak_big}
    log(f"split step (b), batch {big} (estimated monolithic peak "
        f"{result_big['estimated_mono_peak_gib']:.1f} of {total:.1f} GiB), turns {SPLIT_TURNS} "
        f"of {SPLIT_BIG_STEPS} steps: mono {ms_big['mono']:.1f} ms/step, peak "
        f"{peak_big['mono']:.2f} GiB; split {ms_big['split']:.1f} ms/step, peak "
        f"{peak_big['split']:.2f} GiB; each step ({spread(sec_big)})")
    torch.cuda.empty_cache()

    # (c) the step ended after each part
    parts = {}
    batch, noise = inputs()
    for part in TS.SPLIT_PARTS:
        steps["cut"] = TS.make_train_step(frozen, cfg, sched, stage, tx, "ir", stop_after=part)
        before = split_state_snapshot(TS, stage, trainable, opt_state)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sec_cut, logs = zip(*(run("cut", trainable, opt_state, batch, noise, check=False)
                              for _ in range(SPLIT_CUT_STEPS)))
        above = (torch.cuda.max_memory_allocated() - held) / 2**30
        changed = snapshot_equal(before, split_state_snapshot(TS, stage, trainable, opt_state))
        if changed or list(logs[0]) != ["train/loss"]:
            raise AssertionError(f"stop_after={part}: changed {changed[:5]}, logs {logs[0]}")
        parts[part] = {"ms": 1e3 * sum(sec_cut) / len(sec_cut), "loss": logs[0]["train/loss"],
                       "peak_above_held_gib": above}
        del before
    log(f"split step (c), ms and peak GiB above what was held before, up to each part at batch "
        f"{BATCH} (trained leaves and optimizer state unchanged after each): "
        + ", ".join(f"{p} {v['ms']:.1f} ms {v['peak_above_held_gib']:.2f} GiB"
                    for p, v in parts.items())
        + f"; the whole step: split {ms['split']:.1f} ms {peak['split'] - static:.2f} GiB, mono "
        f"{ms['mono']:.1f} ms {peak['mono'] - static:.2f} GiB")
    del steps, frozen, trainable, opt_state
    torch.cuda.empty_cache()
    return {"cell": result_cell, "big_batch": result_big, "parts_ms": parts,
            "seconds": time.perf_counter() - t_phase}, launches


def run_fit_split(KN, bridge, TE, main_fn, work: Path, reference16) -> tuple:
    """Phase 18 (d): phase 9's fit command with ``--trainer.split_step true``,
    FIT_SPLIT_STEPS micro-steps without validation: launches per micro-step
    EXPECTED_TRAIN, the second under ``set_sync_debug_mode("error")``; every
    logged loss and every leaf of ``last.npz`` bit-equal to phase 9's after
    the same micro-steps (phase 16's reference: the flag selects no other
    step). Then ``--trainer.stop_after fr`` for one micro-step: no
    ``last.npz``. Returns (result, launches of the split fit)."""
    from unirestore_torch.train import checkpoints as CKPT

    t0 = time.perf_counter()
    no_val = ("--trainer.val_check_interval", "0", "--trainer.num_sanity_val_steps", "0",
              "--trainer.log_every_n_steps", "1")
    split = ("--trainer.split_step", "true")
    KN.reset_counts()
    with StepProbe(TE, KN, bridge, sync_steps=(1,)) as probe:
        _, trainer = main_fn(fit_argv("fit", work / "data", work / "fit_split", *split,
                                      "--trainer.max_steps", str(FIT_SPLIT_STEPS), *no_val))
    launches = {kern.symbol: kern.launches for kern in KN.KERNELS}
    fit_s = time.perf_counter() - t0
    if not trainer.split_step or len(probe.counts) != FIT_SPLIT_STEPS or any(
            c != EXPECTED_TRAIN for c in probe.counts):
        raise AssertionError(f"split fit: launches per micro-step {probe.counts} != "
                             f"{EXPECTED_TRAIN}")
    logged = [{k: v for k, v in e.items() if k.startswith("train/")} for e in trainer.logs]
    unequal = {f"{i + 1} {k}": (got[k], want[k]) for i, (got, want)
               in enumerate(zip(logged, reference16["logs"])) for k in want
               if k.startswith("train/loss") and got[k] != want[k]}
    flat, meta = CKPT.load_checkpoint(str(work / "fit_split" / "checkpoints" / "last.npz"))
    same = sum(np.array_equal(flat[f"trainable//{k}"], v)
               for k, v in reference16["trainable"].items())
    grad_norms = [(e["train/grad_norm"], w["train/grad_norm"])
                  for e, w in zip(logged, reference16["logs"])]
    log(f"split fit (phase 9's command, --trainer.split_step true, {FIT_SPLIT_STEPS} "
        f"micro-steps, no validation): {fit_s:.1f} s; launches per micro-step equal phase 6's, "
        f"micro-step 2 under set_sync_debug_mode('error'); logged losses vs phase 9's "
        f"{'bit-equal' if not unequal else unequal}; grad norms (split, phase 9) {grad_norms}; "
        f"last.npz at step {meta['step']}: {same} of {len(reference16['trainable'])} trainable "
        "leaves bit-equal to phase 9's")
    if unequal or same != len(reference16["trainable"]) or meta["step"] != FIT_SPLIT_STEPS:
        raise AssertionError(f"split fit differs from phase 9's: losses {unequal}, "
                             f"{len(reference16['trainable']) - same} last.npz leaves")
    del probe, trainer
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    root = work / "fit_stop"
    _, stopped = main_fn(fit_argv("fit", work / "data", root, *split, "--trainer.stop_after",
                                  "fr", "--trainer.max_steps", "1", *no_val))
    left = sorted(p.name for p in (root / "checkpoints").iterdir()) \
        if (root / "checkpoints").exists() else []
    log(f"stop_after fr fit: {time.perf_counter() - t1:.1f} s; logs {stopped.logs}; "
        f"checkpoints left {left}")
    if left or [sorted(e) for e in stopped.logs] != [["imgs_per_sec", "step", "train/loss"]]:
        raise AssertionError(f"stop_after fr: checkpoints {left}, logs {stopped.logs}")
    torch.cuda.empty_cache()
    return {"seconds": fit_s, "losses_bit_equal_phase9": not unequal, "unequal": unequal,
            "grad_norms_split_phase9": grad_norms, "leaves_bit_equal_phase9": same,
            "stop_after_fr": {"seconds": time.perf_counter() - t1, "logs": stopped.logs,
                              "checkpoints": left},
            "phase_seconds": time.perf_counter() - t0}, launches


# ---------------------------------------------------------------------------
# phase 19: the graph-captured train step
# ---------------------------------------------------------------------------


def state_tensors(TS, stage, trainable, opt_state) -> dict:
    """The trained leaves and every optimizer slot, by name (the tensors themselves)."""
    out = {f"trainable/{k}": v for k, v in TS.trained_leaves(stage, trainable).items()}
    for name, sub in opt_state.items():
        if isinstance(sub, dict):
            out.update({f"{name}/{k}": v for k, v in sub.items()})
    return out


def restore_state(TS, stage, trainable, opt_state, snapshot: dict) -> None:
    """Put a ``split_state_snapshot`` back, in place (the tensors keep their addresses)."""
    for k, t in state_tensors(TS, stage, trainable, opt_state).items():
        t.copy_(snapshot[k])
    for k in ("count", "mini_step"):
        opt_state[k] = snapshot[k]


def device_window(fn) -> dict:
    """``fn()`` once under ``torch.profiler``, the card synchronised after it:
    ``train/profiling.py:device_summary`` (the card's busy seconds, its span
    from the first start to the last end, the idle share 1 - busy / span, the
    kernels) and the host's wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    from unirestore_torch.train import profiling as PROF

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = PROF.device_summary(prof)
    if not summary:
        raise AssertionError("the profiled window recorded no device activity")
    return {**summary, "wall_s": wall}


def graph_path_launches(KN, graphs) -> dict:
    """Each graph's launches at capture (forward and remat recompute, the
    counters' ``launches``) times its replays, summed by kernel."""
    out = {kern.symbol: 0 for kern in KN.KERNELS}
    for stats in graphs:
        for sym, n in stats.launches.items():
            out[sym] += (sum(n[:2]) if isinstance(n, tuple) else n) * stats.replays
    return out


def run_graph_training(UR, KN, bridge, TS, GR, cell):
    """Phase 19 (a): phase 6's cell (``cell``, phase 18's build) on the graph
    route (``GraphedTrainStep``) and eagerly (``make_train_step``). From one
    state, the same accumulating and applying micro-steps by each route: the
    logs, every trained leaf and every optimizer slot after them bit-equal;
    launches at capture EXPECTED_TRAIN, the graph's first call
    (TRAIN_WARMUP_STEPS + 1) times it (the eager warm-ups and the capture),
    a replay none. Then GRAPH_TRAIN_TURNS of GRAPH_TURN_STEPS synchronised
    micro-steps, each under ``set_sync_debug_mode("error")``: ms/step and
    each turn's peak; one pair of micro-steps of each route under the
    profiler: the card's idle share. Beside no reference job. Returns
    (result, launches of the graph route by kernel)."""
    t_phase = time.perf_counter()
    cfg, frozen, trainable, stage, tx, opt_state, sched = (
        cell[k] for k in ("cfg", "frozen", "trainable", "stage", "tx", "opt_state", "sched"))
    eager = TS.make_train_step(frozen, cfg, sched, stage, tx, "ir")
    gen = torch.Generator(device="cuda").manual_seed(19)

    def inputs():
        batch = synthetic_pair(gen, BATCH, RES, torch.bfloat16)
        return batch, TS.draw_noise(cfg, batch, gen)

    if opt_state["mini_step"]:  # start at an update boundary
        eager(trainable, opt_state, *inputs())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graphed = GR.GraphedTrainStep(frozen, cfg, sched, stage, tx, "ir", device="cuda")
    routes = {"eager": eager, "graph": graphed}

    def run(route, batch, noise, sync_check=False):
        """One synchronised micro-step: (seconds, logs as floats, launch counts)."""
        KN.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            logs = routes[route](trainable, opt_state, batch, noise)[2]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        logs = {k: v.item() for k, v in logs.items()}
        if not all(math.isfinite(v) for v in logs.values()):
            raise AssertionError(f"{route} micro-step: non-finite logs {logs}")
        return sec, logs, train_counts(KN)

    # one accumulating and one applying micro-step of each route from one state
    pairs = [inputs() for _ in range(STAGE1_ACCUM)]
    start = split_state_snapshot(TS, stage, trainable, opt_state)
    got = {"eager": [run("eager", *pair) for pair in pairs]}
    after = {"eager": split_state_snapshot(TS, stage, trainable, opt_state)}
    restore_state(TS, stage, trainable, opt_state, start)
    torch.cuda.reset_peak_memory_stats()
    got["graph"] = [run("graph", *pair) for pair in pairs]
    peak_first = torch.cuda.max_memory_allocated() / 2**30
    after["graph"] = split_state_snapshot(TS, stage, trainable, opt_state)
    (stats,) = graphed.stats.values()
    zero = {s: (0, 0, 0) for s in EXPECTED_TRAIN}
    first = {s: tuple((GR.TRAIN_WARMUP_STEPS + 1) * n for n in c)
             for s, c in EXPECTED_TRAIN.items()}
    launches_ok = (stats.launches == EXPECTED_TRAIN and got["graph"][0][2] == first
                   and got["graph"][1][2] == zero
                   and all(r[2] == EXPECTED_TRAIN for r in got["eager"]))
    unequal_logs = [(i + 1, k, e[1][k], g[1][k]) for i, (e, g) in
                    enumerate(zip(got["eager"], got["graph"])) for k in e[1] if e[1][k] != g[1][k]]
    unequal_state = snapshot_equal(after["eager"], after["graph"])
    moved = sum(not torch.equal(after["graph"][k], start[k]) for k in start
                if k.startswith("trainable/"))
    n_leaves = sum(k.startswith("trainable/") for k in start)
    n_state = len(start)
    del start, after
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - reserved) / 2**30
    log(f"graph step (a), from one state, an accumulating and an applying micro-step: "
        f"logs {'bit-equal' if not unequal_logs else f'differ: {unequal_logs}'} "
        f"({len(got['eager'][0][1])} and {len(got['eager'][1][1])} values); trained leaves and "
        f"optimizer slots after them: {len(unequal_state)} of {n_state} differ, {moved} of "
        f"{n_leaves} leaves moved; launches at capture {stats.launches}, "
        f"first call {got['graph'][0][2]}, replay {got['graph'][1][2]}: {launches_ok}; "
        f"warm-up {stats.warmup_seconds:.3f} s, capture {stats.capture_seconds:.3f} s, first "
        f"call {got['graph'][0][0]:.3f} s, peak {peak_first:.2f} GiB, held by the graphs "
        f"{held:.2f} GiB")
    if unequal_logs or unequal_state or not launches_ok or moved != n_leaves:
        raise AssertionError(f"graph step differs from the eager step: logs {unequal_logs}, "
                             f"state {unequal_state[:5]}, launches {launches_ok}, moved {moved}")

    # in turns, each micro-step synchronised and checked for host syncs
    marks = {"check": time.perf_counter() - t_phase}
    sec, peak = {"eager": [], "graph": []}, {"eager": 0.0, "graph": 0.0}
    for route in GRAPH_TRAIN_TURNS:
        torch.cuda.reset_peak_memory_stats()
        for _ in range(GRAPH_TURN_STEPS):
            s, _, counts = run(route, *inputs(), sync_check=True)
            if counts != (EXPECTED_TRAIN if route == "eager" else zero):
                raise AssertionError(f"{route} turn: launches {counts}")
            sec[route].append(s)
        peak[route] = max(peak[route], torch.cuda.max_memory_allocated() / 2**30)
    ms = {k: 1e3 * sum(v) / len(v) for k, v in sec.items()}

    def pair(route):
        for batch, noise in [inputs() for _ in range(STAGE1_ACCUM)]:
            routes[route](trainable, opt_state, batch, noise)

    marks["turns"] = time.perf_counter() - t_phase
    window = {route: device_window(lambda r=route: pair(r)) for route in ("eager", "graph")}
    marks["profiled"] = time.perf_counter() - t_phase
    log(f"graph step (a), batch {BATCH}, turns {GRAPH_TRAIN_TURNS} of {GRAPH_TURN_STEPS} "
        f"micro-steps (each under set_sync_debug_mode('error')): eager {ms['eager']:.1f} ms, "
        f"graph {ms['graph']:.1f} ms a micro-step ({(ms['eager'] / ms['graph'] - 1) * 100:+.1f} "
        f"%; each eager {[round(x * 1e3, 1) for x in sec['eager']]}, graph "
        f"{[round(x * 1e3, 1) for x in sec['graph']]}); peak eager {peak['eager']:.2f}, graph "
        f"{peak['graph']:.2f} GiB; profiled pair: eager busy "
        f"{window['eager']['device_busy_s']:.4f} s of {window['eager']['device_span_s']:.4f} "
        f"(idle {window['eager']['device_idle_share']:.3f}), graph busy "
        f"{window['graph']['device_busy_s']:.4f} s of {window['graph']['device_span_s']:.4f} "
        f"(idle {window['graph']['device_idle_share']:.3f})")
    launches = graph_path_launches(KN, graphed.stats.values())
    for kern in KN.KERNELS:  # the first call's eager warm-ups and capture
        launches[kern.symbol] += sum(got["graph"][0][2][kern.symbol][:2])
    result = {"batch": BATCH, "res": RES, "launches_at_capture": stats.launches,
              "warmup_steps": GR.TRAIN_WARMUP_STEPS, "warmup_seconds": stats.warmup_seconds,
              "capture_seconds": stats.capture_seconds, "first_call_seconds": got["graph"][0][0],
              "peak_mem_gib_first_call": peak_first, "graph_held_gib": held,
              "logs": {r: [x[1] for x in v] for r, v in got.items()}, "logs_bit_equal": True,
              "state_bit_equal": True, "trained_leaves": n_leaves, "ms_per_step": ms,
              "ms_each": {k: [x * 1e3 for x in v] for k, v in sec.items()},
              "peak_mem_gib": peak, "profiled_pair": window, "replays": stats.replays,
              "seconds_at": marks, "seconds": time.perf_counter() - t_phase}
    del graphed, routes, eager
    torch.cuda.empty_cache()
    return result, launches


def stage2_batch(gen, task: str) -> dict:
    """A seeded 512 px batch of one for ``task``, with its labels (``cls``: a
    class; ``seg``: 19 classes, the top 32 rows ignored)."""
    batch = synthetic_pair(gen, 1, RES, torch.bfloat16)
    if task == "cls":
        batch["gt"] = torch.tensor([417], device="cuda")
    elif task == "seg":
        labels = torch.randint(0, 19, (1, RES, RES), generator=gen, device="cuda")
        labels[:, :32] = 255
        batch["gt"] = labels
    return batch


def run_graph_stage2(UR, KN, bridge, TS, TE, OPT, GR):
    """Phase 19 (c): the stage-2 step (full width with TFA, bf16 frozen and fp32
    TFA masters seeded 19, the critics of ``build_critics("mtl")``, AdamW from
    the stage-1 YAML's kwargs at accumulation 1, so that each micro-step
    applies) of each task in STAGE2_GRAPH_TASKS, eager and from its graph (one
    ``GraphedTrainStep`` a task, sharing one ``GraphCache``, as the trainer's
    do). The critics' backward runs ``index_select``'s backward
    (``index_add_``, atomic adds on the card) in the resizes and cuDNN's fp32
    convolution backward, so two eager micro-steps from one state differ in
    their last bits: counted first, in the default mode. Then, under
    ``torch.use_deterministic_algorithms(True)`` (sorted sums, deterministic
    cuDNN algorithms), from one state: two eager micro-steps and the graph's
    first call (capture) give bit-equal logs, trained leaves and slots;
    launches at capture EXPECTED_STAGE2 of the task; then one synchronised
    micro-step of each route in that mode (the graph's a replay). Returns the
    result."""
    t0 = time.perf_counter()
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=STAGE2_GRAPH_TASKS)
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=19,
                                    trainable_dtype=torch.float32)
    stage = TS.StageConfig(train_cfrm=False, train_cnet=False, train_tfa=True, multi_task=True)
    te_fn = TE.make_te_loss_fn("mtl", TE.build_critics("mtl", device="cuda"))
    tx, _ = OPT.build(STAGE1_OPT, STAGE1_SCHED, STAGE1_MAX_STEPS, 1, 1, 1)
    opt_state = tx.init(TS.trained_leaves(stage, trainable))
    sched = UR.schedule(cfg, device="cuda")
    cache = GR.GraphCache()
    gen = torch.Generator(device="cuda").manual_seed(20)
    out = {"build_seconds": time.perf_counter() - t0}
    for task in STAGE2_GRAPH_TASKS:
        batch = stage2_batch(gen, task)
        noise = TS.draw_noise(cfg, batch, gen)
        routes = {"eager": TS.make_train_step(frozen, cfg, sched, stage, tx, task,
                                              te_loss_fn=te_fn),
                  "graph": GR.GraphedTrainStep(frozen, cfg, sched, stage, tx, task,
                                               te_loss_fn=te_fn, device="cuda", cache=cache)}
        start = split_state_snapshot(TS, stage, trainable, opt_state)

        def micro_step(route):
            """One synchronised micro-step from ``start``: (logs, state after, seconds)."""
            restore_state(TS, stage, trainable, opt_state, start)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logs = routes[route](trainable, opt_state, batch, noise)[2]
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            return ({k: v.item() for k, v in logs.items()},
                    split_state_snapshot(TS, stage, trainable, opt_state), sec)

        default = [micro_step("eager") for _ in range(2)]
        spread = snapshot_equal(default[0][1], default[1][1])
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            eager = [micro_step("eager") for _ in range(2)]
            KN.reset_counts()
            graph = micro_step("graph")
            first_counts = train_counts(KN)
            timed = {route: micro_step(route)[2] for route in ("eager", "graph")}
        finally:
            torch.use_deterministic_algorithms(False)
        (stats,) = routes["graph"].stats.values()
        unequal = snapshot_equal(eager[0][1], graph[1])
        repeat = snapshot_equal(eager[0][1], eager[1][1])
        moved = sum(not torch.equal(graph[1][k], start[k]) for k in start
                    if k.startswith("trainable/"))
        warm = {s: tuple((GR.TRAIN_WARMUP_STEPS + 1) * n for n in c)
                for s, c in EXPECTED_STAGE2[task].items()}
        ok = (eager[0][0] == graph[0] == eager[1][0] and not unequal and not repeat and moved
              and stats.launches == EXPECTED_STAGE2[task] and first_counts == warm
              and all(math.isfinite(v) for v in graph[0].values()))
        same = "bit-equal" if eager[0][0] == graph[0] else (eager[0][0], graph[0])
        log(f"graph step (c), stage 2 {task}: default mode, two eager micro-steps from one "
            f"state differ in {len(spread)} of {len(start)} trained leaves and slots; "
            f"deterministic algorithms: logs eager vs graph {same}, {len(unequal)} leaves and "
            f"slots differ ({len(repeat)} between the two eager runs; {moved} leaves moved); "
            f"launches at capture {stats.launches}; warm-up {stats.warmup_seconds:.3f} s, "
            f"capture {stats.capture_seconds:.3f} s; a micro-step eager "
            f"{timed['eager'] * 1e3:.1f} ms, replayed {timed['graph'] * 1e3:.1f} ms "
            f"(default-mode eager {default[1][2] * 1e3:.1f} ms)")
        if not ok:
            raise AssertionError(f"stage-2 {task}: the graph step differs from the eager one: "
                                 f"{unequal[:5]}, eager repeat {repeat[:5]}, launches "
                                 f"{stats.launches}, first call {first_counts}")
        out[task] = {"logs": graph[0], "bit_equal": True, "leaves_and_slots": len(start),
                     "moved": moved, "default_mode_eager_repeat_differ": len(spread),
                     "launches_at_capture": stats.launches,
                     "warmup_seconds": stats.warmup_seconds,
                     "capture_seconds": stats.capture_seconds,
                     "ms": {"eager": timed["eager"] * 1e3, "graph": timed["graph"] * 1e3,
                            "eager_default_mode": default[1][2] * 1e3}}
        del routes, start, default, eager, graph
    out["seconds"] = time.perf_counter() - t0
    del frozen, trainable, opt_state, te_fn, cache
    torch.cuda.empty_cache()
    return out


class RestoreCheck:
    """Wraps ``UniFIEEngine.restore_fn`` for a fit on the graph route: each
    restore's answer against the eager route's on the same images (a closure
    made with ``cuda_graphs`` off), in uint8 levels; the eager restores'
    launches are kept apart (``eager_launches``)."""

    def __init__(self, TE, KN):
        self.TE, self.KN = TE, KN
        self.levels, self.max_abs = [], 0.0
        self.eager_launches = {kern.symbol: 0 for kern in KN.KERNELS}
        self.engines = []

    def __enter__(self):
        check, orig = self, self.TE.UniFIEEngine.restore_fn
        self.orig = orig

        def restore_fn(engine, *args, **kwargs):
            graphed = orig(engine, *args, **kwargs)
            engine.cuda_graphs = False
            try:
                eager = orig(engine, *args, **kwargs)
            finally:
                engine.cuda_graphs = True
            if engine not in check.engines:
                check.engines.append(engine)

            def run(images, task):
                out = graphed(images, task)
                before = {kern.symbol: kern.launches for kern in check.KN.KERNELS}
                ref = eager(images, task)
                for kern in check.KN.KERNELS:
                    check.eager_launches[kern.symbol] += kern.launches - before[kern.symbol]
                qa, qb = (np.clip(np.round(x * 255), 0, 255) for x in (out, ref))
                check.levels.append(int(np.abs(qa - qb).max()))
                check.max_abs = max(check.max_abs, float(np.abs(out - ref).max()))
                return out

            return run

        self.TE.UniFIEEngine.restore_fn = restore_fn
        return self

    def __exit__(self, *exc):
        self.TE.UniFIEEngine.restore_fn = self.orig
        return False


def run_fit_graph(KN, bridge, TE, GR, main_fn, work: Path, reference16, eager_timed) -> tuple:
    """Phase 19 (b): phase 9's fit command with ``--trainer.cuda_graphs true``,
    FIT_STEPS micro-steps, sanity validation, validation at FIT_STEPS over
    FIT_GRAPH_VAL_BATCHES batch: every micro-step's logs (losses and gradient
    norm) and every array of ``last.npz`` (trainable and optimizer state)
    bit-equal to phase 9's first fit; micro-step 1 launches
    (TRAIN_WARMUP_STEPS + 1) x EXPECTED_TRAIN (the warm-ups and the capture),
    the others none, micro-step 2 under ``set_sync_debug_mode("error")``;
    each validation restore (a ``GraphedRestore`` replay) within one uint8
    level of the eager route's; s/step over micro-steps 2-FIT_STEPS (the card
    synchronised at both ends) against phase 9's timed eager fit
    (``eager_timed``) and the loader's wait. Returns (result, launches of
    the fit by kernel: the counters less the eager comparisons, plus each
    graph's launches at capture times its replays)."""
    from unirestore_torch.train import checkpoints as CKPT

    t0 = time.perf_counter()
    root = work / "fit_graph"
    args = ("--trainer.cuda_graphs", "true", "--trainer.val_check_interval", str(FIT_STEPS),
            "--trainer.limit_val_batches", str(FIT_GRAPH_VAL_BATCHES),
            "--trainer.log_every_n_steps", "1")
    KN.reset_counts()
    with RestoreCheck(TE, KN) as restores, StepProbe(TE, KN, bridge, sync_steps=(1,)) as probe, \
            WindowTimer(TE, FIT_STEPS) as window:
        _, trainer = main_fn(fit_argv("fit", work / "data", root, *args))
    fit_s = time.perf_counter() - t0
    launches = {kern.symbol: kern.launches - restores.eager_launches[kern.symbol]
                for kern in KN.KERNELS}
    steps = list(probe.step_fns.values())
    restore_graphs = [engine.graphed_restore()[0] for engine in restores.engines]
    for sym, n in graph_path_launches(KN, [s for g in (*steps, *restore_graphs)
                                           for s in g.stats.values()]).items():
        launches[sym] += n
    first = {s: tuple((GR.TRAIN_WARMUP_STEPS + 1) * n for n in c)
             for s, c in EXPECTED_TRAIN.items()}
    zero = {s: (0, 0, 0) for s in EXPECTED_TRAIN}
    counts_ok = (len(probe.counts) == FIT_STEPS and probe.counts[0] == first
                 and all(c == zero for c in probe.counts[1:])
                 and all(isinstance(s, GR.GraphedTrainStep) for s in steps))
    got = [{k: v.item() for k, v in e.items()} for e in probe.step_logs]
    unequal = {f"{i + 1} {k}": (g[k], w[k]) for i, (g, w) in
               enumerate(zip(got, reference16["logs_all"])) for k in w if g[k] != w[k]}
    flat, meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))
    want, want_meta = CKPT.load_checkpoint(str(reference16["last_npz"]))
    differ = [k for k in want if not np.array_equal(flat.get(k), want[k])]
    waits = trainer.timing["loader_waits_s"][1:]
    timed = {"steps": FIT_STEPS - 1, "wall_s": window.seconds,
             "s_per_step": window.seconds / (FIT_STEPS - 1),
             "loader_wait_mean_s": sum(waits) / len(waits),
             "eager_s_per_step_phase9": eager_timed["s_per_step"],
             "eager_loader_wait_mean_s_phase9": eager_timed["loader_wait_mean_s"]}
    (stats,) = steps[0].stats.values()
    log(f"graph fit (phase 9's command, --trainer.cuda_graphs true, {FIT_STEPS} micro-steps): "
        f"{fit_s:.1f} s; launches per micro-step {probe.counts[0]} then none: {counts_ok}; "
        f"warm-up {stats.warmup_seconds:.3f} s, capture {stats.capture_seconds:.3f} s; logs of "
        f"every micro-step vs phase 9's {'bit-equal' if not unequal else unequal}; last.npz at "
        f"step {meta['step']}: {len(want) - len(differ)} of {len(want)} arrays bit-equal to "
        f"phase 9's; {len(restores.levels)} validation restores replayed, largest difference "
        f"from the eager route {max(restores.levels, default=-1)} uint8 levels (max abs "
        f"{restores.max_abs:.3e}); micro-steps 2-{FIT_STEPS}: {timed['s_per_step']:.4f} s/step "
        f"(phase 9's eager {eager_timed['s_per_step']:.4f}), loader wait "
        f"{timed['loader_wait_mean_s'] * 1e3:.2f} ms/step (phase 9's "
        f"{eager_timed['loader_wait_mean_s'] * 1e3:.2f})")
    if (unequal or differ or not counts_ok or meta["step"] != want_meta["step"]
            or not restores.levels or max(restores.levels) > 1):
        raise AssertionError(f"graph fit differs from phase 9's: logs {unequal}, last.npz "
                             f"{differ[:5]}, launches {counts_ok}, restores {restores.levels}")
    result = {"seconds": fit_s, "logs_bit_equal_phase9": True, "last_npz_arrays_bit_equal":
              len(want), "launches_first_micro_step": probe.counts[0],
              "warmup_seconds": stats.warmup_seconds, "capture_seconds": stats.capture_seconds,
              "validation_restores": len(restores.levels),
              "restore_uint8_levels_max": max(restores.levels),
              "restore_max_abs": restores.max_abs, "timed": timed,
              "restore_graphs": {str(k): dataclasses.asdict(v) for g in restore_graphs
                                 for k, v in g.stats.items()}}
    del probe, trainer, restores, steps, restore_graphs
    torch.cuda.empty_cache()
    return result, launches



# ---------------------------------------------------------------------------
# phase 20: the graph route for stage 3 and for the validation networks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    body; yields the messages of the warnings it raised (the ops with no
    deterministic CUDA kernel name themselves there)."""
    import warnings

    named: list = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield named
        finally:
            torch.use_deterministic_algorithms(False)
    named.extend(sorted({str(w.message)[:160] for w in caught
                         if "deterministic" in str(w.message)}))
    for w in caught:  # the body's other warnings, as they would have shown
        if "deterministic" not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


def pool_gib(pool) -> float | None:
    """GiB the caching allocator's segments hold in a CUDA graph's private
    memory pool (``CUDAGraph.pool()``); None where the snapshot names no
    segment's pool."""
    snapshot = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in snapshot):
        return None
    return sum(seg["total_size"] for seg in snapshot
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool)) / 2**30


def det_batch(gen, res: int) -> dict:
    """A seeded bf16 pair of one at ``res`` px with phase 12's three boxes
    (scaled from 256 px) padded to 64."""
    batch = synthetic_pair(gen, 1, res, torch.bfloat16)
    scale = res / 256
    boxes = torch.zeros((1, 64, 4), device="cuda")
    boxes[0, :3] = scale * torch.tensor([[16.0, 24.0, 120.0, 140.0], [100.0, 40.0, 230.0, 200.0],
                                         [30.0, 150.0, 90.0, 250.0]])
    mask = torch.zeros((1, 64), dtype=torch.bool, device="cuda")
    mask[0, :3] = True
    labels = torch.zeros((1, 64), dtype=torch.int64, device="cuda")
    labels[0, :3] = torch.tensor([1, 3, 18])
    batch["gt"] = {"boxes": boxes, "labels": labels, "mask": mask}
    return batch


def within_train_limits(eager, graph) -> dict:
    """Phase 12's card-vs-CPU limits between two micro-steps (logs, state
    snapshot): each loss within TRAIN_LOSS_RTOL relative, the gradient norm
    and each leaf's and slot's norm of the difference within TRAIN_GRAD_RTOL
    of its own."""
    (el, es), (gl, gs) = eager, graph
    loss = max(abs(gl[k] - el[k]) / max(abs(el[k]), 1e-30) for k in el if k != "train/grad_norm")
    norm = abs(gl["train/grad_norm"] - el["train/grad_norm"]) / el["train/grad_norm"]
    state = max(((gs[k].double() - es[k].double()).norm() / es[k].double().norm().clamp_min(1e-30))
                .item() for k in es if isinstance(es[k], torch.Tensor))
    return {"loss_rel": loss, "grad_norm_rel": norm, "state_norm_rel": state,
            "ok": loss <= TRAIN_LOSS_RTOL and norm <= TRAIN_GRAD_RTOL and state <= TRAIN_GRAD_RTOL}


def run_graph_stage3(UR, KN, bridge, TS, TE, OPT, GR):
    """Phase 20 (a): the stage-3 step (full width with TFA's four tasks, bf16
    frozen and fp32 TFA masters seeded 21, only the task prompts trained,
    AdamW from the stage-1 YAML's kwargs at accumulation 1) through each
    detector of STAGE3_GRAPH_DETECTORS on a 512 px batch of one with three
    boxes, eager and from its graph (a ``GraphedTrainStep`` with a cache of its
    own: the two steps share a task). Two eager micro-steps from one state
    are compared in the default mode first; then under deterministic
    algorithms two eager micro-steps and the graph's first call (two warm-ups
    and the capture) from one state give bit-equal logs, trained leaves and
    slots, or, where an op names itself as having no deterministic CUDA
    kernel, agree within phase 12's card-vs-CPU limits; launches at capture
    EXPECTED_STAGE3, the first call three times it, a replay none; then one
    synchronised micro-step of each route in that mode. Returns (result,
    launches of the graph route by kernel)."""
    t0 = time.perf_counter()
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg", "det"))
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=21,
                                    trainable_dtype=torch.float32)
    stage = TS.StageConfig(train_cfrm=False, train_cnet=False, train_tfa=True,
                           tfa_prompts_only=True, multi_task=True)
    tx, _ = OPT.build(STAGE1_OPT, STAGE1_SCHED, STAGE1_MAX_STEPS, 1, 1, 1)
    opt_state = tx.init(TS.trained_leaves(stage, trainable))
    sched = UR.schedule(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(22)
    batch = det_batch(gen, RES)
    noise = TS.draw_noise(cfg, batch, gen)
    out = {"build_seconds": time.perf_counter() - t0}
    launches = {kern.symbol: 0 for kern in KN.KERNELS}
    zero = {s: (0, 0, 0) for s in EXPECTED_STAGE3}
    warm = {s: tuple((GR.TRAIN_WARMUP_STEPS + 1) * n for n in c)
            for s, c in EXPECTED_STAGE3.items()}
    for downstream in STAGE3_GRAPH_DETECTORS:
        te_fn = TE.make_te_loss_fn("det", TE.build_critics("det", downstream, device="cuda"),
                                   downstream)
        routes = {"eager": TS.make_train_step(frozen, cfg, sched, stage, tx, "det",
                                              te_loss_fn=te_fn),
                  "graph": GR.GraphedTrainStep(frozen, cfg, sched, stage, tx, "det",
                                               te_loss_fn=te_fn, device="cuda")}
        start = split_state_snapshot(TS, stage, trainable, opt_state)

        def micro_step(route):
            """One synchronised micro-step from ``start``: (logs, state after,
            seconds, launch counts)."""
            restore_state(TS, stage, trainable, opt_state, start)
            torch.cuda.synchronize()
            KN.reset_counts()
            t1 = time.perf_counter()
            logs = routes[route](trainable, opt_state, batch, noise)[2]
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            return ({k: v.item() for k, v in logs.items()},
                    split_state_snapshot(TS, stage, trainable, opt_state), sec,
                    train_counts(KN))

        default = [micro_step("eager") for _ in range(2)]
        spread = snapshot_equal(default[0][1], default[1][1])
        with deterministic_algorithms() as named:
            graph = micro_step("graph")
            held = pool_gib(routes["graph"]._cache.values()[0].graph.pool())
            eager = [micro_step("eager") for _ in range(2)]
            timed = {route: micro_step(route) for route in ("graph", "eager")}
        (stats,) = routes["graph"].stats.values()
        unequal = snapshot_equal(eager[0][1], graph[1])
        repeat = snapshot_equal(eager[0][1], eager[1][1])
        bit_equal = eager[0][0] == graph[0] == eager[1][0] and not unequal and not repeat
        limits = None if bit_equal else within_train_limits(eager[0][:2], graph[:2])
        moved = sum(not torch.equal(graph[1][k], start[k]) for k in start
                    if k.startswith("trainable/"))
        counts_ok = (stats.launches == EXPECTED_STAGE3 and graph[3] == warm
                     and timed["graph"][3] == zero and timed["eager"][3] == EXPECTED_STAGE3)
        ok = (counts_ok and moved and all(math.isfinite(v) for v in graph[0].values())
              and (bit_equal or (named and limits["ok"])))
        log(f"graph step (20 a), stage 3 {downstream}: default mode, two eager micro-steps from "
            f"one state differ in {len(spread)} of {len(start)} trained leaves and slots; "
            f"deterministic algorithms: eager vs graph "
            f"{'bit-equal' if bit_equal else f'differ in {len(unequal)} ({limits})'} "
            f"({len(repeat)} differ between the two eager runs; {moved} leaves moved); ops "
            f"without a deterministic kernel named: {named or 'none'}; launches at capture "
            f"{stats.launches}, first call {graph[3]}, replay {timed['graph'][3]}: {counts_ok}; "
            f"warm-up {stats.warmup_seconds:.3f} s, capture {stats.capture_seconds:.3f} s, its "
            f"pool {held} GiB; a micro-step eager {timed['eager'][2] * 1e3:.1f} ms, replayed "
            f"{timed['graph'][2] * 1e3:.1f} ms (default-mode eager {default[1][2] * 1e3:.1f} ms)")
        if not ok:
            raise AssertionError(f"stage-3 {downstream}: the graph step differs from the eager "
                                 f"one: {unequal[:5]}, eager repeat {repeat[:5]}, limits "
                                 f"{limits}, launches {stats.launches}, first call {graph[3]}")
        for sym, n in graph[3].items():
            launches[sym] += sum(n[:2])
        for sym, n in graph_path_launches(KN, [stats]).items():
            launches[sym] += n
        out[downstream] = {"logs": graph[0], "bit_equal": bit_equal, "limits": limits,
                           "nondeterministic_ops": named, "leaves_and_slots": len(start),
                           "moved": moved, "default_mode_eager_repeat_differ": len(spread),
                           "launches_at_capture": stats.launches,
                           "warmup_seconds": stats.warmup_seconds,
                           "capture_seconds": stats.capture_seconds, "pool_gib": held,
                           "replays": stats.replays,
                           "ms": {"eager": timed["eager"][2] * 1e3,
                                  "graph": timed["graph"][2] * 1e3,
                                  "eager_default_mode": default[1][2] * 1e3}}
        del routes, start, default, eager, graph, timed, te_fn
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    del frozen, trainable, opt_state
    torch.cuda.empty_cache()
    return out, launches


def run_fit3_graph(KN, bridge, TE, GR, main_fn, work: Path, eager12_s: float) -> tuple:
    """Phase 20 (b): phase 12's RetinaNet fit command for FIT3_GRAPH_STEPS
    micro-steps at that accumulation (one update), under deterministic
    algorithms (the detector's resizes differentiate through ``index_add_``,
    whose default CUDA kernel adds atomically): eagerly without validation,
    the reference, then with ``--trainer.cuda_graphs true`` and validation
    at the last micro-step over FIT3_GRAPH_VAL_BATCHES batch. Every
    micro-step's logs and every array of ``last.npz`` bit-equal between the
    two; eager micro-steps launch EXPECTED_STAGE3 each; on the graph route
    micro-step 1 launches (TRAIN_WARMUP_STEPS + 1) x EXPECTED_STAGE3, the
    others none, micro-step 2 under ``set_sync_debug_mode("error")``; each
    validation restore (a ``GraphedRestore`` replay) within one uint8 level
    of the eager route's; s per micro-step over micro-steps
    2-FIT3_GRAPH_STEPS (the card synchronised at both ends) of each route,
    beside phase 12's default-mode fit (``eager12_s``). Returns (result,
    launches of the graph fit by kernel: the counters less the eager
    comparisons, plus each graph's launches at capture times its
    replays)."""
    from unirestore_torch.train import checkpoints as CKPT

    t0 = time.perf_counter()
    args = ("--trainer.max_steps", str(FIT3_GRAPH_STEPS), "--trainer.accumulate_grad_batches",
            str(FIT3_GRAPH_STEPS), "--trainer.limit_val_batches", str(FIT3_GRAPH_VAL_BATCHES))
    eager_root = work / "stage3_deterministic"
    KN.reset_counts()
    with deterministic_algorithms() as eager_named, \
            StepProbe(TE, KN, bridge, sync_steps=()) as eager, \
            WindowTimer(TE, FIT3_GRAPH_STEPS) as eager_window:
        main_fn(fit3_argv("fit", work, eager_root, *args, "--trainer.val_check_interval", "0"))
    eager_s = time.perf_counter() - t0
    if len(eager.counts) != FIT3_GRAPH_STEPS or any(c != EXPECTED_STAGE3 for c in eager.counts):
        raise AssertionError(f"20 (b) eager reference: launches per micro-step {eager.counts}")
    reference = [{k: v.item() for k, v in e.items()} for e in eager.step_logs]
    del eager
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    root = work / "stage3_graph"
    KN.reset_counts()
    with deterministic_algorithms() as named, RestoreCheck(TE, KN) as restores, \
            StepProbe(TE, KN, bridge, sync_steps=(1,)) as probe, \
            WindowTimer(TE, FIT3_GRAPH_STEPS) as window:
        engine, trainer = main_fn(fit3_argv("fit", work, root, "--trainer.cuda_graphs", "true",
                                            "--trainer.val_check_interval",
                                            str(FIT3_GRAPH_STEPS), *args))
    fit_s = time.perf_counter() - t0
    launches = {kern.symbol: kern.launches - restores.eager_launches[kern.symbol]
                for kern in KN.KERNELS}
    steps = list(probe.step_fns.values())
    restore_graphs = [e.graphed_restore()[0] for e in restores.engines]
    for sym, n in graph_path_launches(KN, [s for g in (*steps, *restore_graphs)
                                           for s in g.stats.values()]).items():
        launches[sym] += n
    first = {s: tuple((GR.TRAIN_WARMUP_STEPS + 1) * n for n in c)
             for s, c in EXPECTED_STAGE3.items()}
    zero = {s: (0, 0, 0) for s in EXPECTED_STAGE3}
    counts_ok = (len(probe.counts) == FIT3_GRAPH_STEPS and probe.counts[0] == first
                 and all(c == zero for c in probe.counts[1:])
                 and all(isinstance(s, GR.GraphedTrainStep) for s in steps)
                 and probe.tasks == ["det"] * FIT3_GRAPH_STEPS)
    got = [{k: v.item() for k, v in e.items()} for e in probe.step_logs]
    unequal = {f"{i + 1} {k}": (g[k], w[k]) for i, (g, w) in
               enumerate(zip(got, reference)) for k in w if g.get(k) != w[k]}
    flat, meta = CKPT.load_checkpoint(str(root / "checkpoints" / "last.npz"))
    want, want_meta = CKPT.load_checkpoint(str(eager_root / "checkpoints" / "last.npz"))
    differ = [k for k in want if not np.array_equal(flat.get(k), want[k])]
    metrics = probe.metrics
    waits = trainer.timing["loader_waits_s"][1:]
    timed = {"micro_steps": FIT3_GRAPH_STEPS - 1, "wall_s": window.seconds,
             "s_per_micro_step": window.seconds / (FIT3_GRAPH_STEPS - 1),
             "loader_wait_mean_s": sum(waits) / len(waits),
             "eager_s_per_micro_step": eager_window.seconds / (FIT3_GRAPH_STEPS - 1),
             "eager_s_per_micro_step_phase12_default_mode": eager12_s}
    (stats,) = steps[0].stats.values()
    log(f"graph fit (20 b; phase 12's RetinaNet command, {FIT3_GRAPH_STEPS} micro-steps, "
        f"deterministic algorithms): eager reference {eager_s:.1f} s; "
        f"--trainer.cuda_graphs true {fit_s:.1f} s; launches per micro-step "
        f"{probe.counts[0]} then none: {counts_ok}; warm-up {stats.warmup_seconds:.3f} s, "
        f"capture {stats.capture_seconds:.3f} s; logs of every micro-step vs the eager "
        f"reference's {'bit-equal' if not unequal else unequal}; last.npz at step "
        f"{meta['step']}: {len(want) - len(differ)} of {len(want)} arrays bit-equal; "
        f"{len(restores.levels)} validation restores replayed, largest difference from the "
        f"eager route {max(restores.levels, default=-1)} uint8 levels (max abs "
        f"{restores.max_abs:.3e}); validation {metrics}; micro-steps 2-{FIT3_GRAPH_STEPS}: "
        f"{timed['s_per_micro_step']:.4f} s a micro-step (eager "
        f"{timed['eager_s_per_micro_step']:.4f} in this mode, phase 12's {eager12_s:.4f} in the "
        f"default mode), loader wait {timed['loader_wait_mean_s'] * 1e3:.2f} ms; ops without a "
        f"deterministic kernel named: {sorted(set(named) | set(eager_named)) or 'none'}")
    if (unequal or differ or not counts_ok or meta["step"] != want_meta["step"]
            or not restores.levels or max(restores.levels) > 1 or len(metrics) != 1
            or set(metrics[0]) != {"val_lq/map", "val_monitor"}):
        raise AssertionError(f"stage-3 graph fit differs from the eager reference: logs "
                             f"{unequal}, last.npz {differ[:5]}, launches {counts_ok}, restores "
                             f"{restores.levels}, validation {metrics}")
    result = {"seconds": fit_s, "eager_reference_seconds": eager_s, "logs_bit_equal": True,
              "last_npz_arrays_bit_equal": len(want), "launches_first_micro_step": first,
              "warmup_seconds": stats.warmup_seconds, "capture_seconds": stats.capture_seconds,
              "validation_restores": len(restores.levels),
              "restore_uint8_levels_max": max(restores.levels),
              "restore_max_abs": restores.max_abs, "validation": metrics[0], "timed": timed,
              "nondeterministic_ops": sorted(set(named) | set(eager_named)),
              "restore_graphs": {str(k): dataclasses.asdict(v) for g in restore_graphs
                                 for k, v in g.stats.items()}}
    del probe, engine, trainer, restores, steps, restore_graphs
    torch.cuda.empty_cache()
    return result, launches


def validation_networks(bridge, TE):
    """(name, fn(*inputs) -> one tensor, input shapes) of every network the
    JAX package jits in validation, each built on the card when it is
    reached: the zoos' probes (each classifier spec, ``dlv3pr50``,
    ``rflwr101``), the stage-2 probes over the ``mtl`` critics, LPIPS, the NR
    suite's networks and FID's Inception, seeded."""
    from unirestore_torch import tasks
    from unirestore_torch.evalx import lpips as LP
    from unirestore_torch.evalx import nr_suite as NRS
    from unirestore_torch.tasks import seg_zoo as SZ

    for name in probe_names():
        tree, apply = bridge.probe_init(name, "cuda"), probe_apply(name)
        kind = "seg" if name in SZ._WEIGHTS else "cls"
        yield name, lambda x, t=tree, a=apply: a(t, x).float(), (PROBE_SHAPES[kind],)
        del tree
    critics = TE.build_critics("mtl", device="cuda")
    for task in ("cls", "seg"):
        yield (f"mtl_{task}", lambda x, t=task: tasks.critic_apply(t, critics[t], x).float(),
               (PROBE_SHAPES[task],))
    del critics
    model = LP.make_lpips(device="cuda").model
    yield "lpips", lambda x, y: model(x, y).float(), (NR_SHAPE, NR_SHAPE)
    del model
    for name in NRS.NETS:
        tree, score = bridge.nr_init(name, "cuda"), NRS.NETS[name][1]
        cast = torch.Tensor.float if name == "inception" else torch.Tensor.double
        yield name, lambda x, t=tree, f=score, c=cast: c(f(t, x)), (NR_SHAPE,)
        del tree


def run_graph_networks(KN, bridge, TE, EV, GR, gen) -> dict:
    """Phase 20 (c): every validation network (``validation_networks``) on one
    seeded batch, eagerly (``evaluators.network_call``) and from its graph
    (``graphs.GraphedCall``), under deterministic algorithms: the outputs of
    the first call and of a replay bit-equal to the eager call's; no launch
    of the repo's kernels; per network the host ms of a call (upload, network,
    read-back) of each route over GRAPH_NET_CALLS calls, the card's busy ms in
    a profiled call of each route, the warm-up and capture seconds."""
    t0 = time.perf_counter()
    out = {}
    with deterministic_algorithms() as named:
        for name, fn, shapes in validation_networks(bridge, TE):
            xs = [torch.rand(s, generator=gen, device="cuda").cpu().numpy() for s in shapes]
            eager, graphed = EV.network_call(fn, "cuda"), GR.GraphedCall(fn, "cuda")
            KN.reset_counts()
            want = eager(*xs)
            t1 = time.perf_counter()
            for _ in range(GRAPH_NET_CALLS):
                eager(*xs)
            eager_ms = (time.perf_counter() - t1) / GRAPH_NET_CALLS * 1e3
            t1 = time.perf_counter()
            got = graphed(*xs)
            first_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            for _ in range(GRAPH_NET_CALLS):
                again = graphed(*xs)
            graph_ms = (time.perf_counter() - t1) / GRAPH_NET_CALLS * 1e3
            busy = profiled_device(lambda: graphed(*xs))["device_busy_s"] * 1e3
            eager_busy = profiled_device(lambda: eager(*xs))["device_busy_s"] * 1e3
            launches = sum(kern.launches for kern in KN.KERNELS)
            (stats,) = graphed.stats.values()
            held = pool_gib(graphed._cache.values()[0].graph.pool())
            equal = torch.equal(want, got) and torch.equal(want, again)
            row = {"inputs": [list(s) for s in shapes], "output": list(want.shape),
                   "bit_equal": equal, "eager_ms": eager_ms, "graph_ms": graph_ms,
                   "graph_busy_ms": busy, "eager_busy_ms": eager_busy, "first_call_s": first_s,
                   "warmup_seconds": stats.warmup_seconds,
                   "capture_seconds": stats.capture_seconds, "pool_gib": held,
                   "repo_kernel_launches": launches}
            log(f"graph network (20 c) {name}: {[tuple(s) for s in shapes]} -> "
                f"{tuple(want.shape)}; replay vs eager {'bit-equal' if equal else 'DIFFERS'}; "
                f"{eager_ms:.3f} ms a call eager, {graph_ms:.3f} replayed (host clock, to the "
                f"read-back), card busy {busy:.3f} ms a replay, {eager_busy:.3f} an eager "
                f"call; warm-up {stats.warmup_seconds:.3f} s, capture "
                f"{stats.capture_seconds:.3f} s, its pool {held} GiB; repo kernel launches "
                f"{launches}")
            if not equal or launches or not torch.isfinite(want.double()).all():
                raise AssertionError(f"graph network {name}: replay vs eager equal {equal}, "
                                     f"{launches} repo kernel launches")
            out[name] = row
            del eager, graphed, want, got, again, fn
            torch.cuda.empty_cache()
    out["nondeterministic_ops"] = named
    out["seconds"] = time.perf_counter() - t0
    return out


def mixed_cls_list(work: Path) -> Path:
    """A cls list of one seeded random image of each VAL20_MIXED_SIZES size."""
    from unirestore_torch.ops import png

    rng = np.random.default_rng(20)
    rows = []
    for i, (h, w) in enumerate(VAL20_MIXED_SIZES):
        path = work / "data" / "images" / f"cls_mixed{i}.png"
        path.write_bytes(png.encode(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
        rows.append(f"None {path} {i % 5}")
    lst = work / "data" / "lists" / "cls_mixed.list"
    lst.write_text("\n".join(rows) + "\n")
    return lst


def run_validate_graphs(KN, TE, bridge, main_fn, work: Path, nr14: dict) -> dict:
    """Phase 20 (d): phase 14's NR validate, and phase 13's cls all_ft
    validate over one image of each VAL20_MIXED_SIZES size, eagerly and then
    with ``--trainer.cuda_graphs true`` (NR's eager run is phase 14's, its
    row ``nr14``): the keys and values equal; every restore and network call
    of a second validation on the graph route is a replay; captures per
    image and s per image of the first validation (on the graph route the
    cls run captures at every image) and of the second (its networks and
    graphs built) on each route."""
    from unirestore_torch.evalx.nr_suite import NeuralNR

    t0 = time.perf_counter()
    mixed = mixed_cls_list(work)
    runs = {"NR": lambda *flag: val14_argv(work, work / "validate20_NR", "NR", False) + [*flag],
            "cls_all_ft": lambda *flag: fit13_argv(
                "validate", work, work / "validate20_all_ft", "cls", "all_ft",
                "--data.init_args.dataset_dict.ImageNet.val", str(mixed),
                "--trainer.limit_val_batches", str(len(VAL20_MIXED_SIZES)), *flag)}
    images = {"NR": VAL14_IMAGES, "cls_all_ft": len(VAL20_MIXED_SIZES)}
    out = {}
    for name, argv in runs.items():
        row, got = {}, {}
        if name == "NR":
            got["eager"] = nr14["validation"]
            row["eager"] = {"phase": 14, "run_seconds": nr14["run_seconds"],
                            "validation_seconds_first": nr14["validation_seconds"],
                            "validation_s_per_image_first": nr14["validation_s_per_image"],
                            "captures_per_image_first": 0.0,
                            "validation_seconds": nr14["validation_seconds_second"],
                            "validation_s_per_image":
                                nr14["validation_seconds_second"] / images[name]}
        routes = (("graph", ("--trainer.cuda_graphs", "true")),)
        if name != "NR":
            routes = (("eager", ()), *routes)
        for route, flag in routes:
            t1 = time.perf_counter()
            with StepProbe(TE, KN, bridge) as probe:
                engine, trainer = main_fn(argv(*flag))
            run_s = time.perf_counter() - t1
            (got[route],) = probe.metrics
            graphs, evaluator, nets = [], None, []
            if route == "graph":
                evaluator = probe.val_args[2](probe.val_args[0])
                nets = ([m.call for m in evaluator.nr["lq"].values() if isinstance(m, NeuralNR)]
                        if name == "NR" else [c.call for c in evaluator.classifiers.values()])
                graphs = [*nets, engine.graphed_restore()[0]]
            before = [sum(s.replays for s in g.stats.values()) for g in graphs]
            captures = sum(s.captures for g in graphs for s in g.stats.values())
            KN.reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.validate(*probe.val_args)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t1
            launches = sum(kern.launches for kern in KN.KERNELS)
            replayed = [sum(s.replays for s in g.stats.values()) - b
                        for g, b in zip(graphs, before)]
            recaptured = sum(s.captures for g in graphs for s in g.stats.values()) - captures
            row[route] = {"run_seconds": run_s, "validation_seconds_first": probe.val_seconds[0],
                          "validation_s_per_image_first": probe.val_seconds[0] / images[name],
                          "captures_per_image_first": captures / images[name],
                          "validation_seconds": warm_s,
                          "validation_s_per_image": warm_s / images[name],
                          "graphs": len(graphs), "captures": captures, "replays": replayed,
                          "launches": launches}
            if route == "graph" and (recaptured or launches or not all(replayed)):
                raise AssertionError(f"graph validate {name}: recaptured {recaptured}, "
                                     f"launches {launches}, replays {replayed}")
            del probe, engine, trainer, graphs, evaluator, nets
            torch.cuda.empty_cache()
        unequal = {k: (got["graph"].get(k), v) for k, v in got["eager"].items()
                   if got["graph"].get(k) != v}
        e, g = row["eager"], row["graph"]
        log(f"graph validate (20 d) {name} ({images[name]} images): keys and values of the "
            f"graph route vs the eager "
            f"{'equal' if not unequal and set(got['graph']) == set(got['eager']) else unequal}; "
            f"{g['graphs']} graph routes (the networks and the restore), {g['captures']} "
            f"captures ({g['captures_per_image_first']:.2f} an image); the first validation "
            f"{e['validation_s_per_image_first']:.3f} s per image eager, "
            f"{g['validation_s_per_image_first']:.3f} with graphs (captures included); a "
            f"second validation {e['validation_s_per_image']:.3f} s per image eager, "
            f"{g['validation_s_per_image']:.3f} replayed (replays {g['replays']}, no "
            f"capture, {g['launches']} kernel launches); runs {e['run_seconds']:.1f} "
            f"({'phase 14' if e.get('phase') else 'here'}) and {g['run_seconds']:.1f} s")
        if unequal or set(got["graph"]) != set(got["eager"]):
            raise AssertionError(f"graph validate {name}: metrics {unequal}")
        out[name] = {**row, "validation": got["graph"]}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 21: from a checkpoint file to a restore
# ---------------------------------------------------------------------------


def converted_trees(bridge) -> dict:
    """Phase 21's seeded full-width VAE and UNet on the host: the seed-
    CONVERT_SEED init, each constant leaf (norm scales, zero biases) redrawn
    around its value, so that no leaf equals the seed-0 init's."""
    from unirestore_torch.models import unet as UN
    from unirestore_torch.models import vae as VAE
    from unirestore_torch.nn.init import make_init

    ini = make_init(None, "cpu", seed=CONVERT_SEED)
    trees = {"vae": VAE.vae_init(ini, VAE.VAEConfig()), "unet": UN.unet_init(ini, UN.UNetConfig())}
    gen = torch.Generator().manual_seed(CONVERT_SEED)
    for leaf in bridge.flatten(trees).values():
        if leaf.min() == leaf.max():
            leaf.normal_(leaf.flatten()[0].item(), 0.02, generator=gen)
    return trees


def diffusers_name(key: str) -> str:
    """The name diffusers gives a leaf of the port's VAE or UNet tree (its flat
    ``//`` key): ``AutoencoderKL`` / ``UNet2DConditionModel`` module paths."""
    k = re.sub(r"mid//resnet(\d)", lambda m: f"mid_block//resnets//{int(m[1]) - 1}", key)
    k = k.replace("mid//attn//", "mid_block//attentions//0//")
    k = re.sub(r"(attentions//\d+//)attn//", r"\1", k)  # the VAE's mid-block attention
    k = re.sub(r"(attentions//\d+//)blocks//", r"\1transformer_blocks//", k)
    k = k.replace("ff_in//", "ff//net//0//proj//").replace("ff_out//", "ff//net//2//")
    k = k.replace("to_out//", "to_out//0//")
    k = k.replace("downsample//", "downsamplers//0//").replace("upsample//", "upsamplers//0//")
    stem, leaf = k.rsplit("//", 1)
    return stem.replace("//", ".") + "." + {"w": "weight", "b": "bias", "scale": "weight",
                                            "bias": "bias"}[leaf]


def diffusers_state_dict(bridge, tree) -> dict:
    """The port's tree as a diffusers state dict of fp32 numpy arrays: conv
    kernels OIHW as the port holds them, linear kernels (out, in)."""
    out = {}
    for key, t in bridge.flatten(tree).items():
        arr = t.numpy()
        if key.endswith("//w") and arr.ndim == 2:
            arr = arr.T
        out[diffusers_name(key)] = np.ascontiguousarray(arr, np.float32)
    return out


def write_safetensors(path: Path, tensors: dict) -> int:
    """Write fp32 ``tensors`` as a ``.safetensors`` file (an 8-byte
    little-endian header length, the JSON header padded with spaces to 8
    bytes, the data); returns its bytes."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, arr in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for arr in tensors.values():
            f.write(np.ascontiguousarray(arr, "<f4").data)
    return 8 + len(raw) + offset


def convert_needs_bytes(bridge) -> int:
    """Free bytes phase 21 needs: the fp32 source and the converted npz of the
    full-width VAE and UNet, and CONVERT_SPARE_BYTES."""
    from unirestore_torch.models import unet as UN
    from unirestore_torch.models import vae as VAE
    from unirestore_torch.nn.init import make_init

    meta = make_init(device="meta")
    trees = {"vae": VAE.vae_init(meta, VAE.VAEConfig()), "unet": UN.unet_init(meta, UN.UNetConfig())}
    return 2 * 4 * sum(t.numel() for t in bridge.flatten(trees).values()) + CONVERT_SPARE_BYTES


def convert_reference_cpu(root: str) -> dict:
    """Reference job: phase 21 (a)'s host work. The seeded tree written as a
    diffusers sd-turbo directory under ``root/sd-turbo``, converted by
    ``python -m unirestore_torch.convert sd_turbo`` into ``root/weights``;
    the source is removed after. Returns seconds, bytes and tensor counts."""
    from unirestore_torch import bridge

    root = Path(root)
    src = root / "sd-turbo"
    t0 = time.perf_counter()
    trees = converted_trees(bridge)
    out = {"init_s": time.perf_counter() - t0, "source_bytes": {}, "tensors": {}}
    t0 = time.perf_counter()
    for sub in ("vae", "unet"):
        sd = diffusers_state_dict(bridge, trees.pop(sub))
        path = src / sub / "diffusion_pytorch_model.safetensors"
        out["source_bytes"][sub] = write_safetensors(path, sd)
        out["tensors"][sub] = len(sd)
        del sd
    out["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "unirestore_torch.convert", "sd_turbo", str(src),
                          str(root / "weights")], cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    out["convert_s"] = time.perf_counter() - t0
    out["convert_stdout"] = res.stdout.splitlines()
    if res.returncode:
        raise AssertionError(f"the converter exited {res.returncode}:\n{res.stderr[-3000:]}")
    out["npz_bytes"] = {p.stem: p.stat().st_size for p in (root / "weights").glob("*.npz")}
    shutil.rmtree(src)
    return out


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's default TF32 flags (cuDNN on, matmul off), which a process
    started from the command line runs with, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def run_phase21(UR, KN, bridge, refs, root: Path) -> tuple:
    """Phase 21: (a) the converted files against the seeded tree, (b) the
    sweep in this process against direct restores, (c) the sweep's command
    line (started first, read last). Returns (results, launches of the path)."""
    from unirestore_torch import cache_quality as CQ
    from unirestore_torch import zoo

    t_phase = time.perf_counter()
    result = {"convert": refs.result("phase 21")}
    conv = result["convert"]
    wrote = [f"wrote sd_turbo_{sub}.npz ({conv['tensors'][sub]} tensors)" for sub in ("vae", "unet")]
    if conv["convert_stdout"] != wrote:
        raise AssertionError(f"converter said {conv['convert_stdout']}, expected {wrote}")
    weights = root / "weights"
    spec = next(s for s in SWEEP_SPECS if s.startswith("deep:"))
    _, stride, warmup = spec.split(":")
    t_cli = time.perf_counter()
    cli = subprocess.Popen([sys.executable, "-m", "unirestore_torch.cache_quality", "--modes", "deep",
                            "--strides", stride, "--warmups", warmup, "--batch", str(SWEEP_BATCH),
                            "--size", str(RES), "--steps", str(STEPS), "--weights-dir", str(weights)],
                           cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the seeded tree drawn again on the host (a thread: the draws release the
    # GIL) while the files load
    drawing = concurrent.futures.ThreadPoolExecutor(1)
    seeded = drawing.submit(converted_trees, bridge)
    try:
        # (a) every VAE and UNet leaf from the files, bit-equal to the seeded tree
        cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
        frozen, trainable = UR.init(cfg, device="cuda", seed=0)
        t0 = time.perf_counter()
        loaded = zoo.load_frozen_backbone(frozen, cfg, weights)
        torch.cuda.synchronize()
        result["load_s"] = time.perf_counter() - t0
        seeded = seeded.result()
        direct = dict(frozen)
        bad, leaves = [], 0
        for part in ("vae", "unet"):
            want = {k: v.to("cuda") for k, v in bridge.flatten(seeded.pop(part)).items()}
            got, init = bridge.flatten(loaded[part]), bridge.flatten(frozen[part])
            leaves += len(want)
            bad += [f"{part}//{k}" for k in want if k not in got or not torch.equal(got[k], want[k])
                    or torch.equal(init[k], want[k])]
            # the seeded tree laid out as bridge.load_tree lays out a file's
            direct[part] = bridge.unflatten_like(
                {k: v.contiguous(memory_format=torch.channels_last) if v.ndim == 4 else v
                 for k, v in want.items()}, frozen[part])
        result["leaves_from_file"] = leaves - len(bad)
        log(f"phase 21 (a): {leaves - len(bad)} of {leaves} VAE and UNet leaves taken from the "
            f"converted files, bit-equal to the seeded tree; source {conv['source_bytes']} bytes "
            f"written in {conv['write_s']:.1f} s (tree drawn in {conv['init_s']:.1f} s), converted "
            f"in {conv['convert_s']:.1f} s to {conv['npz_bytes']} bytes, loaded onto the card in "
            f"{result['load_s']:.1f} s")
        if bad:
            raise AssertionError(f"phase 21 (a): {len(bad)} leaves not from the file: {bad[:8]}")
        # (b) the sweep (its model as cache_quality.build makes it: the seed-0
        # init with the files merged in, bf16) against restore_padded of the
        # seeded tree
        loaded, direct, trainable = (bridge.cast_tree(t, torch.bfloat16)
                                     for t in (loaded, direct, trainable))
        del frozen, seeded
        images, noise = CQ.make_inputs(cfg, SWEEP_BATCH, RES, "cuda")
        raw, counts = {}, {}

        def seen(spec, out):
            torch.cuda.synchronize()
            raw[spec], counts[spec] = out, counts_of(KN)
            KN.reset_counts()

        launches = {kern.symbol: 0 for kern in KN.KERNELS}
        with torch_default_tf32():
            t0 = time.perf_counter()
            KN.reset_counts()
            _, rows = CQ.sweep(loaded, trainable, cfg, images, noise, list(SWEEP_SPECS), STEPS,
                               device="cuda", on_restore=seen)
            result["sweep_s"] = time.perf_counter() - t0
            for spec, mode in SWEEP_SPECS.items():
                for kern, n in zip(KN.KERNELS, counts[spec]):
                    launches[kern.symbol] += n
                want = UR.restore_padded(direct, trainable, CQ.config_for(cfg, spec),
                                         UR.schedule(cfg, device="cuda"), images, "ir",
                                         num_inference_steps=STEPS, posterior_noise=noise[0],
                                         diffusion_noise=noise[1], device="cuda")
                equal = torch.equal(raw[spec], want)
                result[spec] = {"launches": counts[spec], "bit_equal_direct": equal,
                                "levels_vs_direct": uint8_levels(raw[spec], want)}
                if not equal or counts[spec] != EXPECTED[mode] or not torch.isfinite(want).all():
                    raise AssertionError(f"phase 21 (b) {spec}: {result[spec]}, phase 4's "
                                         f"launches {EXPECTED[mode]}")
        result["rows"] = rows
        log(f"phase 21 (b): the sweep from the converted files, {list(SWEEP_SPECS)} at {RES} px, "
            f"batch {SWEEP_BATCH}, {STEPS} steps in {result['sweep_s']:.1f} s: each output "
            f"bit-equal to restore_padded of the seeded tree, launches per restore "
            f"{[counts[s] for s in SWEEP_SPECS]} (phase 4's); rows {rows}")
        # (c) the command line's row
        stdout, stderr = cli.communicate(timeout=900)
        result["cli_s"] = time.perf_counter() - t_cli
        if cli.returncode:
            raise AssertionError(f"cache_quality exited {cli.returncode}:\n{stderr[-3000:]}")
        cli_rows = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
        result["cli_rows"] = cli_rows
        deep = [r for r in rows if r["mode"] == "deep"]
        log(f"phase 21 (c): python -m unirestore_torch.cache_quality --modes deep --strides "
            f"{stride} --warmups {warmup}: {cli_rows} in {result['cli_s']:.1f} s (beside (a) and "
            f"(b)), the in-process row {deep}")
        if cli_rows != deep:
            raise AssertionError(f"phase 21 (c): the command line's rows {cli_rows} != {deep}")
    finally:
        drawing.shutdown(cancel_futures=True)
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    result["phase_seconds"] = time.perf_counter() - t_phase
    return result, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    refs = CpuReferences()
    convert_root = Path(tempfile.mkdtemp(prefix="chip_smoke_convert_"))
    try:
        rc = run_phases(refs, convert_root)
    except BaseException:
        refs.close(wait=False)
        raise
    finally:
        shutil.rmtree(convert_root, ignore_errors=True)
    refs.close()
    return rc


def run_phases(refs, convert_root: Path) -> int:
    """Every phase in order; the CPU halves of the card-vs-CPU checks and
    phase 21's conversion run in ``refs``' worker and are read later.
    ``convert_root`` is phase 21's directory outside the repository."""
    from unirestore_torch import bridge, serve
    from unirestore_torch import graphs as GR
    from unirestore_torch import main as TMAIN
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.nn import attention_kernels as K
    from unirestore_torch.nn import grouped_conv as G
    from unirestore_torch.nn import kernels as KN
    from unirestore_torch.ops import png
    from unirestore_torch.train import engine as TE
    from unirestore_torch.train import optim as OPT
    from unirestore_torch.train import steps as TS

    clock = {"start": time.perf_counter(), "last": time.perf_counter()}
    phase_seconds = {}

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_seconds[name] = now - clock["last"]
        clock["last"] = now
        log(f"phase {name}: {phase_seconds[name]:.1f} s (script {process_age():.1f} s)")

    # phase 1: environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power limit: {card}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # phase 2: build
    t0 = time.perf_counter()
    libs = KN.build_all()
    log(f"built {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
                log(f"  ptxas {lib.stem.split('-')[0]}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {kern.symbol: [] for kern in KN.KERNELS}
    phase_done("1-2")

    # phase 3: kernels against their plain versions
    with torch.inference_mode():
        for kern, shape, heads in kernel_shapes(K):
            rows[kern.symbol].append(check_kernel(K, kern, shape, heads, gen))
        for shape in gconv_shapes():
            rows[G.grouped_conv3.symbol].append(check_gconv(G, shape, gen))
    backward = {kern.symbol: check_backward(K, kern, shape, heads, gen)
                for kern, shape, heads in backward_shapes(K)}
    torch.cuda.empty_cache()
    phase_done("3")

    # phase 4: full-width restore in three modes, and exact on the fused route
    cfg = UR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))
    t0 = time.perf_counter()
    frozen, trainable = make_params(UR, bridge, cfg, torch.bfloat16, seed=1)
    n_params = sum(v.numel() for tree in (frozen, trainable)
                   for v in bridge.flatten(tree).values())
    log(f"init {n_params / 1e6:.1f} M params (bf16) in {time.perf_counter() - t0:.1f} s")
    runs, paths = run_modes(UR, KN, cfg, frozen, trainable, gen)
    graph_runs, graph_paths = run_graph_modes(UR, KN, GR, cfg, frozen, trainable, gen)
    paths.update(graph_paths)
    del frozen, trainable
    torch.cuda.empty_cache()
    phase_done("4")

    # phase 6: the full-width stage-1 training step
    training, paths["train"] = run_training(UR, KN, bridge, TS, OPT)
    torch.cuda.empty_cache()
    phase_done("6")

    # phase 18 (a)-(c): phase 6's cell, the step against monolithic_step;
    # (d) runs after 17
    cell = stage1_cell(UR, bridge, TS, OPT)
    split, paths["train_split"] = run_split_training(UR, KN, bridge, TS, OPT, cell)
    torch.cuda.empty_cache()
    phase_done("18 (a)-(c)")

    # phase 19 (a), (c): the graph-captured step on phase 18's cell, eager and
    # graph in turns; the stage-2 step of each task from its graph; (b) runs
    # after 18 (d)
    graph_step = {}
    graph_step["cell"], paths["train_graph"] = run_graph_training(UR, KN, bridge, TS, GR, cell)
    del cell
    torch.cuda.empty_cache()
    graph_step["stage2"] = run_graph_stage2(UR, KN, bridge, TS, TE, OPT, GR)
    torch.cuda.empty_cache()
    phase_done("19 (a), (c)")

    # phase 5: agreement with the CPU on a small input (the CPU half in the
    # reference worker, from here on beside phases 8 and 9; every such check
    # is read before the report)
    checks = {"restore": reference_check(UR, KN, GR, bridge, cfg, refs)}
    torch.cuda.empty_cache()
    phase_done("5")

    # phase 7: training, card vs CPU
    checks["training"] = train_reference_check(UR, KN, bridge, TS, refs)
    torch.cuda.empty_cache()
    # phase 21 (a)'s host work in the reference worker from here on
    need, free = convert_needs_bytes(bridge), shutil.disk_usage(convert_root).free
    if free < need:
        raise AssertionError(f"phase 21 needs {need / 2**30:.1f} GiB free under {convert_root}, "
                             f"{free / 2**30:.1f} GiB are")
    refs.submit("phase 21", convert_reference_cpu, str(convert_root))
    phase_done("7")

    # phase 8: the restore server, eager and with --cuda-graphs
    serving, paths["serve"], in_process = run_serving(KN, serve, png)
    torch.cuda.empty_cache()
    serving["cuda_graphs"], paths["serve_graph"], _ = run_serving(KN, serve, png, in_process)
    torch.cuda.empty_cache()
    phase_done("8")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as work:
        # phase 9: fit, resume and predict through the CLI; then phase 3's
        # comparison at every shape the fit met that phase 3 had not held
        fit, paths["fit"], fit_shapes, reference16 = run_fit(KN, bridge, TE, TS, OPT,
                                                             TMAIN.main, png, Path(work))
        fit["training_step_ms_phase6"] = training["ms_per_step"]
        fit["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, fit_shapes, rows, gen)
        log(f"fit: {fit['shapes_added_to_phase3']} (kernel, shape) pairs held to their plain "
            f"versions after the fit; CLI {fit['timed']['s_per_step'] * 1e3:.1f} ms/step at "
            f"batch {fit['timed']['batch_size']} (synchronised window) vs phase 6's "
            f"{training['ms_per_step']:.1f} ms/step at batch {BATCH}")
        torch.cuda.empty_cache()
        phase_done("9")

        # phase 11: the stage-2 fit through the CLI on phase 9's smoke tree;
        # phase 3's comparison at the shapes it met that were not held yet;
        # then two stage-2 losses and the TFA gradient, card vs CPU
        t0 = time.perf_counter()
        fit2, paths["fit_stage2"], fit2_shapes = run_fit_stage2(KN, bridge, TE, TS, OPT,
                                                                TMAIN.main, Path(work))
        fit2["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, fit2_shapes, rows, gen,
                                                          path="fit_stage2")
        torch.cuda.empty_cache()
        checks["fit2"] = train2_reference_check(UR, KN, bridge, TS, TE, refs)
        fit2["phase_seconds"] = time.perf_counter() - t0
        log(f"stage-2 fit: {fit2['shapes_added_to_phase3']} (kernel, shape) pairs held to "
            f"their plain versions after it; phase 11 took {fit2['phase_seconds']:.1f} s")
        torch.cuda.empty_cache()
        phase_done("11")

        # phase 12: the stage-3 fit through the CLI, chained to the checkpoints
        # of phases 9 and 11; phase 3's comparison at the shapes it met that
        # were not held yet; then the two detectors' losses, card vs CPU
        t0 = time.perf_counter()
        fit3, paths["fit_stage3"], fit3_shapes, eager12_s = run_fit_stage3(
            KN, bridge, TE, TS, OPT, TMAIN.main, Path(work))
        fit3["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, fit3_shapes, rows, gen,
                                                          path="fit_stage3")
        torch.cuda.empty_cache()
        checks["fit3"] = train3_reference_check(UR, KN, bridge, TS, TE, refs)
        fit3["phase_seconds"] = time.perf_counter() - t0
        log(f"stage-3 fit: {fit3['shapes_added_to_phase3']} (kernel, shape) pairs held to "
            f"their plain versions after it; phase 12 took {fit3['phase_seconds']:.1f} s")
        torch.cuda.empty_cache()
        phase_done("12")

        # phase 13: every probe of the zoos card vs CPU; a fit of the cls and of
        # the seg engine through the CLI; validate runs with the other probe
        # sets; phase 3's comparison at the shapes they met that were not held
        t0 = time.perf_counter()
        engines = {"probes": check_probes(KN, bridge, gen)}
        for task in ("cls", "seg"):
            engines[task], paths[f"fit_{task}"], shapes13 = run_engine_fit(
                KN, bridge, TE, TS, OPT, TMAIN.main, Path(work), task)
            engines[task]["shapes_added_to_phase3"] = check_fit_shapes(
                K, G, KN, shapes13, rows, gen, path=f"fit_{task}")
            torch.cuda.empty_cache()
        engines["validate"], shapes13 = run_validates(KN, TE, bridge, TMAIN.main, Path(work))
        engines["validate_shapes_added_to_phase3"] = check_fit_shapes(
            K, G, KN, shapes13, rows, gen, path="fit_cls")
        engines["phase_seconds"] = time.perf_counter() - t0
        log(f"engines: (kernel, shape) pairs held to their plain versions after the cls fit "
            f"{engines['cls']['shapes_added_to_phase3']}, the seg fit "
            f"{engines['seg']['shapes_added_to_phase3']}, the validate runs "
            f"{engines['validate_shapes_added_to_phase3']}; phase 13 took "
            f"{engines['phase_seconds']:.1f} s")
        torch.cuda.empty_cache()
        phase_done("13")

        # phase 14: validate through the CLI in ALL with FID and in NR, the NR
        # suite's networks and FID's Inception card vs CPU; phase 3's comparison
        # at the shapes the restores met that were not held yet
        nr14, nr_paths, shapes14 = run_validate_nr(KN, TE, bridge, TMAIN.main, Path(work), gen)
        paths.update(nr_paths)
        nr14["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, shapes14, rows, gen,
                                                          path="validate_nr")
        log(f"NR validate: {nr14['shapes_added_to_phase3']} (kernel, shape) pairs held to "
            f"their plain versions after it; phase 14 took {nr14['phase_seconds']:.1f} s, peak "
            f"{nr14['peak_mem_gib']:.2f} GiB")
        torch.cuda.empty_cache()
        phase_done("14")

        # phase 15: the SPADE restores and step, every optimizer and every
        # DeepLab backbone; phase 3's comparison at the shapes they met that
        # were not held
        spade, spade_paths, shapes15, checks15 = run_phase15(UR, KN, GR, bridge, TS, OPT, gen,
                                                             refs, training["ms_per_step"])
        paths.update(spade_paths)
        spade["shapes_added_to_phase3"] = check_fit_shapes(K, G, KN, shapes15, rows, gen,
                                                           path="spade")
        log(f"spade: {spade['shapes_added_to_phase3']} (kernel, shape) pairs held to their "
            "plain versions after phase 15")
        torch.cuda.empty_cache()
        phase_done("15")

        # phases 16 (a), (b) and 17: their torchrun jobs all at once (each is
        # mostly process start, gloo collectives and checkpoints, and only
        # their results are compared), and phase 18 (d) in this process
        # meanwhile; the reference worker's last jobs end beside them
        jobs = torchrun_start(*fit_ddp_jobs(Path(work)), train_ddp2_job(Path(work)),
                              spatial_job(Path(work)))
        try:
            # phase 18 (d): phase 9's fit with --trainer.split_step true, then
            # --trainer.stop_after fr
            split["fit"], paths["fit_split"] = run_fit_split(KN, bridge, TE, TMAIN.main,
                                                             Path(work), reference16)
            torch.cuda.empty_cache()
            phase_done("18 (d)")
            runs = torchrun_wait(jobs)
        finally:
            torchrun_stop(jobs)

        # phase 16: phase 9's fit under torchrun at world size 1 (NCCL), DDP
        # and FSDP; phase 6's cell at two ranks on the card (gloo), DDP and
        # FSDP; the state bytes per rank; phase 3's comparison at new shapes
        parallel, parallel_paths = run_phase16(K, G, KN, TE, UR, rows, gen, reference16,
                                               training, Path(work), runs[:3])
        paths.update(parallel_paths)
        torch.cuda.empty_cache()
        phase_done("16")

        # phase 17: restore_padded on height-sharded images, make_mesh_2d(1, 2)
        # with two gloo ranks on the card; phase 3's comparison at new shapes
        spatial, spatial_paths = run_phase17(K, G, KN, rows, gen, Path(work), runs[3][1])
        paths.update(spatial_paths)
        torch.cuda.empty_cache()
        phase_done("17")

        # phases 19 (b) and 20 run beside no reference job
        log(f"waited {refs.idle():.1f} s for the reference worker's jobs to end")

        # phase 19 (b): phase 9's fit with --trainer.cuda_graphs true
        graph_step["fit"], paths["fit_graph"] = run_fit_graph(
            KN, bridge, TE, GR, TMAIN.main, Path(work), reference16, fit["timed"])
        del reference16
        torch.cuda.empty_cache()
        phase_done("19 (b)")

        # phase 20: the graph route for stage 3 (a: each detector's step; b:
        # phase 12's fit with --trainer.cuda_graphs true) and for every
        # validation network (c: each eager and replayed; d: the NR and cls
        # all_ft validate runs with the flag against phases 14 and 13)
        from unirestore_torch.evalx import evaluators as EV
        graph20 = {}
        graph20["stage3"], paths["train_det_graph"] = run_graph_stage3(UR, KN, bridge, TS, TE,
                                                                       OPT, GR)
        graph20["fit"], paths["fit_stage3_graph"] = run_fit3_graph(
            KN, bridge, TE, GR, TMAIN.main, Path(work), eager12_s)
        graph20["networks"] = run_graph_networks(KN, bridge, TE, EV, GR, gen)
        graph20["validate"] = run_validate_graphs(KN, TE, bridge, TMAIN.main, Path(work),
                                                  nr14["NR"])
        torch.cuda.empty_cache()
        phase_done("20")

    # phase 21: a seeded checkpoint file converted without JAX, then the
    # cached-mode quality sweep from it, in this process and from its CLI
    phase21, paths["cache_quality"] = run_phase21(UR, KN, bridge, refs, convert_root)
    torch.cuda.empty_cache()
    phase_done("21")

    # the CPU halves of phases 5, 7, 11, 12 and 15, read now
    t0 = time.perf_counter()
    reference = checks["restore"]()
    training["reference"] = checks["training"]()
    fit2["reference"] = checks["fit2"]()
    fit3["reference"] = checks["fit3"]()
    spade["reference"] = checks15["reference"]()
    spade["training"]["reference"] = checks15["training"]()
    spade["deeplab"] = checks15["deeplab"]()
    log(f"card-vs-CPU checks of phases 5, 7, 11, 12 and 15 held; waited "
        f"{time.perf_counter() - t0:.1f} s for the reference worker; its jobs ran in these "
        "seconds of the script: " + ", ".join(f"{name} {a:.1f}-{b:.1f}"
                                              for name, (a, b) in refs.spans.items()))
    phase_done("CPU references")

    # phase 10: report; a path routes to a kernel when its expected count is not 0
    routes = {"restore": [sum(EXPECTED[m][i] for m in ("none", "encoder", "deep"))
                          for i in range(len(KN.KERNELS))],
              "restore_fused": list(EXPECTED["fused"]),
              "train": [EXPECTED_TRAIN[kern.symbol][0] for kern in KN.KERNELS],
              "serve": [sum(r[4][i] for r in SERVE_REQUESTS) for i in range(len(KN.KERNELS))]}
    routes.update(restore_graph=routes["restore"], restore_fused_graph=routes["restore_fused"],
                  serve_graph=list(SERVE_BATCH),
                  fit=[EXPECTED_TRAIN[kern.symbol][0] + FIT_RESTORE[i]
                       for i, kern in enumerate(KN.KERNELS)],
                  fit_stage2=[EXPECTED_STAGE2["ir"][kern.symbol][0] + FIT_RESTORE[i]
                              for i, kern in enumerate(KN.KERNELS)],
                  fit_stage3=[EXPECTED_STAGE3[kern.symbol][0] + FIT3_RESTORE[i]
                              for i, kern in enumerate(KN.KERNELS)],
                  **{f"fit_{t}": [EXPECTED_STAGE2[t][kern.symbol][0] + FIT2_RESTORE[t][i]
                                  for i, kern in enumerate(KN.KERNELS)] for t in ("cls", "seg")},
                  **{f"validate_{m.lower()}": [VAL14_RESTORES[m] * n for n in FIT_RESTORE]
                     for m, _ in VAL14_RUNS},
                  **{SPADE_PATHS[run[0]]: list(EXPECTED[run[0]]) for run in SPADE_RUNS},
                  train_spade=[EXPECTED_TRAIN_SPADE[kern.symbol][0] for kern in KN.KERNELS],
                  **{path: routes["train"] for path in ("fit_ddp", "fit_fsdp", "train_ddp2",
                                                        "train_fsdp2")},
                  **{SPATIAL_PATHS[name]: list(EXPECTED[name]) for name in ("none", "deep")},
                  spatial_restore=list(SPATIAL_RESTORE_EXPECTED),
                  **{path: routes["train"] for path in ("train_split", "fit_split")},
                  train_graph=routes["train"],
                  train_det_graph=[EXPECTED_STAGE3[kern.symbol][0] for kern in KN.KERNELS])
    routes["fit_graph"] = routes["fit"]
    routes["cache_quality"] = routes["restore"]
    routes["fit_stage3_graph"] = routes["fit_stage3"]
    entries = []
    for i, kern in enumerate(KN.KERNELS):
        r = rows[kern.symbol]
        by_path = {path: paths[path][kern.symbol] for path in routes}
        missing = [path for path, want in routes.items() if want[i] and not by_path[path]]
        if missing or not any(by_path.values()):
            raise AssertionError(f"{kern.symbol} never ran on {missing or 'any path'}: {by_path}")
        library = [x["library_ms"] for x in r]
        entry = {
            "name": kern.symbol, "route": "cuda", "status": "ported",
            "source": kernel_source(kern), "replaces": kern.replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": sum(x["ms"] for x in r), "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": max(r, key=lambda x: x["bound_ms"])["bound_by"],
            "library_ms": None if None in library else sum(library),
            "shapes": r,
        }
        for key in ("unfused_ms", "sdpa_matmul_ms", "direct_ms", "prev_ms"):
            if key in r[0]:
                entry[key] = sum(x[key] for x in r)
        if kern.symbols:  # an entry per dtype, as the wrapper routes them
            entry["symbols"] = {str(dt).removeprefix("torch."): kern.entry(dt)[0]
                                for dt in (torch.bfloat16, torch.float32)}
        if Path(entry["source"]).name in SM90_DESIGNS:
            entry["design"] = SM90_DESIGNS[Path(entry["source"]).name]
        if kern.symbol in backward:
            entry["backward"] = backward[kern.symbol]
        entries.append(entry)
    log(json.dumps({"restore": {"batch": BATCH, "res": RES, "steps": STEPS, "dtype": "bf16",
                                "runs": runs, "graph_runs": graph_runs,
                                "reference": reference}}))
    log(json.dumps({"training": training}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"fit": fit}))
    log(json.dumps({"fit_stage2": fit2}))
    log(json.dumps({"fit_stage3": fit3}))
    log(json.dumps({"engines": engines}))
    log(json.dumps({"validate_nr": nr14}))
    log(json.dumps({"spade": spade}))
    log(json.dumps({"parallel": parallel}))
    log(json.dumps({"spatial": spatial}))
    split["phase_seconds"] = phase_seconds["18 (a)-(c)"] + phase_seconds["18 (d)"]
    log(json.dumps({"split_step": split}))
    graph_step["phase_seconds"] = phase_seconds["19 (a), (c)"] + phase_seconds["19 (b)"]
    log(json.dumps({"graph_step": graph_step}, default=str))
    graph20["phase_seconds"] = phase_seconds["20"]
    log(json.dumps({"graph_stage3_validation": graph20}, default=str))
    log(json.dumps({"convert_sweep": phase21}))
    phase_done("10")
    log(json.dumps({"phase_seconds": phase_seconds, "reference_jobs": refs.spans,
                    "script_seconds": process_age()}))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"] else main())
