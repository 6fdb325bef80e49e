"""Port parity and CLI: stage 3 from ``configs/train_stage3.yaml`` (the ``det``
engine: only the TFA task prompts train, through a frozen RetinaNet or,
with ``downstream: fastrcnn``, Faster R-CNN critic).

- The task loss (``make_te_loss_fn("det", ...)``) and one ``compute_losses``
  for task ``det`` at the tiny config, losses and gradients against the JAX
  package's, for both detectors, on one set of weights (the tiny model from
  the port's seeded init with its zero leaves filled; the critics of
  ``test_torch_detection.detector``). The Faster R-CNN loss is fed JAX's own
  sampling draws. Losses within 1e-5 relative, gradients within 1e-4 of each
  family's largest, as in ``test_torch_train.py``.
- ``DetectionEvaluator`` against the JAX evaluator on the same restored
  arrays and one detector function: the same quantised images reach the
  detector, the same mAP and monitor come out, the same boxes are drawn.
- The CLI in this process (TensorBoard kept out): the stage-3 YAML at the
  tiny config on the 96 px smoke tree, chained to a stage-1 and a stage-2
  checkpoint made by the CLI first. Only the task prompts move, the loaded
  families are bit-equal to their files, the ``det`` prompt starts at its
  fresh init; checkpoints, a resume, and ``validate`` with either detector.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import make_smoke_tree
from test_torch_detection import detector, targets
from test_torch_eval import filled_init
from test_torch_fasterrcnn import jax_uniforms
from test_torch_train import _assert_losses_and_grads_match, _batch, _jax_noise
from unirestore_torch import bridge
from unirestore_torch import config as TC
from unirestore_torch import main as TMAIN
from unirestore_torch.evalx import evaluators as TEV
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.ops import png
from unirestore_torch.tasks import fasterrcnn as TFRC
from unirestore_torch.train import checkpoints as TCK
from unirestore_torch.train import engine as TE
from unirestore_torch.train import steps as TS
from unirestore_tpu.evalx import evaluators as JEV
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import engine as JE
from unirestore_tpu.train import steps as JS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
STAGE2_YAML = REPO / "configs" / "train_stage2.yaml"
STAGE3_YAML = REPO / "configs" / "train_stage3.yaml"
TASKS = ("ir", "cls", "seg", "det")
STAGE3 = dict(train_cfrm=False, train_cnet=False, train_tfa=True, tfa_prompts_only=True,
              multi_task=True)
NO_TENSORBOARD = ("tensorflow", "torch.utils.tensorboard")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    for name in NO_TENSORBOARD:
        monkeypatch.setitem(sys.modules, name, None)


def det_batch(seed=3):
    batch = _batch(seed, b=1)
    boxes, labels, mask = targets(batch=1)
    batch["gt"] = {"boxes": boxes, "labels": labels, "mask": mask}
    return batch


def to_torch(batch):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("downstream", ["retinanet", "fastrcnn"])
def test_det_task_loss_and_compute_losses_match_jax(downstream, monkeypatch):
    jcrit, tcrit = detector(downstream, seed=2)
    # the port's Faster R-CNN loss draws what the JAX one draws from PRNGKey(0)
    monkeypatch.setattr(TFRC, "loss_uniforms",
                        lambda b, h, w, device: jax_uniforms(b, h, w))
    batch = det_batch()
    preds = np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda crit, p, hq, gt: JE.make_te_loss_fn("det", {"det": crit}, downstream)(
        p, hq, gt, "det"))(jcrit, preds, batch["hq"], batch["gt"])
    tb = to_torch(batch)
    got = TE.make_te_loss_fn("det", {"det": tcrit}, downstream)(
        torch.from_numpy(preds), tb["hq"], tb["gt"], "det")
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    cj, ct = JUR.tiny_config(use_tfa=True, tasks=TASKS), TUR.tiny_config(use_tfa=True, tasks=TASKS)
    ft, tt = filled_init(ct, seed=4)
    fj, tj = (jax.tree.map(jnp.asarray, bridge.to_numpy_tree(t)) for t in (ft, tt))
    rng = jax.random.PRNGKey(7)
    # the critic enters as an argument: closed over, XLA would fold it as constants
    fn = jax.jit(jax.value_and_grad(
        lambda tr, crit, b, r: JS.compute_losses(
            fj, tr, cj, JUR.schedule(cj), JS.StageConfig(**STAGE3), b, r, "det",
            te_loss_fn=JE.make_te_loss_fn("det", {"det": crit}, downstream)), has_aux=True))
    (loss_j, logs_j), grads_j = fn(tj, jcrit, batch, rng)

    leaves = bridge.flatten(tt)
    for p in leaves.values():
        p.requires_grad_(True)
    loss, logs = TS.compute_losses(ft, tt, ct, TUR.schedule(ct), TS.StageConfig(**STAGE3), tb,
                                   _jax_noise(cj, batch, rng), "det",
                                   TE.make_te_loss_fn("det", {"det": tcrit}, downstream))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    assert set(logs) == {"train/loss_det", "train/loss"}
    _assert_losses_and_grads_match(STAGE3, "det", tt, loss, logs, grads, loss_j, logs_j, grads_j)
    # prompts only: the editors get gradients, which the stage does not apply
    trained = TS.trained_leaves(TS.StageConfig(**STAGE3), tt)
    assert sorted(trained) == [f"tfa//task_prompts//{t}" for t in sorted(TASKS)]
    assert float(grads["tfa//task_prompts//det"].abs().max()) > 0


def test_detection_evaluator_matches_jax(tmp_path):
    """One restore and one detector function for both evaluators: the same
    quantised images reach the detector, the same metrics and boxes come out."""
    rng = np.random.default_rng(6)
    seen = {"port": [], "jax": []}

    def restore(images, task):
        assert task == "det"
        return np.clip(np.asarray(images) * 0.9 + 0.003, 0.0, 1.0)

    def detector_of(side):
        def run(images):
            seen[side].append(np.array(images))
            out = []
            for img in images:
                m = img.mean(axis=(0, 1))
                boxes = np.array([[4, 4, 40, 44], [10 + 30 * m[0], 8, 60, 50 + 8 * m[1]],
                                  [40, 40, 60, 60]], np.float32)  # the last a false positive
                out.append({"boxes": boxes, "scores": np.array([0.5, 0.4 + m[2] / 4, 0.9]),
                            "labels": np.array([1, 3, 1])})
            return out
        return run

    ours = TEV.DetectionEvaluator(restore, detector_of("port"), save_dir=str(tmp_path / "port"))
    ref = JEV.DetectionEvaluator(restore, detector_of("jax"), save_dir=str(tmp_path / "jax"))
    for i in range(3):
        lq = rng.uniform(size=(1, 64, 72, 3)).astype(np.float32)
        gt = [{"boxes": np.array([[5, 5, 38, 42], [12, 9, 58, 52]], np.float32) + i,
               "labels": np.array([1, 3])}]
        batch = {"lq": lq, "gt": gt, "fname": [f"img{i}.jpg"], "task": "det"}
        ours.validation_step(batch)
        ref.validation_step(batch)
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.round(a * 255) / 255)  # uint8 levels
    got, want = ours.epoch_end(), ref.epoch_end()
    assert got == want and set(got) == {"val_lq/map", "val_monitor"}
    assert 0 < got["val_monitor"] == got["val_lq/map"] < 1
    assert ours.epoch_end()["val_lq/map"] == 0.0  # reset
    from PIL import Image
    for i in range(3):
        drawn = png.decode((tmp_path / "port" / "det" / f"img{i}.png").read_bytes())
        np.testing.assert_array_equal(drawn, np.asarray(Image.open(
            tmp_path / "jax" / "det" / f"img{i}.png").convert("RGB")))
        assert (drawn == (255, 0, 0)).all(-1).any()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The 96 px smoke tree and a stage-1 and a stage-2 checkpoint made
    through the CLI (tiny, CPU, two micro-steps each)."""
    out = tmp_path_factory.mktemp("stage3")
    make_smoke_tree(out)
    lists = out / "lists"
    with pytest.MonkeyPatch.context() as mp:
        for name in NO_TENSORBOARD:
            mp.setitem(sys.modules, name, None)
        TMAIN.main(["fit", "--config", str(out / "smoke.yaml"), "--tiny", "--device", "cpu",
                    "--trainer.max_steps", "2", "--trainer.logger.init_args.save_dir",
                    str(out / "s1")])
        argv = ["fit", "--config", str(STAGE2_YAML), "--tiny", "--device", "cpu",
                "--data.init_args.train.resolution", "64", "--data.init_args.num_workers", "0",
                "--trainer.max_steps", "2", "--trainer.accumulate_grad_batches", "1",
                "--trainer.num_sanity_val_steps", "0",
                "--trainer.logger.init_args.save_dir", str(out / "s2")]
        for name, lst, splits in (("DIVF2KOST", "ir", ("train", "val")),
                                  ("ImageNet", "cls", ("train", "val")),
                                  ("FoggyCityscapes", "seg", ("train",)),
                                  ("Cityscapes", "seg", ("val",))):
            for split in splits:
                argv += [f"--data.init_args.dataset_dict.{name}.{split}", str(lists / f"{lst}.list")]
        TMAIN.main(argv)
    return {"lists": lists, "stage1": out / "s1" / "checkpoints" / "last.npz",
            "stage2": out / "s2" / "checkpoints" / "last.npz"}


def stage3_overrides(chain, root, *extra):
    """The stage-3 YAML's dotted overrides: the smoke tree's COCO list, a 64 px
    crop, no loader threads, the two checkpoints, the log directory."""
    lists = chain["lists"]
    return ["--data.init_args.train.resolution", "64", "--data.init_args.num_workers", "0",
            "--data.init_args.dataset_dict.COCO.train", str(lists / "det.list"),
            "--data.init_args.dataset_dict.COCO.val", str(lists / "det.list"),
            "--model.init_args.model_kwargs.frenc.ckpt_path", str(chain["stage1"]),
            "--model.init_args.model_kwargs.cnet.ckpt_path", str(chain["stage1"]),
            "--model.init_args.model_kwargs.tedit.ckpt_path", str(chain["stage2"]),
            "--trainer.logger.init_args.save_dir", str(root), *extra]


def test_stage3_cli_fit_trains_only_prompts_resumes_and_validates(chain, tmp_path, capsys):
    root = tmp_path / "logs"
    overrides = stage3_overrides(chain, root, "--trainer.limit_val_batches", "2")
    base = ["--config", str(STAGE3_YAML), "--tiny", "--device", "cpu", *overrides]
    start, _, _, _ = TC.build(TC.load_config(STAGE3_YAML, overrides), tiny=True, device="cpu")
    assert start.engine_type == "det" and start.downstream == "retinanet"
    assert start.stage == TS.StageConfig(**STAGE3)
    before = bridge.flatten(bridge.to_numpy_tree(start.trainable))
    s1 = TCK.load_checkpoint(str(chain["stage1"]))[0]
    s2 = TCK.load_checkpoint(str(chain["stage2"]))[0]
    _, fresh = TUR.init(start.cfg, device="cpu", seed=42)
    fresh = bridge.flatten(bridge.to_numpy_tree(fresh))
    for k, v in before.items():
        family = k.split("//")[0]
        if family in ("cfrm", "controller", "control"):
            np.testing.assert_array_equal(v, s1[f"trainable//{k}"], err_msg=k)
        elif k == "tfa//task_prompts//det":  # the new task: its fresh init
            np.testing.assert_array_equal(v, fresh[k])
            assert f"trainable//{k}" not in s2
        else:  # the editors and the ir, cls and seg prompts of stage 2
            np.testing.assert_array_equal(v, s2[f"trainable//{k}"], err_msg=k)

    capsys.readouterr()
    TMAIN.main(["fit", *base, "--trainer.max_steps", "4", "--trainer.val_check_interval", "2",
                "--trainer.accumulate_grad_batches", "2", "--trainer.log_every_n_steps", "1",
                "--trainer.num_sanity_val_steps", "1"])
    out = capsys.readouterr().out
    assert "!!Loaded frenc" in out and "!!Loaded cnet" in out and "!!Loaded tedit" in out
    assert "[sanity] running 1 validation steps" in out and "[fit] done at step 4" in out
    assert out.count("train/loss_det=") == 4 and "val_lq/map" in out
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    assert len(ckpts) == 3 and ckpts[0] == "last.npz"
    assert ckpts[1].startswith("step=2-val=") and ckpts[2].startswith("step=4-val=")
    flat, meta = TCK.load_checkpoint(str(root / "checkpoints" / "last.npz"))
    assert meta["step"] == 4
    moved = {k for k, v in before.items() if not np.array_equal(flat[f"trainable//{k}"], v)}
    # det and ir by their gradients (ir through the auxiliary IR loss), cls
    # and seg by weight decay alone, which leaves a prompt at its zero init
    # (one that got no step in stage 2) where it is
    prompts = {f"tfa//task_prompts//{t}" for t in TASKS}
    assert moved == {k for k in prompts if k.endswith(("det", "ir")) or before[k].any()}

    TMAIN.main(["fit", *base, "--trainer.max_steps", "5", "--trainer.resume", "auto"])
    out = capsys.readouterr().out
    assert f"[resume] {root / 'checkpoints' / 'last.npz'} @ step 4" in out
    assert TCK.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]["step"] == 5

    for downstream in ("retinanet", "fastrcnn"):
        engine, _ = TMAIN.main(["validate", *base, "--model.init_args.downstream", downstream])
        out = capsys.readouterr().out
        assert "val_lq/map" in out and "val_monitor" in out
        assert ("rpn" in engine.critics["det"]) == (downstream == "fastrcnn")
