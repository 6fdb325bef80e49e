"""Port parity: evaluation (PSNR, SSIM, LPIPS, the IR evaluator), the config
loader and the checkpoint manager.

- PSNR and SSIM are copies of the JAX functions: equal.
- LPIPS with the JAX params carried across by ``evalx.lpips.bridge``:
  relative 1e-5 (fp32 convolutions in another summation order).
- ``ImageRestorationEvaluator``'s PSNR, SSIM and LPIPS over the tiny engine's
  fp32 restores of the 96 px smoke images: relative 1e-3 of the JAX
  evaluator's, both restores given the same noise (the JAX restore's
  ``PRNGKey(0)`` draws, recomputed and injected). The restores agree to
  about 1e-5, and uint8 rounding of the predictions turns that into a few
  one-level flips.
- ``MultiTaskEvaluator``, ``ClassificationEvaluator`` and
  ``SemanticSegmentationEvaluator`` against the JAX ones over the smoke
  tree's mtl validation lists with one restore function, one set of probes
  and one LPIPS: identical metric dicts; the segmentation dumps identical.
- ``load_config``: the same document from the four YAMLs under every
  override form.
- ``CheckpointManager``: the same files kept, the same files adopted.

Both engines start from one parameter tree: the port's seeded init with its
all-zero leaves filled with N(0, 0.05), handed to the JAX engine in its
layout (``bridge.to_numpy_tree``) in place of its own init, which compiles
one program per leaf shape (about 40 s on the CPU).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_data import make_smoke_tree
from test_torch_pipeline import _jax_noise
from unirestore_torch import bridge
from unirestore_torch import config as TC
from unirestore_torch.data import engine as TDE
from unirestore_torch.evalx import evaluators as TEV
from unirestore_torch.evalx import lpips as TL
from unirestore_torch.evalx import metrics as TM
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.tasks import deeplab as TDL
from unirestore_torch.tasks import resnet as TRN
from unirestore_torch.train import checkpoints as TCK
from unirestore_torch.train import engine as TE
from unirestore_tpu import config as JC
from unirestore_tpu.evalx import evaluators as JEV
from unirestore_tpu.evalx import lpips as JL
from unirestore_tpu.evalx import metrics as JM
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import checkpoints as JCK
from unirestore_tpu.train import engine as JE

REPO = Path(__file__).resolve().parent.parent
STAGE1 = {"frenc": {"train": True, "ckpt_path": None, "type": "CFRM"},
          "cnet": {"train": True, "ckpt_path": None, "type": "scedit",
                   "num_inference_steps": 1}}


def filled_init(cfg, seed=42):
    """The port's seeded init with every all-zero leaf filled with N(0, 0.05)."""
    frozen, trainable = TUR.init(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for tree in (frozen, trainable):
        for leaf in bridge.flatten(tree).values():
            if not leaf.any():
                leaf.normal_(0.0, 0.05, generator=gen)
    return frozen, trainable


def jax_layout(tree):
    return jax.tree.map(jnp.asarray, bridge.to_numpy_tree(tree))


@pytest.fixture
def jax_init_from(monkeypatch):
    """``install(frozen, trainable)``: the JAX engine's ``UR.init`` returns them."""
    def install(frozen, trainable):
        pair = (jax_layout(frozen), jax_layout(trainable))
        monkeypatch.setattr(JUR, "init", lambda key, cfg: pair)
    return install


def test_psnr_and_ssim_are_the_jax_functions():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(size=(40, 52, 3)).astype(np.float32) for _ in range(2))
    q = TM.quantize_preds(a)
    np.testing.assert_array_equal(q, JM.quantize_preds(a))
    assert TM.psnr(b, q) == JM.psnr(b, q)
    assert TM.ssim(q, b) == JM.ssim(q, b)
    assert TM.psnr(b, b) == JM.psnr(b, b) == float("inf")


@pytest.mark.parametrize("hw", [(64, 64), (70, 83)])
def test_lpips_with_carried_params_matches_jax(hw):
    params = JL.lpips_init(jax.random.PRNGKey(13))
    rng = np.random.default_rng(1)
    x, y = (rng.uniform(size=(2, *hw, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(JL.lpips_apply(params, jnp.asarray(x), jnp.asarray(y)))
    fn = TL.make_lpips(TL.bridge(jax.tree.map(np.asarray, params), device="cpu"), device="cpu")
    np.testing.assert_allclose(fn(x, y), want, rtol=1e-5)


def test_ir_evaluator_matches_jax(tmp_path, jax_init_from):
    ir_list = make_smoke_tree(tmp_path)
    ct = TUR.tiny_config(use_tfa=False, tasks=("ir",))
    frozen, trainable = filled_init(ct)
    jax_init_from(frozen, trainable)
    jeng = JE.UniFIEEngine(STAGE1, tiny=True, compute_dtype="float32")
    teng = TE.UniFIEEngine(STAGE1, tiny=True, compute_dtype="float32", device="cpu",
                           params=(frozen, trainable))
    lp = JL.lpips_init(jax.random.PRNGKey(13))
    lpips_j = JL.make_lpips(lp)
    lpips_t = TL.make_lpips(TL.bridge(jax.tree.map(np.asarray, lp), device="cpu"), device="cpu")

    def jax_draws(shape):  # the JAX restore_fn's PRNGKey(0) draws
        post, diff = _jax_noise(jeng.cfg, (shape[0], shape[1] * 8, shape[2] * 8, 3),
                                jax.random.PRNGKey(0))
        return post, diff

    ev_j = JEV.ImageRestorationEvaluator(jeng.restore_fn(), lpips_fn=lpips_j)
    ev_t = TEV.ImageRestorationEvaluator(teng.restore_fn(noise_fn=jax_draws), lpips_fn=lpips_t)
    data = TDE.DatasetEngine(task="ir", val={"type": "val", "batch_size": 1},
                             dataset_dict={"DIVF2KOST": {"val": str(ir_list)}}, num_workers=0)
    for i, batch in enumerate(data.val_dataloader()):
        if i == 2:
            break
        ev_j.validation_step(batch)
        ev_t.validation_step(batch)
    got, want = ev_t.epoch_end(), ev_j.epoch_end()
    assert got.keys() == want.keys()
    assert {"val_hq/psnr", "val_lq/ssim", "val_lq/lpips", "val_monitor"} <= got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


OVERRIDES = {
    "none": [],
    "equals": ["--trainer.max_steps=100", "--model.init_args.eval_mode=NR"],
    "separate": ["--trainer.max_steps", "7", "--data.init_args.num_workers", "0"],
    "negative_and_dotless": ["--trainer.limit_val_batches", "-1", "--a.b", "-.5",
                             "--model.init_args.optimizer_kwargs.base_lr", "2e-3"],
    "valueless": ["--trainer.logger", "--trainer.resume", "auto"],
    "new_keys": ["--data.init_args.dataset_dict.DIVF2KOST.train", "/x/train.list",
                 "--trainer.profiler=/tmp/trace"],
}


@pytest.mark.parametrize("yaml", ["train_stage1", "train_stage2", "train_stage3", "val"])
@pytest.mark.parametrize("form", list(OVERRIDES))
def test_load_config_matches_jax(yaml, form):
    path = REPO / "configs" / f"{yaml}.yaml"
    got, want = TC.load_config(path, OVERRIDES[form]), JC.load_config(path, OVERRIDES[form])
    assert got == want
    assert TC.engine_type(got) == JC.engine_type(want)


def test_load_config_raises_like_jax():
    path = REPO / "configs" / "val.yaml"
    for bad in (["stray"], ["--a.b", "-x"]):
        with pytest.raises(ValueError) as t_err:
            TC.load_config(path, bad)
        with pytest.raises(ValueError) as j_err:
            JC.load_config(path, bad)
        assert str(t_err.value) == str(j_err.value)


def test_build_refuses_what_is_not_ported():
    """The mtl engine of stage 2, the cls and seg engines (with their probe
    zoos), the det engine of stage 3 and the ir engine's NR and ALL
    ``eval_mode`` and ``compute_fid`` build, and so do ``trainer.fsdp`` and
    ``trainer.split_step``; ``trainer.stop_after`` without ``split_step``
    raises the JAX config's ``ValueError``."""
    cfg = TC.load_config(REPO / "configs" / "train_stage2.yaml")
    engine, _, data, factory = TC.build(cfg, tiny=True, device="cpu")
    assert engine.engine_type == "mtl" and engine.stage.multi_task and engine.stage.train_tfa
    assert not (engine.stage.train_cfrm or engine.stage.train_cnet)
    assert data.task == "mtl" and callable(factory)
    for task in ("cls", "seg"):
        cfg = TC.load_config(REPO / "configs" / "train_stage2.yaml",
                             ["--model.class_path", f"unirestore_tpu.{task}",
                              "--data.init_args.task", task])
        engine, _, data, factory = TC.build(cfg, tiny=True, device="cpu")
        assert engine.engine_type == task and engine.stage.train_tfa
        assert data.task == task and callable(factory)
    cfg = TC.load_config(REPO / "configs" / "train_stage3.yaml")
    engine, _, data, _ = TC.build(cfg, tiny=True, device="cpu")  # the det engine
    assert engine.engine_type == "det" and engine.downstream == "retinanet"
    assert engine.stage.tfa_prompts_only and engine.stage.multi_task and data.task == "det"
    for mode in ("NR", "ALL", "FR"):
        cfg = TC.load_config(REPO / "configs" / "val.yaml",
                             ["--model.init_args.eval_mode", mode,
                              "--model.init_args.compute_fid", "true"])
        engine, _, _, factory = TC.build(cfg, tiny=True, device="cpu")
        assert engine.engine_type == "ir" and callable(factory)
    cfg = TC.load_config(REPO / "configs" / "val.yaml", ["--trainer.fsdp", "true"])
    assert TC.build(cfg, tiny=True, device="cpu")[1].fsdp
    cfg = TC.load_config(REPO / "configs" / "val.yaml", ["--trainer.split_step", "true"])
    trainer = TC.build(cfg, tiny=True, device="cpu")[1]
    assert trainer.split_step is True and trainer.stop_after is None
    cfg = TC.load_config(REPO / "configs" / "val.yaml", ["--trainer.stop_after", "fr"])
    with pytest.raises(ValueError) as t_err:
        TC.build(cfg, tiny=True, device="cpu")
    with pytest.raises(ValueError) as j_err:  # the JAX trainer as its config builds it
        JE.Trainer(split_step=None, stop_after=cfg["trainer"]["stop_after"])
    assert str(t_err.value) == str(j_err.value) == "trainer.stop_after requires split_step"


def _fixed_restore(images, task):
    """A restore function both evaluators share: a per-task affine map."""
    gain = {"ir": 0.9, "cls": 0.8, "seg": 0.7}[task]
    return np.clip(np.asarray(images) * gain + 0.05, 0.0, 1.0)


def _fixed_probes():
    """Numpy probes both evaluators share: logits linear in the pixels."""
    rng = np.random.default_rng(7)
    w_cls = rng.standard_normal((3, 5)).astype(np.float32)
    w_seg = rng.standard_normal((3, 19)).astype(np.float32)
    return {"cls": lambda x: np.asarray(x).mean(axis=(1, 2)) @ w_cls,
            "seg": lambda x: np.asarray(x) @ w_seg}


def _mtl_evaluators(EV, probes, lpips_fn):
    return EV.MultiTaskEvaluator(
        EV.ImageRestorationEvaluator(_fixed_restore, lpips_fn=lpips_fn),
        EV.ClassificationEvaluator(_fixed_restore, {"r50v1": probes["cls"]}),
        EV.SemanticSegmentationEvaluator(_fixed_restore, {"dlv3pr50": probes["seg"]}))


def test_mtl_evaluators_match_jax(tmp_path):
    """The multi-task, classification and segmentation evaluators against the
    JAX ones over the smoke tree's mtl validation lists, one restore function,
    one set of probes and one LPIPS: identical metric dicts."""
    make_smoke_tree(tmp_path)
    lists = tmp_path / "lists"
    dd = {"DIVF2KOST": {"val": str(lists / "ir.list")}, "ImageNet": {"val": str(lists / "cls.list")},
          "Cityscapes": {"val": str(lists / "seg.list")}}
    data = TDE.DatasetEngine(task="mtl", val={"type": "val", "batch_size": 1}, dataset_dict=dd,
                             num_workers=0)
    probes = _fixed_probes()
    lpips_fn = TL.make_lpips(TL.LPIPS(TL.lpips_init(device="cpu")), device="cpu")
    ev_t, ev_j = _mtl_evaluators(TEV, probes, lpips_fn), _mtl_evaluators(JEV, probes, lpips_fn)
    cls_t = TEV.ClassificationEvaluator(_fixed_restore, {"a": probes["cls"]}, monitor="a")
    cls_j = JEV.ClassificationEvaluator(_fixed_restore, {"a": probes["cls"]}, monitor="a")
    seg_t = TEV.SemanticSegmentationEvaluator(_fixed_restore, {"b": probes["seg"]}, tta=False)
    seg_j = JEV.SemanticSegmentationEvaluator(_fixed_restore, {"b": probes["seg"]}, tta=False)
    seen = set()
    for loader in data.val_dataloader():
        for i, batch in enumerate(loader):
            if i == 2:
                break
            seen.add(batch["task"])
            ev_t.validation_step(batch)
            ev_j.validation_step(batch)
            if batch["task"] == "cls":
                cls_t.validation_step(batch)
                cls_j.validation_step(batch)
            if batch["task"] == "seg":
                seg_t.validation_step(batch)
                seg_j.validation_step(batch)
    assert seen == {"ir", "cls", "seg"}
    got, want = ev_t.epoch_end(), ev_j.epoch_end()
    assert got == want
    assert {"val_ir_lq/psnr", "val_ir_hq/lpips", "val_cls_lq/r50v1", "val_cls_hq/r50v1",
            "val_seg_lq/dlv3pr50"} <= got.keys()
    assert got["val_monitor"] == got["val_ir_lq/psnr"]
    assert cls_t.epoch_end() == cls_j.epoch_end()
    assert seg_t.epoch_end() == seg_j.epoch_end()


def test_seg_evaluator_dumps_like_jax(tmp_path):
    """``save_dir``: the restored lq and the Cityscapes-palette prediction per image."""
    probes = _fixed_probes()
    rng = np.random.default_rng(8)
    batch = {"lq": rng.uniform(size=(2, 40, 48, 3)).astype(np.float32),
             "gt": rng.integers(0, 19, (2, 40, 48)), "fname": ["a.jpg", "b.png"], "task": "seg"}
    outs = {}
    for name, EV in (("port", TEV), ("jax", JEV)):
        ev = EV.SemanticSegmentationEvaluator(_fixed_restore, {"b": probes["seg"]},
                                              save_dir=str(tmp_path / name))
        ev.validation_step(batch)
        outs[name] = {p.relative_to(tmp_path / name): np.asarray(Image.open(p))
                      for p in sorted((tmp_path / name).rglob("*.png"))}
    assert sorted(map(str, outs["port"])) == ["lq/a.png", "lq/b.png", "seg/a.png", "seg/b.png"]
    assert outs["port"].keys() == outs["jax"].keys()
    for k in outs["port"]:
        np.testing.assert_array_equal(outs["port"][k], outs["jax"][k], err_msg=str(k))


def test_mtl_probes_are_the_critics(tmp_path):
    """``config.build``'s mtl evaluator probes the engine's critics (built
    once, shared with the fit) in fp32 and keeps them across epochs."""
    cfg = TC.load_config(REPO / "configs" / "train_stage2.yaml")
    engine, _, _, factory = TC.build(cfg, tiny=True, device="cpu")
    ev1, ev2 = factory(engine), factory(engine)
    probe = ev1.evals["cls"].classifiers["r50v1"]
    assert probe is ev2.evals["cls"].classifiers["r50v1"]
    assert ev1.evals["ir"].lpips_fn is ev2.evals["ir"].lpips_fn
    x = np.random.default_rng(9).uniform(size=(1, 64, 80, 3)).astype(np.float32)
    critics = engine.build_critics()
    with torch.no_grad():
        want = TRN.resnet_apply(critics["cls"], torch.from_numpy(x)).numpy()
        want_seg = TDL.deeplabv3plus_apply(critics["seg"], torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(probe(x), want)
    np.testing.assert_array_equal(ev1.evals["seg"].seg_models["dlv3pr50"](x), want_seg)
    assert engine.build_critics() is critics


def test_checkpoint_manager_keeps_and_adopts_like_jax(tmp_path):
    tree = {"cfrm": {"w": np.ones((2, 3), np.float32)}}
    saves = [(1, 0.5), (2, 0.7), (3, 0.1), (4, 0.9), (5, 0.7), (2, 0.7)]
    for mode in ("max", "min"):
        dirs = {k: tmp_path / f"{mode}_{k}" for k in ("port", "jax")}
        mt = TCK.CheckpointManager(str(dirs["port"]), save_top_k=3, mode=mode)
        mj = JCK.CheckpointManager(str(dirs["jax"]), save_top_k=3, mode=mode)
        for step, val in saves:
            mt.save({"cfrm": {"w": torch.ones(2, 3)}}, step, val)
            mj.save(tree, step, val)
        names = {k: sorted(p.name for p in d.iterdir()) for k, d in dirs.items()}
        assert names["port"] == names["jax"] and len(names["port"]) == 3
        assert Path(mt.best_path).name == Path(mj.best_path).name
        # a new manager adopts the files left in its directory
        at = TCK.CheckpointManager(str(dirs["port"]), save_top_k=3, mode=mode)
        aj = JCK.CheckpointManager(str(dirs["jax"]), save_top_k=3, mode=mode)
        assert ([(v, Path(p).name) for v, p in at._saved]
                == [(v, Path(p).name) for v, p in aj._saved])
        at.save({"cfrm": {"w": torch.ones(2, 3)}}, 9, 0.3)
        aj.save(tree, 9, 0.3)
        assert (sorted(p.name for p in dirs["port"].iterdir())
                == sorted(p.name for p in dirs["jax"].iterdir()))
