"""Port parity: the ``cls`` and ``seg`` engines from ``configs/train_stage2.yaml``
(``--model.class_path unirestore_tpu.cls|seg --data.init_args.task cls|seg``,
``config.build``'s evaluator branches over the probe zoos).

- ``Trainer.fit`` of each engine against the JAX ``Trainer.fit`` on the
  128 px smoke tree at a 128 px crop: two micro-steps at accumulation 1 (two
  AdamW updates) on the same batches and step noise (the JAX trainer's
  ``fold_in(PRNGKey(42), 0)`` keys split once a step), eps 1e-3 and
  ``base_lr`` 4e-3 as ``tests/test_torch_cli.py`` runs stage 2, both engines
  from the port's seeded init (zero leaves filled) and on one set of critics:
  the port's seeded ResNet-50 and DeepLabV3+-ResNet-50 with random BatchNorm
  statistics, cut to the first block of each stage (the critics' own parity is
  ``tests/test_torch_tasks.py``; the cut keeps the two JAX compiles short).
  Every TFA leaf within 1e-5 absolute, every other family bit-unchanged in
  both, the losses within 1e-5 relative.
- ``validate`` through ``config.build``, both packages over one fixed
  restore function: with ``eval_mode bare``, and with a one-probe set
  (``single`` narrowed to ``r50v1`` for ``cls`` and to ``dlv3pr50`` for
  ``seg`` in both packages), the port returns the keys of the JAX evaluator
  on the same images, and its ``val_monitor`` is the value of the key the JAX
  evaluator monitors. The values differ (each package draws its own seeded
  probe weights).
- The CLI entry point (``unirestore_torch.main.main``, in this process): a
  ``fit`` of each engine with validation over the ``all`` probe set (``cls``:
  six full-width probes) and ``single`` (``seg``: DeepLabV3+ and RefineNet,
  three-scale TTA), on the CPU.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_bridge import to_np
from test_torch_data import make_smoke_tree
from test_torch_eval import _fixed_restore, filled_init, jax_layout
from test_torch_tasks import _randomize_bn
from test_torch_train import _jax_noise
from unirestore_torch import bridge, tasks
from unirestore_torch import config as TC
from unirestore_torch import main as TMAIN
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.tasks import classifier_zoo as TCZ
from unirestore_torch.tasks import seg_zoo as TSZ
from unirestore_torch.train import checkpoints as TCK
from unirestore_torch.train import engine as TE
from unirestore_torch.train import optim as TOPT
from unirestore_tpu import config as JC
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.parallel import mesh as JMESH
from unirestore_tpu.tasks import classifier_zoo as JCZ
from unirestore_tpu.tasks import seg_zoo as JSZ
from unirestore_tpu.train import engine as JE

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
STAGE2_YAML = REPO / "configs" / "train_stage2.yaml"
STEPS = 2
EPS = 1e-3
PARITY = ["--trainer.max_steps", str(STEPS), "--trainer.accumulate_grad_batches", "1",
          "--model.init_args.optimizer_kwargs.base_lr", "4e-3",
          "--trainer.num_sanity_val_steps", "0", "--trainer.log_every_n_steps", "1"]
NO_TENSORBOARD = ("tensorflow", "torch.utils.tensorboard")
ONE_PROBE = {"cls": "r50v1", "seg": "dlv3pr50"}
TASKS = ("cls", "seg")


@pytest.fixture(scope="module")
def smoke128(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke128")
    make_smoke_tree(out, res=128)
    return out / "smoke.yaml"


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    for name in NO_TENSORBOARD:
        monkeypatch.setitem(sys.modules, name, None)


def engine_overrides(smoke_yaml, root, task, *extra):
    """The stage-2 YAML made the ``task`` engine by dotted overrides: its class
    path and data task, the smoke tree's lists, a 128 px crop, no loader
    threads, the log directory."""
    lists = Path(smoke_yaml).parent / "lists"
    out = ["--model.class_path", f"unirestore_tpu.{task}", "--data.init_args.task", task]
    for name, lst, splits in (("DIVF2KOST", "ir", ("train", "val")),
                              ("ImageNet", "cls", ("train", "val")),
                              ("FoggyCityscapes", "seg", ("train",)),
                              ("Cityscapes", "seg", ("val",))):
        for split in splits:
            out += [f"--data.init_args.dataset_dict.{name}.{split}", str(lists / f"{lst}.list")]
    return out + ["--data.init_args.train.resolution", "128", "--data.init_args.num_workers", "0",
                  "--trainer.logger.init_args.save_dir", str(root), *extra]


def _cut_critic(tree):
    """A critic tree with each ResNet stage cut to its first block."""
    if "backbone" in tree:
        return {**tree, "backbone": _cut_critic(tree["backbone"])}
    return {**tree, "layers": [s[:1] for s in tree["layers"]]}


def cut_critics():
    """The cls and seg critics as numpy trees in the JAX layout: the port's
    seeded init cut to one block a stage, BatchNorm statistics randomised."""
    rng = np.random.default_rng(0)
    return {task: _randomize_bn(bridge.to_numpy_tree(_cut_critic(tasks.critic_init(task, "cpu"))),
                                rng)
            for task in ("cls", "seg")}


def _forcing(make, **forced):
    def made(*args, **kwargs):
        return make(*args, **{**kwargs, **forced})
    return made


@pytest.fixture(scope="module")
def jax_fits(smoke128, tmp_path_factory):
    """The JAX ``Trainer.fit`` of each engine (each one XLA compile of the tiny
    model's step with its critic, about 37 s on the CPU), run once: by task,
    its engine and trainer; and the port's init and critics they started from."""
    ct = TUR.tiny_config(use_tfa=True, tasks=("ir", "cls", "seg"))
    init = filled_init(ct)
    pair, critics = tuple(jax_layout(t) for t in init), cut_critics()
    fits = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in NO_TENSORBOARD:
            mp.setitem(sys.modules, name, None)
        mp.setattr(JE, "make_mesh", lambda: JMESH.make_mesh(jax.devices()[:1]))
        # a copy for each engine: the JAX step donates its trainable tree
        mp.setattr(JUR, "init", lambda key, cfg: jax.tree.map(jax.numpy.array, pair))
        mp.setattr(JE, "build_critics", lambda *a, **k: jax.tree.map(jax.numpy.asarray, critics))
        mp.setattr(optax, "adamw", _forcing(optax.adamw, eps=EPS))
        for task in TASKS:
            jcfg = JC.load_config(STAGE2_YAML, engine_overrides(
                smoke128, tmp_path_factory.mktemp(f"jax_{task}"), task, *PARITY))
            jeng, jtr, jdata, _ = JC.build(jcfg, tiny=True)
            jtr.fit(jeng, jdata, None)
            fits[task] = jeng, jtr
    return {"fits": fits, "init": init, "critics": critics}


@pytest.mark.parametrize("task", TASKS)
def test_engine_fit_matches_jax(task, smoke128, tmp_path, jax_fits, monkeypatch):
    jeng, jtr = jax_fits["fits"][task]
    rng, keys = jax.random.fold_in(jax.random.PRNGKey(42), 0), []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        keys.append(sub)

    init, critics = jax_fits["init"], jax_fits["critics"]
    monkeypatch.setattr(TOPT, "AdamW", _forcing(TOPT.AdamW, eps=EPS))
    cfg = TC.load_config(STAGE2_YAML, engine_overrides(smoke128, tmp_path / "port", task,
                                                       *PARITY))
    teng, ttr, data, _ = TC.build(cfg, tiny=True, device="cpu")
    assert teng.engine_type == task
    teng.configure_model(tuple(
        bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(t).items()}, t)
        for t in init))
    teng.critics = {t: bridge.load_tree(critics[t], _cut_critic(tasks.critic_init(t, "meta")),
                                        device="cpu") for t in (task,)}
    ttr.noise_fn = lambda step, batch: _jax_noise(jeng.cfg, {"hq": batch["hq"].numpy()},
                                                  keys[step])
    ttr.fit(teng, data, None)

    assert [e["step"] for e in ttr.logs] == [e["step"] for e in jtr.logs] == [1, 2]
    for got, want in zip(ttr.logs, jtr.logs):
        assert f"train/loss_{task}" in want
        for k, v in want.items():
            if k.startswith("train/"):
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, jeng.trainable),
                                           teng.trainable, device="cpu"))
    before = bridge.flatten(init[1])
    moved = set()
    for k, p in bridge.flatten(teng.trainable).items():
        if k.startswith("tfa//"):
            np.testing.assert_allclose(to_np(p), to_np(want[k]), atol=1e-5, rtol=0, err_msg=k)
            moved |= {k} if not torch.equal(p, before[k]) else set()
        else:  # the frozen families: bit-unchanged in both
            assert torch.equal(p, before[k]) and torch.equal(want[k], before[k]), k
    assert f"tfa//task_prompts//{task}" in moved


@pytest.fixture(scope="module")
def tiny_pair():
    """A seeded tiny model for both packages' engines (the JAX layout for JAX)."""
    pair = TUR.init(TUR.tiny_config(use_tfa=True, tasks=("ir", "cls", "seg")), device="cpu")
    return tuple(jax_layout(t) for t in pair)


@pytest.mark.parametrize("task,mode", [("cls", "bare"), ("cls", "single"), ("seg", "bare"),
                                       ("seg", "single")])
def test_validate_keys_and_monitor_match_jax(task, mode, smoke128, tmp_path, tiny_pair,
                                             monkeypatch):
    """Both evaluators over one fixed restore (``test_torch_eval._fixed_restore``)."""
    monkeypatch.setitem(TCZ.EVAL_MODE_SETS, "single", [ONE_PROBE["cls"]])
    monkeypatch.setitem(JCZ.EVAL_MODE_SETS, "single", [ONE_PROBE["cls"]])
    monkeypatch.setitem(TSZ.EVAL_MODE_SETS, "single", [ONE_PROBE["seg"]])
    monkeypatch.setitem(JSZ.EVAL_MODE_SETS, "single", [ONE_PROBE["seg"]])
    for engine in (TE.UniFIEEngine, JE.UniFIEEngine):
        monkeypatch.setattr(engine, "restore_fn", lambda self, *a, **k: _fixed_restore)
    monkeypatch.setattr(JE, "make_mesh", lambda: JMESH.make_mesh(jax.devices()[:1]))
    monkeypatch.setattr(JUR, "init", lambda key, cfg: tiny_pair)
    argv = engine_overrides(smoke128, tmp_path, task, "--model.init_args.eval_mode", mode,
                            "--trainer.limit_val_batches", "1")
    teng, ttr, tdata, tfactory = TC.build(TC.load_config(STAGE2_YAML, argv), tiny=True,
                                          device="cpu")
    got = ttr.validate(teng, tdata, tfactory)
    jeng, jtr, jdata, jfactory = JC.build(JC.load_config(STAGE2_YAML, argv), tiny=True)
    want = jtr.validate(jeng, jdata, jfactory)
    assert got.keys() == want.keys()
    if mode == "bare":
        assert "val_monitor" not in got
        return
    monitor = f"val_lq/{ONE_PROBE[task]}"
    assert want["val_monitor"] == want[monitor] and got["val_monitor"] == got[monitor]
    assert {k for k in got if k != "val_monitor"} == (
        {"val_hq/r50v1", "val_lq/r50v1"} if task == "cls" else {"val_lq/dlv3pr50"})


@pytest.mark.parametrize("task,mode,keys", [
    ("cls", "all", [f"val_{e}/{p}" for e in ("hq", "lq") for p in JCZ.EVAL_MODE_SETS["all"]]),
    ("seg", "single", ["val_lq/dlv3pr50", "val_lq/rflwr101"])])
def test_cli_fit_on_the_cpu(task, mode, keys, smoke128, tmp_path, capsys):
    """``unirestore_torch.main`` in this process: a fit of two updates with one
    validation over the full-width probes of ``eval_mode`` at the tiny model."""
    root = tmp_path / "logs"
    TMAIN.main(["fit", "--config", str(STAGE2_YAML), "--tiny", "--device", "cpu",
                *engine_overrides(smoke128, root, task, "--model.init_args.eval_mode", mode,
                                  "--trainer.max_steps", "2", "--trainer.val_check_interval", "2",
                                  "--trainer.accumulate_grad_batches", "1",
                                  "--trainer.limit_val_batches", "1",
                                  "--trainer.num_sanity_val_steps", "0",
                                  "--trainer.log_every_n_steps", "1")])
    out = capsys.readouterr().out
    assert "[fit] done at step 2" in out and f"train/loss_{task}=" in out
    for key in keys + ["val_monitor"]:
        assert key in out, key
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    assert len(ckpts) == 2 and ckpts[0] == "last.npz" and ckpts[1].startswith("step=2-val=")
    assert TCK.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]["step"] == 2
