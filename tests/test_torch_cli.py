"""Port parity: the training entry point (``unirestore_torch.main``) and
``train/engine.py``'s ``Trainer``, on the tiny config and the 96 px smoke tree.

- ``Trainer.fit`` against the JAX ``Trainer.fit`` from the smoke YAML, at a
  128 px training crop of the 128 px smoke tree: four micro-steps with
  gradient accumulation 2 (two AdamW updates, the first at OneCycle's peak /
  10, the second at its peak), the JAX step noise injected (``noise_fn``,
  the JAX trainer's ``fold_in(PRNGKey(42), 0)`` keys split once a step).
  Both optimizers take eps = 1e-3 and ``base_lr`` 4e-3 (peak 1e-3), as
  ``test_torch_train.py`` does: with the YAML's eps of 1e-8 the first Adam
  update is lr * sign(g), so a leaf whose true gradient is fp32 noise moves
  by +-lr in either framework, and at the YAML's rates two updates stay below
  what the losses can show. At the YAML's 64 px crop the tiny Controller's
  deepest level is 1x1 and its gradients are fp32 noise in both frameworks
  (``test_torch_train.py``), so the fit runs at 128 px. Every trained leaf
  (moved by up to 1.1e-3) within 1e-5 absolute; at every step the loss, its
  diffusion and encoder terms within 1e-5 relative, and the terms that
  compare near-equal features (``loss_frenc``, ``loss_layer1-3``) within
  1e-4 relative: they differ by 5e-6 relative at step 1, before any update.
- The same comparison must fail with a fault planted in the port's
  optimizer: an update on every micro-step (no accumulation), or the
  OneCycle schedule read at the micro-step count instead of the update count.
- Checkpoints resume across packages: the port's trainer resumes from the
  JAX trainer's ``last.npz`` and the JAX trainer from the port's (trainable
  tree and step; each optimizer state is its own, so it restarts fresh).
- The CLI as subprocesses on the CPU: ``fit`` with a validation interval,
  resumed with ``--trainer.resume auto``, and ``predict``; without a GPU
  and without ``--device`` it raises.
- Stage 2 from ``configs/train_stage2.yaml`` (the ``mtl`` engine) on the
  128 px smoke tree at a 128 px crop, the lists and step counts given as
  dotted overrides: the port's ``Trainer.fit`` against the JAX one over two
  micro-steps at accumulation 1 (two AdamW updates; the mixture's seed-0
  draws make both ``seg`` steps, through DeepLabV3+), eps 1e-3 and
  ``base_lr`` 4e-3 as above, both engines on one set of critics
  (``test_torch_tasks.jax_critics``): every TFA leaf within 1e-5, every
  other family bit-unchanged in both, the losses within 1e-5 relative. Then
  the CLI as subprocesses: ``fit`` with sanity validation and a validation
  interval (tasks seg, seg, cls, ir), ``validate`` and ``predict``. A ``cls``
  batch's integer labels reach the step as int64 when the engine computes in
  bf16.

Both engines start from the port's seeded init (zero leaves filled), handed
to the JAX engine in its layout (``test_torch_eval.jax_layout``); the JAX
trainer runs on one CPU device, as the port's does. One JAX fit serves every
test of the module. TensorBoard is kept out (``torch.utils.tensorboard`` and
TensorFlow made unimportable): importing either takes seconds.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_bridge import to_np
# same_native_availability is autouse: the port's fits take the corruption
# path (native kernels or numpy) that the JAX fits took in this process
from test_torch_data import make_smoke_tree, same_native_availability  # noqa: F401
from test_torch_eval import filled_init, jax_layout
from test_torch_tasks import jax_critics
from test_torch_train import _jax_noise
from unirestore_torch import bridge
from unirestore_torch import config as TC
from unirestore_torch import main as TMAIN
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.ops import png
from unirestore_torch.train import checkpoints as TCK
from unirestore_torch.train import engine as TE
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import steps as TS
from unirestore_tpu import config as JC
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.parallel import mesh as JMESH
from unirestore_tpu.train import checkpoints as JCK
from unirestore_tpu.train import engine as JE

REPO = Path(__file__).resolve().parent.parent
STEPS = 4
EPS = 1e-3
STAGE2_YAML = REPO / "configs" / "train_stage2.yaml"
STAGE2_STEPS = 2
STAGE2_PARITY = ["--trainer.max_steps", str(STAGE2_STEPS), "--trainer.accumulate_grad_batches",
                 "1", "--model.init_args.optimizer_kwargs.base_lr", "4e-3",
                 "--trainer.num_sanity_val_steps", "0"]
PARITY = ["--trainer.max_steps", str(STEPS), "--model.init_args.optimizer_kwargs.base_lr", "4e-3",
          "--data.init_args.train.resolution", "128"]
NO_TENSORBOARD = ("tensorflow", "torch.utils.tensorboard")
# terms that compare near-equal features: 5e-6-level relative rounding at step 1
FEATURE_TERMS = ("train/loss_frenc", "train/loss_layer1", "train/loss_layer2", "train/loss_layer3")


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke")
    make_smoke_tree(out)
    return out / "smoke.yaml"


@pytest.fixture(scope="module")
def smoke128(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke128")
    make_smoke_tree(out, res=128)
    return out / "smoke.yaml"


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    for name in NO_TENSORBOARD:
        monkeypatch.setitem(sys.modules, name, None)


def _forcing(make, **forced):
    """``make`` with the keyword arguments ``forced`` over the caller's."""
    def made(*args, **kwargs):
        return make(*args, **{**kwargs, **forced})
    return made


@pytest.fixture(scope="module")
def jax_fit(smoke128, tmp_path_factory):
    """The JAX ``Trainer.fit`` of the parity comparison, run once: returns the
    port's init it started from, its engine and trainer, the step keys and
    its log root."""
    root = tmp_path_factory.mktemp("jax")
    ct = TUR.tiny_config(use_tfa=False, tasks=("ir",))
    frozen, trainable = filled_init(ct)
    pair = (jax_layout(frozen), jax_layout(trainable))
    with pytest.MonkeyPatch.context() as mp:
        for name in NO_TENSORBOARD:  # the JAX logger: JSONL only
            mp.setitem(sys.modules, name, None)
        # the JAX trainer on one device, as the port's (the suite's conftest
        # makes eight virtual ones, which would also scale the learning rate)
        mp.setattr(JE, "make_mesh", lambda: JMESH.make_mesh(jax.devices()[:1]))
        mp.setattr(JUR, "init", lambda key, cfg: pair)
        mp.setattr(optax, "adamw", _forcing(optax.adamw, eps=EPS))
        jcfg = JC.load_config(smoke128, _overrides(root, *PARITY))
        jeng, jtr, jdata, _ = JC.build(jcfg, tiny=True)
        jtr.fit(jeng, jdata, None)
    rng, keys = jax.random.fold_in(jax.random.PRNGKey(42), 0), []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return {"init": (frozen, trainable), "jax_init": pair, "engine": jeng, "trainer": jtr,
            "keys": keys, "root": root, "smoke": smoke128}


def _overrides(root, *extra):
    return ["--trainer.logger.init_args.save_dir", str(root), *extra]


def _stage2_overrides(smoke_yaml, root, *extra):
    """The stage-2 YAML's dotted overrides onto a smoke tree: its lists, a
    128 px crop, no loader threads, the log directory."""
    lists = Path(smoke_yaml).parent / "lists"
    out = []
    for name, lst, splits in (("DIVF2KOST", "ir", ("train", "val")),
                              ("ImageNet", "cls", ("train", "val")),
                              ("FoggyCityscapes", "seg", ("train",)),
                              ("Cityscapes", "seg", ("val",))):
        for split in splits:
            out += [f"--data.init_args.dataset_dict.{name}.{split}", str(lists / f"{lst}.list")]
    return out + ["--data.init_args.train.resolution", "128", "--data.init_args.num_workers", "0",
                  *_overrides(root, *extra)]


@pytest.fixture(scope="module")
def jax_fit_stage2(smoke128, tmp_path_factory):
    """The JAX stage-2 ``Trainer.fit`` of the parity comparison, run once."""
    root = tmp_path_factory.mktemp("jax_stage2")
    ct = TUR.tiny_config(use_tfa=True, tasks=("ir", "cls", "seg"))
    frozen, trainable = filled_init(ct)
    pair = (jax_layout(frozen), jax_layout(trainable))
    critics = jax_critics()
    with pytest.MonkeyPatch.context() as mp:
        for name in NO_TENSORBOARD:
            mp.setitem(sys.modules, name, None)
        mp.setattr(JE, "make_mesh", lambda: JMESH.make_mesh(jax.devices()[:1]))
        mp.setattr(JUR, "init", lambda key, cfg: pair)
        mp.setattr(JE, "build_critics",
                   lambda *a, **k: jax.tree.map(jax.numpy.asarray, critics))
        mp.setattr(optax, "adamw", _forcing(optax.adamw, eps=EPS))
        jcfg = JC.load_config(STAGE2_YAML, _stage2_overrides(smoke128, root, *STAGE2_PARITY))
        jeng, jtr, jdata, _ = JC.build(jcfg, tiny=True)
        jtr.fit(jeng, jdata, None)
    rng, keys = jax.random.fold_in(jax.random.PRNGKey(42), 0), []
    for _ in range(STAGE2_STEPS):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return {"init": (frozen, trainable), "critics": critics, "engine": jeng, "trainer": jtr,
            "keys": keys, "smoke": smoke128}


def _port_run(smoke, root, *extra, noise_fn=None, params=None):
    cfg = TC.load_config(smoke, _overrides(root, *extra))
    engine, trainer, data, _ = TC.build(cfg, tiny=True, device="cpu")
    if params is not None:
        engine.configure_model(params)
    trainer.noise_fn = noise_fn
    trainer.fit(engine, data, None)
    return engine, trainer


def _port_parity_run(root, jax_fit):
    """The port's half of the parity comparison: the JAX init and step noise."""
    jeng, keys = jax_fit["engine"], jax_fit["keys"]

    def noise_fn(step, batch):
        return _jax_noise(jeng.cfg, {"hq": batch["hq"].numpy()}, keys[step])

    params = tuple(bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(t).items()}, t)
                   for t in jax_fit["init"])
    return _port_run(jax_fit["smoke"], root, *PARITY, noise_fn=noise_fn, params=params)


def _assert_fit_matches(teng, ttr, jax_fit):
    jtr = jax_fit["trainer"]
    assert [e["step"] for e in ttr.logs] == [e["step"] for e in jtr.logs] == [1, 2, 3, 4]
    for got, want in zip(ttr.logs, jtr.logs):
        for k, v in want.items():
            if k.startswith("train/"):
                rtol = 1e-4 if k in FEATURE_TERMS else 1e-5
                np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=f"step {want['step']} {k}")
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, jax_fit["engine"].trainable),
                                           teng.trainable, device="cpu"))
    before = bridge.flatten(jax_fit["init"][1])
    moved = set()
    for k, p in TS.trained_leaves(teng.stage, teng.trainable).items():
        np.testing.assert_allclose(to_np(p), to_np(want[k]), atol=1e-5, rtol=0, err_msg=k)
        if not torch.equal(p, before[k]):
            moved.add(k.split("//")[0])
    assert moved == {"cfrm", "controller", "control"}


def _trainable_equal(port_tree, jax_flat):
    for k, v in bridge.flatten(bridge.to_numpy_tree(port_tree)).items():
        np.testing.assert_array_equal(v, jax_flat[k], err_msg=k)


def test_fit_matches_jax_and_checkpoints_resume_across(smoke, tmp_path, jax_fit, monkeypatch,
                                                       capsys):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TOPT, "AdamW", _forcing(TOPT.AdamW, eps=EPS))
        teng, ttr = _port_parity_run(tmp_path / "port", jax_fit)
    _assert_fit_matches(teng, ttr, jax_fit)

    # the JAX trainer's last.npz into the port's trainer: nothing to run at
    # max_steps 4, so it writes back what it loaded; then two more steps
    jax_last = jax_fit["root"] / "checkpoints" / "last.npz"
    jflat, jmeta = JCK.load_checkpoint(str(jax_last))
    assert jmeta["step"] == STEPS
    with pytest.warns(UserWarning, match="optimizer structure changed"):
        back, _ = _port_run(smoke, tmp_path / "from_jax", "--trainer.max_steps", str(STEPS),
                            "--trainer.resume", str(jax_last))
    _trainable_equal(back.trainable, {k[len("trainable//"):]: v for k, v in jflat.items()
                                      if k.startswith("trainable//")})
    _, cont = _port_run(smoke, tmp_path / "from_jax", "--trainer.max_steps", "6",
                        "--trainer.resume", "auto")
    assert [e["step"] for e in cont.logs] == [5, 6]
    assert all(np.isfinite(v) for e in cont.logs for v in e.values())
    out = capsys.readouterr().out
    assert f"[resume] {tmp_path / 'from_jax' / 'checkpoints' / 'last.npz'} @ step 4" in out

    # the port's last.npz into the JAX trainer: nothing to run at max_steps 6
    # (its init is the fixture's: the eager JAX init takes seconds)
    monkeypatch.setattr(JUR, "init", lambda key, cfg: jax_fit["jax_init"])
    port_last = tmp_path / "from_jax" / "checkpoints" / "last.npz"
    pflat, pmeta = TCK.load_checkpoint(str(port_last))
    assert pmeta["step"] == 6
    jcfg2 = JC.load_config(smoke, _overrides(tmp_path / "to_jax", "--trainer.max_steps", "6",
                                             "--trainer.resume", str(port_last)))
    jeng2, jtr2, jdata2, _ = JC.build(jcfg2, tiny=True)
    jtr2.fit(jeng2, jdata2, None)
    assert f"[resume] {port_last} @ step 6" in capsys.readouterr().out
    jflat2, jmeta2 = JCK.load_checkpoint(str(tmp_path / "to_jax" / "checkpoints" / "last.npz"))
    assert jmeta2["step"] == 6
    for k, v in pflat.items():
        if k.startswith("trainable//"):
            np.testing.assert_array_equal(jflat2[k], v, err_msg=k)


def _update_every_micro_step(mp):
    mp.setattr(TOPT, "AdamW", _forcing(TOPT.AdamW, eps=EPS, accum_iter=1))


def _schedule_at_micro_steps(mp):
    lr = TOPT.AdamW._lr
    # update n (0-based) comes after micro-step 2n + 1 (0-based) at accumulation 2
    mp.setattr(TOPT.AdamW, "_lr", lambda self, count: lr(self, 2 * count + 1))
    mp.setattr(TOPT, "AdamW", _forcing(TOPT.AdamW, eps=EPS))


@pytest.mark.parametrize("plant", [_update_every_micro_step, _schedule_at_micro_steps],
                         ids=["update_every_micro_step", "schedule_at_micro_steps"])
def test_fit_parity_catches_a_planted_optimizer_fault(smoke, tmp_path, jax_fit, monkeypatch,
                                                      plant):
    plant(monkeypatch)
    teng, ttr = _port_parity_run(tmp_path, jax_fit)
    with pytest.raises(AssertionError):
        _assert_fit_matches(teng, ttr, jax_fit)


def _cli(*args):
    # ``python -m unirestore_torch.main`` with TensorBoard unimportable, on one
    # intra-op thread, a test worker's share of the host: beside the suite's
    # other workers a subprocess with a thread per core spins them against
    # each other (on an 8-core host the three runs of the fit test took 157 s
    # beside five busy processes with a thread per core, 32 s with one
    # thread; 25 s alone)
    run = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
           "runpy.run_module('unirestore_torch.main', run_name='__main__', alter_sys=True)")
    res = subprocess.run([sys.executable, "-c", run, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_cli_fit_resume_and_predict_on_the_cpu(smoke, tmp_path):
    root = tmp_path / "logs"
    base = ["--config", str(smoke), "--tiny", "--device", "cpu",
            *_overrides(root, "--trainer.limit_val_batches", "1")]
    out = _cli("fit", *base, "--trainer.max_steps", "2", "--trainer.val_check_interval", "2",
               "--trainer.num_sanity_val_steps", "1")
    assert "[sanity] running 1 validation steps" in out and "[fit] done at step 2" in out
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    assert len(ckpts) == 2 and ckpts[0] == "last.npz" and ckpts[1].startswith("step=2-val=")
    records = [json.loads(line) for line in (root / "train" / "metrics.jsonl").read_text()
               .splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in records)

    out = _cli("fit", *base, "--trainer.max_steps", "3", "--trainer.resume", "auto")
    assert f"[resume] {root / 'checkpoints' / 'last.npz'} @ step 2" in out
    assert "[fit] done at step 3" in out
    assert TCK.load_checkpoint(str(root / "checkpoints" / "last.npz"))[1]["step"] == 3

    out = _cli("predict", *base)
    pngs = sorted((root / "predict").iterdir())
    assert len(pngs) == 6 and "[predict] wrote outputs" in out
    for p in pngs:
        img = png.decode(p.read_bytes())
        assert img.shape == (96, 112, 3) and img.dtype == np.uint8


def test_cli_needs_a_gpu_unless_a_device_is_given(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMAIN.main(["fit", "--config", str(smoke), "--tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMAIN.main(["fit", "--config", str(STAGE2_YAML), "--tiny"])
    # --distributed starts a process group; outside torchrun there is none to join
    for name in ("MASTER_ADDR", "WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="no rendezvous"):
        TMAIN.main(["fit", "--config", str(smoke), "--tiny", "--device", "cpu",
                    "--distributed"])


def test_stage2_fit_matches_jax(tmp_path, jax_fit_stage2, monkeypatch):
    jf = jax_fit_stage2
    jeng, keys = jf["engine"], jf["keys"]
    monkeypatch.setattr(TOPT, "AdamW", _forcing(TOPT.AdamW, eps=EPS))
    cfg = TC.load_config(STAGE2_YAML, _stage2_overrides(jf["smoke"], tmp_path, *STAGE2_PARITY))
    teng, ttr, data, _ = TC.build(cfg, tiny=True, device="cpu")
    init = tuple(bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(t).items()}, t)
                 for t in jf["init"])
    teng.configure_model(init)
    teng.critics = bridge.critics_from_jax(jf["critics"], device="cpu")
    ttr.noise_fn = lambda step, batch: _jax_noise(jeng.cfg, {"hq": batch["hq"].numpy()},
                                                  keys[step])
    ttr.fit(teng, data, None)

    jtr = jf["trainer"]
    assert [e["step"] for e in ttr.logs] == [e["step"] for e in jtr.logs] == [1]
    for got, want in zip(ttr.logs, jtr.logs):
        assert "train/loss_seg" in want
        for k, v in want.items():
            if k.startswith("train/"):
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, jeng.trainable),
                                           teng.trainable, device="cpu"))
    before = bridge.flatten(jf["init"][1])
    moved = set()
    for k, p in bridge.flatten(teng.trainable).items():
        if k.startswith("tfa//"):
            np.testing.assert_allclose(to_np(p), to_np(want[k]), atol=1e-5, rtol=0, err_msg=k)
            moved |= {k} if not torch.equal(p, before[k]) else set()
        else:  # the frozen families: bit-unchanged in both
            assert torch.equal(p, before[k]) and torch.equal(want[k], before[k]), k
    assert moved == {k for k in want if k.startswith("tfa//")}


def test_stage2_cli_fit_validate_and_predict_on_the_cpu(smoke128, tmp_path):
    root = tmp_path / "logs"
    base = ["--config", str(STAGE2_YAML), "--tiny", "--device", "cpu",
            *_stage2_overrides(smoke128, root, "--trainer.limit_val_batches", "3")]
    out = _cli("fit", *base, "--trainer.max_steps", "4", "--trainer.val_check_interval", "4",
               "--trainer.accumulate_grad_batches", "2", "--trainer.log_every_n_steps", "1")
    assert "Skipping frenc ckpt placeholder" in out and "Skipping cnet ckpt placeholder" in out
    assert "[sanity] running 2 validation steps" in out and "[fit] done at step 4" in out
    for task in ("seg", "cls", "ir"):
        assert f"train/loss_{task}=" in out, task
    for key in ("val_ir_lq/psnr", "val_cls_lq/r50v1", "val_cls_hq/r50v1", "val_seg_lq/dlv3pr50"):
        assert key in out, key
    ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
    assert len(ckpts) == 2 and ckpts[0] == "last.npz" and ckpts[1].startswith("step=4-val=")
    flat, meta = TCK.load_checkpoint(str(root / "checkpoints" / "last.npz"))
    assert meta["step"] == 4
    # only the TFA leaves train: the rest of last.npz is the seeded init
    ct = TUR.tiny_config(use_tfa=True, tasks=("ir", "cls", "seg"))
    _, init = TUR.init(ct, device="cpu", seed=42)
    moved = set()
    for k, v in bridge.flatten(bridge.to_numpy_tree(init)).items():
        saved = flat[f"trainable//{k}"]
        if not np.array_equal(saved, v):
            moved.add(k.split("//")[0])
    assert moved == {"tfa"}

    out = _cli("validate", *base)
    assert "val_monitor" in out and "val_seg_lq/dlv3pr50" in out
    out = _cli("predict", *base)
    pngs = sorted((root / "predict").iterdir())
    assert "[predict] wrote outputs" in out and len(pngs) >= 10
    for p in pngs:
        assert png.decode(p.read_bytes()).dtype == np.uint8


def test_integer_labels_keep_their_dtype_in_a_bf16_fit(smoke128, tmp_path, monkeypatch):
    """An ImageNet class above 256 is not exact in bf16: the fit casts only
    the float tensors of a batch to ``compute_dtype``."""
    lists = smoke128.parent / "lists"
    rows = (lists / "cls.list").read_text().splitlines()
    labelled = tmp_path / "cls999.list"
    labelled.write_text("\n".join(" ".join(r.split()[:2] + ["999"]) for r in rows))
    # the mixture's seed-0 draws: seg, seg, cls
    cfg = TC.load_config(STAGE2_YAML, _stage2_overrides(
        smoke128, tmp_path, "--trainer.max_steps", "3", "--trainer.num_sanity_val_steps", "0",
        "--data.init_args.dataset_dict.ImageNet.train", str(labelled)))
    engine, trainer, data, _ = TC.build(cfg, tiny=True, device="cpu")
    engine.compute_dtype = torch.bfloat16
    seen = {}

    def step(self, step_fn, trainable, opt_state, batch, i, draw):
        seen[step_fn.task] = {k: v.clone() for k, v in batch.items()}
        return trainable, opt_state, {"train/loss": torch.zeros(())}

    monkeypatch.setattr(TE.Trainer, "_step", step)
    trainer.fit(engine, data, None)
    assert seen.keys() == {"seg", "cls"}
    for batch in seen.values():
        assert batch["lq"].dtype == batch["hq"].dtype == torch.bfloat16
        assert batch["gt"].dtype == torch.int64
    assert seen["cls"]["gt"].tolist() == [999]
