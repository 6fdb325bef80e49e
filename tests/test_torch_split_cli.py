"""Port parity: the train step through ``Trainer`` (``trainer.split_step``,
``trainer.stop_after``) and under data parallelism.

- ``Trainer.fit`` from ``configs/train_stage1.yaml`` with dotted overrides
  (the 128 px smoke tree's lists, a 128 px crop, two micro-steps at the
  YAML's accumulation 2, so one AdamW update; eps 1e-3 and ``base_lr`` 4e-3
  as ``test_torch_cli.py`` takes them, for the reasons its docstring gives),
  the JAX step noise injected: with ``--trainer.split_step true`` every
  logged value and every array of ``last.npz`` are bit-equal to the same fit
  with ``chip_smoke.monolithic_step`` in place of the step (the step computes
  the same values, ``test_torch_split_step.py``), and the fit holds to the
  JAX ``Trainer.fit`` with ``split_step`` at ``test_torch_cli.py``'s
  tolerances: trained leaves within 1e-5, losses within 1e-5 relative, the
  terms that compare near-equal features within 1e-4 relative.
- ``--trainer.stop_after fr`` runs the truncated step, validates nothing at
  the interval and writes no checkpoint; ``stop_after`` without
  ``split_step``, or naming no part, raises JAX's ``ValueError``.
- Two gloo ranks (``test_torch_parallel.run_ranks``), two stage-1 steps on a
  global batch of 2 at 64 px, under DDP and under FSDP (``min_size=64``),
  with SGD and with AdamW: the step's logs and gathered trainable tree are
  bit-equal to ``monolithic_step``'s on both ranks.

TensorBoard is kept out (``test_torch_cli.no_tensorboard``).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from chip_smoke import monolithic_step
from test_torch_bridge import to_np
from test_torch_cli import EPS, FEATURE_TERMS, NO_TENSORBOARD, _forcing, no_tensorboard  # noqa: F401
# the port's fits take the corruption path (native or numpy) of the JAX fit's
from test_torch_data import make_smoke_tree, same_native_availability  # noqa: F401
from test_torch_eval import filled_init, jax_layout
from test_torch_parallel import run_ranks
from test_torch_train import _jax_noise
from unirestore_torch import bridge
from unirestore_torch import config as TC
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.parallel import distributed as DIST
from unirestore_torch.parallel import fsdp as FSDP
from unirestore_torch.parallel import mesh as MESH
from unirestore_torch.train import checkpoints as TCK
from unirestore_torch.train import engine as TE
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import steps as TS
from unirestore_tpu import config as JC
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.parallel import mesh as JMESH
from unirestore_tpu.train import engine as JE

REPO = Path(__file__).resolve().parent.parent
STAGE1_YAML = REPO / "configs" / "train_stage1.yaml"
STEPS = 2
SPLIT = ["--trainer.split_step", "true"]


def _overrides(smoke_yaml, root, *extra):
    """The stage-1 YAML's dotted overrides onto the smoke tree."""
    ir_list = str(Path(smoke_yaml).parent / "lists" / "ir.list")
    return ["--data.init_args.dataset_dict.DIVF2KOST.train", ir_list,
            "--data.init_args.dataset_dict.DIVF2KOST.val", ir_list,
            "--data.init_args.train.resolution", "128", "--data.init_args.num_workers", "0",
            "--trainer.num_sanity_val_steps", "0", "--trainer.max_steps", str(STEPS),
            "--trainer.log_every_n_steps", "1",
            "--model.init_args.optimizer_kwargs.base_lr", "4e-3",
            "--trainer.logger.init_args.save_dir", str(root), *extra]


@pytest.fixture(scope="module")
def smoke128(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke128")
    make_smoke_tree(out, res=128)
    return out / "smoke.yaml"


@pytest.fixture(scope="module")
def jax_split_fit(smoke128, tmp_path_factory):
    """The JAX ``Trainer.fit`` with ``split_step``, run once, from the port's
    init; returns that init, the JAX engine and trainer and the step keys."""
    root = tmp_path_factory.mktemp("jax_split")
    frozen, trainable = filled_init(TUR.tiny_config(use_tfa=False, tasks=("ir",)))
    pair = (jax_layout(frozen), jax_layout(trainable))
    with pytest.MonkeyPatch.context() as mp:
        for name in NO_TENSORBOARD:
            mp.setitem(sys.modules, name, None)
        mp.setattr(JE, "make_mesh", lambda: JMESH.make_mesh(jax.devices()[:1]))
        mp.setattr(JUR, "init", lambda key, cfg: pair)
        mp.setattr(optax, "adamw", _forcing(optax.adamw, eps=EPS))
        jcfg = JC.load_config(STAGE1_YAML, _overrides(smoke128, root, *SPLIT))
        jeng, jtr, jdata, _ = JC.build(jcfg, tiny=True)
        assert jtr.split_step
        jtr.fit(jeng, jdata, None)
    rng, keys = jax.random.fold_in(jax.random.PRNGKey(42), 0), []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return {"init": (frozen, trainable), "engine": jeng, "trainer": jtr, "keys": keys}


def _monolithic(*args, stop_after=None, **kw):
    """``monolithic_step`` where the trainer asks for ``make_train_step``."""
    assert stop_after is None
    return monolithic_step(*args, **kw)


def _port_fit(smoke, root, jax_fit, *extra, factory=False, make=None):
    """The port's fit from the JAX fit's init with its step noise (the step
    from ``make``, if given, in place of ``make_train_step``)."""
    cfg = TC.load_config(STAGE1_YAML, _overrides(smoke, root, *extra))
    engine, trainer, data, evaluator_factory = TC.build(cfg, tiny=True, device="cpu")
    engine.configure_model(tuple(
        bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(t).items()}, t)
        for t in jax_fit["init"]))
    keys, cj = jax_fit["keys"], jax_fit["engine"].cfg
    trainer.noise_fn = lambda step, batch: _jax_noise(cj, {"hq": batch["hq"].numpy()}, keys[step])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TOPT, "AdamW", _forcing(TOPT.AdamW, eps=EPS))
        if make is not None:
            mp.setattr(TS, "make_train_step", make)
        trainer.fit(engine, data, evaluator_factory if factory else None)
    return engine, trainer


def test_split_fit_equals_the_monolithic_fit_and_matches_jax(smoke128, tmp_path, jax_split_fit):
    teng, ttr = _port_fit(smoke128, tmp_path / "split", jax_split_fit, *SPLIT)
    _, mtr = _port_fit(smoke128, tmp_path / "mono", jax_split_fit, make=_monolithic)
    assert ttr.split_step and not mtr.split_step
    assert [e["step"] for e in ttr.logs] == [e["step"] for e in mtr.logs] == [1, 2]
    for got, want in zip(ttr.logs, mtr.logs):
        assert {k: v for k, v in got.items() if k != "imgs_per_sec"} == \
            {k: v for k, v in want.items() if k != "imgs_per_sec"}
    split_last, split_meta = TCK.load_checkpoint(str(tmp_path / "split/checkpoints/last.npz"))
    mono_last, mono_meta = TCK.load_checkpoint(str(tmp_path / "mono/checkpoints/last.npz"))
    assert split_meta["step"] == mono_meta["step"] == STEPS
    assert split_last.keys() == mono_last.keys()
    for k, v in split_last.items():
        np.testing.assert_array_equal(v, mono_last[k], err_msg=k)

    jtr = jax_split_fit["trainer"]
    assert [e["step"] for e in jtr.logs] == [1, 2]
    for got, want in zip(ttr.logs, jtr.logs):
        for k, v in want.items():
            if k.startswith("train/"):
                rtol = 1e-4 if k in FEATURE_TERMS else 1e-5
                np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=f"step {want['step']} {k}")
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray,
                                                        jax_split_fit["engine"].trainable),
                                           teng.trainable, device="cpu"))
    before = bridge.flatten(jax_split_fit["init"][1])
    moved = set()
    for k, p in TS.trained_leaves(teng.stage, teng.trainable).items():
        np.testing.assert_allclose(to_np(p), to_np(want[k]), atol=1e-5, rtol=0, err_msg=k)
        if not torch.equal(p, before[k]):
            moved.add(k.split("//")[0])
    assert moved == {"cfrm", "controller", "control"}


def test_stop_after_validates_nothing_and_writes_no_checkpoint(smoke128, tmp_path, jax_split_fit,
                                                              capsys):
    root = tmp_path / "stop"
    engine, trainer = _port_fit(smoke128, root, jax_split_fit, *SPLIT, "--trainer.stop_after",
                                "fr", "--trainer.max_steps", "1", "--trainer.val_check_interval",
                                "1", factory=True)
    assert trainer.stop_after == "fr"
    assert [sorted(e) for e in trainer.logs] == [["imgs_per_sec", "step", "train/loss"]]
    assert not (root / "checkpoints").exists() or not any((root / "checkpoints").iterdir())
    out = capsys.readouterr().out
    assert "[fit] stop_after=fr pass done at step 1; no checkpoint written" in out
    assert "val_monitor" not in out
    for k, p in bridge.flatten(engine.trainable).items():
        assert torch.equal(p, bridge.flatten(jax_split_fit["init"][1])[k]), k


@pytest.mark.parametrize("kw", [dict(stop_after="fr"), dict(split_step=False, stop_after="cn"),
                                dict(split_step=True, stop_after="apply")])
def test_stop_after_is_refused_as_jax_refuses_it(kw):
    with pytest.raises(ValueError) as t_err:
        TE.Trainer(**kw)
    with pytest.raises(ValueError) as j_err:
        JE.Trainer(**kw)
    assert str(t_err.value) == str(j_err.value)


# -- two gloo ranks --------------------------------------------------------------

WORLD = 2
MIN_SIZE = 64
STAGE1 = dict(train_cfrm=True, train_cnet=True, train_tfa=False)
RANK_CASES = [(mode, opt) for mode in ("ddp", "fsdp") for opt in ("sgd", "adamw")]


def _rank_fit(rank, mesh, make, mode, opt, trees, inputs):
    """Two steps of ``make`` on this rank's rows: (logs, the gathered trainable)."""
    cfg, stage, group = TUR.tiny_config(use_tfa=True, tasks=("ir",)), TS.StageConfig(**STAGE1), \
        mesh.get_group("data")
    frozen, trainable = (bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(t).items()},
                                               t) for t in trees)
    tx = TOPT.make_optimizer(opt, lr=1e-3)
    state = tx.init(TS.trained_leaves(stage, trainable))
    if mode == "fsdp":
        frozen = FSDP.fsdp_shard(mesh, frozen, min_size=MIN_SIZE)
        trainable = FSDP.fsdp_shard(mesh, trainable, min_size=MIN_SIZE)
        state = tx.shard_state(state, TS.trained_leaves(stage, trainable), rank)
    step = make(frozen, cfg, TUR.schedule(cfg), stage, tx, "ir", group=group)
    logs = []
    for batch, noise in inputs:
        rows = DIST.process_local_rows(batch["hq"].shape[0])
        trainable, state, out = step(trainable, state, {k: v[rows] for k, v in batch.items()},
                                     TS.local_noise(noise, rows))
        logs.append({k: v.item() for k, v in out.items()})
    full = FSDP.gather_tree(trainable, group)
    return logs, bridge.flatten(bridge.to_numpy_tree(full))


def _rank_main(rank, init_file, out_dir, payload):
    import pickle
    import traceback

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = MESH.make_mesh()
        cfg = TUR.tiny_config(use_tfa=True, tasks=("ir",))
        trees = TUR.init(cfg, device="cpu", seed=70)
        gen = torch.Generator().manual_seed(71)
        inputs = []
        for _ in range(2):
            batch = {k: torch.rand((WORLD, 64, 64, 3), generator=gen) for k in ("lq", "hq")}
            inputs.append((batch, TS.draw_noise(cfg, batch, gen)))
        res = {(mode, opt, name): _rank_fit(rank, mesh, make, mode, opt, trees, inputs)
               for mode, opt in RANK_CASES
               for name, make in (("mono", monolithic_step), ("split", TS.make_train_step))}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def split_ranks(tmp_path_factory):
    return run_ranks(_rank_main, tmp_path_factory.mktemp("split_ranks"), None)


@pytest.mark.parametrize("mode,opt", RANK_CASES)
def test_two_rank_split_step_equals_the_monolithic_step(split_ranks, mode, opt):
    for rank, res in enumerate(split_ranks):
        mono_logs, mono = res[(mode, opt, "mono")]
        split_logs, split = res[(mode, opt, "split")]
        assert split_logs == mono_logs, rank
        assert split.keys() == mono.keys()
        for k, v in split.items():
            np.testing.assert_array_equal(v, mono[k], err_msg=f"rank {rank} {k}")
    # both ranks hold the same tree, and the step moved it
    assert all(np.array_equal(v, split_ranks[1][(mode, opt, "split")][1][k])
               for k, v in split_ranks[0][(mode, opt, "split")][1].items())
    assert split_ranks[0][(mode, opt, "split")][0][0]["train/loss"] > 0
