"""Port parity: the training CLI under torchrun, data-parallel on the CPU.

``python -m torch.distributed.run --standalone --nproc_per_node 2`` runs
``unirestore_torch.main fit --tiny --device cpu --distributed`` (gloo) on the
128 px smoke tree of ``tools/make_smoke_data.py`` (global batch 2, 128 px
crops: at 64 px the tiny Controller's 1x1 level leaves its gradients 1e-4
apart between a batch of two and two batches of one, ``test_torch_train.py``;
accumulation 2), two micro-steps (one update) with a validation after
them, SGD at ``base_lr`` 0.4 (linear in the gradients, so the rank-order sums
differ from one process's only in rounding, and the update moves leaves by
up to 1e-2): only rank 0 writes (one ``metrics.jsonl`` record a step, one
top-k checkpoint); ``last.npz`` equals a one-process fit on the same global
batch to 1e-5, with ``base_bsz`` halved so that both peak learning rates are
JAX's ``effective_lr`` at 2 devices, which the 2-rank run prints;
the run with ``--trainer.fsdp true`` writes the same ``last.npz``; a 2-rank
resume continues. TensorBoard is kept out of the ranks (its import takes
seconds). Every subprocess has a timeout.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_data import make_smoke_tree
from unirestore_torch import bridge
from unirestore_torch import config as TC
from unirestore_torch import main as TMAIN
from unirestore_torch.train import checkpoints as TCK
from unirestore_tpu.train import optim as JOPT

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300
STEPS = 2
BASE_LR = 0.4
RUN = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
       "sys.modules['tensorflow'] = None; "
       "runpy.run_module('unirestore_torch.main', run_name='__main__', alter_sys=True)")


def _args(smoke, root, *extra):
    return ["fit", "--config", str(smoke), "--tiny", "--device", "cpu", *_overrides(root, *extra)]


def _overrides(root, *extra):
    return ["--trainer.max_steps", str(STEPS), "--trainer.log_every_n_steps", "1",
            "--trainer.val_check_interval", str(STEPS), "--trainer.limit_val_batches", "1",
            "--model.init_args.optimizer_kwargs.opt", "sgd",
            "--model.init_args.optimizer_kwargs.base_lr", str(BASE_LR),
            "--data.init_args.num_workers", "0", "--data.init_args.train.resolution", "128",
            "--trainer.logger.init_args.save_dir", str(root), *extra]


def _torchrun(*args):
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "--no-python", sys.executable, "-c", RUN, *args],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def _trainable(root):
    flat, meta = TCK.load_checkpoint(str(root / "checkpoints" / "last.npz"))
    return {k: v for k, v in flat.items() if k.startswith("trainable//")}, meta


def _records(root):
    return [json.loads(line) for line in (root / "train" / "metrics.jsonl").read_text()
            .splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ddp")
    make_smoke_tree(base / "smoke", res=128)
    smoke = base / "smoke" / "smoke.yaml"
    out = {"smoke": smoke, "ddp": base / "ddp", "fsdp": base / "fsdp", "one": base / "one"}
    out["ddp_stdout"] = _torchrun(*_args(smoke, out["ddp"]), "--distributed")
    out["fsdp_stdout"] = _torchrun(*_args(smoke, out["fsdp"]), "--distributed",
                                   "--trainer.fsdp", "true")
    with pytest.MonkeyPatch.context() as mp:
        for name in ("torch.utils.tensorboard", "tensorflow"):
            mp.setitem(sys.modules, name, None)
        one = ("--model.init_args.optimizer_kwargs.base_bsz", "32")
        TMAIN.main(_args(smoke, out["one"], *one))
        cfg = TC.load_config(str(smoke), _overrides(base / "init", *one))
        engine, _, _, _ = TC.build(cfg, tiny=True, device="cpu")
    out["init"] = {f"trainable//{k}": v
                   for k, v in bridge.flatten(bridge.to_numpy_tree(engine.trainable)).items()}
    return out


def test_only_rank0_writes_and_the_peak_lr_is_jax_at_two_devices(runs):
    out = runs["ddp_stdout"]
    assert "[distributed] process 0/2" in out and "[distributed] process 1/2" in out
    peak = JOPT.effective_lr(BASE_LR, 64, 2, 2, 2)
    assert out.count(f"[optimizer] peak lr {peak:.2e} over {STEPS} steps") == 2
    assert [r["step"] for r in _records(runs["ddp"])] == list(range(1, STEPS + 1))
    ckpts = sorted(p.name for p in (runs["ddp"] / "checkpoints").iterdir())
    assert len(ckpts) == 2 and ckpts[0] == "last.npz" and ckpts[1].startswith(f"step={STEPS}-")
    assert out.count(f"[fit] done at step {STEPS}") == 2


def test_two_rank_fit_equals_one_process_on_the_global_batch(runs):
    ddp, meta = _trainable(runs["ddp"])
    one, _ = _trainable(runs["one"])
    assert meta["step"] == STEPS and ddp.keys() == one.keys()
    for k, v in one.items():
        np.testing.assert_allclose(ddp[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert max(np.abs(v - runs["init"][k]).max() for k, v in one.items()) > 1e-3
    ddp_logs = {r["step"]: r for r in _records(runs["ddp"])}
    for r in _records(runs["one"]):
        np.testing.assert_allclose(ddp_logs[r["step"]]["train/loss"], r["train/loss"],
                                   rtol=1e-5)


def test_fsdp_fit_writes_the_same_last_npz(runs):
    assert re.search(r"\[fsdp\] sharded \d+% of trainable / \d+% of frozen elements over 2 "
                     r"devices", runs["fsdp_stdout"])
    ddp, _ = _trainable(runs["ddp"])
    fsdp, meta = _trainable(runs["fsdp"])
    assert meta["step"] == STEPS
    for k, v in ddp.items():
        np.testing.assert_array_equal(fsdp[k], v, err_msg=k)
    assert [r["step"] for r in _records(runs["fsdp"])] == list(range(1, STEPS + 1))


def test_two_rank_resume_continues(runs):
    out = _torchrun(*_args(runs["smoke"], runs["ddp"], "--trainer.resume", "auto",
                           "--trainer.max_steps", str(STEPS + 1)), "--distributed")
    last = runs["ddp"] / "checkpoints" / "last.npz"
    assert out.count(f"[resume] {last} @ step {STEPS}") == 2
    assert _trainable(runs["ddp"])[1]["step"] == STEPS + 1
    assert [r["step"] for r in _records(runs["ddp"])] == list(range(1, STEPS + 2))
