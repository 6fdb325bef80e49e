"""The port's memory diagnostics (``unirestore_torch/diagnostics/fsdp_memory.py``,
``train_memory.py``) against the JAX package's tools
(``tools/debug_fsdp_memory.py``, ``tools/debug_train_memory.py``), on the CPU.

- The FSDP table at 2, 4 and 8 devices against the tool's ``_bytes`` /
  ``_fsdp_bytes`` over its ``jax.eval_shape`` trees: the frozen and trainable
  rows bit-equal; the optimizer rows differ by optax's int32 ``count`` leaves
  alone (the port keeps its step counts on the host).
- ``state_bytes`` (``chip_smoke.py`` phase 16 (c)) gives the bytes phase 16
  counted before the module existed: numel x 2 (frozen), x 4 (trainable),
  x 8 (AdamW's two slots).
- The ``cn`` part's loss and gradients (``train_memory.cn_value_and_grad``)
  against JAX's ``value_and_grad`` of the same part (the tool's ``cn``,
  ``train/steps.py:cn_part``) on the tiny model at 128 px: the loss within
  1e-5 relative, each gradient within 1e-4 of its family's largest plus 1e-4
  relative.
- The ``fsdp_memory`` command line with JAX and the JAX package unimportable.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import to_np
from test_torch_convert import run_blocked
from test_torch_eval import filled_init, jax_layout
from unirestore_torch import bridge
from unirestore_torch.diagnostics import fsdp_memory as FM
from unirestore_torch.diagnostics import train_memory as TMEM
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.parallel import fsdp as FSDP
from unirestore_torch.train import steps as TS
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import optim as JOPT
from unirestore_tpu.train import steps as JS

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import debug_fsdp_memory as JFM  # noqa: E402

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def jax_trees():
    """The tool's three trees (``main``, :55-64), as shapes."""
    cfg = JUR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg"))

    def build():
        frozen, trainable = JUR.init(jax.random.PRNGKey(0), cfg)
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16), frozen), trainable

    frozen, trainable = jax.eval_shape(build)
    opt_state = jax.eval_shape(JOPT.make_optimizer(lr=1e-4).init, trainable)
    return {"frozen_bf16": frozen, "trainable_fp32": trainable, "adamw_slots_fp32": opt_state}


@functools.lru_cache(maxsize=None)
def port_trees():
    return FM.state_trees()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_table_matches_the_jax_tool(n):
    got = FM.table(n, port_trees())
    jax_rows = {name: (JFM._bytes(tree), JFM._fsdp_bytes(tree, n))
                for name, tree in jax_trees().items()}
    for name in ("frozen_bf16", "trainable_fp32"):
        assert got[name] == jax_rows[name], name
    counts = [leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jax_trees()["adamw_slots_fp32"])[0]
              if getattr(path[-1], "name", None) == "count"]
    assert counts and all(leaf.shape == () and leaf.dtype == jnp.int32 for leaf in counts)
    extra = sum(leaf.dtype.itemsize for leaf in counts)
    want = jax_rows["adamw_slots_fp32"]
    assert got["adamw_slots_fp32"] == (want[0] - extra, want[1] - extra)
    assert got["total"] == tuple(sum(r[i] for k, r in got.items() if k != "total")
                                 for i in range(2))


def test_state_bytes_are_phase_16s():
    """The bytes phase 16 (c) computed inline before the module: each tree's
    elements times 2, 4 and 8 bytes, a sharded leaf's elements // n."""
    frozen, trainable = TUR.init(TUR.UniRestoreConfig(use_tfa=True, tasks=("ir", "cls", "seg")),
                                 device="meta")
    trees = {"frozen_bf16": (frozen, 2), "trainable_fp32": (trainable, 4),
             "adamw_slots_fp32": (trainable, 8)}
    got = FM.state_bytes((2, 4, 8))
    for n in (2, 4, 8):
        for name, (tree, nbytes) in trees.items():
            leaves = list(bridge.flatten(tree).values())
            rep = sum(v.numel() for v in leaves) * nbytes
            sharded = sum((v.numel() // n if FSDP.fsdp_spec(v, n) else v.numel())
                          for v in leaves) * nbytes
            assert got[n][name] == {"replicated_gib": rep / 2**30, "fsdp_gib": sharded / 2**30}
        assert set(got[n]) == {*trees, "total"}


def test_fsdp_memory_cli_runs_without_jax():
    res = run_blocked("unirestore_torch.diagnostics", "fsdp_memory", "--devices", "4")
    lines = res.stdout.strip().splitlines()
    assert lines[0].split()[:3] == ["state", "replicated/chip", "fsdp/chip"]
    assert "(mesh = 4 devices)" in lines[0]
    rows = FM.table(4, port_trees())
    for line, (name, (r, f)) in zip(lines[1:], rows.items()):
        assert f"{r / 2**20:>13.1f} MB {f / 2**20:>9.1f} MB" in line, name
    assert lines[-1].startswith("TOTAL persistent state")


def test_cn_loss_and_gradients_match_jax():
    cj = JUR.tiny_config(use_tfa=False, tasks=("ir",))
    ct = TUR.tiny_config(use_tfa=False, tasks=("ir",))
    ft, tt = filled_init(ct, seed=5)
    fj, tj = jax_layout(ft), jax_layout(tt)
    rng = np.random.default_rng(6)
    lat = (1, 16, 16, 4)  # a 128 px crop's latents
    zt, l0, h0 = (rng.standard_normal(lat).astype(np.float32) for _ in range(3))
    ts = np.array([749], np.int32)

    sched = JUR.schedule(cj)
    sub = {k: tj[k] for k in ("controller", "control")}
    rest = {k: v for k, v in tj.items() if k not in sub}

    def f(s):
        pred = JUR.predict_z0(fj, {**rest, **s}, cj, sched, zt, l0, ts)
        return JS._mse(pred, h0)

    loss_j, grads_j = jax.jit(jax.value_and_grad(f))(sub)

    loss, grads = TMEM.cn_value_and_grad(ft, tt, TS.with_remat(ct), TUR.schedule(ct),
                                         *(torch.from_numpy(a) for a in (zt, l0)),
                                         torch.from_numpy(ts), torch.from_numpy(h0))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    template = {k: tt[k] for k in sub}
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, grads_j), template,
                                           device="cpu"))
    assert want.keys() == grads.keys() == TMEM.cn_leaves(tt).keys()
    scale = {}
    for k, ref in want.items():
        fam = k.split("//")[0]
        scale[fam] = max(scale.get(fam, 0.0), float(ref.abs().max()))
    assert set(scale) == {"controller", "control"} and min(scale.values()) > 0
    for k, g in grads.items():
        fam = k.split("//")[0]
        np.testing.assert_allclose(to_np(g), to_np(want[k]), rtol=1e-4,
                                   atol=1e-4 * scale[fam] + 1e-12, err_msg=k)
    assert not any(p.requires_grad for p in bridge.flatten(tt).values())
