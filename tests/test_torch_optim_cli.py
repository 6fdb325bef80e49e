"""The training CLI takes every optimizer name of the JAX ``make_optimizer``.

``main fit --tiny --device cpu ... --model.init_args.optimizer_kwargs.opt
<name>`` in this process (``config.load_config`` / ``config.build`` /
``Trainer.fit``, as ``tests/test_torch_cli.py`` runs it) on the 96 px smoke
tree: two updates, finite logs. The update rules themselves are held to optax
in ``tests/test_torch_optim.py``.
"""

import sys

import numpy as np
import pytest
import torch

from test_torch_data import make_smoke_tree
from test_torch_optim import NAMES
from unirestore_torch import config as TC

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke")
    make_smoke_tree(out)
    return out / "smoke.yaml"


@pytest.mark.parametrize("name", NAMES)
def test_fit_through_the_cli_takes_every_name(name, smoke, tmp_path, monkeypatch):
    for mod in ("tensorflow", "torch.utils.tensorboard"):  # see tests/test_torch_cli.py
        monkeypatch.setitem(sys.modules, mod, None)
    cfg = TC.load_config(smoke, [
        "--trainer.default_root_dir", str(tmp_path), "--trainer.max_steps", "2",
        "--trainer.accumulate_grad_batches", "1", "--trainer.num_sanity_val_steps", "0",
        "--trainer.val_check_interval", "100", "--data.init_args.train.resolution", "64",
        "--model.init_args.optimizer_kwargs.opt", name])
    engine, trainer, data, _ = TC.build(cfg, tiny=True, device="cpu")
    trainer.fit(engine, data, None)
    assert [e["step"] for e in trainer.logs] == [1, 2], name
    assert all(np.isfinite(v) for e in trainer.logs for v in e.values()), name
