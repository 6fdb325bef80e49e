"""The graph route's switches in the engine, the trainer and the CLI, on the CPU.

``trainer.cuda_graphs`` (YAML or dotted override) reaches both the
``Trainer`` and the ``UniFIEEngine`` and is off by default; the engine keeps
``UNIRESTORE_JIT_CACHE_SIZE`` graph-captured restores (default 8, at least
1), the bound the JAX engine puts on its compiled restores (``_jit_cache``);
the engine's graph route refuses the CPU, a process group, FSDP shards, a
spatial context and the ``det`` engine, and the trainer refuses ``fsdp`` and
a CPU step, with no eager fallback. The route itself runs on the card
(``chip_smoke.py`` phase 19).
"""

import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_eval import STAGE1, filled_init, jax_init_from  # noqa: F401 (fixture)
from test_torch_graph_step import _sharded
from test_torch_spatial import _fake_context
from unirestore_torch import config as C
from unirestore_torch import graphs as GR
from unirestore_torch import main as TMAIN
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.parallel import spatial as SP
from unirestore_torch.train import engine as TE
from unirestore_tpu.train import engine as JE

torch.set_num_threads(2)


def _engine(**kw):
    ct = TUR.tiny_config(use_tfa=False, tasks=("ir",))
    return TE.UniFIEEngine(STAGE1, tiny=True, compute_dtype="float32", device="cpu",
                           params=filled_init(ct, seed=5), **kw)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The CLI's loggers without TensorBoard (its import takes seconds here)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def _yaml(tmp_path, trainer: dict) -> str:
    cfg = {"seed_everything": 42,
           "trainer": {"max_steps": 1, **trainer},
           "model": {"class_path": "unirestore_tpu.ir",
                     "init_args": {"model_kwargs": STAGE1}}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("yaml_value, override, want", [
    (None, None, False),
    (True, None, True),
    (False, "true", True),
    (True, "false", False),
])
def test_trainer_cuda_graphs_parses_from_the_yaml_and_the_cli(tmp_path, monkeypatch, yaml_value,
                                                              override, want):
    trainer = {} if yaml_value is None else {"cuda_graphs": yaml_value}
    argv = [] if override is None else ["--trainer.cuda_graphs", override]
    cfg = C.load_config(_yaml(tmp_path, trainer), argv)
    assert cfg["trainer"].get("cuda_graphs", False) is want
    # the CPU has no graph route: let the refusal pass to see the switch arrive
    monkeypatch.setattr(GR, "refuse_graph_route", lambda *a, **k: torch.device("cpu"))
    engine, trainer, _, _ = C.build(cfg, tiny=True, device="cpu")
    assert engine.cuda_graphs is want and trainer.cuda_graphs is want


def test_the_flag_on_the_cpu_stops_the_cli_before_any_step(tmp_path, no_tensorboard):
    path = _yaml(tmp_path, {"logger": {"init_args": {"save_dir": str(tmp_path / "logs")}}})
    with pytest.raises(ValueError, match="graph-captured restores needs a CUDA device"):
        TMAIN.main(["fit", "--config", path, "--tiny", "--device", "cpu",
                    "--trainer.cuda_graphs", "true"])
    assert not (tmp_path / "logs" / "checkpoints").exists()


@pytest.mark.parametrize("value, want", [(None, 8), ("3", 3), ("1", 1), ("0", 1), ("-4", 1)])
def test_jit_cache_size_sets_the_restore_lru_as_in_jax(monkeypatch, jax_init_from,  # noqa: F811
                                                        value, want):
    if value is None:
        monkeypatch.delenv("UNIRESTORE_JIT_CACHE_SIZE", raising=False)
    else:
        monkeypatch.setenv("UNIRESTORE_JIT_CACHE_SIZE", value)
    ct = TUR.tiny_config(use_tfa=False, tasks=("ir",))
    jax_init_from(*filled_init(ct, seed=5))
    jeng = JE.UniFIEEngine(STAGE1, tiny=True, compute_dtype="float32")
    assert _engine().restore_cache_size == jeng._jit_cache_max == want


def test_the_engines_graph_route_refuses_what_it_cannot_capture(monkeypatch):
    with pytest.raises(ValueError, match="graph-captured restores needs a CUDA device, got cpu"):
        _engine(cuda_graphs=True)
    engine = _engine()
    engine.cuda_graphs = True  # as on a card, from here on each refusal comes first
    images = np.zeros((1, 64, 64, 3), np.float32)
    with SP.partition(_fake_context()):
        with pytest.raises(NotImplementedError, match="restores does not run on height-sharded"):
            engine.restore_fn()(images, "ir")
    engine.engine_type = "det"  # has a route: on the CPU it meets the device's refusal
    with pytest.raises(ValueError, match="graph-captured restores needs a CUDA device, got cpu"):
        engine.restore_fn()
    engine.engine_type = "ir"
    trainable = engine.trainable
    engine.trainable = _sharded(trainable)
    with pytest.raises(ValueError, match="does not take FSDP shards"):
        engine.restore_fn()
    engine.trainable = trainable
    monkeypatch.setattr(GR.dist, "is_initialized", lambda: True)
    with pytest.raises(ValueError, match="does not run under a process group"):
        engine.restore_fn()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="needs a CUDA device, got cpu"):
        engine.restore_fn()
    engine.cuda_graphs = False  # the eager route is untouched
    out = engine.restore_fn()(images, "ir")
    assert out.shape == images.shape and np.isfinite(out).all()


def test_the_trainer_refuses_fsdp_and_a_cpu_step(tmp_path, no_tensorboard):
    with pytest.raises(ValueError, match="cuda_graphs does not take trainer.fsdp"):
        TE.Trainer(cuda_graphs=True, fsdp=True, default_root_dir=str(tmp_path))
    trainer = TE.Trainer(max_steps=1, cuda_graphs=True, default_root_dir=str(tmp_path))
    assert TE.Trainer(default_root_dir=str(tmp_path)).cuda_graphs is False
    batch = {k: np.zeros((1, 64, 64, 3), np.float32) for k in ("lq", "hq")}
    batch["task"] = "ir"

    class Data:
        def train_dataloader(self):
            class Loader(list):
                batch_size = 1
            return Loader([batch])

    with pytest.raises(ValueError, match="GraphedTrainStep needs a CUDA device, got cpu"):
        trainer.fit(_engine(), Data())
    assert not (tmp_path / "checkpoints" / "last.npz").exists()


def test_device_summary_reads_the_cards_time_from_the_raw_events():
    """``train/profiling.py:device_summary`` (the trainer's ``--trainer.profiler``
    summary and phase 19's idle share) over the profiler's raw events: busy
    time summed over the card's events only, span from the first start to the
    last end, user annotations left out; empty without card events."""
    from types import SimpleNamespace

    from unirestore_torch.train import profiling as PROF

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(device, start_ns, end_ns, annotation=False):
        return SimpleNamespace(device_type=lambda: device, is_user_annotation=lambda: annotation,
                               start_ns=lambda: start_ns, end_ns=lambda: end_ns,
                               duration_ns=lambda: end_ns - start_ns)

    def profile(*events):
        return SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: list(events))))

    got = PROF.device_summary(profile(event(cpu, 0, 10**9), event(cuda, 10**9, 2 * 10**9),
                                      event(cuda, 3 * 10**9, 3 * 10**9 + 5 * 10**8),
                                      event(cuda, 0, 4 * 10**9, annotation=True)))
    assert got == {"device_busy_s": 1.5, "device_span_s": 2.5, "device_idle_share": 0.4,
                   "kernels": 2}
    assert PROF.device_summary(profile(event(cpu, 0, 10))) == {}
