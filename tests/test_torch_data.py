"""Port parity: the data pipeline (manifests, datasets, corruptions, loaders).

The port keeps its own copies of the JAX package's numpy data modules, so the
same seeds must give the same arrays: every batch of ``DatasetEngine(task=
"ir")``'s train and val loaders (synchronous and threaded) and every
``common`` corruption are compared for exact equality with the JAX modules on
the 96 px smoke tree of ``tools/make_smoke_data.py``. ``device_prefetch``
converts to tensors on the CPU (its card test, a copy on a side stream with
no host wait, is in ``test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from unirestore_torch.data import engine as TDE
from unirestore_torch.data import loader as TDL
from unirestore_torch.data.corruption import imagenet_c as TIC
from unirestore_torch.data.corruption import native as TNAT
from unirestore_tpu.data import engine as JDE
from unirestore_tpu.data.corruption import imagenet_c as JIC
from unirestore_tpu.data.corruption import native as JNAT

REPO = Path(__file__).resolve().parent.parent


def make_smoke_tree(out: Path, res: int = 96) -> Path:
    """``tools/make_smoke_data.py`` into ``out``; returns the IR list file."""
    spec = importlib.util.spec_from_file_location("make_smoke_data",
                                                  REPO / "tools" / "make_smoke_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(out), str(res))
    return out / "lists" / "ir.list"


@pytest.fixture(scope="module")
def ir_list(tmp_path_factory):
    return make_smoke_tree(tmp_path_factory.mktemp("smoke"))


@pytest.fixture(autouse=True)
def same_native_availability(monkeypatch):
    """Both copies take the native kernels or both the numpy paths: the two
    draw their random numbers differently, and a build of the library racing
    another process's can leave one copy without it."""
    monkeypatch.setattr(TIC, "_USE_NATIVE", JIC._USE_NATIVE)


def test_a_copy_without_the_native_kernels_corrupts_otherwise(monkeypatch):
    """Why the copies are pinned together: with one copy on the native kernels
    and the other on the numpy paths, the same seeded fog differs."""
    if not (TNAT.available() and JNAT.available()):
        pytest.skip("native/libcorruption_kernels.so did not load")
    img = (np.random.default_rng(3).uniform(size=(48, 40, 3)) * 255).astype(np.uint8)

    def both():
        return [mod.corrupt(img, 3, "fog", rng=np.random.default_rng(4)) for mod in (TIC, JIC)]

    np.testing.assert_array_equal(*both())
    monkeypatch.setattr(TIC, "_USE_NATIVE", not JIC._USE_NATIVE)
    assert not np.array_equal(*both())


def _engine(mod, ir_list, workers):
    return mod.DatasetEngine(
        task="ir", train={"type": "div2kost", "resolution": 64, "batch_size": 2},
        val={"type": "val", "val_list": [], "batch_size": 2}, crp_mode="common",
        num_workers=workers, prefetch_factor=2,
        dataset_dict={"DIVF2KOST": {"train": str(ir_list), "val": str(ir_list)}})


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("workers", [0, 4])
def test_ir_loaders_give_the_jax_loaders_arrays(ir_list, workers):
    ours, ref = _engine(TDE, ir_list, workers), _engine(JDE, ir_list, workers)
    # the train stream is infinite (a weighted mixture): four batches, which
    # revisit samples with fresh per-draw augmentations
    it_t, it_j = iter(ours.train_dataloader()), iter(ref.train_dataloader())
    for _ in range(4):
        _assert_batches_equal(next(it_t), next(it_j))
    val_t, val_j = list(ours.val_dataloader()), list(ref.val_dataloader())
    assert len(val_t) == len(val_j) == 3
    for got, want in zip(val_t, val_j):
        _assert_batches_equal(got, want)


def test_threaded_loader_gives_the_synchronous_stream(ir_list):
    sync = iter(_engine(TDE, ir_list, 0).train_dataloader())
    threaded = iter(_engine(TDE, ir_list, 4).train_dataloader())
    for _ in range(3):
        _assert_batches_equal(next(threaded), next(sync))


def test_native_kernels_match_jax():
    if not (TNAT.available() and JNAT.available()):
        pytest.skip("native/libcorruption_kernels.so did not load")
    np.testing.assert_array_equal(TNAT.plasma_fractal(64, 3.0, 5),
                                  JNAT.plasma_fractal(64, 3.0, 5))
    img = np.random.default_rng(1).uniform(size=(24, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(TNAT.glass_shuffle(img, 2, 1, 9),
                                  JNAT.glass_shuffle(img, 2, 1, 9))
    np.testing.assert_array_equal(TNAT.impulse_noise(img, 0.1, 4),
                                  JNAT.impulse_noise(img, 0.1, 4))


@pytest.mark.parametrize("name", TIC.init_corruption_function("common"))
def test_corruptions_match_jax(name):
    img = (np.random.default_rng(3).uniform(size=(48, 56, 3)) * 255).astype(np.uint8)
    for severity in (1, 5):
        got = TIC.corrupt(img, severity, name, rng=np.random.default_rng(7))
        want = JIC.corrupt(img, severity, name, rng=np.random.default_rng(7))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{name} severity {severity}")


def test_device_prefetch_on_the_cpu_converts_in_order():
    batches = [{"lq": np.full((1, 4, 4, 3), i, np.float32), "fname": [f"f{i}"], "task": "ir"}
               for i in range(5)]
    out = list(TDL.device_prefetch(batches, "cpu", depth=2))
    assert [b["fname"] for b in out] == [[f"f{i}"] for i in range(5)]
    for i, b in enumerate(out):
        assert isinstance(b["lq"], torch.Tensor) and b["lq"].device.type == "cpu"
        assert torch.equal(b["lq"], torch.full((1, 4, 4, 3), float(i)))
        assert b["task"] == "ir"
