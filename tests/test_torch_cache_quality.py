"""The port's cached-mode quality sweep (``unirestore_torch/cache_quality.py``)
against ``tools/eval_cache_quality.py``.

Parity: ``tiny_config()``, the JAX parameters carried across with
``bridge.from_jax``, one image batch and one noise draw (recomputed from the
JAX key, as ``test_torch_pipeline.py`` does) for every configuration; each
output against JAX's ``restore_padded`` at the restore tolerance, and the
rows against the tool's ``_compare``. Then: the sweep's model reads
``--weights-dir``, and the command line runs with JAX unimportable.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_bridge import tiny_pair
from test_torch_convert import run_blocked
from test_torch_pipeline import TOL, _jax_noise
from unirestore_torch import bridge
from unirestore_torch import cache_quality as CQ
from unirestore_torch.models import unirestore as TUR
from unirestore_tpu.models import unirestore as JUR

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import eval_cache_quality as ECQ  # noqa: E402

torch.set_num_threads(2)
SPECS = ["exact", "encoder:2:0", "deep:2:0"]


def test_sweep_matches_jax_restore_padded_and_the_tools_rows():
    # test_torch_pipeline.py's draw. Re-randomised leaves can make the tiny
    # UNet's eps large: under seed 31 the latents reach |63| after one DDIM
    # step and the two frameworks' 1e-7 summation differences (encode 3e-7,
    # decode 7e-6 apart on the same input) grow to 6-8e-4 at the output
    cj, ct = JUR.tiny_config(), TUR.tiny_config()
    (fj, tj), (ft, tt) = tiny_pair(cj, ct, seed=11)
    images = np.random.default_rng(12).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(13)
    noise = _jax_noise(cj, images.shape, rng)
    raw = {}
    outputs, rows = CQ.sweep(ft, tt, ct, torch.from_numpy(images), noise, SPECS, 2,
                             device="cpu", on_restore=lambda spec, out: raw.setdefault(spec, out))
    sched = JUR.schedule(cj)
    for spec in SPECS:
        cfg = cj if spec == "exact" else dataclasses.replace(
            cj, **dict(zip(("cache_mode", "cache_stride", "cache_warmup"),
                           (spec.split(":")[0], *map(int, spec.split(":")[1:])))))
        want = np.asarray(jax.jit(lambda f, t, x, r, c=cfg: JUR.restore_padded(
            f, t, c, sched, x, "ir", r, 2))(fj, tj, images, rng))
        np.testing.assert_allclose(raw[spec].numpy(), want, **TOL, err_msg=spec)
        assert np.array_equal(outputs[spec], np.clip(raw[spec].numpy(), 0, 1))
    assert [(r["mode"], r["stride"], r["warmup"]) for r in rows] == [("encoder", 2, 0),
                                                                    ("deep", 2, 0)]
    for row, spec in zip(rows, SPECS[1:]):
        assert list(row) == ["mode", "stride", "warmup", "psnr_vs_exact_db", "rel_l2"]
        want = ECQ._compare(outputs[spec], outputs["exact"])
        assert (row["psnr_vs_exact_db"], row["rel_l2"]) == want and 0 < want[1] < 1
    assert CQ.compare(outputs["exact"], outputs["exact"]) == ECQ._compare(
        outputs["exact"], outputs["exact"]) == (float("inf"), 0.0)


def test_the_sweep_reads_the_converted_weights(tmp_path):
    """A weights directory holding a converted tiny VAE: every VAE leaf comes
    from the file, and the exact output moves."""
    args = CQ.parse_args(["--tiny", "--device", "cpu", "--weights-dir", str(tmp_path)])
    cfg = TUR.tiny_config()
    vae, _ = TUR.init(cfg, device="cpu", seed=5)
    flat = bridge.flatten(bridge.to_numpy_tree(vae["vae"]))
    outs = []
    for write in (False, True):
        if write:
            np.savez(tmp_path / "sd_turbo_vae.npz", **flat)
        frozen, trainable, cfg, dev = CQ.build(args)
        images, noise = CQ.make_inputs(cfg, 1, 64, dev)
        outs.append(CQ.sweep(frozen, trainable, cfg, images, noise, ["exact"], 1, device=dev)[0])
    loaded = bridge.flatten(bridge.to_numpy_tree(frozen["vae"]))
    assert loaded.keys() == flat.keys()
    for key, arr in flat.items():  # the file's fp32 leaf, cast to bf16 as the sweep runs
        want = torch.from_numpy(arr).to(torch.bfloat16).float().numpy()
        assert np.array_equal(loaded[key], want), key
    assert not np.array_equal(outs[0]["exact"], outs[1]["exact"])


def test_cli_runs_without_jax_on_the_cpu(tmp_path):
    res = run_blocked("unirestore_torch.cache_quality", "--tiny", "--device", "cpu",
                      "--size", "64", "--batch", "1", "--steps", "2", "--strides", "2",
                      "--modes", "encoder,deep", "--weights-dir", tmp_path)
    rows = [json.loads(line) for line in res.stdout.splitlines()]
    assert [(r["mode"], r["stride"], r["warmup"]) for r in rows] == [("encoder", 2, 0),
                                                                    ("deep", 2, 0)]
    assert all(np.isfinite(r["psnr_vs_exact_db"]) and r["rel_l2"] > 0 for r in rows)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        CQ.main(["--tiny", "--size", "64", "--batch", "1", "--steps", "1"])
