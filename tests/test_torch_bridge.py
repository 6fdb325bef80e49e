"""Weight bridge, import rules, and the helpers the ``test_torch_*`` files share.

The helpers build JAX parameter trees, replace every leaf with seeded random
values (so zero-initialised adapters and norm affines do real work), and
convert them to the port's tensors through ``unirestore_torch.bridge``.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirestore_torch import bridge
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.nn.init import make_init
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import checkpoints as CK

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
META = make_init(device="meta")


def randomize(tree, seed: int):
    """Every leaf -> mean(leaf) + std * N(0, 1), std = leaf's own std or 0.1."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x, np.float32)
        std = float(x.std()) or 0.1
        return (float(x.mean()) + std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree.map(one, tree)


def jax_params(init_fn, *args, seed: int = 0):
    """Randomised numpy params from a JAX ``*_init(key, *args)``."""
    return randomize(init_fn(jax.random.PRNGKey(seed), *args), seed + 1)


def port_params(np_params, port_init, *args):
    """Convert numpy JAX params with the port's ``*_init`` as the template."""
    return bridge.load_tree(np_params, port_init(META, *args), device="cpu")


def nhwc(seed: int, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tiny_pair(cfg_j, cfg_t, seed=0):
    """Randomised JAX (frozen, trainable) for ``cfg_j`` and the port's copy."""
    frozen, trainable = JUR.init(jax.random.PRNGKey(seed), cfg_j)
    frozen, trainable = randomize(frozen, seed + 1), randomize(trainable, seed + 2)
    port = bridge.from_jax(frozen, trainable, cfg_t, device="cpu")
    return (frozen, trainable), port


def test_bridge_nested_and_flat_npz_agree(tmp_path):
    """Nested tree, flat '//' npz (zoo format) and a checkpoint npz give the same tensors."""
    (frozen, trainable), (tf, tt) = tiny_pair(JUR.tiny_config(), TUR.tiny_config())
    fz_t, tr_t = TUR.init(TUR.tiny_config(), device="meta")

    flat_path = tmp_path / "frozen.npz"
    np.savez(flat_path, **CK.tree_flatten_dict(frozen))
    tf_flat = bridge.load_tree(flat_path, fz_t, device="cpu")
    ckpt = tmp_path / "ckpt.npz"
    CK.save_checkpoint(str(ckpt), jax.tree.map(jnp.asarray, trainable), step=3)
    tt_ckpt = bridge.load_tree(ckpt, tr_t, device="cpu", prefix="trainable")

    for a, b in ((tf, tf_flat), (tt, tt_ckpt)):
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
    # HWIO -> OIHW, task-name keys kept
    w_j = frozen["vae"]["encoder"]["conv_in"]["w"]
    w_t = tf["vae"]["encoder"]["conv_in"]["w"]
    np.testing.assert_array_equal(to_np(w_t), np.transpose(w_j, (3, 2, 0, 1)))
    assert set(tt["tfa"]["task_prompts"]) == {"ir", "cls", "seg"}


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_bridge_rejects_mismatched_keys(change):
    cfg = TUR.tiny_config()
    fz_t, _ = TUR.init(cfg, device="meta")
    frozen, _ = JUR.init(jax.random.PRNGKey(0), JUR.tiny_config())
    flat = CK.tree_flatten_dict(jax.tree.map(np.asarray, frozen))
    if change == "missing":
        flat.pop("vae//quant_conv//b")
    elif change == "extra":
        flat["vae//quant_conv//bogus"] = np.zeros(3, np.float32)
    else:
        flat["null_emb"] = np.zeros((1, 77, 8), np.float32)
    with pytest.raises(KeyError if change != "shape" else ValueError):
        bridge.load_tree(flat, fz_t, device="cpu")


def test_entry_points_need_cuda_or_explicit_cpu(tmp_path):
    """The model and the server default to the card and raise without one; the
    zoo picks no device: merged weights take the device of the tree given."""
    from unirestore_torch import serve, zoo

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TUR.init(TUR.tiny_config())
    assert serve.parse_args([]).device is None and not serve.parse_args([]).fused_out_attn
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_restore(serve.parse_args(["--tiny", "--weights-dir", str(tmp_path)]))
    cfg = TUR.tiny_config()
    frozen, _ = TUR.init(cfg, device="cpu")
    np.save(tmp_path / "sd_null_emb.npy", np.ones(tuple(frozen["null_emb"].shape), np.float32))
    np.savez(tmp_path / "sd_turbo_vae.npz",
             **{k: np.zeros(tuple(v.shape), np.float32)
                for k, v in bridge.flatten(bridge.to_numpy_tree(frozen["vae"])).items()})
    loaded = zoo.load_frozen_backbone(frozen, cfg, tmp_path)
    assert {v.device.type for v in bridge.flatten(loaded).values()} == {"cpu"}
    assert loaded["null_emb"].eq(1).all()


def _port_sources():
    files = sorted((REPO / "unirestore_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    banned = ("jax", "jaxlib", "unirestore_tpu")
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"

    # import every module with jax and the JAX package made unimportable
    code = f"""
import importlib, pkgutil, sys
BANNED = {banned!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BANNED:
            raise ImportError('blocked import of ' + name)
for m in [m for m in sys.modules if m.split('.')[0] in BANNED]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import unirestore_torch
for m in pkgutil.walk_packages(unirestore_torch.__path__, 'unirestore_torch.'):
    importlib.import_module(m.name)
importlib.import_module('chip_smoke')
bad = [m for m in sys.modules if m.split('.')[0] in BANNED]
assert not bad, bad
walked = {{'unirestore_torch.serve', 'unirestore_torch.zoo', 'unirestore_torch.ops.png',
           'unirestore_torch.ops.tiling', 'unirestore_torch.nn.attention_kernels',
           'unirestore_torch.main', 'unirestore_torch.config', 'unirestore_torch.train.engine',
           'unirestore_torch.data.loader', 'unirestore_torch.data.corruption.native',
           'unirestore_torch.evalx.lpips', 'unirestore_torch.evalx.evaluators',
           'unirestore_torch.tasks', 'unirestore_torch.tasks.resnet',
           'unirestore_torch.tasks.deeplab', 'unirestore_torch.evalx.fid',
           'unirestore_torch.evalx.inception', 'unirestore_torch.evalx.niqe',
           'unirestore_torch.evalx.nrqm', 'unirestore_torch.evalx.clipiqa',
           'unirestore_torch.evalx.hyperiqa', 'unirestore_torch.evalx.nima',
           'unirestore_torch.evalx.musiq', 'unirestore_torch.evalx.maniqa',
           'unirestore_torch.evalx.nr_suite'}}
assert walked <= set(sys.modules), walked - set(sys.modules)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_kernels_call_no_library_kernel():
    """The CUDA sources are hand-written kernels: none includes or calls cuBLAS,
    cuDNN, CUTLASS's device-level GEMMs or PyTorch's operators, and each
    includes only CUDA's own headers."""
    sources = sorted((REPO / "unirestore_torch" / "csrc").glob("*.cu"))
    assert {p.name for p in sources} >= {"attention.cu", "attention_sm90.cu", "grouped_conv.cu"}
    allowed = {"cuda.h", "cudaTypedefs.h", "cuda_bf16.h", "cuda_runtime.h", "climits", "cstdint"}
    banned = ("cublas", "cudnn", "cutlass", "torch", "at::", "scaled_dot_product")
    for path in sources:
        text = path.read_text()
        includes = set(re.findall(r'^#include [<"]([^>"]+)[>"]', text, re.M))
        assert includes <= allowed, f"{path.name}: includes {includes - allowed}"
        code = re.sub(r"//[^\n]*", "", text).lower()
        for word in banned:
            assert word not in code, f"{path.name}: mentions {word} outside comments"
