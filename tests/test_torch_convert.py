"""The port's checkpoint converters (``unirestore_torch/convert/``) against the
JAX package's tools (``tools/convert_*.py``).

- The safetensors reader against ``safetensors.numpy.load_file``.
- Every ``convert_*`` function of the four tools against its port on one
  seeded source state dict: the same keys in the same order, the same dtypes,
  bit-equal arrays. The source holds the keys a real checkpoint has: those
  whose converted leaf the port's tree has (learned by running the converter
  on a ``Recorder``, which offers every key).
- Key and shape coverage at full width: each converter, fed zero-stride
  arrays of the shapes a real checkpoint has (conv OIHW, linear (out, in),
  the rest as the tree has them), gives exactly the keys of the port's tree,
  each of the shape ``bridge.load_tree`` takes for it. Nothing is
  materialised: the templates come from the ``meta`` device.
- The MUSIQ and MANIQA templates of ``map_by_shape`` against JAX's.
- The command line, with JAX and the JAX package unimportable.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from safetensors import numpy as stnp
from safetensors import torch as sttorch

from unirestore_torch import bridge
from unirestore_torch.convert import classifiers as PCL
from unirestore_torch.convert import iqa as PIQ
from unirestore_torch.convert import safetensors as PST
from unirestore_torch.convert import sd_turbo as PSD
from unirestore_torch.convert import torchvision as PTV
from unirestore_torch.evalx import lpips as LP
from unirestore_torch.models import unet as UN
from unirestore_torch.models import vae as VAE
from unirestore_torch.nn.init import make_init
from unirestore_torch.tasks import critic_init
from unirestore_tpu.train.checkpoints import tree_flatten_dict

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import convert_classifiers as JCL  # noqa: E402
import convert_iqa as JIQ  # noqa: E402
import convert_sd_turbo as JSD  # noqa: E402
import convert_torchvision as JTV  # noqa: E402

torch.set_num_threads(2)
META = make_init(device="meta")
TOOLS = {"sd_turbo": (JSD, PSD), "torchvision": (JTV, PTV), "classifiers": (JCL, PCL),
         "iqa": (JIQ, PIQ)}

# run a module of the port with jax, jaxlib and unirestore_tpu unimportable
# (``tests/test_torch_bridge.py``'s guard), on one intra-op thread
BLOCKED_RUN = """
import runpy, sys
BANNED = ("jax", "jaxlib", "unirestore_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked import of " + name)
for m in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
"""


def run_blocked(module: str, *args, cwd=REPO, env=None) -> subprocess.CompletedProcess:
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN, module, *map(str, args)],
                         cwd=cwd, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(REPO), **(env or {})})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------


def test_reader_matches_safetensors(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {f"t.{np.dtype(dt).name}": (rng.standard_normal((3, 5)) * 50).astype(dt)
               for dt in (np.float64, np.float32, np.float16, np.int64, np.int32, np.int16,
                          np.int8, np.uint8)}
    tensors["t.bool"] = rng.random((4, 2)) > 0.5
    tensors["scalar"] = np.asarray(3.5, np.float32)
    tensors["empty"] = np.zeros((0, 7), np.float16)
    tensors["a.first"] = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    path = tmp_path / "x.safetensors"
    stnp.save_file(tensors, str(path), metadata={"format": "pt", "note": "meta"})
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert b"__metadata__" in raw[8:8 + n]

    got, want = PST.load_file(path), stnp.load_file(str(path))
    assert list(got) == sorted(want) == sorted(tensors)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
        assert got[key].flags.writeable
    # a header padded with more spaces shifts nothing: offsets count from its end
    pad = raw[8:8 + n] + b" " * 13
    padded = tmp_path / "padded.safetensors"
    padded.write_bytes(len(pad).to_bytes(8, "little") + pad + raw[8 + n:])
    for key, arr in PST.load_file(padded).items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "BF16"), (torch.float8_e4m3fn, "F8_E4M3")])
def test_reader_refuses_what_numpy_cannot_hold(tmp_path, dtype, name):
    path = tmp_path / "x.safetensors"
    sttorch.save_file({"ok": torch.zeros(2), "unet.w": torch.zeros(3, dtype=dtype)}, str(path))
    with pytest.raises(ValueError, match=f"'unet.w' is {name}"):
        PST.load_file(path)


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------


class Tag:
    """Stands for a source tensor: its key, and the axes a converter transposed it by
    (``np.transpose(a, axes)`` calls ``a.transpose(axes)``)."""

    def __init__(self, key, axes=None):
        self.key, self.axes = key, axes

    def transpose(self, axes):
        return Tag(self.key, tuple(axes))


class Recorder(dict):
    """A state dict that offers every key (optional ones included) as a ``Tag``."""

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        return Tag(key)


def _call(fn, *args, **kw):
    return lambda module, sd: getattr(module, fn)(sd, *args, **kw)


TEXT = np.random.default_rng(5).standard_normal((2, 1024)).astype(np.float32)

# case: (call of a tool's module, tool, the port's tree the converted file feeds)
CASES = {
    "sd_turbo_vae": (_call("convert_vae"), "sd_turbo", lambda: VAE.vae_init(META, VAE.VAEConfig())),
    "sd_turbo_unet": (_call("convert_unet"), "sd_turbo",
                      lambda: UN.unet_init(META, UN.UNetConfig())),
    "resnet18": (_call("convert_resnet", "resnet18"), "torchvision",
                 lambda: bridge.probe_init("r18", "meta")),
    "resnet50": (_call("convert_resnet", "resnet50"), "torchvision",
                 lambda: critic_init("cls", "meta")),
    "resnet101": (_call("convert_resnet", "resnet101"), "torchvision",
                  lambda: bridge.probe_init("r101v1", "meta")),
    "cub_resnet50": (_call("convert_resnet", "resnet50"), "torchvision",
                     lambda: bridge.probe_init("cub_r50", "meta")),
    "deeplabv3plus": (_call("convert_deeplab"), "torchvision", lambda: critic_init("seg", "meta")),
    "refinenet": (_call("convert_refinenet"), "torchvision",
                  lambda: bridge.probe_init("rflwr101", "meta")),
    "fasterrcnn": (_call("convert_fasterrcnn"), "torchvision",
                   lambda: critic_init("det", "meta", "fastrcnn")),
    "inception": (_call("convert_inception"), "torchvision",
                  lambda: bridge.nr_init("inception", "meta")),
    "vgg16": (_call("convert_vgg16"), "classifiers", lambda: bridge.probe_init("vgg", "meta")),
    "vit_b16": (_call("convert_vit_b16"), "classifiers", lambda: bridge.probe_init("vit", "meta")),
    "vit_b16_timm": (_call("convert_vit_b16", timm=True), "classifiers",
                     lambda: bridge.probe_init("cub_vitb", "meta")),
    "swin_v2_b": (_call("convert_swin_v2_b"), "classifiers",
                  lambda: bridge.probe_init("swin", "meta")),
    "swin_b_timm": (_call("convert_swin_b_v1_timm"), "classifiers",
                    lambda: bridge.probe_init("cub_swin", "meta")),
    "convnext_base": (_call("convert_convnext_base"), "classifiers",
                      lambda: bridge.probe_init("cub_conv", "meta")),
    "efficientnet_v2_l": (_call("convert_efficientnet_v2_l"), "classifiers",
                          lambda: bridge.probe_init("eff", "meta")),
    "rvt_base_plus": (_call("convert_rvt_base_plus"), "classifiers",
                      lambda: bridge.probe_init("rvt", "meta")),
    "clipiqa": (_call("convert_clipiqa", text_features=TEXT), "iqa",
                lambda: bridge.nr_init("clipiqa", "meta")),
    "nima": (_call("convert_nima"), "iqa", lambda: bridge.nr_init("nima-koniq", "meta")),
    "hyperiqa": (_call("convert_hyperiqa"), "iqa", lambda: bridge.nr_init("hyperiqa", "meta")),
}


# leaves of a port's tree no checkpoint holds: hyperIQA's ResNet-50 has no fc
# head; the tree keeps torchvision's, which its score never reads
# (``evalx/hyperiqa.py:36``), so that leaf stays at the seeded init
NOT_IN_CHECKPOINT = {"hyperiqa": {"backbone//fc//w", "backbone//fc//b"}}


def jax_layout(template) -> dict:
    """{key: shape} of the port's tree in the JAX layout (conv kernels HWIO)."""
    out = {}
    for key, t in bridge.flatten(template).items():
        shape = tuple(t.shape)
        out[key] = (shape[2], shape[3], shape[1], shape[0]) if bridge._is_conv_kernel(key, t) \
            else shape
    return out


def checkpoint_shape(key: str, shape: tuple) -> tuple:
    """The shape a PyTorch checkpoint holds for a leaf of JAX-layout ``shape``:
    conv kernels OIHW, linear kernels (out, in), the rest as they are."""
    if key == "w" or key.endswith(bridge.SEP + "w"):
        if len(shape) == 4:
            return (shape[3], shape[2], shape[0], shape[1])
        if len(shape) == 2:
            return (shape[1], shape[0])
    return shape


@functools.lru_cache(maxsize=None)
def real_keys(case: str) -> tuple:
    """(JAX-layout shapes of the port's tree, {source key: the leaf it feeds}) of a case."""
    call, tool, template = CASES[case]
    shapes = jax_layout(template())
    tags = call(TOOLS[tool][1], Recorder())
    return shapes, {tag.key: ours for ours, tag in tags.items()
                    if ours in shapes and isinstance(tag, Tag)}


@pytest.mark.parametrize("case", list(CASES))
def test_converter_matches_the_tool(case):
    """A seeded source with a real checkpoint's keys, small tensors of each
    leaf's rank: the port and the tool give the same keys, order, dtypes and bits."""
    call, tool, _ = CASES[case]
    shapes, keys = real_keys(case)
    rng = np.random.default_rng(sorted(CASES).index(case))
    sd = {}
    for key, ours in sorted(keys.items()):
        rank = len(shapes[ours])
        sd[key] = rng.standard_normal(tuple(range(2, 2 + rank))).astype(np.float32)
    if case == "rvt_base_plus":  # an int leaf goes through as it is
        sd["transformers.0.blocks.0.attn.att_mask"] = rng.integers(0, 2, (2, 3, 3))
    want, got = call(TOOLS[tool][0], sd), call(TOOLS[tool][1], sd)
    assert list(got) == list(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        assert np.array_equal(got[key], arr), key


@pytest.mark.parametrize("case", list(CASES))
def test_converter_covers_the_ports_tree(case):
    """Zero-stride arrays of a full-width checkpoint's shapes: every leaf of the
    port's tree comes out of the converter, nothing else, each of the shape
    ``bridge.load_tree`` takes for it."""
    call, tool, template = CASES[case]
    shapes, keys = real_keys(case)
    sd = {key: np.broadcast_to(np.float32(0), checkpoint_shape(ours, shapes[ours]))
          for key, ours in keys.items()}
    out = call(TOOLS[tool][1], sd)
    assert set(shapes) - set(out) == NOT_IN_CHECKPOINT.get(case, set())
    assert set(out) <= set(shapes), sorted(set(out) - set(shapes))[:8]
    wrong = {k: (v.shape, shapes[k]) for k, v in out.items() if v.shape != shapes[k]}
    assert not wrong, wrong
    ports = {k: tuple(v.shape) for k, v in bridge.flatten(template()).items() if k in out}
    after = {k: tuple(v.transpose(3, 2, 0, 1).shape if bridge._is_conv_kernel(k, v) else v.shape)
             for k, v in out.items()}
    assert after == ports


def test_lpips_converter_matches_the_tool_and_covers_the_tree(tmp_path):
    rng = np.random.default_rng(3)
    shapes = jax_layout(LP.lpips_init(device="meta"))
    alex, lin = {}, {}
    for i, idx in enumerate((0, 3, 6, 8, 10)):
        alex[f"features.{idx}.weight"] = checkpoint_shape("w", shapes[f"convs//{i}//w"])
        alex[f"features.{idx}.bias"] = shapes[f"convs//{i}//b"]
    for i in range(5):
        lin[f"lin{i}.model.1.weight"] = checkpoint_shape("w", shapes[f"lins//{i}//w"])
    paths = []
    for name, sd in (("alex", alex), ("lin", lin)):
        paths.append(tmp_path / f"{name}.pth")
        torch.save({k: torch.tensor(rng.standard_normal(s).astype(np.float32))
                    for k, s in sd.items()}, paths[-1])
    want, got = JTV.convert_lpips(*map(str, paths)), PTV.convert_lpips(*paths)
    assert list(got) == list(want) and {k: v.shape for k, v in got.items()} == shapes
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and np.array_equal(got[key], arr), key


def test_load_state_dict_reads_both_formats_as_the_tools_do(tmp_path):
    rng = np.random.default_rng(4)
    sd = {"a.weight": rng.standard_normal((3, 2)).astype(np.float32),
          "b.running_var": rng.random(3).astype(np.float64)}
    stnp.save_file(sd, str(tmp_path / "m.safetensors"))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "m.ckpt")
    for got, want in ((PTV.load_state_dict(tmp_path / "m.safetensors"),
                       JSD._load_state_dict(str(tmp_path / "m.safetensors"))),
                      (PTV.load_state_dict(tmp_path / "m.ckpt"), JTV._sd(str(tmp_path / "m.ckpt")))):
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# MUSIQ and MANIQA: the templates of the shape match
# ---------------------------------------------------------------------------


def jax_template(kind: str, name: str) -> dict:
    """{key: ShapeDtypeStruct} of ``tree_flatten_dict(<kind>_init(PRNGKey(0), ...))``
    in its key order, traced without materialising the parameters."""
    from unirestore_tpu.evalx import maniqa as JMA
    from unirestore_tpu.evalx import musiq as JMU

    keys = []

    def flat(key):
        tree = (JMU.musiq_init(key, 10 if name == "musiq_ava" else 1) if kind == "musiq"
                else JMA.maniqa_init(key))
        out = tree_flatten_dict(tree)
        keys.extend(out)
        return list(out.values())

    return dict(zip(keys, jax.eval_shape(flat, jax.random.PRNGKey(0))))


@pytest.mark.parametrize("kind,name", [("musiq", "musiq_koniq"), ("musiq", "musiq_ava"),
                                       ("maniqa", "maniqa")])
def test_shape_match_template_and_result_are_the_tools(kind, name):
    want = jax_template(kind, name)
    got = PIQ.template(kind, name)
    assert [(k, v.shape) for k, v in got.items()] == [(k, tuple(v.shape))
                                                      for k, v in want.items()]
    # a seeded source: the template's shapes in order, some dropped, some
    # transposed, unrelated ones between them; each a distinct constant
    rng = np.random.default_rng(6)
    sd = {}
    for i, (key, v) in enumerate(got.items()):
        draw = rng.random()
        if draw < 0.15:
            continue
        if draw < 0.3:
            sd[f"extra.{i}"] = np.broadcast_to(np.float32(-i), (int(rng.integers(1, 9)), 5))
        shape = v.shape[::-1] if draw > 0.9 else v.shape
        sd[f"p.{i}"] = np.broadcast_to(np.float32(i), shape)
    groups = [("", "", lambda a: a)]
    (out_j, miss_j), (out_p, miss_p) = (JIQ._map_by_shape(sd, want, groups),
                                        PIQ.map_by_shape(sd, got, groups))
    assert miss_p == miss_j and miss_j and list(out_p) == list(out_j) and out_j
    for key, arr in out_j.items():
        assert out_p[key] is arr, key


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_sd_turbo_cli_writes_the_tools_files(tmp_path):
    """A diffusers-layout directory with a real checkpoint's keys (small
    tensors) through ``python -m unirestore_torch.convert sd_turbo`` with JAX
    unimportable, and through the tool's ``main``: the same files and arrays."""
    rng = np.random.default_rng(7)
    src = tmp_path / "sd-turbo"
    for sub, case in (("vae", "sd_turbo_vae"), ("unet", "sd_turbo_unet")):
        shapes, keys = real_keys(case)
        (src / sub).mkdir(parents=True)
        stnp.save_file({k: rng.standard_normal(tuple(range(2, 2 + len(shapes[ours]))))
                        .astype(np.float32) for k, ours in keys.items()},
                       str(src / sub / "diffusion_pytorch_model.safetensors"))
    res = run_blocked("unirestore_torch.convert", "sd_turbo", src, tmp_path / "port")
    JSD.main(str(src), str(tmp_path / "jax"))
    lines = res.stdout.splitlines()
    assert lines == [f"wrote sd_turbo_vae.npz ({len(real_keys('sd_turbo_vae')[1])} tensors)",
                     f"wrote sd_turbo_unet.npz ({len(real_keys('sd_turbo_unet')[1])} tensors)"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        with np.load(tmp_path / "jax" / name) as want, np.load(tmp_path / "port" / name) as got:
            assert got.files == want.files
            for key in want.files:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key]), (name, key)


def _pth(path, keys: dict, rng, prefix: str = "") -> str:
    torch.save({prefix + k: torch.tensor(rng.standard_normal(s).astype(np.float32))
                for k, s in keys.items()}, path)
    return str(path)


def _small(case: str) -> dict:
    shapes, keys = real_keys(case)
    return {k: tuple(range(2, 2 + len(shapes[ours]))) for k, ours in keys.items()}


# (tool, argv after the checkpoint path, case whose keys the checkpoint holds, key prefix)
CLI_RUNS = {
    "resnet18": ("torchvision", ["resnet18"], "resnet18", ""),
    "refinenet_ft": ("torchvision", ["refinenet", "refinenet_lw101_ft"], "refinenet", ""),
    "inception": ("torchvision", ["inception"], "inception", ""),
    "vit_timm_cub": ("classifiers", ["vit_b16_timm", "cub_vit_b16"], "vit_b16_timm", ""),
    "rvt": ("classifiers", ["rvt_base_plus"], "rvt_base_plus", ""),
    "nima": ("iqa", ["nima"], "nima", ""),
    "clipiqa_npy": ("iqa", ["clipiqa", "text.npy"], "clipiqa", ""),
    "musiq_ava": ("iqa", ["musiq", "musiq_ava"], None, ""),
}


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_cli_writes_the_tools_file(tmp_path, monkeypatch, capsys, run):
    """The port's ``main`` and the tool's, each from its own working directory
    with ``$UNIRESTORE_WEIGHTS`` unset: the same file names, arrays and lines."""
    tool, args, case, prefix = CLI_RUNS[run]
    rng = np.random.default_rng(8)
    np.save(tmp_path / "text.npy", TEXT)
    if case is None:  # the first few template shapes, then a stranger: the rest unmatched
        tpl = list(PIQ.template("musiq", "musiq_ava").items())[:6]
        keys = {f"m.{i}": v.shape for i, (_, v) in enumerate(tpl)} | {"m.x": (3, 3)}
    else:
        keys = _small(case)
    ckpt = _pth(tmp_path / "ckpt.pth", keys, rng, prefix)
    monkeypatch.delenv("UNIRESTORE_WEIGHTS", raising=False)
    argv = [args[0], ckpt, *(str(tmp_path / a) if a.endswith(".npy") else a for a in args[1:])]
    outs = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [f"convert_{tool}.py", *argv])
            TOOLS[tool][0].main()
        else:
            TOOLS[tool][1].main(argv)
        outs[side] = capsys.readouterr().out.splitlines()
    assert outs["port"] == outs["jax"] and outs["jax"][-1].startswith("wrote ")
    names = sorted(os.listdir(tmp_path / "jax" / "weights"))
    assert sorted(os.listdir(tmp_path / "port" / "weights")) == names and len(names) == 1
    with np.load(tmp_path / "jax" / "weights" / names[0]) as want, \
            np.load(tmp_path / "port" / "weights" / names[0]) as got:
        assert got.files == want.files
        for key in want.files:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


def test_a_nested_rvt_checkpoint_fails_as_in_the_tool(tmp_path, monkeypatch):
    """The tool strips ``model.`` only when the flat state dict holds a key
    named ``model``; a nested ``{"model": state_dict}`` fails in both."""
    ckpt = tmp_path / "rvt.pth"
    torch.save({"model": {"patch_embed.proj.0.weight": torch.zeros(2, 3, 1, 1)}}, ckpt)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["convert_classifiers.py", "rvt_base_plus", str(ckpt)])
    with pytest.raises(KeyError, match="patch_embed.proj.0.weight"):
        JCL.main()
    with pytest.raises(KeyError, match="patch_embed.proj.0.weight"):
        PCL.main(["rvt_base_plus", str(ckpt)])
