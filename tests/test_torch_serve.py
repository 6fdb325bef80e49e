"""Port parity: the serving path (``ops/tiling.py``, ``ops/png.py``, ``zoo.py``, ``serve.py``).

- tiling: the port's ``plan_tiles`` and ``restore_tiled`` against the JAX
  package's (both numpy) on the shapes of tests/test_tiling.py, with an
  identity, a shift and a nonlinear restore function: equal bit for bit, the
  same numpy operations in the same order.
- PNG: ``decode`` against PIL on PIL-written files of every mode the codec
  takes and on hand-filtered files that use each of the five filter types at
  every bit depth: equal bit for bit; PIL reads ``encode``'s output back
  exactly.
- zoo: missing files, files with no matching key and a null embedding of the
  wrong shape keep the init and warn once, as ``unirestore_tpu/zoo.py`` does;
  present files give the JAX module's values.
- server: ``build_restore``'s function (tiny config, CPU, fp32, 2 steps) with
  the JAX ``PRNGKey(0)`` draws injected against ``tools/serve.py``'s, which
  tiles the jitted JAX ``restore``; both load the same randomised weights from
  a weights directory and a checkpoint. 2e-4, as tests/test_torch_restore.py
  (chained DDIM steps amplify per-op summation differences). Then the HTTP
  server in a thread on an ephemeral port.
"""

import importlib.util
import io
import json
import struct
import sys
import threading
import types
import urllib.error
import urllib.request
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_bridge import REPO, randomize
from unirestore_torch import bridge, serve, zoo
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.ops import png
from unirestore_torch.ops import tiling as TTIL
from unirestore_tpu import zoo as JZOO
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.ops import tiling as JTIL
from unirestore_tpu.train import checkpoints as JCK

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)

# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,tile,overlap", [(700, 1200, 512, 64), (800, 1200, 512, 64),
                                              (512, 512, 512, 64), (96, 130, 64, 16),
                                              (1000, 513, 512, 0)])
def test_plan_tiles_matches_jax(h, w, tile, overlap):
    assert TTIL.plan_tiles(h, w, tile, overlap) == JTIL.plan_tiles(h, w, tile, overlap)


_FUNCTIONS = {
    "identity": lambda x, t: x,
    "shift": lambda x, t: x + 0.5,
    # depends on the tile's position through its mean, so overlaps disagree
    "nonlinear": lambda x, t: np.tanh(3 * x) * (1 + x.mean(axis=(1, 2, 3), keepdims=True)),
}


@pytest.mark.parametrize("fn", sorted(_FUNCTIONS))
@pytest.mark.parametrize("shape,tile,overlap,batch_tiles", [
    ((2, 700, 900, 3), 512, 64, 4),   # two images, batches across them
    ((1, 600, 600, 3), 512, 64, 4),
    ((1, 256, 256, 3), 512, 64, 4),   # sub-tile: one direct call
    ((1, 96, 40, 3), 64, 16, 4),      # one side under the tile: pad and crop
    ((1, 40, 96, 3), 64, 16, 3),
    ((1, 150, 130, 3), 64, 48, 2),    # overlap clamped to half the tile
])
def test_restore_tiled_matches_jax(fn, shape, tile, overlap, batch_tiles):
    img = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    calls = {"jax": [], "port": []}

    def spy(name):
        def f(x, t):
            calls[name].append(x.shape)
            return _FUNCTIONS[fn](x, t)
        return f

    want = JTIL.restore_tiled(spy("jax"), img, "ir", tile, overlap, batch_tiles)
    got = TTIL.restore_tiled(spy("port"), img, "ir", tile, overlap, batch_tiles)
    assert calls["port"] == calls["jax"]
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _test_image(h=37, w=53):
    """Half smooth gradients, half noise: PIL's adaptive filters pick several types."""
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([(x * 4) % 256, (y * 6) % 256, ((x + y) * 3) % 256], -1)
    noise = np.random.default_rng(h * w).integers(0, 256, (h, w, 3))
    return np.concatenate([smooth, noise], 0).astype(np.uint8)


def _pil_png(img, mode, **save):
    im = Image.fromarray(img)
    im = im.quantize(2 ** save.get("bits", 8)) if mode == "P" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("mode,save", [("RGB", {}), ("RGBA", {}), ("L", {}), ("LA", {}),
                                       ("P", {}), ("P", {"bits": 4}), ("P", {"bits": 2}),
                                       ("P", {"bits": 1}), ("1", {})])
def test_png_decodes_pil_files(mode, save):
    data = _pil_png(_test_image(), mode, **save)
    got = png.decode(data)
    assert got.dtype == np.uint8 and got.shape == (74, 53, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(samples, depth, color, kinds, palette=None):
    """A PNG of (H, W, channels) ``samples`` whose row y uses filter
    ``kinds[y % len(kinds)]``, filtered byte by byte as the PNG spec writes it."""
    h, w, ch = samples.shape
    if depth < 8:
        bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., -depth:]
        packed = np.packbits(bits.reshape(h, -1), axis=1)
    else:
        packed = samples.astype(np.uint8).reshape(h, -1)
    bpp = max(1, ch * depth // 8)
    prev = [0] * packed.shape[1]
    raw = bytearray()
    for y in range(h):
        row, kind = [int(v) for v in packed[y]], kinds[y % len(kinds)]
        out = []
        for i, cur in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((cur - pred) & 255)
        raw += bytes([kind] + out)
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return data + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("color,depth", [(2, 8), (6, 8), (0, 8), (4, 8), (0, 4), (0, 2),
                                         (0, 1), (3, 8), (3, 4), (3, 2), (3, 1)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_decodes_every_filter_type(color, depth, kind):
    """Each filter type on every row, and all five in turn, at each colour type and depth."""
    rng = np.random.default_rng(color * 10 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rng.integers(0, 2 ** depth, (9, 11, ch))
    samples[:4] = np.minimum(np.arange(11)[None, :, None] * 3 + np.arange(4)[:, None, None],
                             2 ** depth - 1)  # smooth rows, where prediction matters
    palette = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
    for kinds in ([kind], [kind, 4, 3, 2, 1, 0]):
        data = _filtered_png(samples, depth, color, kinds, palette)
        np.testing.assert_array_equal(png.decode(data), _pil_rgb(data))


def test_png_encode_is_read_back_by_pil():
    img = _test_image(45, 31)
    data = png.encode(img)
    np.testing.assert_array_equal(_pil_rgb(data), img)
    np.testing.assert_array_equal(png.decode(data), img)
    with pytest.raises(ValueError, match="uint8"):
        png.encode(img.astype(np.float32))


def test_png_other_formats_go_to_pil_or_are_refused(monkeypatch):
    img = _test_image()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    jpeg = buf.getvalue()
    sixteen = io.BytesIO()
    Image.fromarray((img[..., 0].astype(np.uint16) * 257)).save(sixteen, format="PNG")
    header = _filtered_png(img[:4, :4], 8, 2, [0])
    interlaced = header[:28] + b"\x01" + header[29:]  # IHDR's interlace byte (CRC left stale)
    with pytest.raises(png.UnsupportedImage, match="not a PNG"):
        png.decode(jpeg)
    with pytest.raises(png.UnsupportedImage, match="16-bit"):
        png.decode(sixteen.getvalue())
    with pytest.raises(ValueError, match="CRC"):
        png.decode(interlaced)
    fixed = bytearray(interlaced)
    fixed[29:33] = struct.pack(">I", zlib.crc32(bytes(fixed[12:29])))
    with pytest.raises(png.UnsupportedImage, match="interlaced"):
        png.decode(bytes(fixed))
    # with PIL: it reads what the codec does not
    np.testing.assert_array_equal(png.read_rgb(jpeg), _pil_rgb(jpeg))
    np.testing.assert_array_equal(png.read_rgb(sixteen.getvalue()), _pil_rgb(sixteen.getvalue()))
    # without PIL: refused with the reason
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(png.UnsupportedImage, match="not a PNG file.*PIL is not installed"):
        png.read_rgb(jpeg)


# ---------------------------------------------------------------------------
# zoo
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_warnings(monkeypatch):
    monkeypatch.setattr(zoo, "_WARNED", set())
    monkeypatch.setattr(JZOO, "_WARNED", set())


def _tiny_frozen():
    """Randomised JAX frozen tree (numpy) of the tiny config, and the port's template."""
    frozen, _ = JUR.init(jax.random.PRNGKey(0), JUR.tiny_config())
    frozen = randomize(frozen, 1)
    template, _ = TUR.init(TUR.tiny_config(), device="cpu")
    return frozen, template


def _assert_port_equals_jax(port_tree, jax_tree):
    got, want = bridge.flatten(bridge.to_numpy_tree(port_tree)), JCK.tree_flatten_dict(jax_tree)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_zoo_missing_files_keep_the_init_and_warn_once(tmp_path, monkeypatch, fresh_warnings):
    monkeypatch.setenv("UNIRESTORE_WEIGHTS", str(tmp_path))
    frozen_j, template = _tiny_frozen()
    with pytest.warns(UserWarning, match="'sd_turbo_vae' not found") as record:
        tree_j, ok_j = JZOO.load_npz_tree("sd_turbo_vae", frozen_j["vae"])
        tree_t, ok_t = zoo.load_npz_tree("sd_turbo_vae", template["vae"], tmp_path)
    assert len(record) == 2
    assert ok_j is ok_t is False
    assert tree_j is frozen_j["vae"] and tree_t is template["vae"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per name, in both
        JZOO.load_npz_tree("sd_turbo_vae", frozen_j["vae"])
        zoo.load_npz_tree("sd_turbo_vae", template["vae"], tmp_path)
    with pytest.warns(UserWarning, match="'sd_null_emb' not found"):
        assert JZOO.load_null_embedding((1, 77, 64)) is None
    with pytest.warns(UserWarning, match="'sd_null_emb' not found"):
        assert zoo.load_null_embedding((1, 77, 64), tmp_path) is None
    assert JZOO._WARNED == zoo._WARNED == {"sd_turbo_vae", "sd_null_emb"}


def test_zoo_null_embedding_of_another_shape_is_refused(tmp_path, monkeypatch, fresh_warnings):
    monkeypatch.setenv("UNIRESTORE_WEIGHTS", str(tmp_path))
    np.save(tmp_path / "sd_null_emb.npy", np.ones((1, 77, 32), np.float32))
    with pytest.warns(UserWarning, match="shape"):
        assert JZOO.load_null_embedding((1, 77, 64)) is None
    with pytest.warns(UserWarning, match="shape"):
        assert zoo.load_null_embedding((1, 77, 64), tmp_path) is None
    emb = np.random.default_rng(0).standard_normal((1, 77, 32)).astype(np.float32)
    np.save(tmp_path / "sd_null_emb.npy", emb)
    np.testing.assert_array_equal(zoo.load_null_embedding((1, 77, 32), tmp_path),
                                  JZOO.load_null_embedding((1, 77, 32)))


def test_zoo_file_without_matching_keys_keeps_the_init(tmp_path, monkeypatch, fresh_warnings):
    monkeypatch.setenv("UNIRESTORE_WEIGHTS", str(tmp_path))
    frozen_j, template = _tiny_frozen()
    np.savez(tmp_path / "sd_turbo_unet.npz", **{"bogus//w": np.zeros(3, np.float32)})
    with pytest.warns(UserWarning, match="no matching keys"):
        tree_j, ok_j = JZOO.load_npz_tree("sd_turbo_unet", frozen_j["unet"])
    with pytest.warns(UserWarning, match="no matching keys"):
        tree_t, ok_t = zoo.load_npz_tree("sd_turbo_unet", template["unet"], tmp_path)
    assert ok_j is ok_t is False
    assert tree_j is frozen_j["unet"] and tree_t is template["unet"]


def test_zoo_loads_the_backbone_as_the_jax_module(tmp_path, monkeypatch, fresh_warnings):
    """Full VAE and UNet files and the null embedding; the UNet file misses one
    leaf, which keeps the init on both sides; a leaf of another shape raises in
    the port (the JAX module merges it and fails at first use)."""
    monkeypatch.setenv("UNIRESTORE_WEIGHTS", str(tmp_path))
    frozen_j, template = _tiny_frozen()
    init_j, _ = JUR.init(jax.random.PRNGKey(0), JUR.tiny_config())
    init_j = jax.tree.map(np.asarray, init_j)
    template = bridge.load_tree(init_j, template, device="cpu")  # the same init on both sides
    np.savez(tmp_path / "sd_turbo_vae.npz", **JCK.tree_flatten_dict(frozen_j["vae"]))
    unet = JCK.tree_flatten_dict(frozen_j["unet"])
    dropped = sorted(unet)[0]
    np.savez(tmp_path / "sd_turbo_unet.npz", **{k: v for k, v in unet.items() if k != dropped})
    np.save(tmp_path / "sd_null_emb.npy", frozen_j["null_emb"])
    cfg_j, cfg_t = JUR.tiny_config(), TUR.tiny_config()
    want = JZOO.load_frozen_backbone(init_j, cfg_j)
    got = zoo.load_frozen_backbone(template, cfg_t, tmp_path)
    _assert_port_equals_jax(got, want)
    np.testing.assert_array_equal(JCK.tree_flatten_dict(want["unet"])[dropped],
                                  JCK.tree_flatten_dict(init_j["unet"])[dropped])
    assert got["null_emb"].device.type == "cpu"

    bad = dict(unet, **{dropped: np.zeros((3, 3), np.float32)})
    np.savez(tmp_path / "sd_turbo_unet.npz", **bad)
    with pytest.raises(ValueError, match="shape"):
        zoo.load_frozen_backbone(template, cfg_t, tmp_path)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


def _jax_server():
    spec = importlib.util.spec_from_file_location("jax_serve", REPO / "tools" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A weights directory and a checkpoint holding one randomised tiny model."""
    root = tmp_path_factory.mktemp("weights")
    frozen, trainable = JUR.init(jax.random.PRNGKey(0), JUR.tiny_config(tasks=("ir", "cls")))
    frozen, trainable = randomize(frozen, 41), randomize(trainable, 42)
    np.savez(root / "sd_turbo_vae.npz", **JCK.tree_flatten_dict(frozen["vae"]))
    np.savez(root / "sd_turbo_unet.npz", **JCK.tree_flatten_dict(frozen["unet"]))
    np.save(root / "sd_null_emb.npy", frozen["null_emb"])
    JCK.save_checkpoint(str(root / "adapters.npz"), jax.tree.map(jnp.asarray, trainable), step=1)
    return root


def _port_args(weights, *extra):
    return serve.parse_args(["--tiny", "--device", "cpu", "--steps", "2", "--tasks", "ir,cls",
                             "--weights-dir", str(weights),
                             "--checkpoint", str(weights / "adapters.npz"), *extra])


def _jax_draws(lat):
    """The posterior and diffusion draws JAX ``restore`` makes from PRNGKey(0)."""
    k_enc, k_diff = jax.random.split(jax.random.PRNGKey(0))
    _, k_n = jax.random.split(k_diff)
    return np.array(jax.random.normal(k_enc, lat)), np.array(jax.random.normal(k_n, lat))


def test_build_restore_matches_the_jax_server(weights, monkeypatch):
    """A sub-tile input (resized and padded inside ``restore``) and a tiled one
    (six 64 px tiles, two batches of 4): the port's server function with JAX's
    draws injected == tools/serve.py's, within 2e-4."""
    monkeypatch.setenv("UNIRESTORE_WEIGHTS", str(weights))
    args = _port_args(weights)
    jargs = types.SimpleNamespace(tasks=args.tasks, cache_mode="none", cache_stride=5,
                                  cache_warmup=0, checkpoint=args.checkpoint, tiny=True,
                                  steps=2, overlap=args.overlap, batch_tiles=args.batch_tiles)
    shapes = []

    def noise_fn(lat):
        shapes.append(lat)
        return _jax_draws(lat)

    restore_t, cfg = serve.build_restore(args, noise_fn=noise_fn)
    restore_j, _ = _jax_server().build_restore(jargs)
    assert cfg.min_size == 64 and not cfg.fused_out_attention
    rng = np.random.default_rng(43)
    for shape, task in [((1, 40, 56, 3), "ir"), ((1, 96, 130, 3), "cls")]:
        img = rng.uniform(size=shape).astype(np.float32)
        got, want = restore_t(img, task), restore_j(img, task)
        assert got.shape == shape
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # 40 x 56 -> 64 x 90 (short side to 64), padded to 64 x 128; then two batches of 4 tiles
    assert shapes == [(1, 8, 16, cfg.vae.latent_channels)] + [(4, 8, 8, cfg.vae.latent_channels)] * 2


def test_restore_gives_the_model_c_contiguous_batches(weights, monkeypatch):
    """An image in another axis order (channel-planar memory, as a transposed
    array gives; numpy keeps it through slicing and np.stack) reaches the model
    C-contiguous, whole or in tiles, and restores as its contiguous copy does:
    on the card a strided bf16 batch rounds differently, and an answer must not
    depend on the caller's memory layout."""
    seen, real = [], TUR.restore

    def spy(frozen, trainable, cfg, sched, x, *a, **k):
        seen.append(x.is_contiguous())
        return real(frozen, trainable, cfg, sched, x, *a, **k)

    monkeypatch.setattr(serve.UR, "restore", spy)
    restore, _ = serve.build_restore(_port_args(weights))
    planar = np.random.default_rng(45).random((1, 3, 96, 130)).astype(np.float32)
    img = planar.transpose(0, 2, 3, 1)
    assert not img.flags.c_contiguous
    for x in (img, img[:, :40, :56]):  # six tiles; one direct call
        np.testing.assert_array_equal(restore(x, "ir", steps=1),
                                      restore(np.ascontiguousarray(x), "ir", steps=1))
    assert len(seen) == 2 * (2 + 1) and all(seen)


@pytest.fixture(scope="module")
def server(weights):
    args = _port_args(weights, "--port", "0", "--batch-tiles", "2")
    httpd = serve.make_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join()


def _request(url, body=None):
    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_server_answers_over_http(server, monkeypatch):
    code, kind, body = _request(server + "/healthz")
    assert (code, kind) == (200, "application/json")
    assert json.loads(body) == {"status": "ok", "tasks": ["ir", "cls"], "served": 0,
                                "cache_mode": "none"}
    rng = np.random.default_rng(44)
    for h, w, task in [(64, 64, "ir"), (96, 130, "cls")]:  # a round trip, then 6 tiles
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        code, kind, body = _request(f"{server}/restore?task={task}&steps=1", png.encode(img))
        assert (code, kind) == (200, "image/png")
        out = png.decode(body)
        assert out.shape == (h, w, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(_pil_rgb(body), out)
    code, _, body = _request(server + "/restore?task=nope", png.encode(img))
    assert code == 400 and "unknown task" in json.loads(body)["error"]
    code, _, body = _request(server + "/restore?task=ir&steps=two", png.encode(img))
    assert code == 400 and "steps" in json.loads(body)["error"]
    assert _request(server + "/nothing")[0] == 404
    code, _, body = _request(server + "/restore?task=ir", b"not an image")
    assert code == 400 and "bad image" in json.loads(body)["error"]
    monkeypatch.setitem(sys.modules, "PIL", None)  # the card's machine has no PIL
    code, _, body = _request(server + "/restore?task=ir", b"not an image")
    assert code == 415 and "PIL is not installed" in json.loads(body)["error"]
    assert json.loads(_request(server + "/healthz")[2])["served"] == 2
