"""Port parity: the 2-D (data, spatial) mesh's partitioned primitives
(``unirestore_torch/parallel/{mesh,spatial}.py`` and the layers that consult
the partition context), the refusals, and SPADE's restore on a height-sharded
batch.

Two CPU processes over gloo (``init_method=file://``), started once for the
module (``ranks``), hold each a slab of the height of every input
(``make_mesh_2d(1, 2)``) and run every partitioned primitive under the
context; the test assembles the slabs and holds them to the same port function
on the whole input, unpartitioned, at 1e-6: the 3x3 convolution (the
depthwise one too) and the 1x1, both downsamplers, GroupNorm, InstanceNorm,
global average pooling, the CFRM grouped 3x3 (its kernel's plain version, and
the F.conv2d path of narrow groups), the nearest resize at whole ratios, and
self-attention on every route ``mha`` has (the plain one, the head-major,
channel-flat and wide-head kernels' plain versions, and the channel-flat one
with the out-projection fused), cross-attention; and the VAE's spatial
self-attention, GroupNorm into attention, at 1e-5. The same processes run the tiny SPADE model's
``restore_padded`` (deep cache mode, two DDIM steps, batch 2, 128 px) on the
mesh, held to JAX's ``restore_padded`` with JAX's noise injected at 2e-4
(``tests/test_torch_pipeline.py``'s whole-restore tolerance), while this
process computes the JAX reference. The processes import neither JAX nor the
JAX package.

In this process: with no context every changed primitive computes today's
arithmetic bit for bit, a ``make_mesh_2d(1, 1)`` restore is bit-equal to the
unsharded one, ``restore`` and ``restore_core`` inside a context,
``GraphedRestore``, the train step, a height resize and the convolutions with
no partitioned form raise under a context, and the level plan puts each height
(``spatial_plan``).
"""

import dataclasses
import multiprocessing
import pickle
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from unirestore_torch import bridge
from unirestore_torch import graphs as TGR
from unirestore_torch.models import cfrm as TCFRM
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.nn import attention as TA
from unirestore_torch.nn import grouped_conv as TGC
from unirestore_torch.nn import layers as TL
from unirestore_torch.nn import resnet as TR
from unirestore_torch.ops import resize as TRS
from unirestore_torch.parallel import mesh as MESH
from unirestore_torch.parallel import spatial as SP
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import steps as TS

torch.set_num_threads(2)
PRIM_TOL = dict(atol=1e-6, rtol=1e-6)
# the VAE's spatial self-attention chains GroupNorm, whose partial sums add in
# another order (1e-7 relative), into a softmax that amplifies it: the
# layers' and attention's tolerance of the port's parity tests
COMPOSITE_TOL = {"spatial_self_attention": dict(atol=1e-5, rtol=1e-5)}
RESTORE_TOL = dict(atol=2e-4, rtol=2e-4)
TIMEOUT = 300
RES, STEPS = 128, 2
SPADE_KW = dict(cache_mode="deep", cache_stride=2, cache_warmup=0)


# -- spawned gloo ranks -------------------------------------------------------------


def start_ranks(body, tmp_path: Path, payload, world: int):
    """``body(rank, world, payload)`` in ``world`` spawned processes joined in
    one gloo process group, started and returned at once (``finish_ranks``
    joins them)."""
    ctx = multiprocessing.get_context("spawn")
    init_file = tmp_path / "pg_init"
    procs = [ctx.Process(target=rank_entry, args=(body, r, world, str(init_file), str(tmp_path),
                                                  payload))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmp_path


def finish_ranks(started, timeout=TIMEOUT) -> list:
    """Each rank's pickled results; fails, with the ranks' tracebacks, if one
    fails or outlives ``timeout`` seconds."""
    procs, tmp_path = started
    for p in procs:
        p.join(timeout)
    hung = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [tmp_path / f"rank{r}.err" for r in range(len(procs))]
    msg = "\n".join(e.read_text() for e in errors if e.exists())
    assert not any(hung), f"ranks hung past {timeout} s: {hung}\n{msg}"
    assert all(p.exitcode == 0 for p in procs), f"exit codes {[p.exitcode for p in procs]}\n{msg}"
    out = []
    for r in range(len(procs)):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def rank_entry(body, rank, world, init_file, out_dir, payload):
    """A rank: the gloo process group, ``body(rank, world, payload)``, its
    result pickled (or its traceback written) in ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        res = body(rank, world, payload)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def port_trees(payload, cfg):
    """The (frozen, trainable) pair of the payload's numpy trees (JAX layout)."""
    return bridge.from_jax(*payload["trees"], cfg, device="cpu")


def sharded_restore(sharding, trees, cfg, images, task, noise, steps=STEPS):
    """``restore_padded`` of this rank's block with the global noise; (the
    assembled output, the collective counts)."""
    local = sharding.local(torch.from_numpy(images))
    out = TUR.restore_padded(*trees, cfg, TUR.schedule(cfg), local, task, None, steps,
                             posterior_noise=torch.from_numpy(noise[0]),
                             diffusion_noise=torch.from_numpy(noise[1]), device="cpu",
                             sharding=sharding)
    ctx = sharding.last_context
    return sharding.assemble(out).numpy(), None if ctx is None else dict(ctx.counts)


# -- the primitives -------------------------------------------------------------------


def _params():
    """Seeded parameters of every case (the same in every process)."""
    rng = np.random.default_rng(7)

    def t(*shape, scale=0.2):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def attn(c, inner, ctx_dim=None):
        return {"to_q": {"w": t(c, inner)}, "to_k": {"w": t(ctx_dim or c, inner)},
                "to_v": {"w": t(ctx_dim or c, inner)}, "to_out": {"w": t(inner, c), "b": t(c)}}

    return {"conv3": {"w": t(12, 6, 3, 3), "b": t(12)}, "conv1": {"w": t(12, 6, 1, 1), "b": t(12)},
            "dw": {"w": t(6, 1, 3, 3), "b": t(6)},
            "down": {"conv": {"w": t(6, 6, 3, 3), "b": t(6)}},
            "norm": {"scale": 1.0 + t(64), "bias": t(64)},
            "gconv": {"w": t(256, 16, 3, 3, scale=0.05), "b": t(256)},
            "gconv_narrow": {"w": t(64, 4, 3, 3), "b": t(64)},
            "attn_plain": attn(32, 32), "attn_bh": attn(128, 128), "attn_btc": attn(128, 128),
            "attn_stream": attn(256, 256), "attn_cross": attn(32, 32, ctx_dim=24),
            "ssa": {"group_norm": {"scale": 1.0 + t(64), "bias": t(64)}, "attn": attn(64, 64)}}


def _inputs():
    """Global inputs: NHWC maps 16 rows high, and (B, T, C) token blocks whose
    T is the row-major tokens of 2 x (T / 2) rows."""
    rng = np.random.default_rng(8)

    def x(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"map6": x(2, 16, 8, 6), "map64": x(2, 16, 8, 64), "map256": x(1, 16, 8, 256),
            "small": x(1, 8, 8, 3), "tok128": x(2, 128, 32), "tok256": x(2, 256, 128),
            "tok1024": x(1, 1024, 128), "tok1024w": x(1, 1024, 256), "ctx": x(2, 7, 24),
            "map64s": x(2, 16, 16, 64)}


def _cases(p):
    """name -> (input key, function of the input and the globals, output kind):
    ``map`` outputs are NHWC slabs, ``tokens`` (B, T_local, C) blocks, ``pooled``
    the same on every rank."""
    def fused(fn):
        def run(x, g):
            with TA.fused_out_projection(True):
                return fn(x, g)
        return run

    return {
        "conv2d_3x3": ("map6", lambda x, g: TL.conv2d(p["conv3"], x, padding=1), "map"),
        "conv2d_same": ("map6", lambda x, g: TL.conv2d(p["conv3"], x), "map"),
        "conv2d_1x1": ("map6", lambda x, g: TL.conv2d(p["conv1"], x, padding=0), "map"),
        "conv2d_depthwise": ("map6", lambda x, g: TL.conv2d(p["dw"], x, padding=1, groups=6),
                             "map"),
        "downsample_sym": ("map6", lambda x, g: TR.downsample(p["down"], x, "sym"), "map"),
        "downsample_asym": ("map6", lambda x, g: TR.downsample(p["down"], x, "asym"), "map"),
        "group_norm": ("map64", lambda x, g: TL.group_norm(p["norm"], x, groups=8), "map"),
        "instance_norm": ("map6", lambda x, g: TL.instance_norm(x), "map"),
        "global_avg_pool": ("map6", lambda x, g: TL.global_avg_pool(x), "pooled"),
        "global_avg_pool_flat": ("map6", lambda x, g: TL.global_avg_pool(x, keepdims=False),
                                 "pooled"),
        "grouped_conv3_kernel": ("map256", lambda x, g: TCFRM._grouped_conv3(p["gconv"], x),
                                 "map"),
        "grouped_conv3_narrow": ("map64", lambda x, g: TCFRM._grouped_conv3(p["gconv_narrow"], x),
                                 "map"),
        "resize_nearest_up": ("small", lambda x, g: TL.resize_nearest(x, (2 * x.shape[1], 16)),
                              "map"),
        "resize_nearest_down": ("map6", lambda x, g: TL.resize_nearest(x, (x.shape[1] // 2, 4)),
                                "map"),
        "mha_plain": ("tok128", lambda x, g: TA.mha(p["attn_plain"], x, heads=2), "tokens"),
        "mha_bh": ("tok256", lambda x, g: TA.mha(p["attn_bh"], x, heads=2), "tokens"),
        "mha_btc": ("tok1024", lambda x, g: TA.mha(p["attn_btc"], x, heads=2), "tokens"),
        "mha_btc_out": ("tok1024", fused(lambda x, g: TA.mha(p["attn_btc"], x, heads=2)),
                        "tokens"),
        "mha_stream": ("tok1024w", lambda x, g: TA.mha(p["attn_stream"], x, heads=1), "tokens"),
        "mha_cross": ("tok128", lambda x, g: TA.mha(p["attn_cross"], x,
                                                    context=torch.from_numpy(g["ctx"]), heads=2),
                      "tokens"),
        "spatial_self_attention": ("map64s", lambda x, g: TA.spatial_self_attention(
            p["ssa"], x, heads=1, groups=8), "map"),
    }


def _run_cases(ctx_of, inputs, local_of):
    p = _params()
    out, counts = {}, {}
    for name, (key, fn, _) in _cases(p).items():
        x = local_of(key, inputs[key])
        ctx = ctx_of(inputs[key])
        with torch.no_grad(), SP.partition(ctx):
            out[name] = fn(x, inputs).numpy()
        counts[name] = dict(ctx.counts)
    return out, counts


def _spade_cfg():
    return dataclasses.replace(TUR.tiny_config(control_type="spade"), **SPADE_KW)


def _rank(rank, world, payload):
    res = {}
    try:
        MESH.make_mesh_2d(1, 1)
    except ValueError as e:
        res["mesh_error"] = str(e)
    mesh = MESH.make_mesh_2d(1, world)
    sharding = MESH.spatial_batch_sharding(mesh)
    res["coordinate"] = sharding.coordinate
    inputs = _inputs()

    def local_of(key, x):
        if key.startswith("tok"):
            n = x.shape[1] // world
            return torch.from_numpy(x[:, rank * n:(rank + 1) * n])
        return sharding.local(torch.from_numpy(x))

    res["cases"], res["counts"] = _run_cases(lambda x: sharding.context(x.shape[1]), inputs,
                                             local_of)
    res["assembled"] = sharding.assemble(sharding.local(torch.from_numpy(inputs["map6"]))).numpy()
    res["spade"] = sharded_restore(sharding, port_trees(payload, _spade_cfg()), _spade_cfg(),
                                   payload["images"], "seg", payload["noise"])
    return res


def _spade_reference():
    """The tiny SPADE model's trees (the port's seeded init with its zero leaves
    filled, in the JAX layout), images, JAX noise and JAX ``restore_padded``."""
    import jax
    import jax.numpy as jnp

    from test_torch_eval import filled_init
    from test_torch_pipeline import _jax_noise
    from unirestore_tpu.models import unirestore as JUR

    trees = tuple(bridge.to_numpy_tree(t) for t in filled_init(_spade_cfg(), seed=31))
    images = np.random.default_rng(32).uniform(size=(2, RES, RES, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(33)
    cj = dataclasses.replace(JUR.tiny_config(control_type="spade"), **SPADE_KW)
    noise = tuple(n.numpy() for n in _jax_noise(cj, images.shape, rng))
    payload = {"trees": trees, "images": images, "noise": noise}

    def reference():
        fj, tj = (jax.tree.map(jnp.asarray, t) for t in trees)
        sched = JUR.schedule(cj)
        return np.asarray(jax.jit(lambda f, t, x, r: JUR.restore_padded(
            f, t, cj, sched, x, "seg", r, STEPS))(fj, tj, images, rng))

    return payload, reference


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    payload, reference = _spade_reference()
    started = start_ranks(_rank, tmp_path_factory.mktemp("spatial"), payload, world=2)
    ref = reference()  # while the ranks run
    return {"ranks": finish_ranks(started), "spade_ref": ref}


def _assembled(results, name, kind):
    outs = [r["cases"][name] for r in results]
    if kind == "pooled":
        np.testing.assert_array_equal(outs[0], outs[1])
        return outs[0]
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("name", list(_cases(_params())))
def test_partitioned_primitive_matches_the_whole_input(name, ranks):
    key, fn, kind = _cases(_params())[name]
    inputs = _inputs()
    with torch.no_grad():
        want = fn(torch.from_numpy(inputs[key]), inputs).numpy()
    got = _assembled(ranks["ranks"], name, kind)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **COMPOSITE_TOL.get(name, PRIM_TOL))
    counts = ranks["ranks"][0]["counts"][name]
    # one exchange per 3x3 or stride-2 convolution, none for a 1x1 or a
    # resize; attention gathers once, cross-attention never
    expected = {"conv2d_1x1": 0, "resize_nearest_up": 0, "resize_nearest_down": 0,
                "mha_cross": 0, "conv2d_3x3": 1, "downsample_sym": 1, "grouped_conv3_kernel": 1}
    if name in expected:
        assert sum(counts.values()) == expected[name], counts
    if name.startswith("mha_") and name != "mha_cross":
        assert counts == {"halo": 0, "all_reduce": 0, "all_gather": 1}


def test_mesh_2d_and_its_sharding_on_two_ranks(ranks):
    r0, r1 = ranks["ranks"]
    assert r0["mesh_error"] == "1x1 mesh needs 1 devices, have 2"
    assert (r0["coordinate"], r1["coordinate"]) == ((0, 0), (0, 1))
    np.testing.assert_array_equal(r0["assembled"], _inputs()["map6"])
    np.testing.assert_array_equal(r1["assembled"], _inputs()["map6"])


def test_spade_restore_on_the_mesh_matches_jax(ranks):
    (out0, counts), (out1, _) = (r["spade"] for r in ranks["ranks"])
    np.testing.assert_array_equal(out0, out1)
    assert out0.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(out0, ranks["spade_ref"], **RESTORE_TOL)
    assert min(counts.values()) > 0, counts


# -- this process: no context, and the refusals ---------------------------------------


def test_no_context_computes_todays_arithmetic():
    """Every function the context changes, without it, bit for bit as the
    formulas it had."""
    assert SP.current() is None
    p, x = _params(), {k: torch.from_numpy(v) for k, v in _inputs().items()}
    m6, m64 = x["map6"], x["map64"]
    w, b = p["conv3"]["w"], p["conv3"]["b"]
    conv = F.conv2d(m6.permute(0, 3, 1, 2), w, b, 1, 1).permute(0, 2, 3, 1)
    assert torch.equal(TL.conv2d(p["conv3"], m6, padding=1), conv)
    dw, db = p["down"]["conv"]["w"], p["down"]["conv"]["b"]
    asym = F.conv2d(F.pad(m6, (0, 0, 0, 1, 0, 1)).permute(0, 3, 1, 2), dw, db, 2,
                    "valid").permute(0, 2, 3, 1)
    assert torch.equal(TR.downsample(p["down"], m6, "asym"), asym)

    bsz, h, wd, c = m64.shape
    xg = m64.reshape(bsz, h * wd, 8, c // 8)
    mean = xg.mean(dim=(1, 3), dtype=torch.float32)
    inv = torch.rsqrt(xg.square().mean(dim=(1, 3)) - mean.square() + 1e-5)
    scale = inv.repeat_interleave(c // 8, dim=1) * p["norm"]["scale"]
    shift = (-mean * inv).repeat_interleave(c // 8, dim=1) * p["norm"]["scale"] + p["norm"]["bias"]
    assert torch.equal(TL.group_norm(p["norm"], m64, groups=8),
                       m64 * scale[:, None, None] + shift[:, None, None])
    mu = m6.mean(dim=(1, 2), keepdim=True)
    var = m6.var(dim=(1, 2), keepdim=True, correction=0)
    assert torch.equal(TL.instance_norm(m6), (m6 - mu) * torch.rsqrt(var + 1e-5))
    assert torch.equal(TL.global_avg_pool(m6), m6.mean(dim=(1, 2), keepdim=True))
    g = p["gconv"]
    assert torch.equal(TCFRM._grouped_conv3(g, x["map256"]),
                       TGC.grouped_conv3(x["map256"], g["w"], g["b"], 16))


def test_mesh_2d_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="1x2 mesh needs 2 devices, have 1"):
        MESH.make_mesh_2d(1, 2)
    sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, 1))
    assert sharding.shape == (1, 1) and sharding.context(64) is None
    x = torch.arange(24.0).reshape(1, 4, 2, 3)
    assert torch.equal(sharding.local(x), x) and torch.equal(sharding.assemble(x), x)


def test_mesh_1x1_restore_is_bit_equal_to_the_unsharded_one():
    cfg = TUR.tiny_config()
    frozen, trainable = TUR.init(cfg, device="cpu", seed=4)
    images = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, 1))
    outs = [TUR.restore_padded(frozen, trainable, cfg, TUR.schedule(cfg), images, "ir",
                               torch.Generator().manual_seed(6), 2, device="cpu", **kw)
            for kw in ({}, {"sharding": sharding})]
    assert sharding.last_context is None
    assert torch.equal(outs[0], outs[1])


def _fake_context():
    """A context of two ranks with no process group: what refuses must do so
    before any collective."""
    return SP.SpatialContext(group=None, index=0, size=2, height=128)


def test_whole_image_entry_points_refuse_a_spatial_context():
    cfg = TUR.tiny_config()
    frozen, trainable = TUR.init(cfg, device="cpu", seed=4)
    images = torch.rand(1, 64, 64, 3)
    sched = TUR.schedule(cfg)
    with SP.partition(_fake_context()):
        with pytest.raises(NotImplementedError, match="restore does not run on height-sharded"):
            TUR.restore(frozen, trainable, cfg, sched, images, "ir", torch.Generator(), 1,
                        device="cpu")
        with pytest.raises(NotImplementedError, match="restore does not run on height-sharded"):
            TUR.restore_core(frozen, trainable, cfg, sched, images, "ir", None, None, 1)
        with pytest.raises(NotImplementedError, match="restore does not run on height-sharded"):
            TUR.restore(frozen, trainable, cfg, sched, images, "ir", torch.Generator(), 1,
                        device="cpu", sharding=MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, 1)))
        with pytest.raises(NotImplementedError, match="without its sharding"):
            TUR.restore_padded(frozen, trainable, cfg, sched, images, "ir", torch.Generator(), 1,
                               device="cpu")
        with pytest.raises(NotImplementedError, match="GraphedRestore does not run"):
            TGR.GraphedRestore(frozen, trainable, cfg, sched, device="cpu")
        stage = TS.StageConfig(train_cfrm=True, train_cnet=True, train_tfa=False)
        tx = TOPT.make_optimizer(lr=1e-3)
        step = TS.make_train_step(frozen, cfg, sched, stage, tx, "ir")
        with pytest.raises(NotImplementedError, match="the train step does not run"):
            step(trainable, tx.init(TS.trained_leaves(stage, trainable)),
                 {"lq": images, "hq": images}, None)
        with pytest.raises(NotImplementedError, match="resizing the height"):
            TRS.resize_bicubic(images, (96, 64))
        with pytest.raises(NotImplementedError, match="reflect-padding the height"):
            TRS.reflect_pad_hw(images, 8, 0)
        p = {"w": torch.zeros(4, 3, 5, 5)}
        with pytest.raises(NotImplementedError, match="no partitioned form"):
            TL.conv2d(p, images, padding=2)
        with pytest.raises(NotImplementedError, match="no partitioned form"):
            TL.conv2d({"w": torch.zeros(4, 3, 3, 3)}, images, padding=2, dilation=2)
    assert SP.current() is None
    # a height resize that changes nothing, a width resize and a pad of the
    # width only read no other slab
    with SP.partition(_fake_context()):
        assert TRS.resize_bicubic(images, (64, 64)) is images
        assert TRS.resize_bilinear(images, (64, 32)).shape == (1, 64, 32, 3)
        assert TRS.reflect_pad_hw(images, 0, 8).shape == (1, 64, 72, 3)


@pytest.mark.parametrize("res,spatial,level", [(64, 4, "UNet level 2"),
                                               (128, 32, "VAE encoder level 3"),
                                               (100, 8, "image")])
def test_heights_that_do_not_divide_are_refused(res, spatial, level):
    """A level whose rows the ranks do not split runs whole, with every level
    below it; only images whose height the ranks do not divide are refused,
    naming the image (``restore`` may run such padded images whole)."""
    cfg = TUR.tiny_config()
    names = [n for n, _ in TUR.spatial_levels(cfg, res)]
    if level == "image":
        with pytest.raises(ValueError, match="the image is 100 rows high"):
            TUR.spatial_plan(cfg, res, spatial)
        assert TUR.spatial_plan(cfg, res, spatial, image_whole=True) == (0, "image")
        return
    depth, name = TUR.spatial_plan(cfg, res, spatial)
    assert name.startswith(level) and names[depth] == name


@pytest.mark.parametrize("res,spatial,level", [(512, 8, None), (576, 2, "UNet level 3"),
                                               (704, 4, "UNet level 2"), (704, 2, "UNet level 3")])
def test_level_plan_of_the_full_config(res, spatial, level):
    """sd-turbo's widths: 512 px splits every level over 8 ranks; 576 px on 2
    runs whole from the 9-row level; a 500 x 375 photo's 704 px on 4 from the
    22-row level (UNet level 1 splits, 11 rows a rank), on 2 from the 11-row
    level."""
    depth, name = TUR.spatial_plan(TUR.UniRestoreConfig(), res, spatial)
    assert (name if level is None else name.split(" (")[0]) == level
    if level is not None:
        assert TUR.spatial_levels(TUR.UniRestoreConfig(), res)[depth][0] == name


def test_heights_that_divide_pass():
    assert TUR.spatial_plan(TUR.tiny_config(), 128, 2) == (None, None)
    assert TUR.spatial_plan(TUR.UniRestoreConfig(), 512, 8) == (None, None)
    names = [n for n, _ in TUR.spatial_levels(TUR.UniRestoreConfig(), 512)]
    assert names[-1] == "UNet level 3 (latent / 8)" and len(names) == 7
