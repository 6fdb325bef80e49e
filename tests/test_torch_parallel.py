"""Port parity: ``unirestore_torch/parallel`` and the data-parallel step.

Two CPU processes over gloo (``init_method=file://``), started once for the
module (``ranks``), run every multi-process case and write their results;
the tests read them. The processes import neither JAX nor the JAX package:
the JAX references are computed here and handed over as numpy arrays.

- ``fsdp_spec`` gives JAX's spec on JAX's shapes and on every leaf of the
  tiny trees at 2 and 8 shards.
- A 2-rank DDP step (stage 1, SGD lr 1e-3, two steps, global batch 2 at 128
  px; ``test_torch_train.py``'s docstring says why 128 px) against JAX's
  ``make_train_step`` on a 2-device mesh (``replicate`` / ``shard_batch``),
  JAX's noise recomputed at the global batch: losses within 1e-5 relative,
  gradients within 1e-4 of each family's largest, parameters within 1e-5.
- FSDP (``min_size=64``) against DDP in the port: bit-equal for SGD and AdamW
  without clipping (an update is elementwise, and the mean of two addends
  does not depend on which rank adds them), within 1e-6 of each leaf's
  largest |value| for ``lamb``, ``adafactor`` and AdamW with ``grad_clip``
  (the whole-leaf norms are summed in another order; these update once,
  after two micro-steps: the tiny model at 64 px turns a 1e-7 relative
  parameter difference into a 0.5 % gradient difference, which a second
  update would compare instead); more than half of the
  trainable and of the frozen elements sharded before and after. The same
  comparison must fail when the trust ratio leaves out its group sum.
  ``adafactor`` factors no leaf of the tiny model, so every optimizer name is
  also held FSDP against DDP on leaves that factor, sharded along the
  factored axes and beside them.
- Faster R-CNN's loss uniforms on each rank are its rows of the global draw;
  ``replicate`` makes a perturbed rank 1 equal to rank 0.
"""

import multiprocessing
import pickle
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from unirestore_torch import bridge
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.parallel import distributed as DIST
from unirestore_torch.parallel import fsdp as FSDP
from unirestore_torch.parallel import mesh as MESH
from unirestore_torch.tasks import fasterrcnn as TFRC
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import steps as TS

WORLD = 2
STAGE1 = dict(train_cfrm=True, train_cnet=True, train_tfa=False)
MIN_SIZE = 64
# the optimizers whose whole-leaf sums differ in order update once, after
# both micro-steps: the tiny model turns a 1e-7 relative parameter difference
# into a 0.5 % gradient difference at the next step (64 px)
TRAIN_OPTS = {"adamw": dict(opt="adamw"), "lamb": dict(opt="lamb", accum_iter=2),
              "adafactor": dict(opt="adafactor", accum_iter=2),
              "adamw_clip": dict(opt="adamw", grad_clip=0.01, accum_iter=2)}
BIT_EQUAL = ("sgd", "adamw")
OPT_NAMES = ("adamw", "nadamw", "radam", "lamb", "lion", "adafactor", "lars", "sgdw", "adam",
             "nadam", "adamax", "sgd", "momentum", "rmsprop", "adagrad", "adadelta")
# leaves that adafactor factors, sharded over 2 along: the largest (factored)
# axis, the second factored axis (the largest is odd), a third axis; and two
# it does not factor, one replicated (under MIN_SIZE), one sharded
OPT_SHAPES = {"a": (256, 128), "b": (257, 128), "c": (131, 129, 8), "d": (7, 9), "e": (64, 66)}
TIMEOUT = 300


def _tiny_cfg():
    return TUR.tiny_config(use_tfa=True, tasks=("ir", "det"))


def _batch(seed, b, hw):
    rng = np.random.default_rng(seed)
    return {"lq": rng.uniform(size=(b, hw, hw, 3)).astype(np.float32),
            "hq": rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)}


# -- the ranks -----------------------------------------------------------------


def _trees(jax_trees, cfg):
    return bridge.from_jax(*jax_trees, cfg, device="cpu")


def _recording(tx):
    """``tx`` with the gradients each update receives kept in ``tx.seen``."""
    tx.seen = []
    update = tx.update

    def record(state, params, grads, group=None):
        tx.seen.append({k: g.clone() for k, g in grads.items()})
        return update(state, params, grads, group)

    tx.update = record
    return tx


def _fit(rank, mesh, jax_trees, opt_kw, inputs, fsdp):
    """Two stage-1 steps on this rank's rows of ``inputs`` [(batch, noise)]:
    (trainable as numpy, logs, gradients, sharded fractions)."""
    cfg, stage, group = _tiny_cfg(), TS.StageConfig(**STAGE1), mesh.get_group("data")
    frozen, trainable = _trees(jax_trees, cfg)
    tx = _recording(TOPT.make_optimizer(lr=1e-3, **opt_kw))
    state = tx.init(TS.trained_leaves(stage, trainable))
    fractions = []
    if fsdp:
        frozen = FSDP.fsdp_shard(mesh, frozen, min_size=MIN_SIZE)
        trainable = FSDP.fsdp_shard(mesh, trainable, min_size=MIN_SIZE)
        state = tx.shard_state(state, TS.trained_leaves(stage, trainable), rank)
        fractions.append((FSDP.sharded_fraction(trainable), FSDP.sharded_fraction(frozen)))
    step = TS.make_train_step(frozen, cfg, TUR.schedule(cfg), stage, tx, "ir", group=group)
    logs = []
    for batch, noise in inputs:
        rows = DIST.process_local_rows(batch["hq"].shape[0])
        local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        nz = TS.local_noise(TS.StepNoise(*(torch.from_numpy(n) for n in noise)), rows)
        trainable, state, out = step(trainable, state, local, nz)
        logs.append({k: v.item() for k, v in out.items()})
    if fsdp:
        fractions.append((FSDP.sharded_fraction(trainable), FSDP.sharded_fraction(frozen)))
    full = FSDP.gather_tree(trainable, group)
    return {"trainable": bridge.flatten(bridge.to_numpy_tree(full)), "logs": logs,
            "grads": [bridge.to_numpy_tree(seen) for seen in tx.seen],
            "fractions": fractions}


def _drawn_inputs(cfg, seed, hw):
    """Two global batches of 2 at ``hw`` and their noise from a seeded
    generator: each rank draws the global noise (``draw_noise(world=2)``) and
    keeps its rows; returned whole, as numpy."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(2):
        batch = _batch(seed + i, WORLD, hw)
        noise = TS.draw_noise(cfg, {"hq": torch.from_numpy(batch["hq"])}, gen)
        out.append((batch, tuple(x.numpy() for x in (noise.hq, noise.lq, noise.diffusion,
                                                      noise.timesteps))))
    return out


def _local_trust_ratio(self, k, p, u, coefficient=1.0):
    """The planted fault: the trust ratio of this rank's block alone."""
    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = coefficient * pn / un
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)


def _optimizer_cases(rank, mesh, group):
    """Every optimizer name (two updates, then clip and accumulation) on
    ``OPT_SHAPES``, replicated (DDP) and in shards (FSDP): the full leaves."""
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    grads = [[{k: rng.standard_normal(s).astype(np.float32) for k, s in OPT_SHAPES.items()}
              for _ in range(WORLD)] for _ in range(4)]
    out = {}
    for name in OPT_NAMES:
        for extra in ({}, {"grad_clip": 1.0, "accum_iter": 2}):
            key = name + ("_clip_accum" if extra else "")
            for mode in ("ddp", "fsdp"):
                tx = TOPT.make_optimizer(name, lr=1e-2, **extra)
                p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
                state = tx.init(p)
                if mode == "fsdp":
                    p = FSDP.fsdp_shard(mesh, p, min_size=MIN_SIZE)
                    state = tx.shard_state(state, p, rank)
                for g in grads:
                    full = {k: torch.from_numpy(v) for k, v in g[rank].items()}
                    local = FSDP.reduce_gradients(full, p, group)
                    tx.update(state, p, local, group)
                p = FSDP.gather_tree(p, group)
                out[(key, mode)] = {k: v.numpy() for k, v in p.items()}
    return out


def _rank_main(rank, init_file, out_dir, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        res = {"rows": DIST.process_local_rows(8)}
        try:
            DIST.process_local_rows(7)
        except ValueError as e:
            res["rows_error"] = str(e)
        mesh = MESH.make_mesh()
        group = mesh.get_group("data")
        res["mesh"] = (mesh.size(), tuple(mesh.mesh_dim_names))

        # replicate: rank 1 perturbed, then every leaf is rank 0's
        cfg = _tiny_cfg()
        _, trainable = _trees(payload["jax_trees"], cfg)
        if rank == 1:
            for v in bridge.flatten(trainable).values():
                v.add_(1.0)
        MESH.replicate(mesh, trainable)
        res["replicated"] = bridge.flatten(bridge.to_numpy_tree(trainable))

        res["uniforms"] = [u.numpy() for u in TFRC.loss_uniforms(2, 64, 64, "cpu")]

        res["ddp_sgd"] = _fit(rank, mesh, payload["jax_trees"], {"opt": "sgd"},
                              payload["jax_inputs"], fsdp=False)
        res["fsdp_sgd"] = _fit(rank, mesh, payload["jax_trees"], {"opt": "sgd"},
                               payload["jax_inputs"], fsdp=True)
        inputs = _drawn_inputs(cfg, 40, 64)
        for name, kw in TRAIN_OPTS.items():
            for mode in ("ddp", "fsdp"):
                res[f"{mode}_{name}"] = _fit(rank, mesh, payload["jax_trees"], kw, inputs,
                                             fsdp=mode == "fsdp")
        trust_ratio = TOPT.Optimizer._trust_ratio
        TOPT.Optimizer._trust_ratio = _local_trust_ratio
        try:
            res["fsdp_lamb_fault"] = _fit(rank, mesh, payload["jax_trees"], TRAIN_OPTS["lamb"],
                                          inputs, fsdp=True)
        finally:
            TOPT.Optimizer._trust_ratio = trust_ratio
        res["optimizers"] = _optimizer_cases(rank, mesh, group)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(target, tmp_path, payload, timeout=TIMEOUT):
    """``target(rank, init_file, out_dir, payload)`` in ``WORLD`` spawned
    processes; returns each rank's pickled results. Fails, with the ranks'
    tracebacks, if one fails or outlives ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    init_file = tmp_path / "pg_init"
    procs = [ctx.Process(target=target, args=(r, str(init_file), str(tmp_path), payload))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [(tmp_path / f"rank{r}.err") for r in range(WORLD)]
    msg = "\n".join(e.read_text() for e in errors if e.exists())
    assert not any(hung), f"ranks hung past {timeout} s: {hung}\n{msg}"
    assert all(p.exitcode == 0 for p in procs), f"exit codes {[p.exitcode for p in procs]}\n{msg}"
    out = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the JAX references (this process only) -------------------------------------


def _jax_reference():
    """The port's seeded init with its zero leaves filled
    (``test_torch_eval.filled_init``) in the JAX layout, two global batches of
    2 at 128 px with their JAX noise, and JAX's mesh step over 2 devices:
    (trees, inputs, trainable after, logs, gradients)."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_eval import filled_init
    from test_torch_train import _jax_noise
    from unirestore_tpu.models import unirestore as JUR
    from unirestore_tpu.parallel import make_mesh, replicate, shard_batch
    from unirestore_tpu.train import optim as JOPT
    from unirestore_tpu.train import steps as JS

    cj = JUR.tiny_config(use_tfa=True, tasks=("ir", "det"))
    trees = tuple(bridge.to_numpy_tree(t) for t in filled_init(_tiny_cfg(), seed=5))
    fj, tj = (jax.tree.map(jnp.asarray, t) for t in trees)
    mesh = make_mesh(jax.devices()[:WORLD])

    def record(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    recorder = optax.GradientTransformation(record, lambda u, s, p=None: (u, {"g": u}))
    tx = optax.chain(recorder, JOPT.make_optimizer(opt="sgd", lr=1e-3))
    step = JS.make_train_step(replicate(mesh, fj), cj, JUR.schedule(cj),
                              JS.StageConfig(**STAGE1), tx, "ir", donate=False)
    tr, state = replicate(mesh, tj), replicate(mesh, tx.init(tj))
    inputs, logs, grads = [], [], []
    for i in range(2):
        batch, rng = _batch(10 + i, WORLD, 128), jax.random.PRNGKey(20 + i)
        noise = _jax_noise(cj, batch, rng)
        inputs.append((batch, tuple(x.numpy() for x in (noise.hq, noise.lq, noise.diffusion,
                                                         noise.timesteps))))
        tr, state, out = step(tr, state, shard_batch(mesh, batch), rng)
        logs.append({k: float(v) for k, v in out.items()})
        grads.append(jax.tree.map(np.asarray, state[0]["g"]))
    return trees, inputs, jax.tree.map(np.asarray, tr), logs, grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    trees, inputs, tr_j, logs_j, grads_j = _jax_reference()
    out = run_ranks(_rank_main, tmp_path_factory.mktemp("ranks"),
                    {"jax_trees": trees, "jax_inputs": inputs})
    return {"ranks": out, "jax": (trees, tr_j, logs_j, grads_j)}


# -- the tests ---------------------------------------------------------------------


def _jax_shapes():
    import jax

    from unirestore_tpu.models import unirestore as JUR

    cj = JUR.tiny_config(use_tfa=True, tasks=("ir", "det"))
    return jax.eval_shape(lambda: JUR.init(jax.random.PRNGKey(0), cj))


@pytest.mark.parametrize("n", [2, 8])
def test_fsdp_spec_matches_jax(n):
    from jax.sharding import PartitionSpec as P

    from unirestore_tpu.parallel import fsdp_spec as jax_spec

    for shape, kw in [((3, 3, 64, 129), dict(min_size=1)), ((128, 256), dict(min_size=1)),
                      ((7, 11), dict(min_size=1)), ((1024,), {}), ((), {})]:
        x = np.zeros(shape)
        assert P(*FSDP.fsdp_spec(x, n, **kw)) == jax_spec(x, n, **kw), shape
    jax_trees = _jax_shapes()
    port_trees = TUR.init(_tiny_cfg(), device="cpu")
    for jt, pt in zip(jax_trees, port_trees):
        port_leaves = bridge.flatten(pt)
        for k, leaf in bridge.flatten(jt).items():
            for size in (FSDP.DEFAULT_MIN_SIZE, MIN_SIZE):
                assert P(*FSDP.fsdp_spec(leaf, n, min_size=size)) == jax_spec(
                    leaf, n, min_size=size), k
                # the port's layout (OIHW convs) shards the same leaves
                assert bool(FSDP.fsdp_spec(port_leaves[k], n, min_size=size)) == bool(
                    jax_spec(leaf, n, min_size=size)), k


def test_single_process_helpers(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "COORDINATOR_ADDRESS", "UNIRESTORE_DISTRIBUTED"):
        monkeypatch.delenv(name, raising=False)
    from unirestore_torch.parallel import init_distributed

    assert init_distributed() is False and not dist.is_initialized()
    assert DIST.process_local_rows(8) == slice(0, 8)
    mesh = MESH.make_mesh()
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",) and mesh.get_group() is None
    batch = {"hq": np.zeros((4, 2)), "task": "ir", "gt": {"boxes": np.zeros((4, 3))}}
    assert MESH.shard_batch(mesh, batch) is batch
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, 2)]}
    assert MESH.replicate(mesh, tree) is tree
    back = MESH.unreplicate(tree)
    assert isinstance(back["b"][0], np.ndarray) and back["a"].tolist() == [1, 1, 1]
    assert MESH.local_batch_size(8, mesh) == 8


def test_process_local_rows_at_two_ranks(ranks):
    r0, r1 = ranks["ranks"]
    assert (r0["rows"], r1["rows"]) == (slice(0, 4), slice(4, 8))
    assert "not divisible by 2" in r0["rows_error"] and "not divisible" in r1["rows_error"]
    assert r0["mesh"] == r1["mesh"] == (2, ("data",))


def test_replicate_makes_rank1_equal_rank0(ranks):
    r0, r1 = ranks["ranks"]
    assert r0["replicated"].keys() == r1["replicated"].keys()
    for k, v in r0["replicated"].items():
        np.testing.assert_array_equal(r1["replicated"][k], v, err_msg=k)


def test_loss_uniforms_are_rows_of_the_global_draw(ranks):
    whole = TFRC.loss_uniforms(4, 64, 64, "cpu")
    for rank, res in enumerate(ranks["ranks"]):
        for got, want in zip(res["uniforms"], whole):
            np.testing.assert_array_equal(got, want[2 * rank:2 * rank + 2].numpy())


def test_ddp_step_matches_the_jax_mesh_step(ranks):
    trees, tr_j, logs_j, grads_j = ranks["jax"]
    like = _trees(trees, _tiny_cfg())[1]
    mask = bridge.flatten(TS.trainable_filter(TS.StageConfig(**STAGE1), like))
    r0, r1 = ranks["ranks"][0]["ddp_sgd"], ranks["ranks"][1]["ddp_sgd"]
    for i in range(2):
        for res in (r0, r1):
            for k, v in logs_j[i].items():
                np.testing.assert_allclose(res["logs"][i][k], v, rtol=1e-5, err_msg=f"{i} {k}")
        want = bridge.flatten(grads_j[i])  # both in the JAX layout
        scale = {}
        for k in r0["grads"][i]:
            fam = k.split("//")[0]
            scale[fam] = max(scale.get(fam, 0.0), float(np.abs(want[k]).max()))
        for k, g in r0["grads"][i].items():
            assert mask[k]
            np.testing.assert_array_equal(r1["grads"][i][k], g, err_msg=k)
            np.testing.assert_allclose(g, want[k], rtol=1e-4,
                                       atol=1e-4 * scale[k.split("//")[0]] + 1e-12, err_msg=k)
    want = bridge.flatten(tr_j)
    for k, v in r0["trainable"].items():
        np.testing.assert_array_equal(r1["trainable"][k], v, err_msg=k)
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=0, err_msg=k)


def _assert_fsdp_matches(ddp, fsdp, exact):
    for i, (a, b) in enumerate(zip(ddp["logs"], fsdp["logs"])):
        for k, v in a.items():
            if k != "train/grad_norm" or exact:
                np.testing.assert_allclose(b[k], v, rtol=1e-6, err_msg=f"step {i} {k}")
    for k, v in ddp["trainable"].items():
        if exact:
            np.testing.assert_array_equal(fsdp["trainable"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(fsdp["trainable"][k], v, rtol=0,
                                       atol=1e-6 * float(np.abs(v).max()), err_msg=k)


@pytest.mark.parametrize("name", ["sgd", *TRAIN_OPTS])
def test_fsdp_step_matches_ddp(ranks, name):
    for res in ranks["ranks"]:
        ddp, fsdp = res[f"ddp_{name}"], res[f"fsdp_{name}"]
        _assert_fsdp_matches(ddp, fsdp, exact=name in BIT_EQUAL)
        for trainable, frozen in fsdp["fractions"]:
            assert trainable > 0.5 and frozen > 0.5, fsdp["fractions"]
    if name == "adamw_clip":  # the clip acted
        assert ranks["ranks"][0]["ddp_adamw_clip"]["logs"][1]["train/grad_norm"] > 0.01


def test_fsdp_parity_catches_a_trust_ratio_without_its_group_sum(ranks):
    res = ranks["ranks"][0]
    with pytest.raises(AssertionError):
        _assert_fsdp_matches(res["ddp_lamb"], res["fsdp_lamb_fault"], exact=False)


@pytest.mark.parametrize("name", OPT_NAMES)
def test_every_optimizer_updates_shards_as_whole_leaves(ranks, name):
    sharded = {k: bool(FSDP.fsdp_spec(np.zeros(s), WORLD, min_size=MIN_SIZE))
               for k, s in OPT_SHAPES.items()}
    assert sum(sharded.values()) == 4
    r0, r1 = ranks["ranks"]
    for key in (name, name + "_clip_accum"):
        for res in (r0, r1):
            ddp, fsdp = res["optimizers"][(key, "ddp")], res["optimizers"][(key, "fsdp")]
            for k, v in ddp.items():
                assert np.isfinite(v).all(), (key, k)
                np.testing.assert_array_equal(v, r0["optimizers"][(key, "ddp")][k])
                np.testing.assert_allclose(fsdp[k], v, rtol=0,
                                           atol=1e-6 * float(np.abs(v).max()),
                                           err_msg=f"{key} {k}")
