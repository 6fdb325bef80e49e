"""Port parity: the no-reference metric suite (``unirestore_torch/evalx/``:
``clipiqa``, ``hyperiqa``, ``nima``, ``musiq``, ``maniqa``, ``niqe``,
``nrqm``, ``nr_suite``), ``ImageRestorationEvaluator`` in the NR and ALL
``eval_mode``, ``config.build`` and the CLI ``validate`` in NR.

Networks run one tree on both sides: the port's seeded tree in the JAX layout
(``bridge.to_numpy_tree``) with the leaves a seeded init leaves trivial
randomised (BatchNorm affines; CLIP-IQA's prompt pair and the 10-bin heads
set so that their softmax moves), its BatchNorm statistics set to the test
batch's own (``calibrate_bn``: with the seeded init's unit statistics the
deep stacks shrink the input away and the comparison would hold the heads
alone), handed to the JAX function and carried back by ``bridge.nr_from_jax``.
Inputs are the small images of ``tests/test_nr_suite.py`` (each network
resizes inside, so they run at their published widths and input sizes;
MUSIQ at its native 96 x 128); the second input is a smooth ramp. Everything
runs in fp32 on the CPU, the JAX functions eagerly. Tolerances:

- the features before the head and the score: max abs within 1e-4 of the
  largest |value| of the JAX function (fp32 convolutions and matmuls summed
  in another order through up to 200 layers); a second input must move each
  of them by more than 100 times that;
- NIQE, NRQM and PI on the committed ``weights/*.npz``: within 1e-12 (the
  same numpy, scipy and cv2 code on the same float64 data);
- the evaluators' NR and ALL key sets and monitors: equal.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import make_smoke_tree
from unirestore_torch import bridge
from unirestore_torch import config as TC
from unirestore_torch import main as TMAIN
from unirestore_torch.evalx import clipiqa as TCIQ
from unirestore_torch.evalx import evaluators as TEV
from unirestore_torch.evalx import hyperiqa as THIQ
from unirestore_torch.evalx import maniqa as TMAN
from unirestore_torch.evalx import musiq as TMUS
from unirestore_torch.evalx import nima as TNIM
from unirestore_torch.evalx import niqe as TNQ
from unirestore_torch.evalx import nr_suite as TNRS
from unirestore_torch.evalx import nrqm as TNRQ
from unirestore_torch.nn.init import make_init
from unirestore_torch.tasks import resnet as TRN
from unirestore_tpu.evalx import clipiqa as JCIQ
from unirestore_tpu.evalx import evaluators as JEV
from unirestore_tpu.evalx import hyperiqa as JHIQ
from unirestore_tpu.evalx import maniqa as JMAN
from unirestore_tpu.evalx import musiq as JMUS
from unirestore_tpu.evalx import nima as JNIM
from unirestore_tpu.evalx import niqe as JNQ
from unirestore_tpu.evalx import nr_suite as JNRS
from unirestore_tpu.evalx import nrqm as JNRQ
from unirestore_tpu.tasks import resnet as JRN
from unirestore_tpu.train import checkpoints as JCK

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "weights"
RTOL = 1e-4
NEURAL = ("clipiqa", "musiq", "musiq-ava", "musiq-paq2piq", "musiq-spaq", "nima-koniq",
          "maniqa", "hyperiqa")


def _head_input(module, p, key, apply, x):
    """(the input of the JAX ``L.linear(p[key], .)`` call, apply's output): the
    module's layers swapped for a spy while ``apply`` runs eagerly."""
    seen, real = [], module.L

    class Spy:
        def __getattr__(self, name):
            return getattr(real, name)

        def linear(self, q, h):
            if q is p[key]:
                seen.append(np.asarray(h))
            return real.linear(q, h)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "L", Spy())
        out = np.asarray(apply(p, jnp.asarray(x)))
    return seen[-1], out


# case -> (the port's template tree, JAX (features, score) on (p, x), port
# (features, score) on (p, x), input shape, BatchNorm in the net)
def _jax_clip(p, x):
    return np.asarray(JCIQ.image_features(p, jnp.asarray(x))), np.asarray(
        JCIQ.clipiqa_score(p, jnp.asarray(x)))


def _port_clip(p, x):
    return TCIQ.image_features(p, x), TCIQ.clipiqa_score(p, x)


def _port_hyper(p, x):
    _, hyper = THIQ.hyperiqa_content(p, x)
    return hyper.mean(dim=(1, 2)), THIQ.hyperiqa_score(p, x)


def _jax_nima(n):
    return lambda p, x: (np.asarray(JNIM.inception_resnet_v2_features(p, JRN.preprocess(
        jnp.asarray(x)))), np.asarray(JNIM.nima_score(p, jnp.asarray(x), num_classes=n)))


def _port_nima(n):
    def run(p, x):
        f = TNIM.nima_features(p, x)
        return f, TNIM.nima_head(p, f, n)
    return run


def _port_musiq(n):
    def run(p, x):
        cls = TMUS.musiq_tokens(p, x)[:, 0]
        return cls, TMUS.musiq_head(p, cls, n)
    return run


def _port_maniqa(p, x):
    f = TMAN.maniqa_features(p, x)
    return f.reshape(f.shape[0], -1, f.shape[-1]), TMAN.maniqa_head(p, f)


def _template(init):
    return lambda: init(make_init(None, "cpu", seed=TNRS.SEED))


CASES = {
    "clipiqa": (_template(TCIQ.clip_rn50_init), _jax_clip, _port_clip, (2, 64, 80, 3), True),
    "hyperiqa": (_template(THIQ.hyperiqa_init),
                 lambda p, x: _head_input(JHIQ, p, "fc5w_fc", JHIQ.hyperiqa_score, x),
                 _port_hyper, (2, 48, 48, 3), True),
    "nima-1": (_template(lambda i: TNIM.inception_resnet_v2_init(i, 1)), _jax_nima(1),
               _port_nima(1), (1, 64, 64, 3), True),
    "nima-10": (_template(lambda i: TNIM.inception_resnet_v2_init(i, 10)), _jax_nima(10),
                _port_nima(10), (1, 64, 64, 3), True),
    "musiq-1": (_template(lambda i: TMUS.musiq_init(i, 1)),
                lambda p, x: _head_input(JMUS, p, "head",
                                         lambda q, y: JMUS.musiq_score(q, y, 1), x),
                _port_musiq(1), (1, 96, 128, 3), False),
    "musiq-10": (_template(lambda i: TMUS.musiq_init(i, 10)),
                 lambda p, x: _head_input(JMUS, p, "head",
                                          lambda q, y: JMUS.musiq_score(q, y, 10), x),
                 _port_musiq(10), (1, 96, 128, 3), False),
    "maniqa": (_template(TMAN.maniqa_init),
               lambda p, x: _head_input(JMAN, p, "score_fc1", JMAN.maniqa_score, x),
               _port_maniqa, (1, 48, 48, 3), False),
}


def _randomize(tree, rng):
    """Random values for the leaves a seeded init leaves trivial: BatchNorm
    affines (their statistics come from ``calibrate_bn``), a 10-bin head
    scaled up 30-fold (near-equal logits keep the expectation at 5.5 whatever
    the input), and CLIP-IQA's prompt pair made two nearby directions (two
    random ones put 100 x their cosine gap into the softmax, which then reads
    1.0 whatever the input)."""
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "mean": tree["mean"], "var": tree["var"]}
    out = {}
    for k, v in tree.items():
        if k == "text_features":
            good = rng.standard_normal(v.shape[1])
            v = np.stack([good, good + 0.1 * rng.standard_normal(v.shape[1])]).astype(np.float32)
        elif k == "head" and v["w"].shape[-1] == 10:
            v = {"w": 30.0 * v["w"], "b": v["b"]}
        out[k] = _randomize(v, rng)
    return out


def calibrate_bn(tree_np, template, port_fn, x):
    """``tree_np`` (JAX layout) with every BatchNorm's running mean and variance
    set to those of its input in one pass of the port's ``port_fn`` on ``x``
    (per channel over batch and space; a BatchNorm that sees one value a
    channel keeps its own)."""
    port = bridge.load_tree(tree_np, template, device="cpu")
    norm = TRN.batch_norm

    def calibrating(p, h, eps=1e-5):
        if h[..., 0].numel() > 1:
            p["mean"].copy_(h.mean(dim=(0, 1, 2)))
            p["var"].copy_(h.var(dim=(0, 1, 2), unbiased=False))
        return norm(p, h, eps)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TRN, "batch_norm", calibrating)
        port_fn(port, torch.from_numpy(x))
    return bridge.to_numpy_tree(port)


def _check_pair(got, want, want2, what):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=what)
    reach = float(np.abs(want2 - want).max())
    assert reach > 100 * RTOL * scale, f"{what}: a second input moves it by {reach:.3g} of {scale}"


def ramp(shape):
    """A smooth second input: a diagonal ramp per channel (two noise images
    share their statistics, and the quality nets read statistics)."""
    b, h, w, c = shape
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.stack([(0.7 * yy + 0.3 * xx + 0.2 * k) % 1.0 for k in range(c)], axis=-1)
    return np.broadcast_to(img, shape).astype(np.float32).copy()


@pytest.mark.parametrize("case", list(CASES))
def test_network_matches_jax(case):
    make, jax_fn, port_fn, shape, has_bn = CASES[case]
    template = make()
    x, x2 = np.random.default_rng(1).uniform(size=shape).astype(np.float32), ramp(shape)
    tree = _randomize(bridge.to_numpy_tree(template), np.random.default_rng(0))
    if has_bn:
        tree = calibrate_bn(tree, template, port_fn, x)
    name = {"nima-1": "nima-koniq", "musiq-1": "musiq", "musiq-10": "musiq-ava"}.get(case, case)
    if case == "nima-10":
        port = bridge.load_tree(tree, template, device="cpu")
    else:
        port = bridge.nr_from_jax({name: tree}, device="cpu")[name]
    jt = jax.tree.map(jnp.asarray, tree)
    (wf, ws), (wf2, ws2) = jax_fn(jt, x), jax_fn(jt, x2)
    with torch.inference_mode():
        gf, gs = (t.numpy() for t in port_fn(port, torch.from_numpy(x)))
    assert gs.shape == (shape[0],) and gs.dtype == np.float32
    _check_pair(gf, wf, wf2, f"{case} features")
    _check_pair(gs, ws, ws2, f"{case} score")


_JAX_INITS = {"clipiqa": JCIQ.clip_rn50_init, "musiq": lambda k: JMUS.musiq_init(k, 1),
              "musiq-ava": lambda k: JMUS.musiq_init(k, 10),
              "musiq-paq2piq": lambda k: JMUS.musiq_init(k, 1),
              "musiq-spaq": lambda k: JMUS.musiq_init(k, 1),
              "nima-koniq": lambda k: JNIM.inception_resnet_v2_init(k, 1),
              "maniqa": JMAN.maniqa_init, "hyperiqa": JHIQ.hyperiqa_init}


@pytest.mark.parametrize("name", NEURAL)
def test_network_tree_has_the_jax_keys_and_shapes(name):
    port = {}
    for k, v in bridge.flatten(bridge.nr_init(name, "meta")).items():
        s = tuple(v.shape)
        port[k] = (s[2], s[3], s[1], s[0]) if k.split("//")[-1] == "w" and len(s) == 4 else s
    tree = jax.eval_shape(_JAX_INITS[name], jax.random.PRNGKey(0))
    assert port == {k: tuple(v.shape) for k, v in JCK.tree_flatten_dict(tree).items()}


def test_suite_names_order_and_weight_files_follow_jax(monkeypatch):
    """The default list, and the weights file each neural metric reads (the JAX
    suite's ``zoo.load_npz_tree`` calls, recorded with its inits stubbed)."""
    assert TNRS.DEFAULT_NR_METRICS == JNRS.DEFAULT_NR_METRICS
    seen = []
    monkeypatch.setattr(JNRS.zoo, "load_npz_tree", lambda name, t: (seen.append(name), (t, 0))[1])
    for mod, fn in ((JNRS.CIQ, "clip_rn50_init"), (JNRS.MUS, "musiq_init"),
                    (JNRS.NIM, "inception_resnet_v2_init"), (JNRS.MAN, "maniqa_init"),
                    (JNRS.HIQ, "hyperiqa_init")):
        monkeypatch.setattr(mod, fn, lambda *a, **k: {})
    assert list(JNRS.build_nr_suite(NEURAL)) == list(NEURAL)
    assert seen == [TNRS.NETS[n][2] for n in NEURAL]
    assert TNRS.NETS["inception"][2] == "inception_v3"


def _sharp_images(n=2, hw=(144, 200), seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 0.8, (n, *hw, 3)) + 0.2 * rng.normal(size=(n, *hw, 3))
    return np.clip(base, 0, 1).astype(np.float32)


def test_niqe_nrqm_pi_equal_jax(monkeypatch):
    imgs = _sharp_images()
    gray = TNQ._gray255(imgs[0])
    np.testing.assert_array_equal(TNQ.niqe_features(gray), JNQ.niqe_features(gray))
    t_niqe = TNQ.NIQEMetric(weights_dir=str(WEIGHTS))
    j_niqe = JNQ.NIQEMetric(params_path=str(WEIGHTS / "niqe_params.npz"))
    t_nrqm = TNRQ.NRQMMetric(weights_dir=str(WEIGHTS))
    j_nrqm = JNRQ.NRQMMetric(model_path=str(WEIGHTS / "nrqm_model.npz"))
    for m in (t_niqe, j_niqe, t_nrqm, j_nrqm):
        m.update(imgs)
    assert abs(t_niqe.compute() - j_niqe.compute()) <= 1e-12
    assert abs(t_nrqm.compute() - j_nrqm.compute()) <= 1e-12
    for g_t, g_j in zip(TNRQ.nrqm_features(imgs[1]), JNRQ.nrqm_features(imgs[1])):
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-12)
    monkeypatch.setenv("UNIRESTORE_WEIGHTS", str(WEIGHTS))
    t_suite = TNRS.build_nr_suite(["pi", "niqe"], device="cpu", weights_dir=str(WEIGHTS))
    j_suite = JNRS.build_nr_suite(["pi", "niqe"])
    assert list(t_suite) == list(j_suite) == ["pi", "niqe"]
    assert t_suite["pi"].nrqm is not None
    for suite in (t_suite, j_suite):
        for m in suite.values():
            m.update(imgs)
    for name in ("pi", "niqe"):
        assert abs(t_suite[name].compute() - j_suite[name].compute()) <= 1e-12, name
    assert np.isfinite(t_suite["pi"].compute())


def test_niqe_skips_small_images_and_fits_like_jax():
    imgs = _sharp_images(n=2, hw=(100, 100), seed=4)
    mu_t, cov_t = TNQ.fit_niqe_model(imgs)
    mu_j, cov_j = JNQ.fit_niqe_model(imgs)
    np.testing.assert_array_equal(mu_t, mu_j)
    np.testing.assert_array_equal(cov_t, cov_j)
    m = TNQ.NIQEMetric(weights_dir=str(WEIGHTS))
    with pytest.warns(UserWarning, match="smaller than 96px"):
        m.update(np.zeros((1, 64, 64, 3), np.float32))
    assert m.count == 0 and m.compute() == 0.0


def test_suite_skips_and_falls_back_like_jax(tmp_path, monkeypatch):
    """No NIQE model: niqe and pi are skipped; a NIQE model without an NRQM
    one: PI with the constant NRQM = 5."""
    assert TNRS.build_nr_suite(["niqe", "pi"], device="cpu", weights_dir=str(tmp_path)) == {}
    monkeypatch.setenv("UNIRESTORE_WEIGHTS", str(tmp_path))
    assert JNRS.build_nr_suite(["niqe", "pi"]) == {}
    (tmp_path / "niqe_params.npz").write_bytes((WEIGHTS / "niqe_params.npz").read_bytes())
    TNRS._WARNED.clear()
    with pytest.warns(UserWarning, match="NRQM=5.0"):
        suite = TNRS.build_nr_suite(["pi"], device="cpu", weights_dir=str(tmp_path))
    assert suite["pi"].nrqm is None and JNRS.build_nr_suite(["pi"])["pi"].nrqm is None
    with pytest.raises(ValueError, match="unknown NR metric nope"):
        TNRS.build_nr_suite(["nope"], device="cpu")


def test_pi_formula_and_clone_state_like_jax():
    class FakeNiqe:
        def __init__(self):
            self.n = 0

        def update(self, x):
            self.n += 1

        def compute(self):
            return 4.0

        def reset(self):
            self.n = 0

    class FakeModel:
        def score(self, img):
            return 7.0

    assert TNRS.PIMetric(FakeNiqe(), nrqm_const=6.0).compute() == pytest.approx(4.0)
    for nrs, ev, nrqm_cls in ((TNRS, TEV, TNRQ.NRQMMetric), (JNRS, JEV, JNRQ.NRQMMetric)):
        nrqm = nrqm_cls.__new__(nrqm_cls)
        nrqm.model, nrqm.total, nrqm.count = FakeModel(), 0.0, 0
        pi = nrs.PIMetric(FakeNiqe(), nrqm)
        clone = ev._clone_metric(pi)
        pi.update(np.zeros((1, 8, 8, 3)))
        assert pi.nrqm.count == 1 and clone.nrqm.count == 0 and pi.niqe.n == 1
        clone.reset()
        assert pi.nrqm.count == 1 and clone.nrqm.compute() == 5.0
        assert pi.compute() == pytest.approx(0.5 * ((10 - 7.0) + 4.0))


def test_neural_metric_loads_a_jax_npz_and_scores_like_jax(tmp_path):
    """A converted ``.npz`` (the JAX tree, flat, under the JAX suite's file
    name): ``musiq-spaq`` of the port's suite loads ``musiq_spaq.npz`` whole and
    its ``NeuralNR`` means the JAX function's scores of that tree over two
    updates. (The JAX suite's own jitted MUSIQ cannot run on a tree loaded
    from a file: ``musiq.py:_hse_lookup`` then indexes a numpy table with a
    traced index; ROADMAP Queue C.)"""
    tree = bridge.to_numpy_tree(bridge.nr_init("musiq-spaq", "cpu"))
    flat = JCK.tree_flatten_dict(tree)
    np.savez(tmp_path / "musiq_spaq.npz", **flat)
    x = np.random.default_rng(6).uniform(size=(2, 64, 96, 3)).astype(np.float32)
    m = TNRS.build_nr_suite(["musiq-spaq"], device="cpu", weights_dir=str(tmp_path))["musiq-spaq"]
    assert bridge.flatten(bridge.to_numpy_tree(m.params)).keys() == flat.keys()
    jt = jax.tree.map(jnp.asarray, tree)
    want = [np.asarray(JMUS.musiq_score(jt, jnp.asarray(b), 1)) for b in (x, x[:, ::-1])]
    m.update(x)
    m.update(x[:, ::-1])
    assert m.count == 4
    mean = float(np.mean(np.concatenate(want).astype(np.float64)))
    assert abs(m.compute() - mean) <= RTOL * float(np.abs(np.concatenate(want)).max())
    m.reset()
    assert m.count == 0 and m.compute() == 0.0


class CheapNR:
    """A host NR metric: the mean intensity."""

    def __init__(self):
        self.v = []

    def update(self, imgs):
        self.v.extend(np.asarray(imgs).mean(axis=(1, 2, 3)).tolist())

    def compute(self):
        return float(np.mean(self.v))

    def reset(self):
        self.v = []


def _fixed_restore(images, task):
    return np.clip(0.9 * np.asarray(images) + 0.05, 0, 1)


@pytest.mark.parametrize("mode", ["NR", "ALL", "FR"])
def test_ir_evaluator_modes_match_jax(mode):
    """Both evaluators over one restore, the real NIQE and PI, a host metric and
    a FID over a cheap extractor: the same keys, values and monitor."""
    from unirestore_torch.evalx import fid as TFID
    from unirestore_tpu.evalx import fid as JFID

    rng = np.random.default_rng(7)
    batches = [{"hq": rng.uniform(size=(1, 128, 160, 3)).astype(np.float32),
                "lq": rng.uniform(size=(1, 128, 160, 3)).astype(np.float32)} for _ in range(2)]
    outs = []
    for nrs, ev, fid_mod, niqe, nrqm in (
            (TNRS, TEV, TFID, TNQ.NIQEMetric(weights_dir=str(WEIGHTS)),
             TNRQ.NRQMMetric(weights_dir=str(WEIGHTS))),
            (JNRS, JEV, JFID, JNQ.NIQEMetric(params_path=str(WEIGHTS / "niqe_params.npz")),
             JNRQ.NRQMMetric(model_path=str(WEIGHTS / "nrqm_model.npz")))):
        suite = {"cheap": CheapNR(), "pi": nrs.PIMetric(niqe, nrqm)}
        fid = None if mode == "NR" else {  # as config.build gives it
            t: fid_mod.FID(lambda x: np.asarray(x).mean(axis=(1, 2)), 3) for t in ("hq", "lq")}
        e = ev.ImageRestorationEvaluator(_fixed_restore, eval_mode=mode, fid=fid,
                                         nr_metrics=suite)
        for b in batches:
            e.validation_step(b)
        outs.append(e.epoch_end())
    got, want = outs
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k
    keys = {"NR": {"val_lq/cheap", "val_lq/pi"},
            "ALL": {f"val_{e}/{k}" for e in ("hq", "lq")
                    for k in ("psnr", "ssim", "fid", "cheap", "pi")},
            "FR": {f"val_{e}/{k}" for e in ("hq", "lq") for k in ("psnr", "ssim", "fid")}}[mode]
    assert set(got) == keys | {"val_monitor"}
    assert got["val_monitor"] == (0.0 if mode == "NR" else got["val_lq/psnr"])


def test_build_nr_and_all_like_jax():
    """``config.build``'s ir evaluator: NR builds the suite (``nr_metrics``
    honoured) and neither LPIPS nor FID; ALL with ``compute_fid`` all three,
    each once across validate() epochs."""
    yaml = REPO / "configs" / "val.yaml"
    cfg = TC.load_config(yaml, ["--model.init_args.eval_mode", "NR",
                                "--model.init_args.compute_fid", "true",
                                "--model.init_args.nr_metrics", "[niqe, musiq]"])
    engine, _, _, factory = TC.build(cfg, tiny=True, device="cpu")
    ev = factory(engine)
    assert ev.eval_types == ["lq"] and ev.lpips_fn is None and ev.fid is None
    assert list(ev.nr["lq"]) == ["niqe", "musiq"]
    assert ev.nr["lq"]["musiq"].device.type == "cpu"
    assert set(ev.task_metric.metrics["lq"]) == set()
    cfg = TC.load_config(yaml, ["--model.init_args.eval_mode", "ALL",
                                "--model.init_args.compute_fid", "true",
                                "--model.init_args.nr_metrics", "[pi]"])
    engine, _, _, factory = TC.build(cfg, tiny=True, device="cpu")
    ev, ev2 = factory(engine), factory(engine)
    assert ev.eval_types == ["hq", "lq"] and ev.lpips_fn is not None
    assert set(ev.fid) == {"hq", "lq"} and ev.fid is ev2.fid
    assert ev.lpips_fn is ev2.lpips_fn
    assert set(ev.nr["hq"]) == set(ev.nr["lq"]) == {"pi"}
    assert ev.nr["hq"]["pi"] is not ev.nr["lq"]["pi"]
    assert set(ev.task_metric.metrics["hq"]) == {"psnr", "ssim", "lpips"}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    for name in ("tensorflow", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)


def test_cli_validate_nr_on_the_cpu(tmp_path, monkeypatch):
    """``unirestore_torch.main validate`` from ``configs/val.yaml`` in NR with the
    full default suite (seeded networks on the CPU) on the tiny model: the JAX
    evaluator's NR keys and the NIQE monitor."""
    from unirestore_torch.train import engine as TE

    ir_list = make_smoke_tree(tmp_path / "smoke", res=128)
    got, validate = [], TE.Trainer.validate
    monkeypatch.setattr(TE.Trainer, "validate",
                        lambda self, *a: (got.append(validate(self, *a)), got[-1])[1])
    TMAIN.main([
        "validate", "--config", str(REPO / "configs" / "val.yaml"), "--tiny", "--device", "cpu",
        "--model.init_args.eval_mode", "NR",
        "--data.init_args.dataset_dict.DIVF2KOST.val", str(ir_list),
        "--data.init_args.num_workers", "0", "--trainer.limit_val_batches", "1",
        "--trainer.logger.init_args.save_dir", str(tmp_path / "logs")])
    (metrics,) = got
    assert set(metrics) == {f"val_lq/{n}" for n in JNRS.DEFAULT_NR_METRICS} | {"val_monitor"}
    assert metrics["val_monitor"] == metrics["val_lq/niqe"] > 0
    assert all(np.isfinite(v) for v in metrics.values())
