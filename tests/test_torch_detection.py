"""Port parity: RetinaNet, the stage-3 detection critic
(``unirestore_torch/tasks/retinanet.py``), the box helpers Faster R-CNN shares
with it, ``nn.layers.resize_nearest`` and ``MeanAveragePrecision``.

Both sides run one set of weights: the port's seeded RetinaNet with random
BatchNorm statistics and random GroupNorm affine leaves, handed to the JAX
functions in the JAX layout and carried back by
``bridge.critics_from_jax``. The JAX networks are compiled with the weights
as arguments (closed over, XLA folds them as constants and compiles for
minutes). Everything runs in fp32 on the CPU. Tolerances:

- ``resize_nearest``: bit-equal (both read the same rows);
- anchors, encode / decode, IoU, ``pad_targets``: 1e-6 (decode's exp
  relative, the rest absolute);
- host ``nms`` and ``MeanAveragePrecision`` on identical inputs: equal;
- per-level logits and box deltas: 1e-4 of the largest magnitude (fp32
  convolutions summed in another order through 50 layers);
- the loss: 1e-5 relative; its gradient with respect to the images: 1e-4 of
  the largest;
- ``retinanet_detect``: the same boxes, box for box, within 1e-4 of the
  largest coordinate, equal labels, scores within 1e-5. A score within 1e-4
  of the threshold would make the two lists differ by a box without either
  being wrong: the test fails naming it rather than comparing silently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirestore_torch import bridge, tasks
from unirestore_torch.evalx import metrics as TM
from unirestore_torch.nn import layers as TL
from unirestore_torch.tasks import retinanet as TRET
from unirestore_torch.train import engine as TE
from unirestore_tpu.evalx import metrics as JM
from unirestore_tpu.nn import layers as JL
from unirestore_tpu.tasks import fasterrcnn as JFRC
from unirestore_tpu.tasks import retinanet as JRET
from unirestore_tpu.train import checkpoints as JCK

torch.set_num_threads(2)


def randomize_norms(tree, rng):
    """Random running statistics and affine leaves for every BatchNorm, and
    random affine leaves for every GroupNorm, of a numpy tree."""
    if isinstance(tree, dict):
        keys = set(tree)
        if keys in ({"scale", "bias", "mean", "var"}, {"scale", "bias"}):
            c = tree["scale"].shape
            out = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
            if "mean" in keys:
                out.update(mean=(0.1 * rng.standard_normal(c)).astype(np.float32),
                           var=rng.uniform(0.5, 1.5, c).astype(np.float32))
            return out
        return {k: randomize_norms(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [randomize_norms(v, rng) for v in tree]
    return tree


def detector(downstream, seed=0):
    """(the JAX tree as jax arrays, the same carried across to the port)."""
    ref = randomize_norms(bridge.to_numpy_tree(tasks.critic_init("det", "cpu", downstream)),
                          np.random.default_rng(seed))
    port = bridge.critics_from_jax({"det": ref}, device="cpu", downstream=downstream)["det"]
    return jax.tree.map(jnp.asarray, ref), port


@pytest.fixture(scope="module")
def retinanet():
    return detector("retinanet")


def close(got, want, scale=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * float(np.abs(want).max()))


def targets(batch=2, m=8):
    """Padded targets on a 64 px image: a box equal to a P3 anchor, others
    that half-overlap anchors, and padding."""
    boxes = np.zeros((batch, m, 4), np.float32)
    labels = np.zeros((batch, m), np.int64)
    mask = np.zeros((batch, m), bool)
    rows = [[[4, 4, 36, 36], [20, 10, 60, 58], [30, 2, 50, 40]], [[8, 16, 58, 46]]]
    labs = [[3, 17, 90], [1]]
    for i in range(batch):
        n = len(rows[i % 2])
        boxes[i, :n], labels[i, :n], mask[i, :n] = rows[i % 2], labs[i % 2], True
    return boxes, labels, mask


def assert_same_detections(got, want, threshold, scores_ref):
    """Box-for-box equality of two detection lists; ``scores_ref``: every
    candidate score the threshold saw (per image), to name the ambiguous ones."""
    near = [float(s) for s in np.ravel(scores_ref) if abs(s - threshold) < 1e-4]
    assert not near, (f"scores {near} lie within 1e-4 of the threshold {threshold}: "
                      "the two lists may rightly differ there")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"boxes", "scores", "labels"}
        assert len(g["boxes"]) == len(w["boxes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        if len(w["boxes"]):
            close(g["boxes"], w["boxes"])


@pytest.mark.parametrize("shape,size", [((2, 4, 4, 8), (8, 8)), ((1, 17, 17, 3), (33, 33)),
                                        ((1, 17, 9, 5), (33, 18)), ((1, 9, 11, 2), (5, 6)),
                                        ((1, 3, 5, 4), (3, 5))],
                         ids=["2x", "17_to_33", "mixed", "shrink", "same"])
def test_resize_nearest_matches_jax_bit_for_bit(shape, size):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(JL.resize_nearest(jnp.asarray(x), size))
    got = TL.resize_nearest(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(64, 64), (120, 140), (512, 512)])
def test_anchors_match_jax(hw):
    np.testing.assert_allclose(TRET.anchors_for_shape(*hw), JRET.anchors_for_shape(*hw),
                               rtol=0, atol=1e-6)


def test_box_helpers_match_jax():
    rng = np.random.default_rng(2)

    def boxes(n):
        xy = rng.uniform(0, 60, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(1, 40, (n, 2))], 1).astype(np.float32)

    a, b = boxes(50), boxes(50)
    deltas = rng.normal(0, 1, (50, 4)).astype(np.float32)
    deltas[0, 2:] = [6.0, -12.0]  # past the decode clamps
    t = torch.from_numpy
    np.testing.assert_allclose(TRET.encode_boxes(t(a), t(b)).numpy(),
                               JRET.encode_boxes(jnp.asarray(a), jnp.asarray(b)), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(TRET.decode_boxes(t(a), t(deltas)).numpy(),
                               JRET.decode_boxes(jnp.asarray(a), jnp.asarray(deltas)),
                               rtol=1e-6, atol=1e-6)
    iou = JRET._pairwise_iou(jnp.asarray(a), jnp.asarray(b[:7]))
    np.testing.assert_allclose(TRET._pairwise_iou(t(a), t(b[:7])).numpy(), iou, rtol=0,
                               atol=1e-6)
    # leading batch dimensions: each image as the JAX function alone
    batched = TRET._pairwise_iou(t(np.stack([a, b])), t(np.stack([b[:7], a[:7]]))).numpy()
    np.testing.assert_allclose(batched[0], iou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(batched[1], JRET._pairwise_iou(jnp.asarray(b), jnp.asarray(a[:7])),
                               rtol=0, atol=1e-6)

    gts = [{"boxes": boxes(3), "labels": np.array([1, 5, 90])}, {"boxes": boxes(0),
                                                                 "labels": np.array([])},
           {"boxes": boxes(70), "labels": rng.integers(1, 91, 70)}]
    for got, want in zip(TRET.pad_targets(gts), JRET.pad_targets(gts)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_host_nms_and_mean_average_precision_match_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, (200, 2))
    bx = np.concatenate([xy, xy + rng.uniform(5, 30, (200, 2))], 1).astype(np.float32)
    sc = rng.uniform(size=200).astype(np.float32)
    for thr, max_det in ((0.5, 100), (0.3, 10), (0.7, 300)):
        np.testing.assert_array_equal(TRET.nms(bx, sc, thr, max_det),
                                      JRET.nms(bx, sc, thr, max_det))
    preds, gts = [], []
    for i in range(4):
        sel = rng.choice(200, 30, replace=False)
        preds.append({"boxes": bx[sel], "scores": sc[sel], "labels": rng.integers(1, 4, 30)})
        gts.append({"boxes": bx[sel[:5]] + rng.normal(0, 2, (5, 4)).astype(np.float32),
                    "labels": rng.integers(1, 4, 5)})
    for thresholds in ((0.1,), (0.5, 0.75)):
        ours, ref = TM.MeanAveragePrecision(thresholds), JM.MeanAveragePrecision(thresholds)
        ours.update(preds, gts)
        ref.update(preds, gts)
        assert ours.compute() == ref.compute() > 0


def test_retinanet_features_match_jax(retinanet):
    """At 72 x 88 px the FPN meets non-integer ratios (c5 3 x 3 -> c4 5 x 6 -> c3 9 x 11)."""
    jp, tp = retinanet
    x = np.random.default_rng(4).uniform(size=(2, 72, 88, 3)).astype(np.float32)
    cls_j, box_j = jax.jit(JRET.retinanet_features)(jp, jnp.asarray(x))
    cls_t, box_t = TRET.retinanet_features(tp, torch.from_numpy(x))
    assert [tuple(c.shape[1:3]) for c in cls_t] == [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
    for got, want in zip(cls_t + box_t, list(cls_j) + list(box_j)):
        close(got, want)
    flat_j = JRET._flatten_outputs(cls_j, box_j, 91)
    flat_t = TRET._flatten_outputs(cls_t, box_t, 91)
    for got, want in zip(flat_t, flat_j):
        close(got, want)
    assert flat_t[0].shape[1] == TRET.anchors_for_shape(72, 88).shape[0]


def test_retinanet_loss_and_image_gradient_match_jax(retinanet):
    jp, tp = retinanet
    x = np.random.default_rng(5).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    boxes, labels, mask = targets()
    fn = jax.jit(jax.value_and_grad(
        lambda im, p: JRET.retinanet_loss(p, im, boxes, labels, mask)))
    loss_j, grad_j = fn(jnp.asarray(x), jp)

    im = torch.from_numpy(x).requires_grad_(True)
    loss = TRET.retinanet_loss(tp, im, *map(torch.from_numpy, (boxes, labels, mask)))
    (grad,) = torch.autograd.grad(loss, [im])
    # the targets hold positives (IoU >= 0.5) and ignored anchors in both images
    best, _ = TRET.match(torch.from_numpy(TRET.anchors_for_shape(64, 64)),
                         torch.from_numpy(boxes), torch.from_numpy(mask))
    assert ((best >= 0.5).sum(1) > 0).all() and (((best >= 0.4) & (best < 0.5)).sum(1) > 0).all()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    close(grad, grad_j)
    assert float(np.abs(np.asarray(grad_j)).max()) > 0


def test_retinanet_detect_matches_jax(retinanet, monkeypatch):
    jp, tp = retinanet
    x = np.random.default_rng(6).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    # the JAX detector runs its network compiled (op by op it takes seconds)
    monkeypatch.setattr(JRET, "retinanet_features", jax.jit(JRET.retinanet_features))
    cls_j, box_j = JRET.retinanet_features(jp, jnp.asarray(x))
    probs = np.asarray(jax.nn.sigmoid(JRET._flatten_outputs(cls_j, box_j, 91)[0]))
    # the seeded heads' scores crowd 0.01-0.05; both thresholds lie in gaps
    # wider than 1e-4, and the second keeps fewer boxes than it finds
    for threshold, max_det in ((0.05, 100), (0.053, 2)):
        want = JRET.retinanet_detect(jp, x, score_threshold=threshold, max_det=max_det)
        got = TRET.retinanet_detect(tp, x, score_threshold=threshold, max_det=max_det)
        assert_same_detections(got, want, threshold, probs.max(-1))
        assert sum(len(d["boxes"]) for d in got) > 0


def test_detector_trees_have_the_jax_keys_and_shapes(tmp_path):
    inits = {"retinanet": JRET.retinanet_init, "fastrcnn": JFRC.fasterrcnn_init}
    shapes = {d: jax.eval_shape(init, jax.random.PRNGKey(9)) for d, init in inits.items()}
    for downstream in inits:
        want = {k: tuple(v.shape) for k, v in JCK.tree_flatten_dict(shapes[downstream]).items()}
        got = bridge.flatten(tasks.critic_init("det", "meta", downstream))
        assert got.keys() == want.keys(), downstream
        for k, v in got.items():
            shape = tuple(v.shape)
            if v.ndim == 4:  # OIHW here, HWIO there
                shape = (shape[2], shape[3], shape[1], shape[0])
            assert shape == want[k], k
    assert tasks.critic_name("det") == tasks.critic_name("det", "retinanet") == "retinanet"
    assert "fc" in tasks.critic_init("det", "meta")["backbone"]
    assert "fc" not in tasks.critic_init("det", "meta", "fastrcnn")["backbone"]
    # the prior bias of the classification head
    b = tasks.critic_init("det", "cpu")["cls_head"]["out"]["b"]
    np.testing.assert_allclose(b.numpy(), -np.log(99.0), rtol=1e-6)
    # a RetinaNet tree is not a Faster R-CNN tree: the bridge checks both ways
    ref = jax.tree.map(lambda v: np.zeros(v.shape, np.float32), shapes["fastrcnn"])
    with pytest.raises(KeyError, match="missing"):
        bridge.critics_from_jax({"det": ref}, device="cpu")
    assert bridge.critics_from_jax({"det": ref}, device="cpu", downstream="fastrcnn").keys() \
        == {"det"}
    # no converted file: the seeded init, warned, keyed "det" for either detector
    with pytest.warns(UserWarning, match="fasterrcnn_resnet50"):
        critics = TE.build_critics("det", "fastrcnn", device="cpu", weights_dir=tmp_path)
    assert critics.keys() == {"det"} and "rpn" in critics["det"]
    seeded = bridge.flatten(tasks.critic_init("det", "cpu", "fastrcnn"))
    for k, v in bridge.flatten(critics["det"]).items():
        assert v.dtype == torch.float32 and torch.equal(v, seeded[k]), k
        if v.ndim == 4:
            assert v.is_contiguous(memory_format=torch.channels_last), k
    with pytest.raises(KeyError):
        TE.build_critics("nope", device="cpu")
