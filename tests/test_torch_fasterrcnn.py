"""Port parity: Faster R-CNN, the stage-3 critic of ``downstream: fastrcnn``
(``unirestore_torch/tasks/fasterrcnn.py``).

One set of weights on both sides, as in ``test_torch_detection.py`` (the
port's seeded tree, BatchNorm statistics and affine leaves randomised),
compiled on the JAX side with the weights as arguments. fp32 on the CPU.
Tolerances:

- ``_greedy_nms_mask`` on identical inputs: the same indices;
- FPN features, RPN outputs, proposals, ``_roi_align`` and ``_box_head``: 1e-4
  of the largest magnitude;
- the loss: 1e-5 relative, fed JAX's own sampling draws (the uniforms
  ``jax.random.uniform`` makes from ``PRNGKey(0)`` with the function's own
  key splits); its gradient with respect to the images: 1e-4 of the largest;
- ``fasterrcnn_detect``: box for box, as ``retinanet_detect`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_detection import assert_same_detections, close, detector, targets
from unirestore_torch.tasks import fasterrcnn as TFRC
from unirestore_tpu.tasks import fasterrcnn as JFRC

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fasterrcnn():
    return detector("fastrcnn", seed=1)


def jax_uniforms(batch, h, w, key=None):
    """The sampling scores ``JFRC.fasterrcnn_loss`` draws from ``key``
    (default ``PRNGKey(0)``): one uniform per RPN anchor and per proposal and
    image, from the key splits the function makes."""
    key = jax.random.PRNGKey(0) if key is None else key
    n = JFRC.rpn_anchors_for_shape(h, w).shape[0]
    post = min(JFRC.POST_NMS, JFRC.PRE_NMS, n)
    k1, k2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (size,)))
                                            for k in jax.random.split(kk, batch)]))
                 for kk, size in ((k1, n), (k2, post)))


def test_fpn_rpn_and_proposals_match_jax(fasterrcnn):
    """At 72 x 88 px the FPN meets non-integer ratios (c5 3 x 3 -> c4 5 x 6)."""
    jp, tp = fasterrcnn
    x = np.random.default_rng(7).uniform(size=(2, 72, 88, 3)).astype(np.float32)

    def run(p, im):
        feats = JFRC.fpn_features(p, im)
        return feats, JFRC._rpn_outputs(p, feats), JFRC._proposals(p, feats, 72, 88)[0]

    feats_j, (obj_j, box_j), props_j = jax.jit(run)(jp, jnp.asarray(x))
    feats = TFRC.fpn_features(tp, torch.from_numpy(x))
    assert feats.keys() == feats_j.keys() == {2, 3, 4, 5, 6}
    assert [tuple(feats[k].shape[1:3]) for k in (2, 3, 4, 5, 6)] == \
        [(18, 22), (9, 11), (5, 6), (3, 3), (2, 2)]
    for k in feats:
        close(feats[k], feats_j[k])
    obj, box = TFRC._rpn_outputs(tp, feats)
    close(obj, obj_j)
    close(box, box_j)
    props = TFRC._proposals(tp, feats, 72, 88)[0]
    assert props.shape == (2, TFRC.POST_NMS, 4)
    close(props, props_j)


def test_greedy_nms_matches_jax_on_identical_inputs():
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 40, (2, 64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 24, (2, 64, 2))], -1).astype(np.float32)
    boxes[0, 5] = boxes[0, 6]  # a duplicate
    boxes[1, 9, 2:] = boxes[1, 9, :2]  # a box of zero area
    scores = -np.sort(-rng.uniform(size=(2, 64)), axis=1).astype(np.float32)
    got = TFRC._greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 64)
    for i in range(2):
        for thr, keep in ((0.3, 64), (0.5, 48), (0.7, 16)):
            want = np.asarray(JFRC._greedy_nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                                    thr, keep))
            one = TFRC._greedy_nms_mask(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]),
                                        thr, keep)
            np.testing.assert_array_equal(one.numpy(), want)
            if (thr, keep) == (0.3, 64):  # batched: each row as alone
                np.testing.assert_array_equal(got[i].numpy(), want)
        # past the candidates still alive, every step picks index 0
        assert (got[i, -1] == 0).item()


def test_roi_align_and_box_head_match_jax(fasterrcnn):
    """Boxes of every size on a 512 px image's P2-P5, so that every level is
    chosen (sqrt(area) from 12 to 540 px), two images of different boxes."""
    jp, tp = fasterrcnn
    rng = np.random.default_rng(9)
    feats = {lvl: rng.standard_normal((2, 512 // 2 ** lvl, 512 // 2 ** lvl, 8))
             .astype(np.float32) for lvl in JFRC.LEVELS}
    side = np.geomspace(12, 540, 24)
    xy = rng.uniform(-8, np.maximum(512 - side[:, None], 0) + 8, (2, 24, 2))
    boxes = np.concatenate([xy, xy + side[:, None] * rng.uniform(0.9, 1.1, (2, 24, 2))],
                           -1).astype(np.float32)
    got = TFRC._roi_align({k: torch.from_numpy(v) for k, v in feats.items()},
                          torch.from_numpy(boxes))
    for i in range(2):
        want = JFRC._roi_align({k: jnp.asarray(v[i]) for k, v in feats.items()},
                               jnp.asarray(boxes[i]))
        close(got[i], want)
    areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    levels = np.clip(np.floor(4 + np.log2(np.sqrt(areas) / 224.0)), 2, 5)
    assert set(levels.ravel()) == {2.0, 3.0, 4.0, 5.0}

    rois = rng.standard_normal((5, 7, 7, 256)).astype(np.float32)
    close(TFRC._box_head(tp, torch.from_numpy(rois)),
          jax.jit(JFRC._box_head)(jp, jnp.asarray(rois)))


def test_fasterrcnn_loss_and_image_gradient_match_jax_on_its_draws(fasterrcnn):
    jp, tp = fasterrcnn
    x = np.random.default_rng(10).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    boxes, labels, mask = targets()
    fn = jax.jit(jax.value_and_grad(
        lambda im, p: JFRC.fasterrcnn_loss(p, im, boxes, labels, mask)))
    loss_j, grad_j = fn(jnp.asarray(x), jp)

    im = torch.from_numpy(x).requires_grad_(True)
    gt = tuple(map(torch.from_numpy, (boxes, labels, mask)))
    loss = TFRC.fasterrcnn_loss(tp, im, *gt, uniforms=jax_uniforms(2, 64, 64))
    (grad,) = torch.autograd.grad(loss, [im])
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    close(grad, grad_j)
    assert float(np.abs(np.asarray(grad_j)).max()) > 0

    # another key's draws give another loss: the draws are what is compared
    other = TFRC.fasterrcnn_loss(tp, torch.from_numpy(x), *gt,
                                 uniforms=jax_uniforms(2, 64, 64, jax.random.PRNGKey(1)))
    assert other.item() != loss.item()
    # without draws: a generator seeded 0 on every call, one fixed sample
    with torch.no_grad():
        first = TFRC.fasterrcnn_loss(tp, torch.from_numpy(x), *gt)
        again = TFRC.fasterrcnn_loss(tp, torch.from_numpy(x), *gt)
        drawn = TFRC.fasterrcnn_loss(tp, torch.from_numpy(x), *gt,
                                     uniforms=TFRC.loss_uniforms(2, 64, 64, "cpu"))
    assert first.item() == again.item() == drawn.item()
    assert [tuple(u.shape) for u in TFRC.loss_uniforms(2, 64, 64, "cpu")] == [(2, 1023),
                                                                             (2, 256)]


def test_fasterrcnn_detect_matches_jax(fasterrcnn, monkeypatch):
    # the seeded predictor's class scores all lie within 2e-3 of 1/91: its
    # weights scaled by 40 spread them, so that thresholds find gaps
    jp, tp = fasterrcnn
    jp = {**jp, "cls_score": {**jp["cls_score"], "w": 40.0 * jp["cls_score"]["w"]}}
    tp = {**tp, "cls_score": {**tp["cls_score"], "w": 40.0 * tp["cls_score"]["w"]}}
    x = np.random.default_rng(11).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    # the JAX detector's networks run compiled (op by op they take seconds)
    for name in ("fpn_features", "_box_head"):
        monkeypatch.setattr(JFRC, name, jax.jit(getattr(JFRC, name)))
    monkeypatch.setattr(JFRC, "_proposals", jax.jit(JFRC._proposals, static_argnums=(2, 3)))

    def class_scores(p, im):
        feats = JFRC.fpn_features(p, im)
        props, _ = JFRC._proposals(p, feats, 64, 64)
        out = []
        for b in range(im.shape[0]):
            emb = JFRC._box_head(p, JFRC._roi_align({k: feats[k][b] for k in JFRC.LEVELS},
                                                    props[b]))
            out.append(jax.nn.softmax(emb @ p["cls_score"]["w"] + p["cls_score"]["b"], -1))
        return jnp.stack(out)

    scores = np.asarray(jax.jit(class_scores)(jp, jnp.asarray(x)))[..., 1:]
    # both thresholds lie in gaps wider than 1e-3, and the second keeps fewer
    # boxes than it finds
    for threshold, max_det in ((0.06, 100), (0.075, 3)):
        want = JFRC.fasterrcnn_detect(jp, x, score_threshold=threshold, max_det=max_det)
        got = TFRC.fasterrcnn_detect(tp, x, score_threshold=threshold, max_det=max_det)
        assert_same_detections(got, want, threshold, scores)
        assert sum(len(d["boxes"]) for d in got) > 0
    none = TFRC.fasterrcnn_detect(tp, x, score_threshold=0.5)
    assert all(d["boxes"].shape == (0, 4) and d["labels"].dtype == np.int64 for d in none)
