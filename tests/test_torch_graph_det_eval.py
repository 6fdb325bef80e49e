"""The graph route for stage 3 (``det``) and for the validation networks, on
the CPU: what the route needs from the host side, which runs here. CUDA
graphs run only on the card (``tests/test_torch_cuda.py`` holds the det step
of both detectors and three validation networks replayed against eager
there; ``chip_smoke.py`` phase 20 the full-width ones).

- Faster R-CNN's sampling draws (``loss_uniforms``) are the draws of a fresh
  generator seeded 0, cut to the rank's rows, made once per key and kept:
  the loss draws nothing after its first call, so a graph holds no generator.
- ``on_device`` and ``loss_uniforms`` refuse to make a missing constant
  inside a (mocked) CUDA graph capture, and serve a present one.
- ``GraphedTrainStep`` keys a ``det`` batch by every entry of its nested
  ``gt`` dict (shape and dtype), and rebuilds the nesting for the parts.
- ``GraphedCall`` keeps one graph per input (shape, dtype), evicts the least
  recently used, counts captures and replays (a stub capture stands in for
  the card), and refuses the CPU, a process group and a spatial context.
- ``config.build`` with ``trainer.cuda_graphs`` refuses the CPU for every
  engine and ``eval_mode``, ``det`` included, before any work; every network
  factory's ``cuda_graphs`` reaches a ``GraphedCall``, which refuses it.
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_spatial import _fake_context
from unirestore_torch import config as C
from unirestore_torch import graphs as GR
from unirestore_torch import zoo
from unirestore_torch.evalx import evaluators as EV
from unirestore_torch.evalx import inception as INC
from unirestore_torch.evalx import lpips as LP
from unirestore_torch.evalx import nr_suite as NRS
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.nn.init import make_init
from unirestore_torch.parallel import spatial as SP
from unirestore_torch.tasks import classifier_zoo as CZ
from unirestore_torch.tasks import fasterrcnn as TFRC
from unirestore_torch.tasks import retinanet as TRET
from unirestore_torch.tasks import seg_zoo as SZ
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import steps as TS

torch.set_num_threads(2)


@pytest.mark.parametrize("world, rank", [(1, 0), (2, 0), (2, 1)])
def test_loss_uniforms_are_a_fresh_seed0_draw_cut_to_the_rows(monkeypatch, world, rank):
    monkeypatch.setattr(TFRC, "_UNIFORMS", {})
    monkeypatch.setattr(TFRC, "world_size", lambda: world)
    monkeypatch.setattr(TFRC, "rank", lambda: rank)
    monkeypatch.setattr("unirestore_torch.parallel.distributed.world_size", lambda: world)
    monkeypatch.setattr("unirestore_torch.parallel.distributed.rank", lambda: rank)
    rpn, roi = TFRC.loss_uniforms(2, 64, 64, "cpu")
    gen = torch.Generator().manual_seed(0)
    whole = (torch.rand((2 * world, 1023), generator=gen), torch.rand((2 * world, 256),
                                                                       generator=gen))
    rows = slice(2 * rank, 2 * rank + 2)
    assert torch.equal(rpn, whole[0][rows]) and torch.equal(roi, whole[1][rows])
    # kept: the same tensors again, whatever the generator would do now
    again = TFRC.loss_uniforms(2, 64, 64, "cpu")
    assert again[0] is rpn and again[1] is roi
    assert list(TFRC._UNIFORMS) == [(2, 64, 64, world, rank, "cpu")]


def test_fasterrcnn_loss_draws_nothing_after_its_first_call(monkeypatch):
    monkeypatch.setattr(TFRC, "_UNIFORMS", {})
    p = TFRC.fasterrcnn_init(make_init(None, "cpu", seed=1))
    x = torch.from_numpy(np.random.default_rng(3).uniform(size=(1, 64, 64, 3))
                         .astype(np.float32))
    boxes = torch.zeros((1, 64, 4))
    boxes[0, 0] = torch.tensor([8.0, 10.0, 40.0, 50.0])
    labels = torch.zeros((1, 64), dtype=torch.int64)
    labels[0, 0] = 3
    mask = torch.zeros((1, 64), dtype=torch.bool)
    mask[0, 0] = True
    with torch.no_grad():
        first = TFRC.fasterrcnn_loss(p, x, boxes, labels, mask)

        def no_draw(*args, **kwargs):
            raise AssertionError("fasterrcnn_loss drew after its first call")

        monkeypatch.setattr(torch, "Generator", no_draw)
        monkeypatch.setattr(torch, "rand", no_draw)
        again = TFRC.fasterrcnn_loss(p, x, boxes, labels, mask)
    assert torch.equal(first, again)


def test_constants_missing_inside_a_capture_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match=r"anchors_for_shape\(64, 64\) is not on cuda yet "
                                           "and a CUDA graph is being captured"):
        TRET.on_device(TRET.anchors_for_shape, 64, 64, device="cuda")
    with pytest.raises(RuntimeError, match=r"loss_uniforms\(1, 64, 64, 1, 0\) is not on cuda"):
        TFRC.loss_uniforms(1, 64, 64, "cuda")
    # a constant made before the capture is served; the CPU is never captured
    key = (TRET.anchors_for_shape.__module__, TRET.anchors_for_shape.__qualname__, (64, 64),
           "cuda")
    monkeypatch.setitem(TRET._CONSTANTS, key, torch.zeros(1))
    assert TRET.on_device(TRET.anchors_for_shape, 64, 64, device="cuda") is \
        TRET._CONSTANTS[key]
    assert TRET.on_device(TRET.anchors_for_shape, 32, 32, device="cpu").shape == (
        TRET.anchors_for_shape(32, 32).shape)


def _det_batch(boxes_dtype=torch.float32, n_boxes=64):
    return {"hq": torch.zeros((1, 64, 64, 3)), "lq": torch.zeros((1, 64, 64, 3)),
            "gt": {"boxes": torch.zeros((1, n_boxes, 4), dtype=boxes_dtype),
                   "labels": torch.zeros((1, n_boxes), dtype=torch.int64),
                   "mask": torch.zeros((1, n_boxes), dtype=torch.bool)}}


def test_graphed_train_step_keys_a_det_batch_by_its_nested_targets(monkeypatch):
    monkeypatch.setattr(GR, "refuse_graph_route", lambda *a, **k: torch.device("cpu"))
    cfg = TUR.tiny_config(tasks=("ir", "det"))
    frozen, _ = TUR.init(cfg, device="cpu", seed=2)
    stage = TS.StageConfig(train_cfrm=False, train_cnet=False, train_tfa=True,
                           tfa_prompts_only=True, multi_task=True)
    step = GR.GraphedTrainStep(frozen, cfg, TUR.schedule(cfg), stage, TOPT.AdamW(1e-3), "det",
                               device="cpu")
    key = step.key(_det_batch())
    assert key == ("det", ((("gt", "boxes"), (1, 64, 4), torch.float32),
                           (("gt", "labels"), (1, 64), torch.int64),
                           (("gt", "mask"), (1, 64), torch.bool),
                           (("hq",), (1, 64, 64, 3), torch.float32),
                           (("lq",), (1, 64, 64, 3), torch.float32)), None)
    assert step.key(_det_batch()) == key
    assert step.key(_det_batch(boxes_dtype=torch.float64)) != key
    assert step.key(_det_batch(n_boxes=32)) != key
    flat = GR._flat_batch(_det_batch())
    nested = GR._nest(flat)
    assert set(nested) == {"gt", "hq", "lq"} and set(nested["gt"]) == {"boxes", "labels", "mask"}
    assert all(nested["gt"][k] is flat[("gt", k)] for k in nested["gt"])
    with pytest.raises(TypeError, match="batch entry 'gt.boxes' is not a tensor"):
        step.key({**_det_batch(), "gt": {"boxes": np.zeros((1, 64, 4))}})


class _Replay:
    """A stand-in for a captured graph: a replay recomputes ``fn`` on the buffers."""

    def __init__(self, fn, inputs, out):
        self.fn, self.inputs, self.out = fn, inputs, out

    def replay(self):
        self.out.copy_(self.fn(*self.inputs))


def _stub_capture(self, key, host):
    stats = self.stats.setdefault(key, GR.GraphStats())
    stats.captures += 1
    inputs = tuple(x.clone() for x in host)
    out = self.fn(*inputs)
    return GR._CallGraph(_Replay(self.fn, inputs, out), inputs, out)


def test_graphed_call_keeps_a_graph_per_input_shape_least_recently_used_first(monkeypatch):
    monkeypatch.setattr(GR, "refuse_graph_route", lambda *a, **k: torch.device("cpu"))
    monkeypatch.setattr(GR, "MAX_GRAPHS", 2)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(GR.GraphedCall, "_capture", _stub_capture)
    call = GR.GraphedCall(lambda x, y: (x * y).sum(dim=(1, 2, 3)), "cpu")
    rng = np.random.default_rng(0)
    shapes = [(1, 8, 8, 3), (1, 16, 8, 3), (1, 8, 8, 3), (2, 8, 8, 3), (1, 16, 8, 3)]
    for shape in shapes:
        x, y = rng.uniform(size=shape), rng.uniform(size=shape).astype(np.float64)
        got = call(x, y)
        want = (torch.from_numpy(x).float() * torch.from_numpy(y).float()).sum(dim=(1, 2, 3))
        assert torch.equal(got, want)
    key = GR.GraphedCall.key
    a, b, c = (key([torch.zeros(s, dtype=torch.float32)] * 2) for s in
               ((1, 8, 8, 3), (1, 16, 8, 3), (2, 8, 8, 3)))
    assert a == (((1, 8, 8, 3), torch.float32),) * 2
    # a, b, a (a hit), c (evicts b), b (evicts a)
    assert call._cache.keys() == [c, b]
    assert {k: (s.captures, s.replays) for k, s in call.stats.items()} == {
        a: (1, 2), b: (2, 2), c: (1, 1)}


def test_graphed_call_refuses_what_it_cannot_capture(monkeypatch):
    def fn(x):
        return x

    with pytest.raises(ValueError, match="GraphedCall needs a CUDA device, got cpu"):
        GR.GraphedCall(fn, "cpu")
    with pytest.raises(ValueError, match="GraphedCall does not run under a process group"):
        with monkeypatch.context() as m:
            m.setattr(GR.dist, "is_initialized", lambda: True)
            GR.GraphedCall(fn, "cpu")
    with SP.partition(_fake_context()):
        with pytest.raises(NotImplementedError, match="GraphedCall does not run on height-sharded"):
            GR.GraphedCall(fn, "cpu")
    # a call refuses too: a context entered after the instance was made
    monkeypatch.setattr(GR, "refuse_graph_route", lambda *a, **k: torch.device("cpu"))
    call = GR.GraphedCall(fn, "cpu")
    monkeypatch.undo()
    with SP.partition(_fake_context()):
        with pytest.raises(NotImplementedError, match="GraphedCall does not run on height-sharded"):
            call(np.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError, match="GraphedCall needs a CUDA device, got cpu"):
        call(np.zeros((1, 8, 8, 3)))


ENGINES = [("unirestore_tpu.ir", {"eval_mode": m}) for m in ("FR", "NR", "ALL")] + \
    [("unirestore_tpu.ir", {"eval_mode": "ALL", "compute_fid": True}),
     ("unirestore_tpu.mtl", {})] + \
    [("unirestore_tpu.cls", {"eval_mode": m}) for m in CZ.EVAL_MODE_SETS] + \
    [("unirestore_tpu.seg", {"eval_mode": m}) for m in SZ.EVAL_MODE_SETS] + \
    [("unirestore_tpu.det", {"downstream": d}) for d in ("retinanet", "fastrcnn")]


@pytest.mark.parametrize("class_path, init_args", ENGINES,
                         ids=[f"{c.rsplit('.', 1)[1]}-{'-'.join(map(str, a.values()))}"
                              for c, a in ENGINES])
def test_build_with_cuda_graphs_refuses_the_cpu_before_any_work(monkeypatch, class_path,
                                                                 init_args):
    def no_work(*args, **kwargs):
        raise AssertionError("built a model before the refusal")

    monkeypatch.setattr(TUR, "init", no_work)
    monkeypatch.setattr(zoo, "load_npz_tree", no_work)
    cfg = {"model": {"class_path": class_path, "init_args": {"model_kwargs": {}, **init_args}},
           "trainer": {"cuda_graphs": True}}
    assert C.engine_type(cfg) in ("ir", "mtl", "cls", "seg", "det")
    with pytest.raises(ValueError, match="graph-captured restores needs a CUDA device, got cpu"):
        C.build(cfg, tiny=True, device="cpu")


def test_every_network_factory_takes_the_route_and_refuses_the_cpu():
    cpu = "GraphedCall needs a CUDA device, got cpu"
    factories = {
        "a classifier probe": lambda: CZ.build_classifier("r18", device="cpu", cuda_graphs=True),
        "the classifier zoo": lambda: CZ.build_classifier_zoo("single", device="cpu",
                                                              cuda_graphs=True),
        "a segmentation probe": lambda: SZ.build_seg_probe("dlv3pr50", device="cpu",
                                                           cuda_graphs=True),
        "a stage-2 probe": lambda: EV.probe("cls", {}, torch.device("cpu"), cuda_graphs=True),
        "LPIPS": lambda: LP.make_lpips(device="cpu", cuda_graphs=True),
        "Inception": lambda: INC.make_fid_extractor(device="cpu", cuda_graphs=True),
        "the NR suite": lambda: NRS.build_nr_suite(["musiq"], device="cpu", cuda_graphs=True),
    }
    for what, build in factories.items():
        with pytest.raises(ValueError, match=cpu):
            build()
