"""The port's diagnostic tools (``unirestore_torch/diagnostics/``) against the
JAX package's (``tools/microbench_shapes.py``, ``tools/bench_conv.py``,
``tools/profile_components.py``), on the CPU.

- The 14 per-shape cases: names, shape strings and FLOPs equal to the JAX
  tool's ``conv_case`` / ``linear_case`` at batch 1.
- The four conv-chain variants at a tiny level (2 x 8² x 32, fp32) within
  1e-5 of the JAX tool's ``chain_*`` (largest difference over the largest
  |value|): ``resblock`` holds the port's ``group_norm`` + ``silu`` against
  JAX's.
- The FLOP counter: each kernel's count on ``meta`` tensors is its closed
  form; over a tiny restore's encode the kernels add exactly their closed
  forms at the shapes they meet; nothing leaves the ``meta`` device.
- The launches of each component row as the routing gives them at full width
  (on ``meta``: the wrappers count their calls instead of launching).
- Every tool that measures the card refuses a machine without one.
"""

import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from unirestore_torch.diagnostics import components as C
from unirestore_torch.diagnostics import conv_chains as CC
from unirestore_torch.diagnostics import flops as FL
from unirestore_torch.diagnostics import shapes as SH
from unirestore_torch.diagnostics import timing as TM
from unirestore_torch.diagnostics import train_memory as TMEM
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.nn import attention_kernels as K
from unirestore_torch.nn import grouped_conv as GC
from unirestore_torch.nn import kernels as KN

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import bench_conv as JBC  # noqa: E402
import microbench_shapes as JMS  # noqa: E402

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# the 14 per-shape cases
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_cases():
    """(name, shape string, FLOPs) of the JAX tool's cases at batch 1, in order:
    ``microbench_shapes.main`` builds them inline, so its lines are replayed
    here through its own ``conv_case`` / ``linear_case``."""
    b = 1
    specs = [("conv", "unet_conv_top", b, 64, 320, 320), ("conv", "unet_conv_mid", b, 32, 640, 640),
             ("conv", "unet_conv_deep", b, 16, 1280, 1280),
             ("conv", "unet_conv_bottom", b, 8, 1280, 1280),
             ("conv", "vae_conv_512_128", b, 512, 128, 128),
             ("conv", "vae_conv_256_256", b, 256, 256, 256),
             ("conv", "vae_conv_128_512", b, 128, 512, 512),
             ("linear", "qkv_320", b * 4096, 320, 960), ("linear", "out_320", b * 4096, 320, 320),
             ("linear", "qkv_640", b * 1024, 640, 1920),
             ("linear", "qkv_1280", b * 256, 1280, 3840),
             ("linear", "ffn_320_geglu", b * 4096, 320, 2560),
             ("linear", "ffn_back_320", b * 4096, 1280, 320),
             ("linear", "xattn_kv_320", 77, 1024, 640)]
    out = []
    for kind, *args in specs:
        case = (JMS.conv_case if kind == "conv" else JMS.linear_case)(*args)
        out.append((case[0], case[1], case[5]))
    return out


def test_the_jax_tool_still_builds_these_cases():
    """The replayed lines are the tool's: every name appears in its ``main``
    with the same arguments."""
    src = (REPO / "tools" / "microbench_shapes.py").read_text()
    for case in SH.cases(8):
        assert f'"{case.name}"' in src, case.name
    assert src.count("conv_case(\"") + src.count("linear_case(\"") == len(SH.cases(8))


@pytest.mark.parametrize("index", range(14))
def test_case_matches_the_jax_tool(index):
    case = SH.cases(1)[index]
    name, shape, flops = jax_cases()[index]
    assert (case.name, case.shape, case.flops) == (name, shape, flops)
    assert 0 < case.cap <= 1


def test_tile_cap_pads_to_wgmma_tiles():
    assert SH.tile_cap(64, 16, 8) == 1.0
    assert SH.tile_cap(77, 1024, 640) == pytest.approx(77 / 128)
    assert SH.tile_cap(4096, 2880, 320) == 1.0  # k 2880 = 180 x 16
    assert SH.tile_cap(64, 24, 12) == pytest.approx((24 / 32) * (12 / 16))


# ---------------------------------------------------------------------------
# conv chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(CC.VARIANTS))
def test_conv_chain_matches_the_jax_tool(variant):
    b, hw, c = 2, 8, 32
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(b, hw, hw, c)) * 0.3).astype(np.float32)
    ws = [(rng.normal(size=(3, 3, c, c)) * (9 * c) ** -0.5).astype(np.float32)
          for _ in range(CC.N_CHAIN)]
    scale = (1 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    want = np.asarray(JBC.VARIANTS[variant](
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}))
    got = CC.VARIANTS[variant](
        torch.from_numpy(x), [torch.from_numpy(w).permute(3, 2, 0, 1).contiguous() for w in ws],
        {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_conv_chain_lowerings_agree_and_rel_err_is_the_tools():
    x, ws, gn = CC.level_inputs(2, 8, 32, "cpu", dtype=torch.float32)
    ref = CC.chain_conv(x, ws, gn)
    for name in ("im2col", "taps"):
        assert CC.rel_err(CC.VARIANTS[name](x, ws, gn), ref) < 1e-5
    bad = ref.clone()
    bad[0, 0, 0, 0] += ref.abs().max()
    assert CC.rel_err(bad, ref) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _on(device, *shape):
    return torch.empty(shape, device=device, dtype=torch.bfloat16)


KERNEL_CASES = {
    "btc": (lambda dev: K.fused_attention_btc_prescaled(*(_on(dev, 2, 1024, 320),) * 3),
            FL.attention_flops(2, 5, 1024, 1024, 64)),
    "bh": (lambda dev: K.fused_attention_bh_prescaled(*(_on(dev, 10, 256, 128),) * 3),
           FL.attention_flops(10, 1, 256, 256, 128)),
    "stream": (lambda dev: K.streaming_attention_bh_prescaled(*(_on(dev, 2, 1024, 512),) * 3),
               FL.attention_flops(2, 1, 1024, 1024, 512)),
    "btc_out": (lambda dev: K.fused_attention_btc_out_prescaled(*(_on(dev, 2, 1024, 640),) * 3,
                                                                _on(dev, 640, 320)),
                FL.attention_flops(2, 10, 1024, 1024, 64) + 2 * 2 * 1024 * 640 * 320),
    "gconv": (lambda dev: GC.grouped_conv3(_on(dev, 2, 16, 24, 512), _on(dev, 512, 32, 3, 3),
                                           _on(dev, 512)),
              FL.grouped_conv_flops(2, 16, 24, 512)),
}


@pytest.mark.parametrize("kernel", list(KERNEL_CASES))
def test_kernel_flops_are_the_closed_forms(kernel):
    call, want = KERNEL_CASES[kernel]
    KN.reset_counts()
    assert FL.count(lambda: call("meta")) == want
    assert all(kern.launches == 0 for kern in KN.KERNELS)
    with pytest.raises(ValueError, match="CUDA"):  # the context is gone
        call("meta")


@pytest.mark.parametrize("kernel", list(KERNEL_CASES))
def test_plain_kernels_refuses_tensors_off_meta(kernel):
    """Inside ``plain_kernels()`` a wrapper gives way to its plain version on
    ``meta`` tensors only: a tensor anywhere else raises, so that the block
    cannot route a call on a device around its kernel."""
    call, _ = KERNEL_CASES[kernel]
    KN.reset_counts()
    with FL.plain_kernels(), pytest.raises(ValueError, match="meta tensors only"):
        call("cpu")
    assert all(kern.launches == 0 for kern in KN.KERNELS)


class DeviceLog(TorchDispatchMode):
    """The devices of every operation's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


def test_a_tiny_encode_counts_each_kernel_by_its_closed_form():
    """At 256 px the tiny VAE's mid-block attention (T = 1024, one 64-wide
    head) takes the channel-flat kernel and its widest CFRM stage the grouped
    conv: the count with the kernels' plain versions exceeds the count with
    zero-work stand-ins by the closed forms at the shapes met, and no
    operation leaves the ``meta`` device."""
    s = C.meta_setup(1, cfg=TUR.tiny_config(), res=256)
    encode = C.components(s)["encode(+CFRM) 512px"]
    log = DeviceLog()
    with log:
        total = FL.count(encode)
    assert log.devices == {"meta"}

    met = []

    def stand_in(kern):
        def forward(*xs):
            met.append((kern, tuple(xs[0].shape)))
            return torch.empty_like(xs[0])
        return forward

    for kern in KN.KERNELS:
        kern.forward = stand_in(kern)
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            encode()
    finally:
        for kern in KN.KERNELS:
            del kern.forward
    assert {kern for kern, _ in met} == {GC.grouped_conv3, K.fused_attention_btc_prescaled}
    kernels = sum(FL.grouped_conv_flops(*shape) if kern is GC.grouped_conv3
                  else FL.attention_flops(shape[0], shape[2] // 64, shape[1], shape[1], 64)
                  for kern, shape in met)
    assert total - counter.get_total_flops() == kernels > 0


def test_component_flops_are_whole_and_ddim_is_twenty_steps():
    """On ``meta`` at the tiny width: the step is the Controller plus the
    UNet, and the DDIM loop is its steps (the scheduler adds no tensor-core
    work; run at 2 steps here)."""
    s = C.meta_setup(1, cfg=TUR.tiny_config(), res=128)
    calls = C.components(s)
    got = {name: FL.count(calls[name]) for name in ("controller 64px", "unet-only step",
                                                    "ctrl+unet step")}
    assert all(v > 0 for v in got.values())
    assert got["ctrl+unet step"] == got["controller 64px"] + got["unet-only step"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "STEPS", 2)
        assert FL.count(calls["ddim x20"]) == 2 * got["ctrl+unet step"]


# ---------------------------------------------------------------------------
# the launches of each row, by the routing at full width
# ---------------------------------------------------------------------------


def test_each_row_calls_the_kernels_the_table_says():
    """Full width on ``meta``: each wrapper counts its calls (it cannot launch
    there) and computes its plain version; ``ddim x20`` is twenty steps of
    ``ctrl+unet step`` by construction, so the loop runs at 2 steps here."""
    s = C.meta_setup(1)
    calls = {kern: 0 for kern in KN.KERNELS}

    def counting(kern):
        def forward(*xs):
            calls[kern] += 1
            return kern.plain(*xs)
        return forward

    want = C.expected_launches()
    for kern in KN.KERNELS:
        kern.forward = counting(kern)
    try:
        with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(C, "STEPS", 2)
            for name, fn in C.components(s).items():
                for kern in calls:
                    calls[kern] = 0
                fn()
                got = tuple(calls[kern] for kern in KN.KERNELS)
                expect = want[name]
                if name == "ddim x20":
                    expect = tuple(n // 10 for n in expect)
                assert got == expect, name
    finally:
        for kern in KN.KERNELS:
            del kern.forward
    fused = C.expected_launches(fused=True)
    assert fused["ddim x20"] == (0, 140, 0, 280, 0)


# ---------------------------------------------------------------------------
# no card, no measurement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["components", "shapes", "conv_chains", "train_memory"])
def test_a_tool_that_measures_the_card_refuses_the_cpu(tool, monkeypatch):
    from unirestore_torch.diagnostics import __main__ as DM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DM.main([tool])
    with pytest.raises(ValueError, match="CUDA device"):
        TM.card("cpu")


def test_train_memory_config_is_the_tools():
    cfg = TMEM.model_config()
    assert (cfg.use_tfa, cfg.tasks, cfg.unet.remat) == (False, ("ir",), True)
    assert not TMEM.model_config(remat=False).unet.remat
    assert TMEM.parse_args(["--no-remat"]).remat is False
