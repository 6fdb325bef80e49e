"""Skip-connected SD VAE with CFRM and TFA (mirrors ``unirestore_tpu/models/vae.py``).

The encoder returns the posterior moments and three skips (after the CFRM
stages when enabled); the decoder takes the skips and a task name and routes
the task prompt through the three TFA adapters. NHWC maps throughout.

sd-turbo VAE: block_out_channels (128, 256, 512, 512), 2 res layers per
encoder block (3 per decoder block), 4 latent channels, GroupNorm(32,
eps=1e-6), single-head mid attention, scaling_factor 0.18215.

On a height-sharded restore each level's work (level k at image / 2^k, the
CFRM stage and the TFA adapter at the level of their skip) runs where the plan
puts that level (``parallel/spatial.py``): split, or whole from the first
level the ranks cannot split, entered through ``PS.descend`` and left through
``PS.ascend``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn import attention as A
from ..nn import layers as L
from ..nn import remat as RM
from ..nn import resnet as R
from ..parallel import spatial as PS
from . import cfrm as CFRM
from . import tfa as TFA


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    eps: float = 1e-6
    # CFRM stage depths (NAFBlocks before the AdaNAFV2) per skip scale
    cfrm_depths: tuple = (1, 1, 9)
    # rematerialise each resnet, CFRM block and TFA adapter in the backward
    # pass (JAX ``VAEConfig.remat``); the train step turns it on
    remat: bool = False

    @property
    def skip_channels(self):
        # post-down-block channels at the three skip scales (/2, /4, /8)
        return tuple(self.block_out_channels[:3])


def tiny_vae_config():
    """Scaled-down config for tests (same topology, 8x narrower)."""
    return VAEConfig(block_out_channels=(16, 32, 64, 64), cfrm_depths=(1, 1, 2),
                     norm_num_groups=8)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _mid_init(ini, c):
    return {
        "resnet1": R.resnet_block_init(ini, c, c),
        "attn": A.spatial_self_attention_init(ini, c, heads=1),
        "resnet2": R.resnet_block_init(ini, c, c),
    }


def encoder_init(ini, cfg: VAEConfig):
    chans = cfg.block_out_channels
    p = {"conv_in": L.conv2d_init(ini, cfg.in_channels, chans[0], 3)}
    blocks = []
    cin = chans[0]
    for i, cout in enumerate(chans):
        blk = {"resnets": [R.resnet_block_init(ini, cin if j == 0 else cout, cout)
                           for j in range(cfg.layers_per_block)]}
        if i < len(chans) - 1:
            blk["downsample"] = R.downsample_init(ini, cout)
        blocks.append(blk)
        cin = cout
    p["down_blocks"] = blocks
    p["mid"] = _mid_init(ini, chans[-1])
    p["conv_norm_out"] = L.norm_init(ini, chans[-1])
    p["conv_out"] = L.conv2d_init(ini, chans[-1], 2 * cfg.latent_channels, 3)
    return p


def decoder_init(ini, cfg: VAEConfig):
    chans = list(reversed(cfg.block_out_channels))  # e.g. (512, 512, 256, 128)
    cmid = chans[0]
    p = {
        "conv_in": L.conv2d_init(ini, cfg.latent_channels, cmid, 3),
        "mid": _mid_init(ini, cmid),
    }
    blocks = []
    cin = cmid
    for i, cout in enumerate(chans):
        blk = {"resnets": [R.resnet_block_init(ini, cin if j == 0 else cout, cout)
                           for j in range(cfg.layers_per_block + 1)]}
        if i < len(chans) - 1:
            blk["upsample"] = R.upsample_init(ini, cout)
        blocks.append(blk)
        cin = cout
    p["up_blocks"] = blocks
    p["conv_norm_out"] = L.norm_init(ini, chans[-1])
    p["conv_out"] = L.conv2d_init(ini, chans[-1], cfg.out_channels, 3)
    return p


def vae_init(ini, cfg: VAEConfig):
    """Frozen VAE backbone params (no adapters)."""
    return {
        "encoder": encoder_init(ini, cfg),
        "decoder": decoder_init(ini, cfg),
        "quant_conv": L.conv2d_init(ini, 2 * cfg.latent_channels, 2 * cfg.latent_channels, 1),
        "post_quant_conv": L.conv2d_init(ini, cfg.latent_channels, cfg.latent_channels, 1),
    }


def cfrm_adapter_init(ini, cfg: VAEConfig):
    return CFRM.cfrm_init(ini, cfg.skip_channels, cfg.cfrm_depths)


def tfa_adapter_init(ini, cfg: VAEConfig, tasks, prompt_len: int = 1):
    c_out = cfg.block_out_channels[-1]
    return {
        "task_editors": TFA.tfa_init(ini, c_out, tuple(reversed(cfg.skip_channels)),
                                     prompt_len),
        "task_prompts": TFA.task_prompts_init(ini, tasks, prompt_len, c_out),
    }


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _resnet(p, x, cfg: VAEConfig):
    return R.resnet_block(p, x, groups=cfg.norm_num_groups, eps=cfg.eps)


def _res_unit(p, x, cfg: VAEConfig):
    """A resnet block, rematerialised when ``cfg.remat`` (JAX ``_res_fn``)."""
    return RM.checkpoint(_resnet, p, x, cfg) if cfg.remat else _resnet(p, x, cfg)


def _mid_block(p, x, cfg: VAEConfig):
    x = _resnet(p["resnet1"], x, cfg)
    x = A.spatial_self_attention(p["attn"], x, heads=1, groups=cfg.norm_num_groups,
                                 eps=cfg.eps)
    return _resnet(p["resnet2"], x, cfg)


def encode_moments(p, x, cfg: VAEConfig, fr_params=None, enable_fr: bool = False):
    """Encoder forward; x in [0, 1] NHWC.

    Returns (mean, logvar, skips): posterior moments at /8 (logvar clipped to
    [-30, 20]) and the three skips (after CFRM when enabled) at /2, /4, /8.
    The latent path is detached before the last down block, as the JAX
    function stops its gradient there.
    """
    enc = p["encoder"]
    with PS.level(0):
        h = L.conv2d(enc["conv_in"], x * 2.0 - 1.0, padding=1)
    skips = []
    blocks = enc["down_blocks"]
    for i, blk in enumerate(blocks[:-1]):
        with PS.level(i):
            for res in blk["resnets"]:
                h = _res_unit(res, h, cfg)
        if "downsample" in blk:
            h = PS.descend(lambda x: R.downsample(blk["downsample"], x, pad_mode="asym"), h,
                           i + 1)
        if enable_fr:
            with PS.level(i + 1):
                h = CFRM.cfrm_stage(fr_params[i], h, remat=cfg.remat)
        skips.append(h)

    h = h.detach()
    with PS.level(len(blocks) - 1):
        for res in blocks[-1]["resnets"]:
            h = _res_unit(res, h, cfg)
        h = _mid_block(enc["mid"], h, cfg)
        h = L.silu(L.group_norm(enc["conv_norm_out"], h, groups=cfg.norm_num_groups,
                                eps=cfg.eps))
        h = L.conv2d(enc["conv_out"], h, padding=1)
        moments = L.conv2d(p["quant_conv"], h, padding=0)
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0), skips


def encode(p, x, cfg: VAEConfig, noise=None, generator=None, fr_params=None,
           enable_fr: bool = False, sample: bool = True):
    """Posterior sample (or mode) scaled by scaling_factor; returns (latents, skips).

    The posterior noise is ``noise`` when given, else a standard normal draw
    from ``generator``.
    """
    mean, logvar, skips = encode_moments(p, x, cfg, fr_params, enable_fr)
    z = mean
    if sample:
        if noise is None:
            if generator is None:
                raise ValueError("encode: pass the posterior noise or a generator")
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    return z * cfg.scaling_factor, skips


def decode(p, z, cfg: VAEConfig, skips=None, tfa_params=None, task=None,
           prompt_len: int = 1):
    """Decoder forward; returns images in [0, 1] (un-clamped).

    With ``tfa_params`` and ``task`` the task prompt threads through the TFA
    adapters before the first three up blocks.
    """
    dec = p["decoder"]
    blocks = dec["up_blocks"]
    with PS.level(len(blocks) - 1):
        h = L.conv2d(p["post_quant_conv"], z / cfg.scaling_factor, padding=0)
        h = L.conv2d(dec["conv_in"], h, padding=1)
        h = _mid_block(dec["mid"], h, cfg)

    use_tfa = tfa_params is not None and task is not None
    if use_tfa:
        prompt = tfa_params["task_prompts"][task]  # (T, D)
        cond = prompt[None].expand((h.shape[0],) + tuple(prompt.shape)).to(h.dtype)

    for i, blk in enumerate(blocks):
        lvl = len(blocks) - 1 - i
        with PS.level(lvl):
            if use_tfa and i < len(blocks) - 1:
                args = (tfa_params["task_editors"][i], h, skips[-i - 1], cond, prompt_len)
                h, cond = (RM.checkpoint(TFA.task_feature_adapter, *args) if cfg.remat
                           else TFA.task_feature_adapter(*args))
            for res in blk["resnets"]:
                h = _res_unit(res, h, cfg)
        if "upsample" in blk:
            h = PS.ascend(lambda x: R.upsample(blk["upsample"], x), h, lvl - 1)

    with PS.level(0):
        h = L.silu(L.group_norm(dec["conv_norm_out"], h, groups=cfg.norm_num_groups,
                                eps=cfg.eps))
        h = L.conv2d(dec["conv_out"], h, padding=1)
    return (h + 1.0) / 2.0
