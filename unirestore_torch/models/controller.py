"""Controller: StableSR-style control encoder (mirrors ``unirestore_tpu/models/controller.py``).

Maps the degraded latent and the timestep to four 256-channel control maps
(latent res /1, /2, /4, /8). Each stage's capture is its last pre-downsample
activation; the mid-block output replaces the deepest capture. ControlNet
zero-init: every ResnetBlock2D conv2 and every attention out-projection
start at zero.

On a height-sharded restore each stage runs where the plan puts its level
(``parallel/spatial.py``), as the UNet's level of the same height does: the
capture at latent / 2^k feeds the UNet's skips at that level in the same
layout.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn import attention as A
from ..nn import embeddings as E
from ..nn import layers as L
from ..nn import resnet as R
from ..parallel import spatial as PS


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    in_channels: int = 4
    model_channels: int = 256
    out_channels: int = 256
    num_res_blocks: int = 2
    channel_mult: tuple = (1, 1, 2, 2)
    num_heads: int = 4
    # attention in the first three down stages, none in the last (stablesr)
    attn_stages: tuple = (True, True, True, False)
    norm_num_groups: int = 32
    eps: float = 1e-5

    @property
    def time_embed_dim(self):
        return self.model_channels * 4


def tiny_controller_config():
    return ControllerConfig(model_channels=32, out_channels=32, num_heads=2)


def _zero(p):
    return {k: torch.zeros_like(v) for k, v in p.items()}


def _resnet_zero(ini, cin, cout, temb):
    rp = R.resnet_block_init(ini, cin, cout, temb)
    rp["conv2"] = _zero(rp["conv2"])  # ControlNet-style zero conv
    return rp


def _attn_zero(ini, c, heads):
    ap = A.spatial_self_attention_init(ini, c, heads)
    ap["attn"]["to_out"] = _zero(ap["attn"]["to_out"])
    return ap


def controller_init(ini, cfg: ControllerConfig):
    temb = cfg.time_embed_dim
    p = {
        "time_embedding": E.timestep_mlp_init(ini, cfg.model_channels, temb),
        "conv_in": L.conv2d_init(ini, cfg.in_channels, cfg.model_channels, 3),
    }
    down = []
    stage_chans = []
    cin = cfg.model_channels
    n = len(cfg.channel_mult)
    for i, mult in enumerate(cfg.channel_mult):
        cout = cfg.model_channels * mult
        blk = {"resnets": [], "attentions": []}
        for j in range(cfg.num_res_blocks):
            blk["resnets"].append(_resnet_zero(ini, cin if j == 0 else cout, cout, temb))
            if cfg.attn_stages[i]:
                blk["attentions"].append(_attn_zero(ini, cout, cfg.num_heads))
        if i < n - 1:
            blk["downsample"] = R.downsample_init(ini, cout)
        down.append(blk)
        stage_chans.append(cout)
        cin = cout
    p["down_blocks"] = down

    cmid = stage_chans[-1]
    p["mid"] = {
        "resnet1": _resnet_zero(ini, cmid, cmid, temb),
        "attn": _attn_zero(ini, cmid, cfg.num_heads),
        "resnet2": _resnet_zero(ini, cmid, cmid, temb),
    }
    p["fea_tran"] = [_resnet_zero(ini, c, cfg.out_channels, temb) for c in stage_chans]
    return p


def controller_apply(p, cfg: ControllerConfig, x, timesteps):
    """Returns [c0, c1, c2, c3]: control maps at latent res /1, /2, /4, /8."""
    temb = E.sinusoidal_timestep_embedding(timesteps, cfg.model_channels)
    emb = E.timestep_mlp(p["time_embedding"], temb.to(x.dtype))
    kw = {"groups": cfg.norm_num_groups, "eps": cfg.eps}

    with PS.level(0, latent=True):
        h = L.conv2d(p["conv_in"], x, padding=1)
    captures = []
    for i, blk in enumerate(p["down_blocks"]):
        with PS.level(i, latent=True):
            for j, res in enumerate(blk["resnets"]):
                h = R.resnet_block(res, h, emb, **kw)
                if blk["attentions"]:
                    h = A.spatial_self_attention(blk["attentions"][j], h,
                                                 heads=cfg.num_heads, **kw)
        captures.append(h)  # pre-downsample capture
        if "downsample" in blk:
            h = PS.descend(lambda x: R.downsample(blk["downsample"], x), h, i + 1, latent=True)

    with PS.level(len(p["down_blocks"]) - 1, latent=True):
        h = R.resnet_block(p["mid"]["resnet1"], h, emb, **kw)
        h = A.spatial_self_attention(p["mid"]["attn"], h, heads=cfg.num_heads, **kw)
        h = R.resnet_block(p["mid"]["resnet2"], h, emb, **kw)
    captures[-1] = h  # mid replaces the deepest capture (controller.py:141)

    out = []
    for k, (ft, c) in enumerate(zip(p["fea_tran"], captures)):
        with PS.level(k, latent=True):
            out.append(R.resnet_block(ft, c, emb, **kw))
    return out
