"""Controlled SD UNet, the denoiser (mirrors ``unirestore_tpu/models/unet.py``).

sd-turbo UNet (SD 2.1 architecture): block_out_channels (320, 640, 1280,
1280), CrossAttnDownBlock2D x3 + DownBlock2D, heads (5, 10, 20, 20),
cross-attention dim 1024, linear transformer projections, GroupNorm(32,
eps=1e-5). The Controller's per-scale maps steer it by the control type:
``scedit`` passes the 12 skip tensors of the down path through SC-Tuner
adapters; ``spade`` modulates the conv2 output of each of the 22
ResnetBlock2Ds with a SPADE layer (``_resnet_maybe_spade``, JAX
``unet.py:201-218``). NHWC maps.

On a height-sharded restore (``parallel/spatial.py``) each level's work runs
where the plan puts that level (``PS.level``, level k at latent / 2^k, the
Controller's too): split, or whole on every rank from the first level whose
rows the ranks cannot split; the downsampler into that level runs on the
gathered map (``PS.descend``) and the upsampler out of it keeps this rank's
rows (``PS.ascend``). The SC-Tuner's 1x1 adapters read one pixel and take
either layout.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn import embeddings as E
from ..nn import layers as L
from ..nn import remat as RM
from ..nn import resnet as R
from ..nn import transformer as T
from ..parallel import spatial as PS
from . import scedit as SC
from . import spade as SP


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    # True for CrossAttnDownBlock2D (and the mirrored up block)
    cross_attention: tuple = (True, True, True, False)
    heads: tuple = (5, 10, 20, 20)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    eps: float = 1e-5
    control_type: str = "scedit"  # "scedit" | "spade" | "none"
    control_channels: int = 256
    # rematerialise each (resnet, attention) unit and the mid block in the
    # backward pass (JAX ``UNetConfig.remat``); the train step turns it on
    remat: bool = False

    @property
    def time_embed_dim(self):
        return self.block_out_channels[0] * 4

    def skip_channels(self):
        """Channels of down_block_res_samples, in capture order."""
        chans = [self.block_out_channels[0]]  # conv_in output
        for i, c in enumerate(self.block_out_channels):
            chans += [c] * self.layers_per_block
            if i < len(self.block_out_channels) - 1:
                chans.append(c)  # downsample output
        return chans

    def skip_scale_indices(self):
        """Control-scale index (0 = full latent res) per skip tensor."""
        idxs = [0]
        for i in range(len(self.block_out_channels)):
            idxs += [i] * self.layers_per_block
            if i < len(self.block_out_channels) - 1:
                idxs.append(i + 1)
        return idxs


def tiny_unet_config(control_type: str = "scedit"):
    return UNetConfig(block_out_channels=(32, 64, 64, 64), heads=(2, 2, 2, 2),
                      cross_attention_dim=64, control_type=control_type,
                      control_channels=32)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def unet_init(ini, cfg: UNetConfig):
    chans = cfg.block_out_channels
    temb = cfg.time_embed_dim
    p = {
        "conv_in": L.conv2d_init(ini, cfg.in_channels, chans[0], 3),
        "time_embedding": E.timestep_mlp_init(ini, chans[0], temb),
    }

    def attn(c, i):
        return T.transformer_2d_init(ini, c, cfg.heads[i], cfg.cross_attention_dim)

    down = []
    cin = chans[0]
    for i, cout in enumerate(chans):
        blk = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            blk["resnets"].append(R.resnet_block_init(ini, cin if j == 0 else cout, cout, temb))
            if cfg.cross_attention[i]:
                blk["attentions"].append(attn(cout, i))
        if i < len(chans) - 1:
            blk["downsample"] = R.downsample_init(ini, cout)
        down.append(blk)
        cin = cout
    p["down_blocks"] = down

    cmid = chans[-1]
    p["mid"] = {
        "resnet1": R.resnet_block_init(ini, cmid, cmid, temb),
        "attn": attn(cmid, -1),
        "resnet2": R.resnet_block_init(ini, cmid, cmid, temb),
    }

    up = []
    skip_chans = cfg.skip_channels()
    prev_out = cmid
    for i, cout in enumerate(reversed(chans)):
        blk_idx = len(chans) - 1 - i  # mirrored down block index
        blk = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            res_in = (prev_out if j == 0 else cout) + skip_chans.pop()
            blk["resnets"].append(R.resnet_block_init(ini, res_in, cout, temb))
            if cfg.cross_attention[blk_idx]:
                blk["attentions"].append(attn(cout, blk_idx))
        if i < len(chans) - 1:
            blk["upsample"] = R.upsample_init(ini, cout)
        up.append(blk)
        prev_out = cout
    p["up_blocks"] = up

    p["conv_norm_out"] = L.norm_init(ini, chans[0])
    p["conv_out"] = L.conv2d_init(ini, chans[0], cfg.out_channels, 3)
    return p


def control_adapters_init(ini, cfg: UNetConfig):
    """Trainable control-injection params for the configured mode (JAX
    ``control_adapters_init``, ``unet.py:154-175``)."""
    if cfg.control_type == "scedit":
        return {"csc_editors": SC.sc_tuner_init(ini, cfg.skip_channels(),
                                                cfg.control_channels)}
    if cfg.control_type == "spade":
        # one SPADE per ResnetBlock2D of the UNet, in traversal order
        chans = cfg.block_out_channels

        def spades(c, n):
            return [SP.spade_init(ini, c, cfg.control_channels) for _ in range(n)]

        return {"spades": {
            "down": [spades(c, cfg.layers_per_block) for c in chans],
            "mid": spades(chans[-1], 2),
            "up": [spades(c, cfg.layers_per_block + 1) for c in reversed(chans)],
        }}
    return {}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _resnet_maybe_spade(p_res, x, temb, cfg, spade_p, control, scale_idx):
    """ResnetBlock2D, with SPADE on the conv2 output before the shortcut add
    when ``spade_p`` is given (JAX ``_resnet_maybe_spade``)."""
    modulate = None if spade_p is None else (
        lambda h: SP.spade(spade_p, h, control[scale_idx]))
    return R.resnet_block(p_res, x, temb, groups=cfg.norm_num_groups, eps=cfg.eps,
                          modulate=modulate)


def _unit_body(cfg, scale_idx, res_p, attn_p, h, temb, encoder_hidden_states, control=None,
               spade_p=None):
    h = _resnet_maybe_spade(res_p, h, temb, cfg, spade_p, control, scale_idx)
    if attn_p is not None:
        h = T.transformer_2d(attn_p, h, encoder_hidden_states,
                             heads=cfg.heads[scale_idx], groups=cfg.norm_num_groups)
    return h


def _unit(cfg, scale_idx, res_p, attn_p, h, temb, encoder_hidden_states, control=None,
          spade_p=None):
    """One (ResnetBlock2D, Transformer2D) unit; ``attn_p`` may be None, and
    ``spade_p`` is the unit's SPADE under the ``spade`` control type.

    Rematerialised in the backward pass when ``cfg.remat``.
    """
    args = (cfg, scale_idx, res_p, attn_p, h, temb, encoder_hidden_states, control, spade_p)
    return RM.checkpoint(_unit_body, *args) if cfg.remat else _unit_body(*args)


def _mid(cfg, mid, h, emb, encoder_hidden_states, control=None, sp1=None, sp2=None):
    deepest = len(cfg.block_out_channels) - 1
    h = _unit_body(cfg, deepest, mid["resnet1"], mid["attn"], h, emb, encoder_hidden_states,
                   control, sp1)
    return _resnet_maybe_spade(mid["resnet2"], h, emb, cfg, sp2, control, deepest)


def _use_scedit(control, control_params):
    return (control is not None and control_params is not None
            and "csc_editors" in control_params)


def _spades(control, control_params):
    """The SPADE tree under the ``spade`` control type, else None."""
    if control is not None and control_params is not None and "spades" in control_params:
        return control_params["spades"]
    return None


def unet_time_embedding(p, cfg: UNetConfig, timesteps, dtype):
    temb = E.sinusoidal_timestep_embedding(timesteps, cfg.block_out_channels[0])
    return E.timestep_mlp(p["time_embedding"], temb.to(dtype))


def unet_encode(p, cfg: UNetConfig, sample, emb, encoder_hidden_states,
                control=None, control_params=None):
    """Down path + mid (SPADE in each resnet under ``spade``) + SC-Tuner skip
    injection under ``scedit``. Returns (h_mid, skips)."""
    spades = _spades(control, control_params)
    with PS.level(0, latent=True):
        h = L.conv2d(p["conv_in"], sample, padding=1)
    skips = [h]
    for i, blk in enumerate(p["down_blocks"]):
        with PS.level(i, latent=True):
            for j, res in enumerate(blk["resnets"]):
                attn = blk["attentions"][j] if blk["attentions"] else None
                sp = spades["down"][i][j] if spades else None
                h = _unit(cfg, i, res, attn, h, emb, encoder_hidden_states, control, sp)
                skips.append(h)
        if "downsample" in blk:
            h = PS.descend(lambda x: R.downsample(blk["downsample"], x), h, i + 1, latent=True)
            skips.append(h)

    sp1, sp2 = spades["mid"] if spades else (None, None)
    args = (cfg, p["mid"], h, emb, encoder_hidden_states, control, sp1, sp2)
    with PS.level(len(cfg.block_out_channels) - 1, latent=True):
        h = RM.checkpoint(_mid, *args) if cfg.remat else _mid(*args)

    if _use_scedit(control, control_params):
        skips = [SC.csce_adapter(ed, s, control[si])
                 for ed, s, si in zip(control_params["csc_editors"], skips,
                                      cfg.skip_scale_indices())]
    return h, skips


def _head(p, cfg, h):
    h = L.silu(L.group_norm(p["conv_norm_out"], h, groups=cfg.norm_num_groups, eps=cfg.eps))
    return L.conv2d(p["conv_out"], h, padding=1)


def unet_decode(p, cfg: UNetConfig, h, skips, emb, encoder_hidden_states,
                control=None, control_params=None, return_deep: bool = False):
    """Up path + head; ``skips`` is not mutated.

    With ``return_deep=True`` also returns the input of the shallowest up
    block (after the previous block's upsample), the feature the ``deep``
    cache mode keeps.
    """
    spades = _spades(control, control_params)
    skips = list(skips)
    n_levels = len(cfg.block_out_channels)
    deep = None
    for i, blk in enumerate(p["up_blocks"]):
        lvl = n_levels - 1 - i
        if i == len(p["up_blocks"]) - 1:
            deep = h
        with PS.level(lvl, latent=True):
            for j, res in enumerate(blk["resnets"]):
                h = torch.cat([h, skips.pop()], dim=-1)
                attn = blk["attentions"][j] if blk["attentions"] else None
                sp = spades["up"][i][j] if spades else None
                h = _unit(cfg, lvl, res, attn, h, emb, encoder_hidden_states, control, sp)
        if "upsample" in blk:
            h = PS.ascend(lambda x: R.upsample(blk["upsample"], x), h, lvl - 1, latent=True)
    with PS.level(0, latent=True):
        h = _head(p, cfg, h)
    return (h, deep) if return_deep else h


def unet_down_shallow(p, cfg: UNetConfig, sample, emb, encoder_hidden_states,
                      control=None, control_params=None):
    """Level-0 down path only (conv_in + the first down block's units, no
    downsample). Returns the three full-resolution skips, after SC-Tuner
    injection when configured; under ``spade`` each resnet takes its SPADE at
    scale 0."""
    spades = _spades(control, control_params)
    blk = p["down_blocks"][0]
    with PS.level(0, latent=True):
        h = L.conv2d(p["conv_in"], sample, padding=1)
        skips = [h]
        for j, res in enumerate(blk["resnets"]):
            attn = blk["attentions"][j] if blk["attentions"] else None
            sp = spades["down"][0][j] if spades else None
            h = _unit(cfg, 0, res, attn, h, emb, encoder_hidden_states, control, sp)
            skips.append(h)
    if _use_scedit(control, control_params):
        # the first len(skips) editors are the level-0 ones
        skips = [SC.csce_adapter(ed, s, control[0])
                 for ed, s in zip(control_params["csc_editors"], skips)]
    return skips


def unet_up_shallow(p, cfg: UNetConfig, deep, skips0, emb,
                    encoder_hidden_states, control=None, control_params=None):
    """Shallowest up block + head, fed by the cached deep feature and the
    level-0 skips from ``unet_down_shallow`` (SPADE at scale 0 under ``spade``)."""
    spades = _spades(control, control_params)
    skips = list(skips0)
    blk = p["up_blocks"][-1]
    h = deep
    with PS.level(0, latent=True):
        for j, res in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            attn = blk["attentions"][j] if blk["attentions"] else None
            sp = spades["up"][-1][j] if spades else None
            h = _unit(cfg, 0, res, attn, h, emb, encoder_hidden_states, control, sp)
        return _head(p, cfg, h)


def unet_apply(p, cfg: UNetConfig, sample, timesteps, encoder_hidden_states,
               control=None, control_params=None):
    """Full controlled UNet forward.

    sample (B, h, w, 4) NHWC; timesteps (B,) int; encoder_hidden_states
    (B, 77, 1024); control: per-scale maps from the Controller, or None.
    """
    emb = unet_time_embedding(p, cfg, timesteps, sample.dtype)
    h, skips = unet_encode(p, cfg, sample, emb, encoder_hidden_states,
                           control, control_params)
    return unet_decode(p, cfg, h, skips, emb, encoder_hidden_states,
                       control, control_params)
