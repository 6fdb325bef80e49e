"""Diffusers sd-turbo checkpoint -> ``sd_turbo_vae.npz`` and ``sd_turbo_unet.npz``
(the port of ``tools/convert_sd_turbo.py``, without JAX or ``safetensors``).

    python -m unirestore_torch.convert sd_turbo /path/to/sd-turbo ./weights

Maps the diffusers state dicts (``vae/`` and
``unet/diffusion_pytorch_model.safetensors``, else ``.bin``) onto the flat
``//``-keyed trees in the JAX layout that both packages read
(``zoo.load_frozen_backbone``): conv OIHW -> HWIO, linear (out, in) -> (in,
out). The reference model is ``AutoencoderKL`` / ``UNet2DConditionModel``
``.from_pretrained("stabilityai/sd-turbo")``.
"""

from __future__ import annotations

import os

from .common import SEP, load_state_dict, put_conv, put_lin, put_norm, save


def _put_resnet(out, ours, theirs, sd):
    put_norm(out, f"{ours}{SEP}norm1", f"{theirs}.norm1", sd)
    put_conv(out, f"{ours}{SEP}conv1", f"{theirs}.conv1", sd)
    put_norm(out, f"{ours}{SEP}norm2", f"{theirs}.norm2", sd)
    put_conv(out, f"{ours}{SEP}conv2", f"{theirs}.conv2", sd)
    if f"{theirs}.time_emb_proj.weight" in sd:
        put_lin(out, f"{ours}{SEP}time_emb_proj", f"{theirs}.time_emb_proj", sd)
    if f"{theirs}.conv_shortcut.weight" in sd:
        put_conv(out, f"{ours}{SEP}conv_shortcut", f"{theirs}.conv_shortcut", sd)


def _put_vae_attn(out, ours, theirs, sd):
    put_norm(out, f"{ours}{SEP}group_norm", f"{theirs}.group_norm", sd)
    for q in ("to_q", "to_k", "to_v"):
        put_lin(out, f"{ours}{SEP}attn{SEP}{q}", f"{theirs}.{q}", sd)
    put_lin(out, f"{ours}{SEP}attn{SEP}to_out", f"{theirs}.to_out.0", sd)


def convert_vae(sd: dict) -> dict:
    out = {}
    put_conv(out, f"encoder{SEP}conv_in", "encoder.conv_in", sd)
    for i in range(4):
        base = f"encoder.down_blocks.{i}"
        for j in range(2):
            _put_resnet(out, f"encoder{SEP}down_blocks{SEP}{i}{SEP}resnets{SEP}{j}",
                        f"{base}.resnets.{j}", sd)
        if f"{base}.downsamplers.0.conv.weight" in sd:
            put_conv(out, f"encoder{SEP}down_blocks{SEP}{i}{SEP}downsample{SEP}conv",
                     f"{base}.downsamplers.0.conv", sd)
    _put_resnet(out, f"encoder{SEP}mid{SEP}resnet1", "encoder.mid_block.resnets.0", sd)
    _put_vae_attn(out, f"encoder{SEP}mid{SEP}attn", "encoder.mid_block.attentions.0", sd)
    _put_resnet(out, f"encoder{SEP}mid{SEP}resnet2", "encoder.mid_block.resnets.1", sd)
    put_norm(out, f"encoder{SEP}conv_norm_out", "encoder.conv_norm_out", sd)
    put_conv(out, f"encoder{SEP}conv_out", "encoder.conv_out", sd)
    put_conv(out, "quant_conv", "quant_conv", sd)
    put_conv(out, "post_quant_conv", "post_quant_conv", sd)
    put_conv(out, f"decoder{SEP}conv_in", "decoder.conv_in", sd)
    _put_resnet(out, f"decoder{SEP}mid{SEP}resnet1", "decoder.mid_block.resnets.0", sd)
    _put_vae_attn(out, f"decoder{SEP}mid{SEP}attn", "decoder.mid_block.attentions.0", sd)
    _put_resnet(out, f"decoder{SEP}mid{SEP}resnet2", "decoder.mid_block.resnets.1", sd)
    for i in range(4):
        base = f"decoder.up_blocks.{i}"
        for j in range(3):
            _put_resnet(out, f"decoder{SEP}up_blocks{SEP}{i}{SEP}resnets{SEP}{j}",
                        f"{base}.resnets.{j}", sd)
        if f"{base}.upsamplers.0.conv.weight" in sd:
            put_conv(out, f"decoder{SEP}up_blocks{SEP}{i}{SEP}upsample{SEP}conv",
                     f"{base}.upsamplers.0.conv", sd)
    put_norm(out, f"decoder{SEP}conv_norm_out", "decoder.conv_norm_out", sd)
    put_conv(out, f"decoder{SEP}conv_out", "decoder.conv_out", sd)
    return out


def _put_tblock(out, ours, theirs, sd):
    """Transformer2DModel with use_linear_projection=True."""
    put_norm(out, f"{ours}{SEP}norm", f"{theirs}.norm", sd)
    put_lin(out, f"{ours}{SEP}proj_in", f"{theirs}.proj_in", sd)
    tb = f"{theirs}.transformer_blocks.0"
    o = f"{ours}{SEP}blocks{SEP}0"
    for n in ("norm1", "norm2", "norm3"):
        put_norm(out, f"{o}{SEP}{n}", f"{tb}.{n}", sd)
    for attn in ("attn1", "attn2"):
        for q in ("to_q", "to_k", "to_v"):
            put_lin(out, f"{o}{SEP}{attn}{SEP}{q}", f"{tb}.{attn}.{q}", sd)
        put_lin(out, f"{o}{SEP}{attn}{SEP}to_out", f"{tb}.{attn}.to_out.0", sd)
    put_lin(out, f"{o}{SEP}ff_in", f"{tb}.ff.net.0.proj", sd)
    put_lin(out, f"{o}{SEP}ff_out", f"{tb}.ff.net.2", sd)
    put_lin(out, f"{ours}{SEP}proj_out", f"{theirs}.proj_out", sd)


def convert_unet(sd: dict) -> dict:
    out = {}
    put_conv(out, "conv_in", "conv_in", sd)
    put_lin(out, f"time_embedding{SEP}linear_1", "time_embedding.linear_1", sd)
    put_lin(out, f"time_embedding{SEP}linear_2", "time_embedding.linear_2", sd)
    for i in range(4):
        base, ours = f"down_blocks.{i}", f"down_blocks{SEP}{i}"
        for j in range(2):
            _put_resnet(out, f"{ours}{SEP}resnets{SEP}{j}", f"{base}.resnets.{j}", sd)
            if f"{base}.attentions.{j}.proj_in.weight" in sd:
                _put_tblock(out, f"{ours}{SEP}attentions{SEP}{j}", f"{base}.attentions.{j}", sd)
        if f"{base}.downsamplers.0.conv.weight" in sd:
            put_conv(out, f"{ours}{SEP}downsample{SEP}conv", f"{base}.downsamplers.0.conv", sd)
    _put_resnet(out, f"mid{SEP}resnet1", "mid_block.resnets.0", sd)
    _put_tblock(out, f"mid{SEP}attn", "mid_block.attentions.0", sd)
    _put_resnet(out, f"mid{SEP}resnet2", "mid_block.resnets.1", sd)
    for i in range(4):
        base, ours = f"up_blocks.{i}", f"up_blocks{SEP}{i}"
        for j in range(3):
            _put_resnet(out, f"{ours}{SEP}resnets{SEP}{j}", f"{base}.resnets.{j}", sd)
            if f"{base}.attentions.{j}.proj_in.weight" in sd:
                _put_tblock(out, f"{ours}{SEP}attentions{SEP}{j}", f"{base}.attentions.{j}", sd)
        if f"{base}.upsamplers.0.conv.weight" in sd:
            put_conv(out, f"{ours}{SEP}upsample{SEP}conv", f"{base}.upsamplers.0.conv", sd)
    put_norm(out, "conv_norm_out", "conv_norm_out", sd)
    put_conv(out, "conv_out", "conv_out", sd)
    return out


def main(src: str, dst: str = "./weights") -> None:
    """Convert ``<src>/vae`` and ``<src>/unet`` into ``<dst>``."""
    os.makedirs(dst, exist_ok=True)
    for sub, convert, name in (("vae", convert_vae, "sd_turbo_vae"),
                               ("unet", convert_unet, "sd_turbo_unet")):
        for fname in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"):
            path = os.path.join(src, sub, fname)
            if os.path.exists(path):
                save(os.path.join(dst, f"{name}.npz"), convert(load_state_dict(path)))
                break
        else:
            print(f"!! {sub} checkpoint not found under {src}")
