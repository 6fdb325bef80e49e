"""Classification probe checkpoints -> flat npz trees (the port of
``tools/convert_classifiers.py``): every probe of the reference's eval_mode
sets (eval_classification.py:36-48, 209-270), which ``tasks/classifier_zoo.py``
loads by file name.

    python -m unirestore_torch.convert classifiers vgg16 vgg16-397923af.pth
    python -m unirestore_torch.convert classifiers vit_b16_timm timm_vit.pth cub_vit_b16
    python -m unirestore_torch.convert classifiers swin_b_timm cub_swin.pth cub_swin_base

An optional trailing argument overrides the output name (the ``*_ft``
Lightning exports and the CUB-200 fine-tunes). Outputs go to
``$UNIRESTORE_WEIGHTS`` (default ``./weights``).
"""

from __future__ import annotations

from .common import (SEP, conv_w, lin_w, load_state_dict, put_bn, put_lin, put_norm, save,
                     weights_out)
from .torchvision import convert_resnet

VGG_PLAN = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
SWIN_DEPTHS = (2, 2, 18, 2)


def convert_vgg16(sd):
    out = {}
    for s, idxs in enumerate(VGG_PLAN):
        for j, idx in enumerate(idxs):
            out[f"features{SEP}{s}{SEP}{j}{SEP}w"] = conv_w(sd[f"features.{idx}.weight"])
            out[f"features{SEP}{s}{SEP}{j}{SEP}b"] = sd[f"features.{idx}.bias"]
    for ours, theirs in (("fc1", "classifier.0"), ("fc2", "classifier.3"),
                         ("fc3", "classifier.6")):
        put_lin(out, ours, theirs, sd)
    return out


def convert_vit_b16(sd, timm: bool = False):
    out = {}
    if timm:
        out[f"patch{SEP}w"] = conv_w(sd["patch_embed.proj.weight"])
        out[f"patch{SEP}b"] = sd["patch_embed.proj.bias"]
        out["cls_token"] = sd["cls_token"]
        out["pos_embed"] = sd["pos_embed"]
        for i in range(12):
            t, o = f"blocks.{i}", f"blocks{SEP}{i}"
            put_norm(out, f"{o}{SEP}norm1", f"{t}.norm1", sd)
            put_lin(out, f"{o}{SEP}qkv", f"{t}.attn.qkv", sd)
            put_lin(out, f"{o}{SEP}proj", f"{t}.attn.proj", sd)
            put_norm(out, f"{o}{SEP}norm2", f"{t}.norm2", sd)
            put_lin(out, f"{o}{SEP}fc1", f"{t}.mlp.fc1", sd)
            put_lin(out, f"{o}{SEP}fc2", f"{t}.mlp.fc2", sd)
        put_norm(out, "norm", "norm", sd)
        put_lin(out, "head", "head", sd)
        return out
    out[f"patch{SEP}w"] = conv_w(sd["conv_proj.weight"])
    out[f"patch{SEP}b"] = sd["conv_proj.bias"]
    out["cls_token"] = sd["class_token"]
    out["pos_embed"] = sd["encoder.pos_embedding"]
    for i in range(12):
        t, o = f"encoder.layers.encoder_layer_{i}", f"blocks{SEP}{i}"
        put_norm(out, f"{o}{SEP}norm1", f"{t}.ln_1", sd)
        out[f"{o}{SEP}qkv{SEP}w"] = lin_w(sd[f"{t}.self_attention.in_proj_weight"])
        out[f"{o}{SEP}qkv{SEP}b"] = sd[f"{t}.self_attention.in_proj_bias"]
        put_lin(out, f"{o}{SEP}proj", f"{t}.self_attention.out_proj", sd)
        put_norm(out, f"{o}{SEP}norm2", f"{t}.ln_2", sd)
        put_lin(out, f"{o}{SEP}fc1", f"{t}.mlp.0", sd)
        put_lin(out, f"{o}{SEP}fc2", f"{t}.mlp.3", sd)
    put_norm(out, "norm", "encoder.ln", sd)
    put_lin(out, "head", "heads.head", sd)
    return out


def convert_swin_v2_b(sd):
    """torchvision swin_v2_b layout (features.{0,1,2,...})."""
    out = {}
    out[f"patch{SEP}w"] = conv_w(sd["features.0.0.weight"])
    out[f"patch{SEP}b"] = sd["features.0.0.bias"]
    put_norm(out, "patch_norm", "features.0.2", sd)
    for s, depth in enumerate(SWIN_DEPTHS):
        feat = 1 + 2 * s  # stages at features indices 1, 3, 5, 7
        if s > 0:
            m = f"features.{feat - 1}"
            put_lin(out, f"merge{SEP}{s - 1}{SEP}reduction", f"{m}.reduction", sd, bias=False)
            put_norm(out, f"merge{SEP}{s - 1}{SEP}norm", f"{m}.norm", sd)
        for j in range(depth):
            t, o = f"features.{feat}.{j}", f"stages{SEP}{s}{SEP}{j}"
            put_norm(out, f"{o}{SEP}norm1", f"{t}.norm1", sd)
            put_norm(out, f"{o}{SEP}norm2", f"{t}.norm2", sd)
            put_lin(out, f"{o}{SEP}qkv", f"{t}.attn.qkv", sd)
            put_lin(out, f"{o}{SEP}proj", f"{t}.attn.proj", sd)
            out[f"{o}{SEP}logit_scale"] = sd[f"{t}.attn.logit_scale"]
            put_lin(out, f"{o}{SEP}cpb_fc1", f"{t}.attn.cpb_mlp.0", sd)
            put_lin(out, f"{o}{SEP}cpb_fc2", f"{t}.attn.cpb_mlp.2", sd, bias=False)
            put_lin(out, f"{o}{SEP}fc1", f"{t}.mlp.0", sd)
            put_lin(out, f"{o}{SEP}fc2", f"{t}.mlp.3", sd)
    put_norm(out, "norm", "norm", sd)
    put_lin(out, "head", "head", sd)
    return out


def convert_swin_b_v1_timm(sd):
    """timm swin_base_patch4_window7_224 layout (layers.{i})."""
    out = {}
    out[f"patch{SEP}w"] = conv_w(sd["patch_embed.proj.weight"])
    out[f"patch{SEP}b"] = sd["patch_embed.proj.bias"]
    put_norm(out, "patch_norm", "patch_embed.norm", sd)
    for s, depth in enumerate(SWIN_DEPTHS):
        # timm puts the downsample at the END of stage s; ours precedes s + 1
        if s > 0:
            m = f"layers.{s - 1}.downsample"
            put_lin(out, f"merge{SEP}{s - 1}{SEP}reduction", f"{m}.reduction", sd, bias=False)
            put_norm(out, f"merge{SEP}{s - 1}{SEP}norm", f"{m}.norm", sd)
        for j in range(depth):
            t, o = f"layers.{s}.blocks.{j}", f"stages{SEP}{s}{SEP}{j}"
            put_norm(out, f"{o}{SEP}norm1", f"{t}.norm1", sd)
            put_norm(out, f"{o}{SEP}norm2", f"{t}.norm2", sd)
            put_lin(out, f"{o}{SEP}qkv", f"{t}.attn.qkv", sd)
            put_lin(out, f"{o}{SEP}proj", f"{t}.attn.proj", sd)
            out[f"{o}{SEP}rel_bias"] = sd[f"{t}.attn.relative_position_bias_table"]
            put_lin(out, f"{o}{SEP}fc1", f"{t}.mlp.fc1", sd)
            put_lin(out, f"{o}{SEP}fc2", f"{t}.mlp.fc2", sd)
    put_norm(out, "norm", "norm", sd)
    put_lin(out, "head", "head", sd)
    return out


def convert_convnext_base(sd):
    """timm convnext_base layout."""
    out = {}
    out[f"stem{SEP}w"] = conv_w(sd["stem.0.weight"])
    out[f"stem{SEP}b"] = sd["stem.0.bias"]
    put_norm(out, "stem_norm", "stem.1", sd)
    for s, depth in enumerate((3, 3, 27, 3)):
        if s > 0:
            put_norm(out, f"downsample{SEP}{s - 1}{SEP}norm", f"stages.{s}.downsample.0", sd)
            out[f"downsample{SEP}{s - 1}{SEP}conv{SEP}w"] = conv_w(
                sd[f"stages.{s}.downsample.1.weight"])
            out[f"downsample{SEP}{s - 1}{SEP}conv{SEP}b"] = sd[f"stages.{s}.downsample.1.bias"]
        for j in range(depth):
            t, o = f"stages.{s}.blocks.{j}", f"stages{SEP}{s}{SEP}{j}"
            out[f"{o}{SEP}dwconv{SEP}w"] = conv_w(sd[f"{t}.conv_dw.weight"])
            out[f"{o}{SEP}dwconv{SEP}b"] = sd[f"{t}.conv_dw.bias"]
            put_norm(out, f"{o}{SEP}norm", f"{t}.norm", sd)
            put_lin(out, f"{o}{SEP}fc1", f"{t}.mlp.fc1", sd)
            put_lin(out, f"{o}{SEP}fc2", f"{t}.mlp.fc2", sd)
            out[f"{o}{SEP}gamma"] = sd[f"{t}.gamma"]
    put_norm(out, "norm", "head.norm", sd)
    put_lin(out, "head", "head.fc", sd)
    return out


def convert_efficientnet_v2_l(sd):
    out = {}
    plan = ((True, 1, 4), (True, 4, 7), (True, 4, 7), (False, 4, 10), (False, 6, 19),
            (False, 6, 25), (False, 6, 7))

    def cbn(ours, theirs):
        out[f"{ours}{SEP}conv{SEP}w"] = conv_w(sd[f"{theirs}.0.weight"])
        put_bn(out, f"{ours}{SEP}bn", f"{theirs}.1", sd)

    cbn("stem", "features.0")
    for s, (fused, expand, layers) in enumerate(plan):
        for j in range(layers):
            t, o = f"features.{s + 1}.{j}.block", f"stages{SEP}{s}{SEP}{j}"
            if fused and expand == 1:
                cbn(f"{o}{SEP}single", f"{t}.0")
            elif fused:
                cbn(f"{o}{SEP}expand", f"{t}.0")
                cbn(f"{o}{SEP}project", f"{t}.1")
            else:
                cbn(f"{o}{SEP}expand", f"{t}.0")
                cbn(f"{o}{SEP}dw", f"{t}.1")
                out[f"{o}{SEP}se_reduce{SEP}w"] = conv_w(sd[f"{t}.2.fc1.weight"])
                out[f"{o}{SEP}se_reduce{SEP}b"] = sd[f"{t}.2.fc1.bias"]
                out[f"{o}{SEP}se_expand{SEP}w"] = conv_w(sd[f"{t}.2.fc2.weight"])
                out[f"{o}{SEP}se_expand{SEP}b"] = sd[f"{t}.2.fc2.bias"]
                cbn(f"{o}{SEP}project", f"{t}.3")
    cbn("head", "features.8")
    put_lin(out, "fc", "classifier.1", sd)
    return out


def convert_rvt_base_plus(sd):
    """RVT repository checkpoint (robust_models.py PoolingTransformer)."""
    out = {}
    out[f"stem_conv1{SEP}w"] = conv_w(sd["patch_embed.proj.0.weight"])
    out[f"stem_conv1{SEP}b"] = sd["patch_embed.proj.0.bias"]
    put_bn(out, "stem_bn", "patch_embed.proj.1", sd)
    out[f"stem_conv2{SEP}w"] = conv_w(sd["patch_embed.proj.3.weight"])
    out[f"stem_conv2{SEP}b"] = sd["patch_embed.proj.3.bias"]
    for i in range(12):
        t, o = f"transformers.0.blocks.{i}", f"blocks{SEP}{i}"
        put_norm(out, f"{o}{SEP}norm1", f"{t}.norm1", sd)
        put_lin(out, f"{o}{SEP}qkv", f"{t}.attn.qkv", sd)
        put_lin(out, f"{o}{SEP}proj", f"{t}.attn.proj", sd)
        if f"{t}.attn.att_mask" in sd:
            out[f"{o}{SEP}att_mask"] = sd[f"{t}.attn.att_mask"]
        put_norm(out, f"{o}{SEP}norm2", f"{t}.norm2", sd)
        put_lin(out, f"{o}{SEP}fc1", f"{t}.mlp.fc1", sd)
        put_lin(out, f"{o}{SEP}fc2", f"{t}.mlp.fc2", sd)
    put_norm(out, "norm", "norm", sd)
    put_lin(out, "head", "head", sd)
    return out


# kind -> (converter, default output name)
CONVERTERS = {
    "resnet18": (lambda sd: convert_resnet(sd, "resnet18"), "resnet18_v1"),
    "resnet50": (lambda sd: convert_resnet(sd, "resnet50"), "resnet50_v1"),
    "resnet50_v2": (lambda sd: convert_resnet(sd, "resnet50"), "resnet50_v2"),
    "resnet101": (lambda sd: convert_resnet(sd, "resnet101"), "resnet101_v1"),
    "vgg16": (convert_vgg16, "vgg16"),
    "vit_b16": (convert_vit_b16, "vit_b16"),
    "vit_b16_timm": (lambda sd: convert_vit_b16(sd, timm=True), "vit_b16"),
    "swin_v2_b": (convert_swin_v2_b, "swin_v2_b"),
    "swin_b_timm": (convert_swin_b_v1_timm, "cub_swin_base"),
    "convnext_base": (convert_convnext_base, "cub_convnext_base"),
    "efficientnet_v2_l": (convert_efficientnet_v2_l, "efficientnet_v2_l"),
    "rvt_base_plus": (convert_rvt_base_plus, "rvt_base_plus"),
}


def main(argv: list) -> None:
    """``<kind> <checkpoint> [<output name>]``, as the tool takes them."""
    kind = argv[0]
    if kind not in CONVERTERS:
        raise SystemExit(f"unknown kind {kind}; one of {list(CONVERTERS)}")
    fn, name = CONVERTERS[kind]
    if len(argv) > 2:
        name = argv[2]
    sd = load_state_dict(argv[1])
    # RVT checkpoints nest under "model"; Lightning exports under "state_dict"
    if "model" in sd and kind == "rvt_base_plus":
        sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    save(weights_out(name), fn(sd))
