"""torchvision / LPIPS / DeepLab / RefineNet / Faster R-CNN / Inception
checkpoints -> flat npz trees (the port of ``tools/convert_torchvision.py``).

    python -m unirestore_torch.convert torchvision resnet50 /path/resnet50-v1.pth
    python -m unirestore_torch.convert torchvision deeplabv3plus /path/dlv3p_r50.pth
    python -m unirestore_torch.convert torchvision lpips_alex /path/alexnet.pth \\
        /path/lpips_lin_alex.pth

Outputs go to ``$UNIRESTORE_WEIGHTS`` (default ``./weights``) under the
tool's names, which the critics (``tasks/__init__.py:CRITIC_WEIGHTS``), the
probe zoos, LPIPS and FID's Inception load. ResNet mapping: torchvision
names (conv1, bn1, layer{1-4}.{j}.conv{1-3}/bn{1-3}/downsample.{0,1}, fc) ->
``tasks/resnet.py``'s tree.
"""

from __future__ import annotations

import numpy as np

from .common import SEP, conv_w, load_state_dict, put_bn, save, weights_out

BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def convert_resnet(sd: dict, arch: str = "resnet50", prefix: str = "",
                   out_prefix: str = "") -> dict:
    out = {}

    def P(name):
        return f"{out_prefix}{name}" if out_prefix else name

    out[P(f"stem{SEP}conv{SEP}w")] = conv_w(sd[f"{prefix}conv1.weight"])
    put_bn(out, P(f"stem{SEP}bn"), f"{prefix}bn1", sd)
    for i, n in enumerate(BLOCKS[arch]):
        for j in range(n):
            t = f"{prefix}layer{i + 1}.{j}"
            o = P(f"layers{SEP}{i}{SEP}{j}")
            for c in (1, 2, 3) if arch != "resnet18" else (1, 2):
                out[f"{o}{SEP}conv{c}{SEP}conv{SEP}w"] = conv_w(sd[f"{t}.conv{c}.weight"])
                put_bn(out, f"{o}{SEP}conv{c}{SEP}bn", f"{t}.bn{c}", sd)
            if f"{t}.downsample.0.weight" in sd:
                out[f"{o}{SEP}downsample{SEP}conv{SEP}w"] = conv_w(sd[f"{t}.downsample.0.weight"])
                put_bn(out, f"{o}{SEP}downsample{SEP}bn", f"{t}.downsample.1", sd)
    if f"{prefix}fc.weight" in sd:
        out[P(f"fc{SEP}w")] = np.transpose(sd[f"{prefix}fc.weight"], (1, 0))
        out[P(f"fc{SEP}b")] = sd[f"{prefix}fc.bias"]
    return out


def convert_lpips(alexnet_path: str, lin_path: str) -> dict:
    sd = load_state_dict(alexnet_path)
    out = {}
    # torchvision alexnet features indices 0, 3, 6, 8, 10
    for i, idx in enumerate((0, 3, 6, 8, 10)):
        out[f"convs{SEP}{i}{SEP}w"] = conv_w(sd[f"features.{idx}.weight"])
        out[f"convs{SEP}{i}{SEP}b"] = sd[f"features.{idx}.bias"]
    lin = load_state_dict(lin_path)
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        if key in lin:
            out[f"lins{SEP}{i}{SEP}w"] = conv_w(lin[key])
    return out


def convert_deeplab(sd: dict) -> dict:
    """Reference DeepLabV3+ checkpoints: backbone.* + classifier.* modules."""
    out = convert_resnet(sd, "resnet50", prefix="backbone.", out_prefix=f"backbone{SEP}")

    def cb(ours, theirs):
        out[f"{ours}{SEP}conv{SEP}w"] = conv_w(sd[f"{theirs}.0.weight"])
        put_bn(out, f"{ours}{SEP}bn", f"{theirs}.1", sd)

    # reference classifier: ASPP (0 = 1x1, 1-3 atrous, 4 pool) + project
    cb(f"aspp{SEP}conv1x1", "classifier.aspp.convs.0")
    for i in range(3):
        cb(f"aspp{SEP}atrous{SEP}{i}", f"classifier.aspp.convs.{i + 1}")
    cb(f"aspp{SEP}pool", "classifier.aspp.convs.4.1")
    cb(f"aspp{SEP}project", "classifier.aspp.project")
    cb("low_proj", "classifier.project")
    cb("decoder", "classifier.classifier.0")
    out[f"classifier{SEP}w"] = conv_w(sd["classifier.classifier.3.weight"])
    out[f"classifier{SEP}b"] = sd["classifier.classifier.3.bias"]
    return out


def convert_refinenet(sd: dict) -> dict:
    """RefineNet-LW-101 checkpoints (refinenetlw.py:153-222 naming) ->
    ``tasks/refinenet.py``'s tree; the Cityscapes, FIFO and ft exports."""
    out = convert_resnet(sd, "resnet101", out_prefix=f"backbone{SEP}")
    out.pop(f"backbone{SEP}fc{SEP}w", None)
    out.pop(f"backbone{SEP}fc{SEP}b", None)

    def c1(ours, theirs):
        out[f"{ours}{SEP}w"] = conv_w(sd[f"{theirs}.weight"])

    for lvl, i in {"c5": 1, "c4": 2, "c3": 3, "c2": 4}.items():
        c1(f"dimred{SEP}{lvl}", f"p_ims1d2_outl{i}_dimred")
        for s in range(4):
            c1(f"crp{SEP}{lvl}{SEP}{s}", f"mflow_conv_g{i}_pool.{s + 1}_outvar_dimred")
        if lvl != "c2":
            c1(f"fuse{SEP}{lvl}", f"mflow_conv_g{i}_b3_joint_varout_dimred")
        if lvl != "c5":
            c1(f"adapt{SEP}{lvl}", f"adapt_stage{i}_b2_joint_varout_dimred")
    out[f"clf{SEP}w"] = conv_w(sd["clf_conv.weight"])
    if "clf_conv.bias" in sd:
        out[f"clf{SEP}b"] = sd["clf_conv.bias"]
    return out


def convert_fasterrcnn(sd: dict) -> dict:
    """torchvision fasterrcnn_resnet50_fpn_v2 -> ``tasks/fasterrcnn.py``'s tree."""
    out = convert_resnet(sd, "resnet50", prefix="backbone.body.", out_prefix=f"backbone{SEP}")
    out.pop(f"backbone{SEP}fc{SEP}w", None)
    out.pop(f"backbone{SEP}fc{SEP}b", None)

    def cv(ours, theirs):
        out[f"{ours}{SEP}w"] = conv_w(sd[f"{theirs}.weight"])
        if f"{theirs}.bias" in sd:
            out[f"{ours}{SEP}b"] = sd[f"{theirs}.bias"]

    def lin(ours, theirs):
        out[f"{ours}{SEP}w"] = np.transpose(sd[f"{theirs}.weight"], (1, 0))
        out[f"{ours}{SEP}b"] = sd[f"{theirs}.bias"]

    for i, lvl in enumerate((2, 3, 4, 5)):
        cv(f"lateral{SEP}c{lvl}", f"backbone.fpn.inner_blocks.{i}.0")
        cv(f"smooth{SEP}p{lvl}", f"backbone.fpn.layer_blocks.{i}.0")
    for i in range(2):
        cv(f"rpn{SEP}convs{SEP}{i}", f"rpn.head.conv.{i}.0")
    cv(f"rpn{SEP}cls", "rpn.head.cls_logits")
    cv(f"rpn{SEP}box", "rpn.head.bbox_pred")
    for i in range(4):
        # FastRCNNConvFCHead: Conv2dNormActivation x 4, Flatten, Linear
        t = f"roi_heads.box_head.{i}"
        out[f"box_head{SEP}convs{SEP}{i}{SEP}conv{SEP}w"] = conv_w(sd[f"{t}.0.weight"])
        put_bn(out, f"box_head{SEP}convs{SEP}{i}{SEP}bn", f"{t}.1", sd)
    lin(f"box_head{SEP}fc", "roi_heads.box_head.5")
    lin("cls_score", "roi_heads.box_predictor.cls_score")
    lin("bbox_pred", "roi_heads.box_predictor.bbox_pred")
    return out


def convert_inception(sd: dict) -> dict:
    """torchvision inception_v3 -> ``evalx/inception.py``'s tree (FID features)."""
    out = {}

    def cbn(ours, theirs):
        out[f"{ours}{SEP}conv{SEP}w"] = conv_w(sd[f"{theirs}.conv.weight"])
        put_bn(out, f"{ours}{SEP}bn", f"{theirs}.bn", sd)

    for i, t in enumerate(("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                           "Conv2d_4a_3x3")):
        cbn(f"stem{SEP}{i}", t)
    for i, t in enumerate(("Mixed_5b", "Mixed_5c", "Mixed_5d")):
        for o, b in (("b1x1", "branch1x1"), ("b5_1", "branch5x5_1"), ("b5_2", "branch5x5_2"),
                     ("b3_1", "branch3x3dbl_1"), ("b3_2", "branch3x3dbl_2"),
                     ("b3_3", "branch3x3dbl_3"), ("bp", "branch_pool")):
            cbn(f"a{SEP}{i}{SEP}{o}", f"{t}.{b}")
    for o, b in (("b3", "branch3x3"), ("d3_1", "branch3x3dbl_1"), ("d3_2", "branch3x3dbl_2"),
                 ("d3_3", "branch3x3dbl_3")):
        cbn(f"b{SEP}{o}", f"Mixed_6a.{b}")
    for i, t in enumerate(("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e")):
        for o, b in (("b1x1", "branch1x1"), ("b7_1", "branch7x7_1"), ("b7_2", "branch7x7_2"),
                     ("b7_3", "branch7x7_3"), ("b7d_1", "branch7x7dbl_1"),
                     ("b7d_2", "branch7x7dbl_2"), ("b7d_3", "branch7x7dbl_3"),
                     ("b7d_4", "branch7x7dbl_4"), ("b7d_5", "branch7x7dbl_5"),
                     ("bp", "branch_pool")):
            cbn(f"c{SEP}{i}{SEP}{o}", f"{t}.{b}")
    for o, b in (("b3_1", "branch3x3_1"), ("b3_2", "branch3x3_2"), ("b7_1", "branch7x7x3_1"),
                 ("b7_2", "branch7x7x3_2"), ("b7_3", "branch7x7x3_3"),
                 ("b7_4", "branch7x7x3_4")):
        cbn(f"d{SEP}{o}", f"Mixed_7a.{b}")
    for i, t in enumerate(("Mixed_7b", "Mixed_7c")):
        for o, b in (("b1x1", "branch1x1"), ("b3_1", "branch3x3_1"), ("b3_2a", "branch3x3_2a"),
                     ("b3_2b", "branch3x3_2b"), ("bd_1", "branch3x3dbl_1"),
                     ("bd_2", "branch3x3dbl_2"), ("bd_3a", "branch3x3dbl_3a"),
                     ("bd_3b", "branch3x3dbl_3b"), ("bp", "branch_pool")):
            cbn(f"e{SEP}{i}{SEP}{o}", f"{t}.{b}")
    return out


def main(argv: list) -> None:
    """``<kind> <checkpoint> [<second file or output name>]``, as the tool takes them."""
    kind = argv[0]
    if kind == "inception":
        out, name = convert_inception(load_state_dict(argv[1])), "inception_v3"
    elif kind in BLOCKS:
        out, name = convert_resnet(load_state_dict(argv[1]), kind), f"{kind}_v1"
    elif kind == "deeplabv3plus":
        out, name = convert_deeplab(load_state_dict(argv[1])), "deeplabv3plus_resnet50"
    elif kind == "refinenet":
        out = convert_refinenet(load_state_dict(argv[1]))
        name = argv[2] if len(argv) > 2 else "refinenet_lw101"
    elif kind == "fasterrcnn":
        out, name = convert_fasterrcnn(load_state_dict(argv[1])), "fasterrcnn_resnet50"
    elif kind == "lpips_alex":
        out, name = convert_lpips(argv[1], argv[2]), "lpips_alex"
    else:
        raise SystemExit(f"unknown kind {kind}")
    save(weights_out(name), out)
