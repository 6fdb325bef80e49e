"""NR-IQA checkpoints -> flat npz trees for ``evalx/nr_suite.py`` (the port of
``tools/convert_iqa.py``). Outputs go to ``$UNIRESTORE_WEIGHTS`` (default
``./weights``).

    python -m unirestore_torch.convert iqa clipiqa <openai-clip-RN50 state dict> \\
        [text_features.npy]                                   -> clipiqa_rn50.npz
    python -m unirestore_torch.convert iqa nima <pyiqa-NIMA-koniq.pth>  -> nima_koniq.npz
    python -m unirestore_torch.convert iqa hyperiqa <koniq_pretrained.pkl> -> hyperiqa.npz
    python -m unirestore_torch.convert iqa musiq <ckpt> musiq_koniq      -> musiq_koniq.npz
    python -m unirestore_torch.convert iqa maniqa <ckpt>                 -> maniqa.npz

CLIP text features: the antonym prompt pair ("Good photo.", "Bad photo.")
embeddings (2, 1024), from a ``.npy``, or computed when the ``clip`` package
imports.

MUSIQ and MANIQA: the pyiqa checkpoints use per-port layouts, so those map
by shape and order (``map_by_shape``) onto a template and print the keys
left unmatched. The template is the port's own seeded tree
(``evalx/musiq.py:musiq_init``, ``evalx/maniqa.py:maniqa_init``) in the JAX
layout, which has the keys, key order and shapes of the JAX tool's
``tree_flatten_dict(musiq_init(PRNGKey(0), ...))``: the greedy match depends
on all three.
"""

from __future__ import annotations

import numpy as np

from .. import bridge
from ..evalx import maniqa, musiq
from ..nn.init import make_init
from .common import SEP, load_state_dict, put_bn, put_conv, put_lin, save, weights_out
from .torchvision import convert_resnet


def convert_clipiqa(sd, text_features=None):
    """OpenAI CLIP RN50 state dict (visual.* keys) -> ``evalx/clipiqa.py``'s tree."""
    v = "visual."
    out = {}
    for i in (1, 2, 3):
        put_conv(out, f"stem{i}{SEP}conv", f"{v}conv{i}", sd, bias=False)
        put_bn(out, f"stem{i}{SEP}bn", f"{v}bn{i}", sd)
    for s, n in enumerate((3, 4, 6, 3)):
        for j in range(n):
            t, o = f"{v}layer{s + 1}.{j}", f"layers{SEP}{s}{SEP}{j}"
            for c in (1, 2, 3):
                put_conv(out, f"{o}{SEP}conv{c}{SEP}conv", f"{t}.conv{c}", sd, bias=False)
                put_bn(out, f"{o}{SEP}conv{c}{SEP}bn", f"{t}.bn{c}", sd)
            if f"{t}.downsample.0.weight" in sd:
                put_conv(out, f"{o}{SEP}down{SEP}conv", f"{t}.downsample.0", sd, bias=False)
                put_bn(out, f"{o}{SEP}down{SEP}bn", f"{t}.downsample.1", sd)
    ap = f"{v}attnpool"
    out[f"attnpool{SEP}pos"] = sd[f"{ap}.positional_embedding"]
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "c_proj")):
        put_lin(out, f"attnpool{SEP}{ours}", f"{ap}.{theirs}", sd)
    if text_features is None and "text_features" in sd:
        text_features = sd["text_features"]
    if text_features is None:
        try:
            import clip
            import torch

            model, _ = clip.load("RN50", device="cpu")
            tok = clip.tokenize(["Good photo.", "Bad photo."])
            with torch.no_grad():
                text_features = model.encode_text(tok).float().numpy()
        except Exception as e:  # the clip package is optional
            raise SystemExit("pass precomputed text_features.npy (2, 1024); could not "
                             f"compute with the clip package: {e}") from e
    out["text_features"] = np.asarray(text_features, np.float32)
    return out


def convert_nima(sd):
    """timm / pyiqa inception_resnet_v2 NIMA checkpoint -> ``evalx/nima.py``'s tree."""
    p = "base_model." if any(k.startswith("base_model.") for k in sd) else ""
    out = {}

    def cbn(ours, theirs):
        put_conv(out, f"{ours}{SEP}conv", f"{p}{theirs}.conv", sd, bias=False)
        put_bn(out, f"{ours}{SEP}bn", f"{p}{theirs}.bn", sd)

    for i, t in enumerate(("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a")):
        cbn(f"stem{SEP}{i}", t)

    def branch(ours, theirs, n):
        if n == 1:
            cbn(f"{ours}{SEP}0", theirs)
        else:
            for i in range(n):
                cbn(f"{ours}{SEP}{i}", f"{theirs}.{i}")

    m = "mixed_5b"
    branch(f"{m}{SEP}b0", f"{m}.branch0", 1)
    branch(f"{m}{SEP}b1", f"{m}.branch1", 2)
    branch(f"{m}{SEP}b2", f"{m}.branch2", 3)
    cbn(f"{m}{SEP}bp{SEP}0", f"{m}.branch3.1")
    for i in range(10):
        t, o = f"repeat.{i}", f"repeat{SEP}{i}"
        branch(f"{o}{SEP}b0", f"{t}.branch0", 1)
        branch(f"{o}{SEP}b1", f"{t}.branch1", 2)
        branch(f"{o}{SEP}b2", f"{t}.branch2", 3)
        put_conv(out, f"{o}{SEP}conv", f"{p}{t}.conv2d", sd)
    m = "mixed_6a"
    branch(f"{m}{SEP}b0", f"{m}.branch0", 1)
    branch(f"{m}{SEP}b1", f"{m}.branch1", 3)
    for i in range(20):
        t, o = f"repeat_1.{i}", f"repeat_1{SEP}{i}"
        branch(f"{o}{SEP}b0", f"{t}.branch0", 1)
        branch(f"{o}{SEP}b1", f"{t}.branch1", 3)
        put_conv(out, f"{o}{SEP}conv", f"{p}{t}.conv2d", sd)
    m = "mixed_7a"
    branch(f"{m}{SEP}b0", f"{m}.branch0", 2)
    branch(f"{m}{SEP}b1", f"{m}.branch1", 2)
    branch(f"{m}{SEP}b2", f"{m}.branch2", 3)
    for i in range(9):
        t, o = f"repeat_2.{i}", f"repeat_2{SEP}{i}"
        branch(f"{o}{SEP}b0", f"{t}.branch0", 1)
        branch(f"{o}{SEP}b1", f"{t}.branch1", 3)
        put_conv(out, f"{o}{SEP}conv", f"{p}{t}.conv2d", sd)
    branch(f"block8{SEP}b0", "block8.branch0", 1)
    branch(f"block8{SEP}b1", "block8.branch1", 3)
    put_conv(out, f"block8{SEP}conv", f"{p}block8.conv2d", sd)
    cbn("conv2d_7b", "conv2d_7b")
    for head in ("classifier.2", "classifier.1", "classif", "head"):
        if f"{head}.weight" in sd:
            put_lin(out, "head", head, sd)
            break
    return out


def convert_hyperiqa(sd):
    """Official hyperIQA koniq_pretrained.pkl (HyperNet state dict) ->
    ``evalx/hyperiqa.py``'s tree."""
    out = convert_resnet(sd, "resnet50", prefix="res.", out_prefix=f"backbone{SEP}")
    # drop the (absent) classifier head key if emitted
    out.pop(f"backbone{SEP}fc{SEP}w", None)
    out.pop(f"backbone{SEP}fc{SEP}b", None)
    for i in (1, 2, 3):
        put_conv(out, f"lda{i}_conv", f"res.lda{i}_pool.0", sd)
        put_lin(out, f"lda{i}_fc", f"res.lda{i}_fc", sd)
    put_lin(out, "lda4_fc", "res.lda4_fc", sd)
    for ours, theirs in (("hconv1", "conv1.0"), ("hconv2", "conv1.2"), ("hconv3", "conv1.4")):
        put_conv(out, ours, theirs, sd)
    for i in range(1, 5):
        put_conv(out, f"fc{i}w_conv", f"fc{i}w_conv", sd)
        put_lin(out, f"fc{i}b_fc", f"fc{i}b_fc", sd)
    put_lin(out, "fc5w_fc", "fc5w_fc", sd)
    put_lin(out, "fc5b_fc", "fc5b_fc", sd)
    return out


def map_by_shape(sd, template_flat, groups):
    """Greedy order-preserving shape match within named key groups
    (``tools/convert_iqa.py:_map_by_shape``); returns (tree, unmatched keys)."""
    out = {}
    unmatched = []
    for ours_prefix, theirs_prefix, transform in groups:
        ours = [(k, v) for k, v in template_flat.items() if k.startswith(ours_prefix)]
        theirs = [(k, v) for k, v in sd.items() if k.startswith(theirs_prefix)]
        ti = 0
        for ok, ov in ours:
            hit = None
            for i in range(ti, len(theirs)):
                tv = transform(theirs[i][1])
                if tv.shape == ov.shape:
                    hit = (i, tv)
                    break
            if hit is None:
                unmatched.append(ok)
            else:
                ti = hit[0] + 1
                out[ok] = hit[1]
    return out, unmatched


def template(kind: str, name: str = "") -> dict:
    """The flat JAX-layout tree ``map_by_shape`` matches against: MUSIQ with 10
    classes for ``musiq_ava`` (else 1), or MANIQA."""
    if kind == "musiq":
        tree = musiq.musiq_init(make_init(None, "cpu", seed=0), 10 if name == "musiq_ava" else 1)
    elif kind == "maniqa":
        tree = maniqa.maniqa_init(make_init(None, "cpu", seed=0))
    else:
        raise ValueError(f"no shape template for {kind!r}")
    return bridge.flatten(bridge.to_numpy_tree(tree))


def main(argv: list) -> None:
    """``<kind> <checkpoint> [<text features .npy> | <output name>]``, as the tool takes them."""
    kind = argv[0]
    if kind == "clipiqa":
        text = np.load(argv[2]) if len(argv) > 2 else None
        out, name = convert_clipiqa(load_state_dict(argv[1]), text), "clipiqa_rn50"
    elif kind == "nima":
        out, name = convert_nima(load_state_dict(argv[1])), "nima_koniq"
    elif kind == "hyperiqa":
        out, name = convert_hyperiqa(load_state_dict(argv[1])), "hyperiqa"
    elif kind in ("musiq", "maniqa"):
        name = (argv[2] if len(argv) > 2 else "musiq_koniq") if kind == "musiq" else "maniqa"
        flat = template(kind, name)
        out, unmatched = map_by_shape(load_state_dict(argv[1]), flat, [("", "", lambda a: a)])
        if unmatched:
            print(f"WARNING: {len(unmatched)} unmatched keys (first 10): {unmatched[:10]}")
    else:
        raise SystemExit(f"unknown kind {kind}")
    save(weights_out(name), out)
