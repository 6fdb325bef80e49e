"""Plain PyTorch reference of the UniRestore restore: the yardstick that decides `correct`.

A frozen copy of the model's arithmetic (VAE with CFRM and TFA, the
StableSR-style Controller, the SD 2.1 UNet with SC-Tuner or SPADE control,
DDIM with trailing spacing), written from the published architecture and the
parameter layout the benchmark's weight files describe. It imports nothing of
the program and none of JAX: plain `torch` operations in float32 with TF32
off, no kernels, no graphs, no caches.

Parameters are nested dicts / lists of tensors (conv kernels OIHW, linear
kernels (in, out) applied as `x @ w`); feature maps are NHWC. Every product
(convolution, linear layer, attention's two matrix products) goes through an
`Arith`: `Arith()` computes in float32, `Fp8Arith()` rounds both operands of
every product to float8 e4m3 with one scale a tensor first, the control that
`correct` has to reject.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


class Arith:
    """float32 products."""

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()

    def conv(self, x, p, stride=1, padding=1, groups=1):
        """NHWC x OIHW -> NHWC; ``padding`` an int or ((top, bottom), (left, right))."""
        if not isinstance(padding, int):
            (top, bottom), (left, right) = padding
            x = F.pad(x, (0, 0, left, right, top, bottom))
            padding = 0
        b = p["b"].float() if "b" in p else None
        y = F.conv2d(self.operand(x).permute(0, 3, 1, 2), self.operand(p["w"]), b, stride,
                     padding, 1, groups)
        return y.permute(0, 2, 3, 1)

    def linear(self, x, p):
        y = self.operand(x) @ self.operand(p["w"])
        return y + p["b"].float() if "b" in p else y

    def matmul(self, a, b):
        return self.operand(a) @ self.operand(b)


class Fp8Arith(Arith):
    """Both operands of every product rounded to float8 e4m3 (one scale a
    tensor, amax to 448), the products then summed in float32; the backward
    pass takes the rounding as the identity (straight through)."""

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        with torch.no_grad():
            scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
            rounded = (t / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (rounded - t).detach()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def group_norm(p, x, groups, eps):
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return y if p is None else y * p["scale"].float() + p["bias"].float()


def layer_norm(p, x, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y if p is None else y * p["scale"].float() + p["bias"].float()


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def gap(x):
    return x.mean(dim=(1, 2), keepdim=True)


def attention(A: Arith, p, x, context, heads: int, record=None):
    """softmax(q kᵀ / sqrt(d)) v over ``heads`` heads; (B, T, C) tokens."""
    ctx = x if context is None else context
    b, t, _ = x.shape
    s = ctx.shape[1]
    inner = p["to_q"]["w"].shape[1]
    d = inner // heads
    if record is not None:
        record.append({"op": "attention", "b": b, "heads": heads, "t": t, "s": s, "d": d})

    def split(y, n):
        return y.reshape(b, n, heads, d).transpose(1, 2)

    q = split(A.linear(x, p["to_q"]), t)
    k = split(A.linear(ctx, p["to_k"]), s)
    v = split(A.linear(ctx, p["to_v"]), s)
    probs = torch.softmax(A.matmul(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
    o = A.matmul(probs, v).transpose(1, 2).reshape(b, t, inner)
    return A.linear(o, p["to_out"])


def spatial_self_attention(A, p, x, heads, groups, eps, record=None):
    b, h, w, c = x.shape
    y = group_norm(p["group_norm"], x, groups, eps).reshape(b, h * w, c)
    return x + attention(A, p["attn"], y, None, heads, record).reshape(b, h, w, c)


def resnet(A, p, x, groups, eps, temb=None, modulate=None):
    h = A.conv(F.silu(group_norm(p["norm1"], x, groups, eps)), p["conv1"])
    if temb is not None:
        h = h + A.linear(F.silu(temb), p["time_emb_proj"])[:, None, None, :]
    h = A.conv(F.silu(group_norm(p["norm2"], h, groups, eps)), p["conv2"])
    if modulate is not None:
        h = modulate(h)
    if "conv_shortcut" in p:
        x = A.conv(x, p["conv_shortcut"], padding=0)
    return x + h


def upsample_2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def timestep_embedding(timesteps, dim, max_period=10000.0):
    """Sinusoidal embedding, cos first (flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def time_mlp(A, p, emb):
    return A.linear(F.silu(A.linear(emb, p["linear_1"])), p["linear_2"])


# ---------------------------------------------------------------------------
# VAE with CFRM and TFA
# ---------------------------------------------------------------------------


def naf_block(A, p, x):
    h = A.conv(layer_norm(p["norm1"], x, 1e-6), p["conv1"], padding=0)
    h = A.conv(h, p["conv2"], padding=1, groups=p["conv2"]["w"].shape[0])
    h1, h2 = h.chunk(2, dim=-1)
    h = h1 * h2
    h = h * A.conv(gap(h), p["sca"], padding=0)
    y = x + A.conv(h, p["conv3"], padding=0) * p["beta"].float()
    h = A.conv(layer_norm(p["norm2"], y, 1e-6), p["conv4"], padding=0)
    h1, h2 = h.chunk(2, dim=-1)
    return y + A.conv(h1 * h2, p["conv5"], padding=0) * p["gamma"].float()


def ada_naf(A, p, x, groups=16, record=None):
    dw = p["conv_in"]["w"].shape[0]
    h = A.conv(x, p["conv_in"], padding=0)
    h = group_norm(p["group_norm"], h, groups, 1e-5)
    if record is not None:
        record.append({"op": "grouped_conv", "shape": tuple(h.shape), "groups": groups})
    h = F.gelu(A.conv(h, p["group_conv"], padding=1, groups=groups))
    h = h * A.conv(gap(h), p["intra_attn"], padding=0, groups=groups)
    iga = A.conv(gap(h), p["inter_attn"], padding=0)  # (B, 1, 1, groups)
    b, hh, ww, _ = h.shape
    h = (h.reshape(b, hh, ww, groups, dw // groups) * iga[..., None]).reshape(b, hh, ww, dw)
    return naf_block(A, p["nafblock"], x + A.conv(h, p["pwconv"], padding=0))


def vae_encode(A, spec, p, cfrm, x, noise, record=None):
    """x in [0, 1] NHWC -> (scaled latent sample, the three skips: after the
    CFRM stages, or as the encoder gives them where ``cfrm`` is None). The
    latent path carries no gradient back into the skips (detached before the
    last down block)."""
    v = spec["vae"]
    g, eps = v["norm_num_groups"], v["eps"]
    enc = p["encoder"]
    h = A.conv(x * 2.0 - 1.0, enc["conv_in"])
    skips = []
    blocks = enc["down_blocks"]
    for i, blk in enumerate(blocks[:-1]):
        for res in blk["resnets"]:
            h = resnet(A, res, h, g, eps)
        h = A.conv(h, blk["downsample"]["conv"], stride=2, padding=((0, 1), (0, 1)))
        if cfrm is not None:
            for nb in cfrm[i]["naf"]:
                h = naf_block(A, nb, h)
            h = ada_naf(A, cfrm[i]["ada"], h, record=record)
        skips.append(h)
    h = h.detach()
    for res in blocks[-1]["resnets"]:
        h = resnet(A, res, h, g, eps)
    h = mid_block(A, enc["mid"], h, g, eps, record)
    h = A.conv(F.silu(group_norm(enc["conv_norm_out"], h, g, eps)), enc["conv_out"])
    moments = A.conv(h, p["quant_conv"], padding=0)
    mean, logvar = moments.chunk(2, dim=-1)
    z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise.float()
    return z * v["scaling_factor"], skips


def mid_block(A, p, x, groups, eps, record=None):
    x = resnet(A, p["resnet1"], x, groups, eps)
    x = spatial_self_attention(A, p["attn"], x, 1, groups, eps, record)
    return resnet(A, p["resnet2"], x, groups, eps)


def tfa_tower(A, p, skip):
    h = F.gelu(A.conv(instance_norm(skip), p["conv1"]))
    return A.conv(h, p["conv2"]).mean(dim=(1, 2))


def tfa(A, p, x, skip, cond, prompt_len):
    b, d = skip.shape[0], skip.shape[-1]
    f = torch.softmax(tfa_tower(A, p["filter_gate"], skip).reshape(b, prompt_len, d), dim=-1)
    i = torch.softmax(tfa_tower(A, p["info_gate"], skip).reshape(b, prompt_len, d), dim=-1)
    c = torch.tanh(tfa_tower(A, p["content_trans"], skip)).reshape(b, prompt_len, d)
    cond = f * cond + i * c
    o = torch.tanh(A.linear(cond.reshape(b, prompt_len * d), p["out_gate"]))
    hidden = A.conv(skip, p["t_gate1"], padding=0) * o[:, None, None, :]
    skip = skip + A.conv(hidden, p["t_gate2"], padding=0)
    x = x + A.conv(torch.cat([x, skip], dim=-1), p["conv_out"], padding=0)
    nxt = F.gelu(A.linear(cond, p["prompt_trans"])) if "prompt_trans" in p else None
    return x, nxt


def vae_decode(A, spec, p, tfa_p, z, skips, task, record=None):
    v = spec["vae"]
    g, eps = v["norm_num_groups"], v["eps"]
    dec = p["decoder"]
    h = A.conv(z / v["scaling_factor"], p["post_quant_conv"], padding=0)
    h = A.conv(h, dec["conv_in"])
    h = mid_block(A, dec["mid"], h, g, eps, record)
    cond = None
    if tfa_p is not None:
        prompt = tfa_p["task_prompts"][task].float()
        cond = prompt[None].expand((h.shape[0],) + tuple(prompt.shape))
    blocks = dec["up_blocks"]
    for i, blk in enumerate(blocks):
        if cond is not None and i < len(blocks) - 1:
            h, cond = tfa(A, tfa_p["task_editors"][i], h, skips[-i - 1], cond,
                          spec["prompt_len"])
        for res in blk["resnets"]:
            h = resnet(A, res, h, g, eps)
        if "upsample" in blk:
            h = A.conv(upsample_2x(h), blk["upsample"]["conv"])
    h = A.conv(F.silu(group_norm(dec["conv_norm_out"], h, g, eps)), dec["conv_out"])
    return (h + 1.0) / 2.0


# ---------------------------------------------------------------------------
# Controller, UNet, control adapters
# ---------------------------------------------------------------------------


def controller(A, spec, p, x, timesteps, record=None):
    """Four control maps at latent / 1, 2, 4, 8."""
    c = spec["controller"]
    g, eps, heads = c["norm_num_groups"], c["eps"], c["num_heads"]
    emb = time_mlp(A, p["time_embedding"], timestep_embedding(timesteps, c["model_channels"]))
    h = A.conv(x, p["conv_in"])
    captures = []
    for blk in p["down_blocks"]:
        for j, res in enumerate(blk["resnets"]):
            h = resnet(A, res, h, g, eps, emb)
            if blk["attentions"]:
                h = spatial_self_attention(A, blk["attentions"][j], h, heads, g, eps, record)
        captures.append(h)
        if "downsample" in blk:
            h = A.conv(h, blk["downsample"]["conv"], stride=2, padding=1)
    h = resnet(A, p["mid"]["resnet1"], h, g, eps, emb)
    h = spatial_self_attention(A, p["mid"]["attn"], h, heads, g, eps, record)
    captures[-1] = resnet(A, p["mid"]["resnet2"], h, g, eps, emb)
    return [resnet(A, ft, cap, g, eps, emb) for ft, cap in zip(p["fea_tran"], captures)]


def transformer(A, p, x, context, heads, groups, record=None):
    b, h, w, c = x.shape
    y = A.linear(group_norm(p["norm"], x, groups, 1e-6).reshape(b, h * w, c), p["proj_in"])
    for blk in p["blocks"]:
        y = y + attention(A, blk["attn1"], layer_norm(blk["norm1"], y), None, heads, record)
        y = y + attention(A, blk["attn2"], layer_norm(blk["norm2"], y), context, heads, record)
        val, gate = A.linear(layer_norm(blk["norm3"], y), blk["ff_in"]).chunk(2, dim=-1)
        y = y + A.linear(val * F.gelu(gate), blk["ff_out"])
    return x + A.linear(y, p["proj_out"]).reshape(b, h, w, c)


def spade(A, p, x, segmap):
    normalized = group_norm(p["norm"], x, 32, 1e-5)
    _, h, w, _ = x.shape
    _, sh, sw, _ = segmap.shape
    rows = torch.from_numpy(np.floor(np.arange(h, dtype=np.float32) * np.float32(sh / h))
                            .astype(np.int64)).to(x.device)
    cols = torch.from_numpy(np.floor(np.arange(w, dtype=np.float32) * np.float32(sw / w))
                            .astype(np.int64)).to(x.device)
    seg = segmap.index_select(1, rows).index_select(2, cols)
    actv = F.relu(A.conv(seg, p["mlp_shared"]))
    return normalized * (1.0 + A.conv(actv, p["mlp_gamma"])) + A.conv(actv, p["mlp_beta"])


def csce(A, p, x, cond):
    proj = A.conv(cond, p["proj"], padding=0)
    h = A.conv(F.gelu(A.conv(x + proj, p["tuner_in"], padding=0)), p["tuner_out"], padding=0)
    return h + proj + x


def skip_scales(levels: int, per_block: int) -> list:
    """The control scale of each UNet skip, in capture order."""
    out = [0]
    for i in range(levels):
        out += [i] * per_block
        if i < levels - 1:
            out.append(i + 1)
    return out


def unet(A, spec, p, adapters, z, timesteps, context, control, record=None):
    """Controlled UNet's noise prediction; control by SC-Tuner or SPADE."""
    u = spec["unet"]
    g, eps, heads = u["norm_num_groups"], u["eps"], u["heads"]
    emb = time_mlp(A, p["time_embedding"],
                   timestep_embedding(timesteps, u["block_out_channels"][0]))
    spades = adapters.get("spades")

    def unit(res, attn, h, lvl, sp):
        mod = None if sp is None else (lambda y: spade(A, sp, y, control[lvl]))
        h = resnet(A, res, h, g, eps, emb, mod)
        return h if attn is None else transformer(A, attn, h, context, heads[lvl], g, record)

    h = A.conv(z, p["conv_in"])
    skips = [h]
    for i, blk in enumerate(p["down_blocks"]):
        for j, res in enumerate(blk["resnets"]):
            attn = blk["attentions"][j] if blk["attentions"] else None
            h = unit(res, attn, h, i, spades["down"][i][j] if spades else None)
            skips.append(h)
        if "downsample" in blk:
            h = A.conv(h, blk["downsample"]["conv"], stride=2, padding=1)
            skips.append(h)
    deepest = len(p["down_blocks"]) - 1
    sp1, sp2 = spades["mid"] if spades else (None, None)
    h = unit(p["mid"]["resnet1"], p["mid"]["attn"], h, deepest, sp1)
    h = unit(p["mid"]["resnet2"], None, h, deepest, sp2)
    if "csc_editors" in adapters:
        scales = skip_scales(len(p["down_blocks"]), u["layers_per_block"])
        skips = [csce(A, ed, s, control[si])
                 for ed, s, si in zip(adapters["csc_editors"], skips, scales)]
    for i, blk in enumerate(p["up_blocks"]):
        lvl = deepest - i
        for j, res in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            attn = blk["attentions"][j] if blk["attentions"] else None
            h = unit(res, attn, h, lvl, spades["up"][i][j] if spades else None)
        if "upsample" in blk:
            h = A.conv(upsample_2x(h), blk["upsample"]["conv"])
    h = F.silu(group_norm(p["conv_norm_out"], h, g, eps))
    return A.conv(h, p["conv_out"])


# ---------------------------------------------------------------------------
# the sd-turbo scheduler and the restore
# ---------------------------------------------------------------------------


def alphas_cumprod(device) -> torch.Tensor:
    """Scaled-linear betas 0.00085 .. 0.012 over 1000 steps."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32)).to(device)


def ddim_timesteps(n: int) -> list:
    """Trailing spacing, descending."""
    return [int(t) for t in np.round(np.arange(1000, 0, -1000 / n)).astype(np.int64) - 1]


def restore(A, spec, frozen, trainable, images, task, posterior_noise, diffusion_noise,
            steps, record=None):
    """Restore images in [0, 1] NHWC whose sides are multiples of 64 (no
    resize, no pad): encode with CFRM, noise to t = 999, ``steps`` DDIM steps
    (eta 0) of the Controller and the controlled UNet, decode with TFA for
    ``task``. Returns float32 NHWC, unclamped."""
    acp = alphas_cumprod(images.device)
    z0, skips = vae_encode(A, spec, frozen["vae"], trainable["cfrm"], images.float(),
                           posterior_noise, record)
    a = acp[999]
    z = a.sqrt() * z0 + (1.0 - a).sqrt() * diffusion_noise.float()
    b = images.shape[0]
    null = frozen["null_emb"].float()
    context = null.expand((b,) + tuple(null.shape[1:]))
    for t in ddim_timesteps(steps):
        tv = torch.full((b,), t, dtype=torch.int64, device=images.device)
        control = controller(A, spec, trainable["controller"], z0, tv, record)
        eps = unet(A, spec, frozen["unet"], trainable["control"], z, tv, context, control,
                   record)
        prev = t - 1000 // steps
        a_t = acp[t]
        a_prev = acp[prev] if prev >= 0 else acp[0]
        x0 = (z - (1.0 - a_t).sqrt() * eps) / a_t.sqrt()
        z = a_prev.sqrt() * x0 + (1.0 - a_prev).sqrt() * eps
    tfa_p = trainable.get("tfa") if spec["use_tfa"] else None
    return vae_decode(A, spec, frozen["vae"], tfa_p, z, skips, task, record)
