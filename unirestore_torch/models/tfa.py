"""TFA: Task Feature Adapters with per-task prompts (mirrors ``unirestore_tpu/models/tfa.py``).

Per decoder level: three InstanceNorm -> 3x3 -> GELU -> 3x3 -> GAP towers over
the encoder skip give filter/info gates (softmax) and a content code (tanh);
the prompt updates as ``cond' = f * cond + i * content``; an out-gate
modulates a 1x1-bottlenecked skip; fusion is ``x + conv_out(cat(x, skip'))``.
"""

from __future__ import annotations

import torch

from ..nn import layers as L


def _tower_init(ini, c_skip: int, hidden: int):
    return {
        "conv1": L.conv2d_init(ini, c_skip, c_skip, 3),
        "conv2": L.conv2d_init(ini, c_skip, hidden, 3),
    }


def _tower(p, skip):
    h = L.gelu(L.conv2d(p["conv1"], L.instance_norm(skip), padding=1))
    h = L.conv2d(p["conv2"], h, padding=1)
    return L.global_avg_pool(h, keepdims=False)  # (B, hidden)


def task_feature_adapter_init(ini, c_out: int = 512, c_skip: int = 256,
                              prompt_len: int = 1, last_layer: bool = False):
    c_emb = c_skip
    hidden = c_emb * prompt_len
    p = {
        "t_gate1": L.conv2d_init(ini, c_skip, c_emb, 1),
        "t_gate2": L.conv2d_init(ini, c_emb, c_skip, 1),
        "conv_out": L.conv2d_init(ini, c_skip + c_out, c_out, 1),
        "filter_gate": _tower_init(ini, c_skip, hidden),
        "info_gate": _tower_init(ini, c_skip, hidden),
        "content_trans": _tower_init(ini, c_skip, hidden),
        "out_gate": L.linear_init(ini, hidden, c_emb),
    }
    if not last_layer:
        p["prompt_trans"] = L.linear_init(ini, c_emb, c_emb // 2)
    return p


def task_feature_adapter(p, x, skip, cond, prompt_len: int = 1):
    """x (B,h,w,c_out), skip (B,h,w,c_skip), cond (B,T,D=c_skip).

    Returns (fused x, next condition or None)."""
    b, d = skip.shape[0], skip.shape[-1]
    f = torch.softmax(_tower(p["filter_gate"], skip).reshape(b, prompt_len, d), dim=-1)
    i = torch.softmax(_tower(p["info_gate"], skip).reshape(b, prompt_len, d), dim=-1)
    c = torch.tanh(_tower(p["content_trans"], skip)).reshape(b, prompt_len, d)

    update_cond = f * cond + i * c                       # (B, T, D)
    o = torch.tanh(L.linear(p["out_gate"], update_cond.reshape(b, prompt_len * d)))

    hidden = L.conv2d(p["t_gate1"], skip, padding=0) * o[:, None, None, :]
    skip = skip + L.conv2d(p["t_gate2"], hidden, padding=0)
    x = x + L.conv2d(p["conv_out"], torch.cat([x, skip], dim=-1), padding=0)

    next_cond = None
    if "prompt_trans" in p:
        next_cond = L.gelu(L.linear(p["prompt_trans"], update_cond))
    return x, next_cond


def tfa_init(ini, c_out: int = 512, skip_channels=(512, 256, 128), prompt_len: int = 1):
    """The three decoder-level adapters."""
    n = len(skip_channels)
    return [task_feature_adapter_init(ini, c_out, cs, prompt_len, last_layer=(i == n - 1))
            for i, cs in enumerate(skip_channels)]


def task_prompts_init(ini, tasks, prompt_len: int = 1, dim: int = 512):
    """Zero-init per-task prompts, keyed by task name."""
    return {t: ini.zeros((prompt_len, dim)) for t in tasks}
