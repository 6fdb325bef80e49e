"""Timestep embeddings (mirrors ``unirestore_tpu/nn/embeddings.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as L


def sinusoidal_timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0,
                                  max_period: float = 10000.0):
    """Sinusoidal embedding of integer timesteps -> (B, dim), fp32."""
    t = timesteps.to(torch.float32)
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def timestep_mlp_init(ini, in_dim: int, embed_dim: int):
    return {
        "linear_1": L.linear_init(ini, in_dim, embed_dim),
        "linear_2": L.linear_init(ini, embed_dim, embed_dim),
    }


def timestep_mlp(p, emb):
    """TimestepEmbedding: linear -> silu -> linear."""
    return L.linear(p["linear_2"], L.silu(L.linear(p["linear_1"], emb)))
