"""Sinusoidal timestep embeddings (port of ``diffuncertainty_tpu/ops/time_embed.py``).

``max_period=10`` (continuous t in [0, 1], not integer DDPM steps) and the
cos-before-sin order, in float32.
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10.0) -> torch.Tensor:
    """Embed a ``(B,)`` vector of (possibly fractional) timesteps to ``(B, dim)``."""
    half = dim // 2
    arange = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(max_period) * arange / half)
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding
