"""Rotary position embeddings (RoPE). Port of `ggrmcp_tpu/ops/rope.py`:
frequencies computed per call from the head dim, explicit positions,
rotation in float32 and cast back."""

from __future__ import annotations

import math
from typing import Optional

import torch


def rope_freqs(
    head_dim: int,
    theta: float = 10000.0,
    scaling: Optional[tuple] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Inverse frequencies for half the head dim: [head_dim // 2].

    `scaling`: Llama-3-style 4-tuple (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings): long
    wavelengths slow by `factor`, short ones stay, and a linear ramp
    blends between the two cutoffs."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    freqs = 1.0 / (theta ** exponent)
    if scaling:
        factor, low, high, orig = (float(v) for v in scaling)
        wavelen = 2.0 * math.pi / freqs
        ramp = (orig / wavelen - low) / (high - low)
        smooth = torch.clamp(ramp, 0.0, 1.0)
        freqs = (1.0 - smooth) * freqs / factor + smooth * freqs
    return freqs


def apply_rope(
    x: torch.Tensor,  # [..., seq, num_heads, head_dim]
    positions: torch.Tensor,  # [..., seq]
    theta: float = 10000.0,
    scaling: Optional[tuple] = None,
) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) by position-dependent
    angles, in float32, cast back to x's dtype."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, scaling, device=x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, d/2]
    cos = torch.cos(angles)[..., None, :]  # [..., seq, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
