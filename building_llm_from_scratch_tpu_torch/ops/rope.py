"""Rotary position embeddings: fp32 cos/sin tables (with LLaMA-3.1 frequency
smoothing) and rotate-half application with optional per-row positions."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from building_llm_from_scratch_tpu_torch.configs import RopeScaling


def precompute_rope_params(
    head_dim: int,
    theta_base: float = 10_000.0,
    context_length: int = 4096,
    rope_scaling: Optional[RopeScaling] = None,
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each (context_length, head_dim), fp32."""
    if head_dim % 2:
        raise ValueError("head_dim must be even for RoPE")
    f32 = torch.float32
    exps = torch.arange(0, head_dim, 2, dtype=f32, device=device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta_base, dtype=f32,
                                            device=device), exps)

    if rope_scaling is not None:
        orig_ctx = rope_scaling.original_context_length
        low_freq_wavelen = orig_ctx / rope_scaling.low_freq_factor
        high_freq_wavelen = orig_ctx / rope_scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq

        scaled = inv_freq / rope_scaling.factor
        smooth = (orig_ctx / wavelen - rope_scaling.low_freq_factor) / (
            rope_scaling.high_freq_factor - rope_scaling.low_freq_factor)
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq

        inv_freq = torch.where(wavelen > low_freq_wavelen, scaled, inv_freq)
        is_medium = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
        inv_freq = torch.where(is_medium, smoothed, inv_freq)

    positions = torch.arange(context_length, dtype=f32, device=device)
    angles = positions[:, None] * inv_freq[None, :]
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); positions: None (= arange(seq)),
    (seq,) or per-row (batch, seq) absolute positions."""
    _, t, _, d = x.shape
    if positions is None:
        cos_t = cos[:t][None, :, None, :]
        sin_t = sin[:t][None, :, None, :]
    else:
        cos_t = cos[positions]
        sin_t = sin[positions]
        if positions.ndim == 1:
            cos_t = cos_t[None, :, None, :]
            sin_t = sin_t[None, :, None, :]
        else:
            cos_t = cos_t[:, :, None, :]
            sin_t = sin_t[:, :, None, :]
    x1 = x[..., : d // 2]
    x2 = x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    out = x.float() * cos_t + rotated.float() * sin_t
    return out.to(x.dtype)
