"""Normalization (forward only): LayerNorm and RMSNorm with fp32 statistics,
cast back to the input dtype — the math of ``ops/norms.py`` in the JAX
package."""

from __future__ import annotations

from typing import Optional

import torch


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype)
