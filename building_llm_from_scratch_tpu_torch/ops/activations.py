"""Activations: exact-erf GELU (GPT-2) and SiLU (LLaMA's SwiGLU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    # written as x * sigmoid(x), as the JAX package does, so the model dtype
    # rounds at the same two places
    return x * torch.sigmoid(x)
