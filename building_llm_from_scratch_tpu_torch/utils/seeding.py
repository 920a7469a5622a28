"""Reproducibility (the port's counterpart of the JAX package's
``utils/seeding.py``): host RNGs are seeded, and device randomness comes
from explicit ``torch.Generator``s made from the same seed."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 123, device: torch.device | str = "cpu"
             ) -> torch.Generator:
    """Seed Python's and numpy's global RNGs and return a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
