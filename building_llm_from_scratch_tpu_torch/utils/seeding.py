"""Reproducibility (the port's counterpart of the JAX package's
``utils/seeding.py``): host RNGs are seeded, device randomness comes from
explicit ``torch.Generator``s made from the same seed, and dropout masks
from 64-bit seeds derived here.

The JAX train step folds the step into its rng and splits it per dropout
site (``fold_in(rng, step)``, then the embedding, and attention, residual 1
and residual 2 of every layer). The port derives the same tree of seeds
with a fixed integer hash (splitmix64's finaliser) on the host: no device
read per step, and the derivation sits in this one place.
"""

from __future__ import annotations

import random

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
#: the dropout sites of a layer (the embedding is site 0 of layer -1)
SITES = {"embedding": 0, "attention": 1, "residual1": 2, "residual2": 3}


def set_seed(seed: int = 123, device: torch.device | str = "cpu"
             ) -> torch.Generator:
    """Seed Python's and numpy's global RNGs and return a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def mix64(z: int) -> int:
    """splitmix64's output function of ``z + golden ratio``."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(*parts: int) -> int:
    """A 64-bit seed that is a fixed function of the integers ``parts``."""
    h = 0
    for p in parts:
        h = mix64(h ^ (int(p) & _MASK64))
    return h


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of train step ``step`` (0-based) of a run seeded
    with ``seed`` (the JAX ``fold_in(rng, step)``)."""
    return derive_seed(seed, step)


def site_seed(step_seed: int, layer: int, site: str) -> int:
    """The seed of one dropout site of a step: ``layer`` -1 with
    "embedding", or a layer index with "attention", "residual1" or
    "residual2"."""
    return derive_seed(step_seed, layer + 1, SITES[site])
