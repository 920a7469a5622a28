"""Token sampling for the serving engine (port of the sampling half of the
JAX package's ``generate.py``): per-row temperature / top-k / seed in one
batch, and the prompt-length buckets.

Randomness: JAX folds the token index into the request's key
(``token_rng(PRNGKey(seed), i)``); here token i of a request is drawn from a
``torch.Generator`` seeded with ``token_seed(seed, i)``. The two streams
differ, but each keeps the property the engine relies on: a request's tokens
depend only on its own (prompt, seed, params), never on its slot or on the
traffic beside it.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def token_seed(seed: int, i: int) -> int:
    """The generator seed of token ``i`` of a request seeded ``seed``
    (splitmix64 of the pair, so nearby seeds and indices give unrelated
    streams)."""
    z = ((int(seed) & _MASK64) * 0x9E3779B97F4A7C15 + int(i) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def sample_tokens_dynamic(logits: torch.Tensor, seeds: np.ndarray,
                          token_index: np.ndarray, temperature: np.ndarray,
                          top_k: np.ndarray, max_top_k: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Per-row sampling of ``logits`` (S, V) fp32 with per-row parameters
    held on the host: ``seeds``/``token_index`` (S,) pick each row's
    generator seed, ``temperature`` (S,) (0 = greedy argmax) and ``top_k``
    (S,) (0 = off, else 1..max_top_k). Returns (S,) int64 token ids on the
    logits' device.

    The top-k rule is the JAX one: keep the values >= the k-th largest
    (ties at the threshold survive), set the rest to -inf. A sampled row
    draws ``argmax(logits / t + Gumbel noise)`` with the noise from its own
    generator, a categorical draw over softmax(logits / t)."""
    S, V = logits.shape
    dev = logits.device
    if (top_k > 0).any():
        K = min(max_top_k, V)
        vals = torch.topk(logits, K, dim=-1).values
        idx = torch.as_tensor(np.clip(top_k, 1, K) - 1, device=dev).long()
        kth = vals.gather(1, idx[:, None])
        on = torch.as_tensor(top_k > 0, device=dev)[:, None]
        logits = torch.where(on & (logits < kth),
                             torch.full((), -float("inf"), device=dev), logits)
    tokens = logits.argmax(dim=-1)
    rows = [s for s in range(S) if temperature[s] > 0.0]
    if rows:
        drawn = []
        for s in rows:
            generator.manual_seed(token_seed(seeds[s], token_index[s]))
            u = torch.rand(V, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u))
            drawn.append((logits[s] / float(temperature[s]) + gumbel).argmax())
        tokens[torch.as_tensor(rows, device=dev)] = torch.stack(drawn)
    return tokens


def _bucket(n: int, step: int = 64, lo: int = 32) -> int:
    """Round up to the prompt-length bucket (multiples of ``step``, floor
    ``lo``), as the JAX package does for its compile shapes."""
    return max(lo, -(-n // step) * step)
