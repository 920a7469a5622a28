"""The dropout keep masks of the port: Philox4x32-10 on int64 tensors, the
same function as ``csrc/philox.cuh`` (see there for the counters), so a
kernel and its plain twin draw the same mask bit for bit.

The JAX package draws its masks from the TPU core's generator, reseeded per
tile (``ops/fused_attention.py:_keep_mask``, ``ops/fused_dropout.py:
_tile_keep``), or from ``jax.random.bernoulli``; the port's masks never
equal JAX's (ROADMAP, Randomness). What carries over is the rule: keep
means ``bits >= min(int(rate * 2**32), 2**32 - 1)``, compared as unsigned
32-bit integers, so P(keep) = 1 - rate.

Every product of the 32-bit multiplies is split into 16-bit halves, so no
intermediate leaves the int64 range.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def keep_threshold(rate: float) -> int:
    """The uint32 threshold of a keep bit (keep = bits >= threshold)."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def split_seed(seed: int) -> Tuple[int, int]:
    """A 64-bit seed as the generator's two 32-bit key words (low, high)."""
    seed = int(seed) & ((1 << 64) - 1)
    return seed & _MASK32, seed >> 32


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * b for a constant a < 2**32 and b an
    int64 tensor of values in [0, 2**32)."""
    x = a * (b & 0xFFFF)            # < 2**48
    y = a * (b >> 16)               # < 2**48
    lo = (x + ((y & 0xFFFF) << 16)) & _MASK32
    hi = (y + (x >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, seed: int) -> Tuple[torch.Tensor, ...]:
    """The four output words of Philox4x32-10 for counters (c0, c1, c2, c3)
    (int64 tensors of values in [0, 2**32), broadcast together) under the
    key ``split_seed(seed)``."""
    k0, k1 = split_seed(seed)
    dev = next((x.device for x in (c0, c1, c2, c3) if isinstance(x, torch.Tensor)),
               None)
    c = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.int64, device=dev)
                                  for x in (c0, c1, c2, c3)))
    c0, c1, c2, c3 = c
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def attention_keep_mask(seed: int, B: int, H: int, Tq: int, Tk: int,
                        rate: float, device=None, *, q0: int = 0, k0: int = 0,
                        h0: int = 0) -> torch.Tensor:
    """(B, H, Tq, Tk) bool keep mask of the attention weights: element
    (b, h, q, k) is word 2 (q & 1) + (k & 1) of counter (k >> 1, q >> 1, h,
    b). Query head h is the model's head index (kv head h // G under GQA).
    ``q0``, ``k0``, ``h0``: the global index of the first query, key and
    head (a sequence-parallel block, a tensor-parallel rank's heads), so a
    block draws its part of the whole mask."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    qa, ka = q0 - q0 % 2, k0 - k0 % 2
    Q2, K2 = (Tq + q0 - qa + 1) // 2, (Tk + k0 - ka + 1) // 2
    words = philox4x32_10(ar(K2)[None, None, None, :] + ka // 2,
                          ar(Q2)[None, None, :, None] + qa // 2,
                          ar(H)[None, :, None, None] + h0,
                          ar(B)[:, None, None, None], seed)
    thr = keep_threshold(rate)
    keep = torch.stack([w >= thr for w in words], dim=-1)      # (B, H, Q2, K2, 4)
    keep = keep.reshape(B, H, Q2, K2, 2, 2).permute(0, 1, 2, 4, 3, 5)
    keep = keep.reshape(B, H, 2 * Q2, 2 * K2)
    return keep[:, :, q0 - qa:q0 - qa + Tq, k0 - ka:k0 - ka + Tk]


def flat_keep_mask(seed: int, shape, rate: float, device=None,
                   layout=None) -> torch.Tensor:
    """Keep mask of a tensor of ``shape`` whose element at flat (row-major)
    index i is word i & 3 of counter (g low word, g high word, 0, 0) for
    its group g = i >> 2: the residual and embedding dropout sites.
    ``layout`` (chunk, stride, offset), in groups: the tensor is a block of
    a larger one, its group g that one's (g // chunk) * stride + offset +
    g % chunk (a sequence-parallel rank's T block)."""
    n = 1
    for d in shape:
        n *= int(d)
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    if layout is not None:
        chunk, stride, offset = layout
        g = torch.div(g, chunk, rounding_mode="floor") * stride + offset + g % chunk
    words = philox4x32_10(g & _MASK32, g >> 32, 0, 0, seed)
    thr = keep_threshold(rate)
    keep = torch.stack([w >= thr for w in words], dim=-1).reshape(-1)
    return keep[:n].reshape(tuple(shape))
