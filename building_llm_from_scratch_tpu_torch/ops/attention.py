"""Causal grouped-query attention: the math the JAX package leaves to XLA
(``ops/attention.py``'s ``_xla_attention`` and ``decode_attention``) in
plain PyTorch, and the training dispatch ``causal_attention``.

Scores are taken in fp32 from the model-dtype operands (the products of two
bf16 or fp16 values are exact in fp32, so upcasting first is the JAX
``preferred_element_type=float32`` contraction), masked with the same
-1e30 constant, softmaxed in fp32, and the weights are cast to the value
dtype before the value product, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from building_llm_from_scratch_tpu_torch.ops.philox import attention_keep_mask

_NEG_INF = -1e30


def _value_product(weights: torch.Tensor, v: torch.Tensor,
                   equation: str) -> torch.Tensor:
    """``einsum(weights.astype(v.dtype), v)`` with fp32 accumulation and the
    result in v's dtype."""
    w = weights.to(v.dtype)
    return torch.einsum(equation, w.float(), v.float()).to(v.dtype)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_length: Optional[torch.Tensor] = None,
                  dropout_rate: float = 0.0, seed: Optional[int] = None,
                  deterministic: bool = True) -> torch.Tensor:
    """Masked attention over (B, Tkv, Hkv, D) k/v for (B, Tq, Hq, D) queries
    (the JAX ``_xla_attention``).

    ``q_positions``: None (= arange(Tq)), (Tq,) or (B, Tq) absolute
    positions; the causal rule is ``q_pos >= kv_pos``. ``kv_length``:
    scalar or (B,) valid key prefix. With ``dropout_rate > 0`` and not
    ``deterministic``, the softmax weights are dropped and scaled by
    1/(1-rate) with the fused kernels' keep mask for ``seed``
    (``ops/philox.py``), over query heads."""
    B, Tq, Hq, D = q.shape
    _, Tkv, Hkv, _ = k.shape
    G = Hq // Hkv
    dev = q.device
    q_pos = (torch.arange(Tq, device=dev) if q_positions is None
             else q_positions)
    kv_pos = torch.arange(Tkv, device=dev)
    if q_pos.ndim == 1:
        mask = (q_pos[:, None] >= kv_pos[None, :])[None, None, None]
    else:
        mask = (q_pos[:, :, None] >= kv_pos[None, None, :])[:, None, None]
    if kv_length is not None:
        valid = kv_pos[None, :] < torch.as_tensor(
            kv_length, device=dev).reshape(-1, 1)
        mask = mask & valid[:, None, None, None, :]

    qg = q.reshape(B, Tq, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    scores = torch.where(mask, scores, torch.full((), _NEG_INF, device=dev))
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        if seed is None:
            raise ValueError("attention dropout requires a seed")
        keep = attention_keep_mask(seed, B, Hq, Tq, Tkv, dropout_rate, dev)
        weights = torch.where(keep.reshape(B, Hkv, G, Tq, Tkv),
                              weights / (1.0 - dropout_rate), 0.0)
    out = _value_product(weights, v, "bhgqk,bkhd->bqhgd")
    return out.reshape(B, Tq, Hq, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     q_positions: torch.Tensor,
                     kv_length: torch.Tensor) -> torch.Tensor:
    """Attention over a cache in its own (B, Hkv, Tmax, D) layout for
    (B, Tq, Hq, D) queries at absolute ``q_positions`` ((Tq,) or (B, Tq)),
    with ``kv_length`` (scalar or (B,)) valid positions per row."""
    B, Tq, Hq, D = q.shape
    _, Hkv, Tkv, _ = k_cache.shape
    G = Hq // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                          k_cache.float()) * scale
    kv_pos = torch.arange(Tkv, device=dev)
    kv_length = torch.as_tensor(kv_length, device=dev)
    if q_positions.ndim == 2:
        mask = ((q_positions[:, :, None] >= kv_pos[None, None, :])
                & (kv_pos[None, None, :] < kv_length.reshape(-1, 1, 1)))
        mask = mask[:, None, None]
    else:
        mask = ((q_positions[:, None] >= kv_pos[None, :])
                & (kv_pos[None, :] < kv_length))
        mask = mask[None, None, None]
    scores = torch.where(mask, scores, torch.full((), _NEG_INF, device=dev))
    weights = torch.softmax(scores, dim=-1)
    out = _value_product(weights, v_cache, "bhgqk,bhkd->bhgqd")
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, D)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     dropout_rate: float = 0.0, seed: Optional[int] = None,
                     deterministic: bool = True) -> torch.Tensor:
    """Full-sequence causal self-attention for training and evaluation (the
    JAX ``causal_attention`` with ``impl='auto'``), with attention-weight
    dropout at ``dropout_rate`` unless ``deterministic``: the fused kernels
    (``ops/fused_attention.py``) for every shape ``supports_shape`` allows,
    whatever the device (on the CPU they compute their twins), and
    ``xla_attention`` for the rest, as the JAX package runs its XLA path for
    such shapes. Both draw the same mask for a seed. On CUDA the fused path
    launches the kernels or raises."""
    from building_llm_from_scratch_tpu_torch.ops.fused_attention import (
        fused_causal_attention,
        supports_shape,
    )

    rate = 0.0 if deterministic else dropout_rate
    if supports_shape(q.shape[1], k.shape[1], q.shape[3]):
        return fused_causal_attention(q, k, v, dropout_rate=rate, seed=seed)
    return xla_attention(q, k, v, dropout_rate=rate, seed=seed,
                         deterministic=deterministic)
