"""Slot KV-cache allocation (the default ``KVCachePolicy`` of the JAX
package's ``serving/kvcache.py``): model-dtype caches, no prefix store, no
chunked prefill, no paging."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig


@dataclass(frozen=True)
class KVCachePolicy:
    """The slot cache's layout and dtype. Only the default policy is ported
    (int8, prefix-cache, chunked and paged policies wait): per-layer
    (n_rows, Hkv, max_length, head_dim) buffers in the model dtype, the
    attention-native layout the decode step reads without a re-layout."""

    def alloc(self, cfg: ModelConfig, n_rows: int, max_length: int,
              device: torch.device | str) -> dict:
        shape = (n_rows, cfg.n_kv_groups, max_length, cfg.head_dim)
        mk = lambda: [torch.zeros(shape, dtype=cfg.torch_dtype, device=device)  # noqa: E731
                      for _ in range(cfg.n_layers)]
        return {"k": mk(), "v": mk()}


DEFAULT_POLICY = KVCachePolicy()
