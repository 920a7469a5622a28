"""LoRA adapters as a tree beside the model (port of the JAX package's
``models/lora.py``).

An adapter is a nested dict mirroring the model's adapted linear weights:

  lora = {
    "blocks": {"attn": {"wq": {"A": (L, in, r), "B": (L, r, out)}, ...},
               "mlp":  {...}},
    "head":   {"weight": {"A": (in, r), "B": (r, out)}},
  }

Every linear gets an adapter (the attention and MLP projections and the LM
head); embeddings do not. A is kaiming-uniform(a=sqrt(5)) over (in, r),
i.e. U(-1/sqrt(in), 1/sqrt(in)), B is zero, and the scale is alpha / rank.

``merge_lora`` folds an adapter into the weights (W' = W + s A@B);
``apply_lora`` applies it at the activation instead, so one base weight
serves many adapters at once (multi-tenant serving, ``serving/adapters.py``).
Its ``"bgmv"`` node sends the per-row delta of a single-token decode
through the kernel B6 (``ops/decode_step.lora_bgmv``).

Artifacts (``save_adapter``/``load_adapter``) are the JAX package's ``.npz``
format, readable both ways: dotted keys, a ``__dtype__.<key>`` entry per
array (bf16 stored as raw 2-byte records) and ``__adapter_meta__`` JSON with
rank, alpha and the base config's fingerprint. The random stream of
``init_lora_params`` is torch's, not JAX's; the same artifact file gives
the same adapter in both packages.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig

Tree = Dict[str, Any]

#: adapter artifact (.npz) format version, as the JAX package writes it
ADAPTER_FORMAT_VERSION = 1

#: model-tree linear weights that receive adapters
_ADAPTED = {
    ("blocks", "attn", "wq"),
    ("blocks", "attn", "wk"),
    ("blocks", "attn", "wv"),
    ("blocks", "attn", "wo"),
    ("blocks", "mlp", "up"),
    ("blocks", "mlp", "down"),
    ("blocks", "mlp", "gate"),
    ("head", "weight"),
}


def adapted_shapes(cfg: ModelConfig, rank: int) -> Dict[tuple, tuple]:
    """Path (``("blocks", "attn", "wq", "A")``...) -> shape of every leaf of
    a rank-``rank`` adapter for ``cfg``, in the tree's sorted order."""
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        param_shapes,
    )

    out = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        path = tuple(name.split("/"))
        if path not in _ADAPTED:
            continue
        *lead, fan_in, fan_out = shape
        out[path + ("A",)] = (*lead, fan_in, rank)
        out[path + ("B",)] = (*lead, rank, fan_out)
    return out


def _set(tree: Tree, path: tuple, leaf) -> None:
    node = tree
    for name in path[:-1]:
        node = node.setdefault(name, {})
    node[path[-1]] = leaf


def flatten_lora(lora: Tree, prefix: tuple = ()) -> Dict[tuple, Any]:
    """Nested adapter tree -> {path tuple: leaf}, keys sorted at each level
    (the JAX tree's flattening order)."""
    out: Dict[tuple, Any] = {}
    for k in sorted(lora):
        v = lora[k]
        if isinstance(v, dict):
            out.update(flatten_lora(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_lora(flat: Dict[tuple, Any]) -> Tree:
    tree: Tree = {}
    for path, leaf in flat.items():
        _set(tree, path, leaf)
    return tree


def init_lora_params(cfg: ModelConfig, generator: torch.Generator, rank: int,
                     device: torch.device | str = "cpu") -> Tree:
    """A rank-``rank`` adapter for every adapted linear of ``cfg``: A drawn
    from ``generator`` (which must live on ``device``) as U(-1/sqrt(in),
    1/sqrt(in)) in fp32 and cast to the model dtype, B zero. Stacked block
    weights (L, in, out) give (L, in, r) / (L, r, out) leaves."""
    dt = cfg.torch_dtype
    flat = {}
    for path, shape in adapted_shapes(cfg, rank).items():
        if path[-1] == "A":
            bound = 1.0 / math.sqrt(shape[-2])
            t = torch.empty(shape, dtype=torch.float32, device=device)
            t.uniform_(-bound, bound, generator=generator)
            flat[path] = t.to(dt)
        else:
            flat[path] = torch.zeros(shape, dtype=dt, device=device)
    return unflatten_lora(flat)


def merge_lora(params: Dict[str, torch.Tensor], lora: Tree, alpha: float,
               rank: int) -> Dict[str, torch.Tensor]:
    """The model's flat parameters (``"blocks/attn/wq"`` -> tensor) with
    W' = W + (alpha / rank) * A @ B on every adapted weight; the product is
    taken and scaled in the weight's dtype, as the JAX ``merge_lora``."""
    scaling = alpha / rank
    merged = dict(params)
    flat = flatten_lora(lora)
    for path, a in flat.items():
        if path[-1] != "A":
            continue
        name = "/".join(path[:-1])
        w = params[name]
        b = flat[path[:-1] + ("B",)]
        delta = torch.matmul(a.to(w.device, w.dtype), b.to(w.device, w.dtype))
        merged[name] = w + scaling * delta
    return merged


def lora_delta(x: torch.Tensor, node: Tree, scaling) -> torch.Tensor:
    """The scaled unmerged delta ``s * ((x @ A) @ B)``: the products in the
    operands' dtype, the scale in fp32 (a scalar, or ``(B,)`` per row), so
    the result is fp32, as in the JAX ``lora_delta``."""
    delta = torch.matmul(torch.matmul(x, node["A"]), node["B"])
    s = torch.as_tensor(scaling, dtype=torch.float32, device=x.device)
    if s.ndim == 1:                       # (B,) per-row scales
        s = s[:, None, None]
    return s * delta


def apply_lora(x: torch.Tensor, w: torch.Tensor, node: Optional[Tree],
               scaling=None) -> torch.Tensor:
    """Merge-free adapted projection ``x @ w + s * ((x @ A) @ B)``.

    ``node``: ``{"A", "B"}``, unbatched ((in, r)/(r, out), one adapter for
    the batch) or per-row ((B, in, r)/(B, r, out), the gathered pool rows);
    ``None`` returns exactly ``x @ w``. ``scaling``: a scalar or ``(B,)``
    per-row scales (0 for a base-model row). A node with a ``"bgmv"`` entry
    (a_pool, b_pool, ids, scales) takes the delta of single-token rows
    ``x`` (S, 1, in) from the kernel B6 (its twin on the CPU)."""
    h = x @ w
    if node is None:
        return h
    if "bgmv" in node:
        from building_llm_from_scratch_tpu_torch.ops.decode_step import lora_bgmv

        a_pool, b_pool, ids, scales = node["bgmv"]
        delta = lora_bgmv(x[:, 0].contiguous(), a_pool, b_pool, ids, scales)
        return h + delta[:, None].to(h.dtype)
    return h + lora_delta(x, node, scaling).to(h.dtype)


def count_lora_params(lora: Tree) -> int:
    """Number of adapter parameters."""
    return int(sum(leaf.numel() for leaf in flatten_lora(lora).values()))


# ---------------------------------------------------------------------------
# adapter artifacts (.npz)
# ---------------------------------------------------------------------------

#: ModelConfig fields that define the architecture an adapter (or a cached
#: KV pane) binds to; dtype and kernel choices are runtime, not identity
_FINGERPRINT_FIELDS = (
    "name", "vocab_size", "context_length", "emb_dim", "n_heads",
    "n_layers", "hidden_dim", "n_kv_groups", "norm", "positional",
    "activation", "qkv_bias", "attn_out_bias", "mlp_bias", "norm_bias",
)


def adapter_fingerprint(cfg: ModelConfig) -> str:
    """Short stable hash of the base architecture, equal to the JAX
    package's for one config."""
    ident = {f: getattr(cfg, f) for f in _FINGERPRINT_FIELDS}
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_adapter(path: str, lora: Tree, *, rank: int, alpha: float,
                 cfg: ModelConfig) -> str:
    """Write one adapter as a standalone ``.npz`` artifact in the JAX
    package's format: the tree under dotted keys in its flattening order,
    each with its ``__dtype__`` entry, then ``__adapter_meta__``. Written to
    a temporary file and renamed into place."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        torch_to_numpy,
    )

    arrays: Dict[str, Any] = {}
    for p, leaf in flatten_lora(lora).items():
        key = ".".join(p)
        arrays[key] = torch_to_numpy(leaf)
        arrays[f"__dtype__.{key}"] = np.asarray(
            "bfloat16" if leaf.dtype == torch.bfloat16
            else str(arrays[key].dtype))
    meta = {
        "format": ADAPTER_FORMAT_VERSION,
        "rank": int(rank),
        "alpha": float(alpha),
        "fingerprint": adapter_fingerprint(cfg),
        "model": cfg.name,
    }
    arrays["__adapter_meta__"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz to a path without it
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)
    return path


def load_adapter(path: str) -> Tuple[Tree, Dict[str, Any]]:
    """Read a ``save_adapter`` artifact of either package -> (adapter tree
    of CPU tensors, bit for bit; meta). Raises ``ValueError`` for a file
    without adapter metadata or of a newer format."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        numpy_to_torch,
    )

    with np.load(path, allow_pickle=False) as data:
        if "__adapter_meta__" not in data:
            raise ValueError(
                f"{path} is not an adapter artifact (no __adapter_meta__; "
                "write one with models.lora.save_adapter)")
        meta = json.loads(str(data["__adapter_meta__"]))
        if meta.get("format", 0) > ADAPTER_FORMAT_VERSION:
            raise ValueError(
                f"{path}: adapter format {meta.get('format')} is newer than "
                f"this build supports ({ADAPTER_FORMAT_VERSION})")
        flat = {}
        for key in data.files:
            if key.startswith("__"):
                continue
            dt_key = f"__dtype__.{key}"
            dtype_name = str(data[dt_key]) if dt_key in data else None
            flat[tuple(key.split("."))] = numpy_to_torch(data[key], dtype_name)
    return unflatten_lora(flat), meta
