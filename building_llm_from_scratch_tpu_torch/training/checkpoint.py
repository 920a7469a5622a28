"""The parameter-export format of the JAX package's ``training/
checkpoint.py`` (``export_params`` and ``load_exported_params``), and the
weight carrier from a JAX parameter tree to the port's model.

Export format: one ``.npz`` with a key per leaf named by its tree path
(``blocks/attn/wq``), plus a ``__dtype__.<key>`` entry naming the dtype.
``np.savez`` stores bf16 leaves as raw 2-byte void records, so their bits
are reinterpreted, never converted: ``uint16 -> int16 -> torch.bfloat16``
keeps them bit-exact, both ways. ``lora_from_jax`` carries a LoRA adapter
tree across the same way. Train-state checkpoints (optimizer state, resume)
are not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.device import resolve_device
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    param_shapes,
)

_NUMPY_NAMES = {"fp32": "float32", "fp16": "float16", "bf16": "bfloat16"}


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}; a flat dict passes through."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def numpy_to_torch(arr: np.ndarray, dtype_name: str | None = None) -> torch.Tensor:
    """A numpy leaf as a CPU tensor, bit for bit. bf16 arrays (ml_dtypes, or
    the raw 2-byte records np.load gives back) are reinterpreted through
    int16, since ``torch.from_numpy`` has no bf16."""
    arr = np.asarray(arr)
    name = dtype_name or arr.dtype.name
    if name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"bfloat16 leaf stored with itemsize {arr.dtype.itemsize}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        arr = arr.view(np.dtype(name))
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy leaf, bit for bit: bf16 becomes the 2-byte void
    records ``np.savez`` writes for a JAX bf16 array."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def export_params(path: str, model: Transformer) -> str:
    """Write the model's parameters in the JAX ``export_params`` format:
    one key per JAX tree path (sorted, the tree's flattening order) and a
    ``__dtype__.<key>`` entry with the dtype's numpy name. The JAX
    package's ``load_exported_params`` and the port's read it back with
    identical bits."""
    arrays = {}
    for key, t in sorted(model.flat_params().items()):
        arrays[key] = torch_to_numpy(t)
        arrays[f"__dtype__.{key}"] = np.asarray(
            "bfloat16" if t.dtype == torch.bfloat16
            else str(arrays[key].dtype))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return path


def params_from_jax(tree_or_flat: Dict[str, Any], cfg: ModelConfig,
                    device: torch.device | str = "cuda") -> Transformer:
    """Build the port's model from a JAX parameter tree (nested dict of
    numpy arrays, e.g. ``jax.device_get(params)``) or its flat
    ``{"blocks/attn/wq": array}`` form. The layouts are the same, so no leaf
    is transposed; leaves keep their dtype."""
    device = resolve_device(device)
    flat = flatten_tree(tree_or_flat)
    return Transformer(cfg, {k: numpy_to_torch(v).to(device)
                             for k, v in flat.items()})


def load_exported_params(path: str, cfg: ModelConfig,
                         device: torch.device | str = "cuda") -> Transformer:
    """Load an ``export_params`` ``.npz`` into the port's model for ``cfg``.
    Each leaf is restored through its recorded dtype, then cast to the
    config's dtype, as the JAX loader casts to its template."""
    device = resolve_device(device)
    with np.load(path) as data:
        flat = {}
        for key in param_shapes(cfg):
            if key not in data:
                raise KeyError(f"Export missing parameter {key}")
            dkey = f"__dtype__.{key}"
            recorded = (str(data[dkey]) if dkey in data
                        else _NUMPY_NAMES[cfg.dtype])
            t = numpy_to_torch(data[key], recorded)
            flat[key] = t.to(device=device, dtype=cfg.torch_dtype)
    return Transformer(cfg, flat)


def lora_from_jax(tree_or_flat: Dict[str, Any], cfg: ModelConfig,
                  device: torch.device | str = "cuda") -> Dict[str, Any]:
    """The port's adapter tree (``models/lora.py``) from a JAX lora tree of
    numpy arrays (``jax.device_get(lora)``) or its flat ``{"blocks/attn/wq/A":
    array}`` form: the same nesting and layouts, no transposes, bit-exact
    (bf16 included). Every leaf's shape is checked against ``cfg`` at the
    adapter's rank."""
    from building_llm_from_scratch_tpu_torch.models.lora import (
        adapted_shapes,
        unflatten_lora,
    )

    device = resolve_device(device)
    flat = {tuple(k.split("/")): numpy_to_torch(v).to(device)
            for k, v in flatten_tree(tree_or_flat).items()}
    rank = next((leaf.shape[-1] for p, leaf in flat.items() if p[-1] == "A"), 0)
    expected = adapted_shapes(cfg, rank)
    if set(flat) != set(expected):
        raise KeyError(f"adapter differs from the config's: missing "
                       f"{sorted(set(expected) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(expected))}")
    for path, shape in expected.items():
        if tuple(flat[path].shape) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(flat[path].shape)} "
                             f"!= {shape}")
    return unflatten_lora(flat)
