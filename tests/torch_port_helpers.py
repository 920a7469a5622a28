"""Shared helpers of the ``test_torch_*`` files: small configs built from
both packages' registries, JAX-initialised weights, and numpy bridges.

Both packages run on the same weights (made by the JAX ``init_params``,
carried into the port by ``params_from_jax``) and the same numpy inputs."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from building_llm_from_scratch_tpu import configs as jcfgs
from building_llm_from_scratch_tpu.models import init_params as jax_init_params
from building_llm_from_scratch_tpu_torch import configs as tcfgs

# The tier-1 suite runs these files in several worker processes beside the
# JAX tests, some of which time their own ticks; torch's default of one
# intra-op thread per core in every worker oversubscribes the CPU.
torch.set_num_threads(min(2, torch.get_num_threads()))

SMALL = dict(emb_dim=128, n_heads=4, n_kv_groups=2, vocab_size=512,
             context_length=64, n_layers=2, hidden_dim=256, drop_rate=0.0)


def small_configs(kind: str, dtype: str = "fp32", **kw):
    """(jax_cfg, torch_cfg) for a GPT-2-like or LLaMA-like small model cut
    from the registries with ``replace``."""
    if kind == "gpt2":
        base = jcfgs.get_config("GPT2", "124M", dtype=dtype)
        small = dict(SMALL, n_kv_groups=SMALL["n_heads"])
    else:
        base = jcfgs.get_config("llama3_2", "1B", dtype=dtype)
        small = dict(SMALL)
    jcfg = base.replace(**{**small, **kw})
    return jcfg, to_torch_config(jcfg)


def to_torch_config(jcfg) -> tcfgs.ModelConfig:
    d = dataclasses.asdict(jcfg)
    if d["rope_scaling"] is not None:
        d["rope_scaling"] = tcfgs.RopeScaling(**d["rope_scaling"])
    return tcfgs.ModelConfig(**d)


def jax_params(jcfg, seed: int = 0):
    """The JAX params tree and its numpy copy."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return params, jax.device_get(params)


def bits(a) -> np.ndarray:
    """Raw bits of a numpy or torch array (bf16 included), for exact
    comparisons."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().view(np.dtype(f"u{t.element_size()}"))
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def to_np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)
