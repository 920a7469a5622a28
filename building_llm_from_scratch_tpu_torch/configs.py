"""Model configuration registry (PyTorch port of ``building_llm_from_scratch_tpu/configs.py``).

The same frozen ``ModelConfig`` dataclass, the same GPT-2 and LLaMA
registries, and the same ``get_config`` rules (dtype injection, the
``--debug`` tiny-model shrink, and the LLaMA context clamp with a linear
RoPE theta rescale). The only difference is that dtype names map to torch
dtypes (``ModelConfig.torch_dtype``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPE_MAP = {
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
}

DTYPE_BYTES = {"fp32": 4, "fp16": 2, "bf16": 2}


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """LLaMA-3.1-style RoPE frequency smoothing parameters."""

    factor: float
    low_freq_factor: float
    high_freq_factor: float
    original_context_length: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture description covering GPT-2 and every LLaMA variant:

      norm        'layernorm' (GPT-2) | 'rmsnorm' (LLaMA)
      positional  'learned'   (GPT-2) | 'rope'    (LLaMA)
      activation  'gelu'      (GPT-2) | 'swiglu'  (LLaMA)
      n_kv_groups n_heads == MHA (GPT-2, LLaMA-2) | < n_heads == GQA (LLaMA-3)
    """

    name: str
    vocab_size: int
    context_length: int
    emb_dim: int
    n_heads: int
    n_layers: int
    hidden_dim: int                      # FFN hidden width
    n_kv_groups: int                     # == n_heads for full MHA
    norm: str = "layernorm"              # 'layernorm' | 'rmsnorm'
    positional: str = "learned"          # 'learned' | 'rope'
    activation: str = "gelu"             # 'gelu' | 'swiglu'
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    norm_bias: bool = False
    rope_base: float = 10_000.0
    rope_scaling: Optional[RopeScaling] = None
    drop_rate: float = 0.0
    eos_id: int = 50256
    eos_text: str = "<|endoftext|>"
    dtype: str = "fp32"                  # params + activations
    rmsnorm_eps: float = 1e-5
    layernorm_eps: float = 1e-5
    use_actv_ckpt: bool = False
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPE_MAP[self.dtype]

    @property
    def uses_rope(self) -> bool:
        return self.positional == "rope"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def num_params(self, exclude_embeddings: bool = False) -> int:
        """Analytic parameter count."""
        d, v, t = self.emb_dim, self.vocab_size, self.context_length
        hd, nh, nkv, f = self.head_dim, self.n_heads, self.n_kv_groups, self.hidden_dim
        emb = v * d + (t * d if self.positional == "learned" else 0)
        qkv = d * (nh * hd) + 2 * d * (nkv * hd)
        if self.qkv_bias:
            qkv += nh * hd + 2 * nkv * hd
        attn_out = (nh * hd) * d + (d if self.attn_out_bias else 0)
        if self.activation == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f + ((f + d) if self.mlp_bias else 0)
        norm_w = d * (2 if self.norm_bias else 1)
        per_layer = qkv + attn_out + mlp + 2 * norm_w
        final_norm = d * (2 if self.norm_bias else 1)
        head = d * v
        total = per_layer * self.n_layers + final_norm + head
        if not exclude_embeddings:
            total += emb
        return total


def rescale_theta(theta_old: float, context_length_old: int,
                  context_length_new: int) -> float:
    """Linearly rescale the RoPE base frequency when the context changes."""
    return theta_old * (context_length_new / context_length_old)


def _gpt2(name: str, emb_dim: int, n_heads: int, n_layers: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        vocab_size=50257,
        context_length=1024,
        emb_dim=emb_dim,
        n_heads=n_heads,
        n_layers=n_layers,
        hidden_dim=4 * emb_dim,
        n_kv_groups=n_heads,
        norm="layernorm",
        positional="learned",
        activation="gelu",
        qkv_bias=False,
        attn_out_bias=True,
        mlp_bias=True,
        norm_bias=True,
        drop_rate=0.1,
        eos_id=50256,
        eos_text="<|endoftext|>",
    )


GPT2_CONFIGS = {
    "124M": _gpt2("gpt2-124M", 768, 12, 12),
    "355M": _gpt2("gpt2-355M", 1024, 16, 24),
    "774M": _gpt2("gpt2-774M", 1280, 20, 36),
    "1.5B": _gpt2("gpt2-1.5B", 1600, 25, 48),
}

LLAMA2_CONFIG_7B = ModelConfig(
    name="llama2-7B",
    vocab_size=32_000,
    context_length=4096,
    emb_dim=4096,
    n_heads=32,
    n_layers=32,
    hidden_dim=11_008,
    n_kv_groups=32,
    norm="rmsnorm",
    positional="rope",
    activation="swiglu",
    rope_base=10_000.0,
    eos_id=2,
    eos_text="</s>",
    dtype="bf16",
)

LLAMA3_CONFIG_8B = ModelConfig(
    name="llama3-8B",
    vocab_size=128_256,
    context_length=8192,
    emb_dim=4096,
    n_heads=32,
    n_layers=32,
    hidden_dim=14_336,
    n_kv_groups=8,
    norm="rmsnorm",
    positional="rope",
    activation="swiglu",
    rope_base=500_000.0,
    eos_id=128_001,
    eos_text="<|end_of_text|>",
    dtype="bf16",
)

LLAMA31_CONFIG_8B = LLAMA3_CONFIG_8B.replace(
    name="llama3_1-8B",
    context_length=131_072,
    rope_scaling=RopeScaling(
        factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_context_length=8192,
    ),
)

LLAMA32_CONFIG_1B = ModelConfig(
    name="llama3_2-1B",
    vocab_size=128_256,
    context_length=131_072,
    emb_dim=2048,
    n_heads=32,
    n_layers=16,
    hidden_dim=8192,
    n_kv_groups=8,
    norm="rmsnorm",
    positional="rope",
    activation="swiglu",
    rope_base=500_000.0,
    rope_scaling=RopeScaling(
        factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_context_length=8192,
    ),
    eos_id=128_001,
    eos_text="<|end_of_text|>",
    dtype="bf16",
)

LONGCTX_CONFIG_32K = ModelConfig(
    name="longctx-32k",
    vocab_size=50_257,
    context_length=32_768,
    emb_dim=1024,
    n_heads=16,
    n_layers=24,
    hidden_dim=4096,
    n_kv_groups=4,
    norm="rmsnorm",
    positional="rope",
    activation="swiglu",
    rope_base=500_000.0,
    eos_id=50_256,
    eos_text="<|endoftext|>",
    dtype="bf16",
)

MODEL_PARAMS_MAPPING = {
    "GPT2": ["124M", "355M", "774M", "1.5B"],
    "llama2": ["7B"],
    "llama3": ["8B"],
    "llama3_1": ["8B"],
    "llama3_2": ["1B"],
    "longctx": ["32k"],
}

_LLAMA_REGISTRY = {
    ("llama2", "7B"): LLAMA2_CONFIG_7B,
    ("llama3", "8B"): LLAMA3_CONFIG_8B,
    ("llama3_1", "8B"): LLAMA31_CONFIG_8B,
    ("llama3_2", "1B"): LLAMA32_CONFIG_1B,
    ("longctx", "32k"): LONGCTX_CONFIG_32K,
}


def get_config_gpt2(num_params: str) -> ModelConfig:
    num_params = str(num_params)
    if num_params not in GPT2_CONFIGS:
        raise ValueError(
            f"GPT-2 config for model '{num_params}' not found. "
            f"Available options: {list(GPT2_CONFIGS.keys())}"
        )
    return GPT2_CONFIGS[num_params]


def get_config_llama(num_params: str, model_name: str,
                     target_context_length: Optional[int] = 1024) -> ModelConfig:
    """Look up a LLaMA config; a truthy ``target_context_length`` clamps the
    context with a linear theta rescale (``None`` keeps the native one)."""
    key = (model_name, str(num_params))
    if key not in _LLAMA_REGISTRY:
        raise ValueError(
            f"A {model_name} model with {num_params} parameters does not exist."
        )
    cfg = _LLAMA_REGISTRY[key]
    if target_context_length and cfg.context_length != target_context_length:
        cfg = cfg.replace(
            rope_base=rescale_theta(cfg.rope_base, cfg.context_length,
                                    target_context_length),
            context_length=target_context_length,
        )
    return cfg


def get_config(model: str, num_params: str, *,
               dtype: Optional[str] = None,
               qkv_bias: Optional[bool] = None,
               use_actv_ckpt: bool = False,
               debug: bool = False,
               target_context_length: Optional[int] = 1024) -> ModelConfig:
    """Unified config builder: dtype injection, qkv_bias override and the
    ``--debug`` tiny-model shrink."""
    if model == "GPT2":
        cfg = get_config_gpt2(num_params)
    else:
        cfg = get_config_llama(num_params, model,
                               target_context_length=target_context_length)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if qkv_bias is not None:
        cfg = cfg.replace(qkv_bias=qkv_bias)
    if use_actv_ckpt:
        cfg = cfg.replace(use_actv_ckpt=True)
    if debug:
        cfg = cfg.replace(
            context_length=16,
            emb_dim=32,
            n_layers=2,
            n_heads=2,
            n_kv_groups=min(cfg.n_kv_groups, 2),
            hidden_dim=64,
        )
    return cfg
