"""State dict -> the port's flat stacked parameters, for every pretrained
family (the port's copy of the JAX package's ``weights/mappings.py``).

The same three name maps:

  - GPT-2 (HF ``GPT2Model`` / ``GPT2LMHeadModel`` naming: ``wte``,
    ``h.{b}.attn.c_attn`` ..., with or without the ``transformer.``
    prefix). HF GPT-2 keeps its linear weights in Conv1D layout (in, out),
    the port's layout, so nothing is transposed; the fused ``c_attn`` is
    split in thirds along its output axis (q, k, v), and the head is tied
    to ``wte`` (a copy of its transpose). The config must have
    ``qkv_bias``.
  - LLaMA-2 (Meta ``consolidated.00.pth`` naming: ``tok_embeddings``,
    ``layers.{l}.attention.wq`` ...), with the checkpoint's ``w1`` the
    gate, ``w3`` the up and ``w2`` the down projection.
  - LLaMA-3/3.1/3.2 (HF naming: ``model.embed_tokens``,
    ``self_attn.q_proj`` ...), with the head tied to the embedding when
    ``lm_head.weight`` is absent (LLaMA-3.2-1B ships tied).

LLaMA checkpoints hold torch ``Linear`` weights (out, in); they are
transposed into the port's (in, out). Every tensor passes a shape check.

The converters take a mapping of names to tensors (a lazy reader from
``weights/fetch.py``, whose tensors are read when asked for, or a plain
dict) and return ``{"blocks/attn/wq": tensor}`` with the blocks stacked on
a leading layer axis, the layout ``models.transformer.Transformer`` takes.
Each stacked leaf is allocated on the device in the model dtype and filled
one layer at a time, so the host holds one checkpoint tensor at a time
beyond what the reader maps.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.device import resolve_device

Flat = Dict[str, torch.Tensor]
StateDict = Mapping[str, torch.Tensor]


def _check(name: str, t: torch.Tensor, expected: Tuple[int, ...]) -> torch.Tensor:
    """Shape guard (the reference's ``assign_check``)."""
    if tuple(t.shape) != tuple(expected):
        raise ValueError(
            f"Shape mismatch for '{name}': checkpoint {tuple(t.shape)} vs "
            f"model {tuple(expected)}")
    return t


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x


def _get(sd: StateDict, name: str) -> torch.Tensor:
    if name not in sd:
        raise KeyError(f"Checkpoint is missing tensor '{name}'")
    return _tensor(sd[name])


class _Placer:
    """Allocates each leaf on the device in the model dtype and copies the
    checkpoint's tensors into it (``copy_`` casts and moves)."""

    def __init__(self, cfg: ModelConfig, device):
        self.dtype = cfg.torch_dtype
        self.device = resolve_device(device)

    def leaf(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=self.dtype, device=self.device)
        return out.copy_(t)

    def stacked(self, layers: List[Callable[[], torch.Tensor]],
                parts: int = 1) -> List[torch.Tensor]:
        """Stack the layers' tensors, each read only when its turn comes;
        ``parts`` > 1 cuts each along its last axis into that many equal
        leaves (GPT-2's fused q/k/v), reading it once."""
        outs = None
        for l, read in enumerate(layers):
            pieces = read().chunk(parts, dim=-1)
            if outs is None:
                outs = [torch.empty((len(layers), *p.shape), dtype=self.dtype,
                                    device=self.device) for p in pieces]
            for out, piece in zip(outs, pieces):
                out[l].copy_(piece)
        return outs


# ---------------------------------------------------------------------------
# GPT-2 (HF GPT2Model naming)
# ---------------------------------------------------------------------------

def _get_gpt2(sd: StateDict, name: str) -> torch.Tensor:
    """Fetch accepting both ``GPT2Model`` keys (``wte.weight``) and
    ``GPT2LMHeadModel`` keys (``transformer.wte.weight``)."""
    if name in sd:
        return _tensor(sd[name])
    if f"transformer.{name}" in sd:
        return _tensor(sd[f"transformer.{name}"])
    raise KeyError(f"Checkpoint is missing tensor '{name}'")


def convert_gpt2_state_dict(sd: StateDict, cfg: ModelConfig,
                            device="cuda") -> Flat:
    """HF GPT-2 state dict -> the port's flat stacked parameters on
    ``device``: wte/wpe, each block's fused ``c_attn`` split into q/k/v
    (weights and biases), ``c_proj``, ``c_fc``/``c_proj`` MLP, ``ln_1``/
    ``ln_2``/``ln_f``, and the head tied to ``wte``."""
    if not cfg.qkv_bias:
        raise ValueError(
            "GPT-2 HF checkpoints carry QKV biases; build the config with "
            "qkv_bias=True (--load_weights sets it for GPT2)")
    put = _Placer(cfg, device)
    L, D, V, T, F = (cfg.n_layers, cfg.emb_dim, cfg.vocab_size,
                     cfg.context_length, cfg.hidden_dim)

    def get(name: str, shape) -> torch.Tensor:
        return _check(name, _get_gpt2(sd, name), shape)

    def per_layer(template: str, shape, parts: int = 1):
        reads = [lambda b=b: get(template.format(b=b), shape) for b in range(L)]
        out = put.stacked(reads, parts)
        return out if parts > 1 else out[0]

    flat: Flat = dict(zip(
        ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv"),
        per_layer("h.{b}.attn.c_attn.weight", (D, 3 * D), parts=3)))
    flat.update(zip(("blocks/attn/bq", "blocks/attn/bk", "blocks/attn/bv"),
                    per_layer("h.{b}.attn.c_attn.bias", (3 * D,), parts=3)))
    flat.update({
        "blocks/attn/wo": per_layer("h.{b}.attn.c_proj.weight", (D, D)),
        "blocks/attn/bo": per_layer("h.{b}.attn.c_proj.bias", (D,)),
        "blocks/mlp/up": per_layer("h.{b}.mlp.c_fc.weight", (D, F)),
        "blocks/mlp/b_up": per_layer("h.{b}.mlp.c_fc.bias", (F,)),
        "blocks/mlp/down": per_layer("h.{b}.mlp.c_proj.weight", (F, D)),
        "blocks/mlp/b_down": per_layer("h.{b}.mlp.c_proj.bias", (D,)),
        "blocks/norm1/scale": per_layer("h.{b}.ln_1.weight", (D,)),
        "blocks/norm1/bias": per_layer("h.{b}.ln_1.bias", (D,)),
        "blocks/norm2/scale": per_layer("h.{b}.ln_2.weight", (D,)),
        "blocks/norm2/bias": per_layer("h.{b}.ln_2.bias", (D,)),
        "final_norm/scale": put.leaf(get("ln_f.weight", (D,))),
        "final_norm/bias": put.leaf(get("ln_f.bias", (D,))),
        "pos_emb/weight": put.leaf(get("wpe.weight", (T, D))),
        "tok_emb/weight": put.leaf(get("wte.weight", (V, D))),
    })
    # the tied head: the head is (D, V), applied as x @ w
    flat["head/weight"] = flat["tok_emb/weight"].t().contiguous()
    return flat


# ---------------------------------------------------------------------------
# LLaMA: one assembly for both namings
# ---------------------------------------------------------------------------

def _convert_llama(sd: StateDict, cfg: ModelConfig, names: Dict[str, str],
                   head_key: str, embed_key: str, device) -> Flat:
    """The port's flat stacked parameters from a per-layer name template
    map (``names``: the port's leaf -> a checkpoint name with ``{l}``).
    Linear weights are (out, in) in the checkpoint and transposed."""
    put = _Placer(cfg, device)
    L, D, V = cfg.n_layers, cfg.emb_dim, cfg.vocab_size
    hd, Hq, Hkv, F = cfg.head_dim, cfg.n_heads, cfg.n_kv_groups, cfg.hidden_dim

    def lin(key: str, out_dim: int, in_dim: int) -> torch.Tensor:
        def read(l: int) -> torch.Tensor:
            name = names[key].format(l=l)
            return _check(name, _get(sd, name), (out_dim, in_dim)).t()
        return put.stacked([lambda l=l: read(l) for l in range(L)])[0]

    def norm(key: str) -> torch.Tensor:
        def read(l: int) -> torch.Tensor:
            name = names[key].format(l=l)
            return _check(name, _get(sd, name), (D,))
        return put.stacked([lambda l=l: read(l) for l in range(L)])[0]

    flat: Flat = {
        "blocks/attn/wq": lin("wq", Hq * hd, D),
        "blocks/attn/wk": lin("wk", Hkv * hd, D),
        "blocks/attn/wv": lin("wv", Hkv * hd, D),
        "blocks/attn/wo": lin("wo", D, Hq * hd),
        "blocks/mlp/gate": lin("gate", F, D),
        "blocks/mlp/up": lin("up", F, D),
        "blocks/mlp/down": lin("down", D, F),
        "blocks/norm1/scale": norm("norm1"),
        "blocks/norm2/scale": norm("norm2"),
        "final_norm/scale": put.leaf(_check(names["final_norm"],
                                            _get(sd, names["final_norm"]), (D,))),
        "tok_emb/weight": put.leaf(_check(embed_key, _get(sd, embed_key), (V, D))),
    }
    if head_key in sd:
        flat["head/weight"] = put.leaf(
            _check(head_key, _get(sd, head_key), (V, D)).t())
    else:
        # weight tying fallback (reference load_weights_llama3.py:81-85)
        flat["head/weight"] = flat["tok_emb/weight"].t().contiguous()
    return flat


def convert_llama_meta_state_dict(sd: StateDict, cfg: ModelConfig,
                                  device="cuda") -> Flat:
    """Meta ``consolidated.00.pth`` naming (LLaMA-2) -> flat parameters.
    The checkpoint's ``w1`` feeds the gate, ``w3`` the up branch and ``w2``
    the down projection."""
    names = {
        "wq": "layers.{l}.attention.wq.weight",
        "wk": "layers.{l}.attention.wk.weight",
        "wv": "layers.{l}.attention.wv.weight",
        "wo": "layers.{l}.attention.wo.weight",
        "gate": "layers.{l}.feed_forward.w1.weight",
        "up": "layers.{l}.feed_forward.w3.weight",     # the swap
        "down": "layers.{l}.feed_forward.w2.weight",
        "norm1": "layers.{l}.attention_norm.weight",
        "norm2": "layers.{l}.ffn_norm.weight",
        "final_norm": "norm.weight",
    }
    return _convert_llama(sd, cfg, names, head_key="output.weight",
                          embed_key="tok_embeddings.weight", device=device)


def convert_llama_hf_state_dict(sd: StateDict, cfg: ModelConfig,
                                device="cuda") -> Flat:
    """HF naming (LLaMA-3/3.1/3.2) -> flat parameters, with the tied head
    when ``lm_head.weight`` is absent."""
    names = {
        "wq": "model.layers.{l}.self_attn.q_proj.weight",
        "wk": "model.layers.{l}.self_attn.k_proj.weight",
        "wv": "model.layers.{l}.self_attn.v_proj.weight",
        "wo": "model.layers.{l}.self_attn.o_proj.weight",
        "gate": "model.layers.{l}.mlp.gate_proj.weight",
        "up": "model.layers.{l}.mlp.up_proj.weight",
        "down": "model.layers.{l}.mlp.down_proj.weight",
        "norm1": "model.layers.{l}.input_layernorm.weight",
        "norm2": "model.layers.{l}.post_attention_layernorm.weight",
        "final_norm": "model.norm.weight",
    }
    return _convert_llama(sd, cfg, names, head_key="lm_head.weight",
                          embed_key="model.embed_tokens.weight", device=device)
