"""The shared transformer core (port of the JAX package's
``models/transformer.py``): the full-sequence training/eval forward and the
serving forward passes.

One parameterised model covers GPT-2 and the LLaMA family. Parameters keep
the JAX package's layout so weights move between the two packages without a
transpose:

  - linear weights are (in, out) and applied as ``x @ w``;
  - ``head`` is (D, V); ``tok_emb`` (V, D); ``pos_emb`` (T, D) (GPT-2 only);
  - the flat names are the JAX tree's paths (``blocks/attn/wq``), and the
    ``blocks/...`` leaves are stacked on a leading layer axis. Each layer's
    module holds views of its slice of those stacked tensors.

``forward_hidden``/``forward`` are the training forward: parameters are
trainable once ``requires_grad_(True)`` is called (the trainer does), and
attention goes through ``ops.attention.causal_attention`` (the fused flash
kernels for the shapes they take). With a seed and ``deterministic=False``
a config's ``drop_rate`` drops the embedding output, the attention weights
and both residual branches of every block, each site with its own seed
(``utils.seeding.site_seed``); residual and embedding dropout go through
the fused kernel B3 (``ops/fused_dropout.py``) for the shapes it takes. No
activation checkpointing.

The serving functions (``prefill_into_slot``, ``decode_slots``) mirror the
JAX ones: the same masks, the same zeroed bucket pads, the same fp32 logits.
The decode step goes through the fused kernel (``ops/decode_step.py``)
whenever the cache shape is one the kernel takes. ``forward_with_cache`` is
the one-shot ``generate()``'s cached forward, with ``decode_attention`` over
the cache as the JAX default does. No adapters, no int8 or paged caches.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.ops.activations import gelu, silu
from building_llm_from_scratch_tpu_torch.ops.attention import (
    causal_attention,
    decode_attention,
    xla_attention,
)
from building_llm_from_scratch_tpu_torch.ops.decode_step import (
    fused_decode_step,
    fused_decode_step_plain,
)
from building_llm_from_scratch_tpu_torch.ops.fused_dropout import (
    fused_dropout,
    fused_dropout_add,
    supports_shape as dropout_supports_shape,
)
from building_llm_from_scratch_tpu_torch.ops.norms import layernorm, rmsnorm
from building_llm_from_scratch_tpu_torch.ops.philox import flat_keep_mask
from building_llm_from_scratch_tpu_torch.ops.rope import (
    apply_rope,
    precompute_rope_params,
)
from building_llm_from_scratch_tpu_torch.ops.xent_fwd import matmul_fp32
from building_llm_from_scratch_tpu_torch.utils.seeding import site_seed

Flat = Dict[str, torch.Tensor]

_BIASES = {"bq", "bk", "bv", "bo", "b_up", "b_down", "bias"}


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """JAX-path name -> shape of every parameter, as ``init_params`` builds."""
    L, D, V, T = cfg.n_layers, cfg.emb_dim, cfg.vocab_size, cfg.context_length
    hd, Hq, Hkv, F = cfg.head_dim, cfg.n_heads, cfg.n_kv_groups, cfg.hidden_dim
    s = {
        "tok_emb/weight": (V, D),
        "blocks/attn/wq": (L, D, Hq * hd),
        "blocks/attn/wk": (L, D, Hkv * hd),
        "blocks/attn/wv": (L, D, Hkv * hd),
        "blocks/attn/wo": (L, Hq * hd, D),
        "blocks/mlp/up": (L, D, F),
        "blocks/mlp/down": (L, F, D),
        "blocks/norm1/scale": (L, D),
        "blocks/norm2/scale": (L, D),
        "final_norm/scale": (D,),
        "head/weight": (D, V),
    }
    if cfg.qkv_bias:
        s.update({"blocks/attn/bq": (L, Hq * hd), "blocks/attn/bk": (L, Hkv * hd),
                  "blocks/attn/bv": (L, Hkv * hd)})
    if cfg.attn_out_bias:
        s["blocks/attn/bo"] = (L, D)
    if cfg.activation == "swiglu":
        s["blocks/mlp/gate"] = (L, D, F)
    if cfg.mlp_bias:
        s.update({"blocks/mlp/b_up": (L, F), "blocks/mlp/b_down": (L, D)})
    if cfg.norm_bias:
        s.update({"blocks/norm1/bias": (L, D), "blocks/norm2/bias": (L, D),
                  "final_norm/bias": (D,)})
    if cfg.positional == "learned":
        s["pos_emb/weight"] = (T, D)
    return s


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> Flat:
    """Seeded random init with the shapes of the JAX ``init_params``:
    truncated-normal (+-3 sigma) linears with std min(0.02, fan_in^-0.5),
    N(0, 0.02) embeddings, unit norm scales and zero biases. The values come
    from ``generator`` (which must live on ``device``), not from JAX's
    stream; weights are made on the device."""
    dt = cfg.torch_dtype
    out: Flat = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "scale":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif leaf in _BIASES:
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif name in ("tok_emb/weight", "pos_emb/weight"):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            t.normal_(0.0, 0.02, generator=generator)
            out[name] = t.to(dt)
        else:
            fan_in = shape[-2]
            std = min(0.02, fan_in ** -0.5)
            t = torch.empty(shape, dtype=torch.float32, device=device)
            nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                  generator=generator)
            out[name] = t.to(dt)
    return out


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.kind = cfg.norm
        self.eps = cfg.rmsnorm_eps if cfg.norm == "rmsnorm" else cfg.layernorm_eps
        self.scale = nn.Parameter(scale, requires_grad=False)
        self.bias = (nn.Parameter(bias, requires_grad=False)
                     if bias is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale, eps=self.eps)
        return layernorm(x, self.scale, self.bias, eps=self.eps)


class ParamGroup(nn.Module):
    """One layer's projection weights, by their JAX names: the attention's
    wq, wk, wv, wo (+ bq, bk, bv, bo) or the MLP's up, down (+ gate,
    + b_up, b_down)."""

    def __init__(self, layer: Flat):
        super().__init__()
        for k, v in layer.items():
            self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def has(self, name: str) -> bool:
        return name in self._parameters


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, flat: Flat, l: int):
        super().__init__()
        pick = lambda group: {  # noqa: E731
            k.split("/")[-1]: v[l] for k, v in flat.items()
            if k.startswith(f"blocks/{group}/")}
        n1, n2 = pick("norm1"), pick("norm2")
        self.norm1 = Norm(cfg, n1["scale"], n1.get("bias"))
        self.attn = ParamGroup(pick("attn"))
        self.norm2 = Norm(cfg, n2["scale"], n2.get("bias"))
        self.mlp = ParamGroup(pick("mlp"))


class Transformer(nn.Module):
    """The model: embeddings, L pre-norm blocks, final norm and LM head.

    ``flat`` maps JAX paths to tensors (stacked ``blocks/...`` leaves); the
    per-layer modules hold views of those tensors, so building the model
    copies nothing."""

    def __init__(self, cfg: ModelConfig, flat: Flat):
        super().__init__()
        expected = param_shapes(cfg)
        if set(flat) != set(expected):
            raise KeyError(f"parameters differ from the config's: missing "
                           f"{sorted(set(expected) - set(flat))}, unexpected "
                           f"{sorted(set(flat) - set(expected))}")
        for k, shape in expected.items():
            if tuple(flat[k].shape) != shape:
                raise ValueError(f"{k}: shape {tuple(flat[k].shape)} != {shape}")
        self.cfg = cfg
        #: the stacked JAX-layout leaves; every parameter below is one of
        #: them or a per-layer view of one (shared storage)
        self.stacked: Flat = dict(flat)
        self.tok_emb = nn.Parameter(flat["tok_emb/weight"], requires_grad=False)
        self.pos_emb = (nn.Parameter(flat["pos_emb/weight"], requires_grad=False)
                        if "pos_emb/weight" in flat else None)
        self.blocks = nn.ModuleList(Block(cfg, flat, l)
                                    for l in range(cfg.n_layers))
        self.final_norm = Norm(cfg, flat["final_norm/scale"],
                               flat.get("final_norm/bias"))
        self.head = nn.Parameter(flat["head/weight"], requires_grad=False)
        rope = None
        if cfg.uses_rope:
            rope = precompute_rope_params(
                cfg.head_dim, theta_base=cfg.rope_base,
                context_length=cfg.context_length,
                rope_scaling=cfg.rope_scaling, device=self.tok_emb.device)
        self.rope = rope

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def leaves(self):
        """(JAX path, layer index or None, parameter) for every parameter;
        a parameter with a layer index is that layer's view of the stacked
        leaf."""
        yield "tok_emb/weight", None, self.tok_emb
        yield "head/weight", None, self.head
        yield "final_norm/scale", None, self.final_norm.scale
        if self.pos_emb is not None:
            yield "pos_emb/weight", None, self.pos_emb
        if self.final_norm.bias is not None:
            yield "final_norm/bias", None, self.final_norm.bias
        for l, blk in enumerate(self.blocks):
            for group in ("norm1", "attn", "norm2", "mlp"):
                for name, p in getattr(blk, group).named_parameters():
                    yield f"blocks/{group}/{name}", l, p

    def attach_grads(self, grads: Flat) -> None:
        """Point every parameter's ``.grad`` at its slice of the stacked
        ``grads`` buffers (same names and shapes as ``stacked``). Autograd
        then accumulates each layer's gradient in place into the stacked
        buffer, so the optimizer updates whole stacked leaves; the caller
        zeroes ``grads`` before each backward."""
        for name, l, p in self.leaves():
            p.grad = grads[name] if l is None else grads[name][l]

    def flat_params(self) -> Flat:
        """JAX path -> stacked tensor (detached; the storage the
        parameters are views of)."""
        return {k: v.detach() for k, v in self.stacked.items()}


# ---------------------------------------------------------------------------
# building blocks (the JAX package's helpers of the same names)
# ---------------------------------------------------------------------------

def _embed(model: Transformer, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = model.tok_emb[tokens]
    if model.pos_emb is not None:
        x = x + model.pos_emb[positions]
    return x


def _qkv_proj(cfg: ModelConfig, p: ParamGroup, x: torch.Tensor, rope,
              positions: torch.Tensor):
    B, Tq, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.has("bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, Tq, -1, hd)
    k = k.reshape(B, Tq, -1, hd)
    v = v.reshape(B, Tq, -1, hd)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    return q, k, v


def _attn_out_proj(p: ParamGroup, out: torch.Tensor, B: int, Tq: int) -> torch.Tensor:
    out = out.reshape(B, Tq, -1) @ p.wo
    if p.has("bo"):
        out = out + p.bo
    return out


def _mlp(cfg: ModelConfig, p: ParamGroup, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        return (silu(x @ p.gate) * (x @ p.up)) @ p.down
    h = x @ p.up
    if p.has("b_up"):
        h = h + p.b_up
    h = gelu(h) @ p.down
    if p.has("b_down"):
        h = h + p.b_down
    return h


class _HeadLogits(torch.autograd.Function):
    """(N, D) @ (D, V) -> fp32 (N, V). The backward rounds the fp32
    cotangent to the model dtype on every device, and both gradient GEMMs
    run in that dtype with fp32 accumulation: the single-pass 16-bit
    product a TPU's matrix unit makes of an fp32 operand at default
    precision (a no-op for fp32 models)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return matmul_fp32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x2.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def _head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ w`` with fp32 accumulation (the JAX package's
    ``preferred_element_type=float32``), differentiable. On the card 16-bit
    inputs go through one GEMM with an fp32 output; elsewhere the operands
    are upcast first (products of 16-bit floats are exact in fp32, so the
    two are the same contraction)."""
    lead = x.shape[:-1]
    out = _HeadLogits.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# dropout (the JAX package's helpers of the same names)
# ---------------------------------------------------------------------------

def _dropout(x: torch.Tensor, rate: float, seed: Optional[int],
             deterministic: bool) -> torch.Tensor:
    """dropout(x): the fused kernel B3 for the shapes it takes (its twin on
    the CPU), else ``x / (1 - rate)`` on the kept elements, rounded in x's
    dtype as the JAX ``_dropout`` does, with the same mask function."""
    if rate <= 0.0 or deterministic:
        return x
    if dropout_supports_shape(x.shape):
        return fused_dropout(x, rate, seed)
    keep = flat_keep_mask(seed, x.shape, rate, x.device)
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _residual_dropout(x: torch.Tensor, h: torch.Tensor, rate: float,
                      seed: Optional[int], deterministic: bool) -> torch.Tensor:
    """x + dropout(h), the pre-norm residual update: one fused kernel for
    the shapes B3 takes."""
    if rate <= 0.0 or deterministic:
        return x + h
    if dropout_supports_shape(h.shape):
        return fused_dropout_add(x, h, rate, seed)
    return x + _dropout(h, rate, seed, deterministic)


# ---------------------------------------------------------------------------
# full-sequence forward (training / evaluation)
# ---------------------------------------------------------------------------

def forward_hidden(model: Transformer, tokens: torch.Tensor, *,
                   seed: Optional[int] = None,
                   deterministic: bool = True) -> torch.Tensor:
    """(B, T) token ids -> the final-normed (B, T, D) hidden states before
    the head (the JAX ``forward_hidden``). ``seed`` is the step's 64-bit
    dropout seed (None: deterministic); each dropout site draws from its own
    ``site_seed(seed, layer, site)``, as the JAX package splits its rng."""
    cfg = model.cfg
    B, T = tokens.shape
    if seed is None:
        deterministic = True
    rate = cfg.drop_rate

    def sites(layer: int, site: str) -> Optional[int]:
        return None if deterministic else site_seed(seed, layer, site)

    positions = torch.arange(T, device=tokens.device)
    x = _dropout(_embed(model, tokens, positions), rate,
                 sites(-1, "embedding"), deterministic)
    for layer, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions)
        out = causal_attention(q, k, v, dropout_rate=rate,
                               seed=sites(layer, "attention"),
                               deterministic=deterministic)
        x = _residual_dropout(x, _attn_out_proj(blk.attn, out, B, T), rate,
                              sites(layer, "residual1"), deterministic)
        x = _residual_dropout(x, _mlp(cfg, blk.mlp, blk.norm2(x)), rate,
                              sites(layer, "residual2"), deterministic)
    return model.final_norm(x)


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) token ids -> fp32 logits (B, T, V), without dropout."""
    return _head_logits(forward_hidden(model, tokens), model.head)


# ---------------------------------------------------------------------------
# slot cache + serving forward passes
# ---------------------------------------------------------------------------

def init_slot_cache(cfg: ModelConfig, n_slots: int, max_length: int,
                    device: torch.device | str) -> dict:
    """Per-layer (n_slots, Hkv, Tmax, hd) k/v buffers (serving/kvcache.py)."""
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        DEFAULT_POLICY,
    )

    return DEFAULT_POLICY.alloc(cfg, n_slots, max_length, device)


@torch.no_grad()
def prefill_into_slot(model: Transformer, tokens: torch.Tensor,
                      prompt_len: int, slot: int, cache: dict) -> torch.Tensor:
    """Run one prompt (``tokens`` (1, Tpb), right-padded to its bucket) and
    write its k/v panes into row ``slot`` of ``cache`` IN PLACE (positions
    [0, Tpb); pad positions are written as zeros, as in the JAX package).
    Returns the fp32 logits (V,) at the last real position."""
    cfg = model.cfg
    _, Tpb = tokens.shape
    dev = tokens.device
    positions = torch.arange(Tpb, device=dev)
    x = _embed(model, tokens, positions)
    valid = (positions < prompt_len)[None, :, None, None]
    kv_len = torch.tensor(prompt_len, device=dev)
    for blk, K, V in zip(model.blocks, cache["k"], cache["v"]):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions)
        out = xla_attention(q, k, v, q_positions=positions, kv_length=kv_len)
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=dev))
        v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=dev))
        K[slot, :, :Tpb] = k[0].transpose(0, 1)
        V[slot, :, :Tpb] = v[0].transpose(0, 1)
        x = x + _attn_out_proj(blk.attn, out, 1, Tpb)
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x))
    x = model.final_norm(x)
    last = x[:, prompt_len - 1: prompt_len]
    return _head_logits(last, model.head)[0, 0]


@torch.no_grad()
def decode_slots(model: Transformer, tokens: torch.Tensor,
                 lengths: torch.Tensor, cache: dict) -> torch.Tensor:
    """One decode tick for the whole slot batch: ``tokens`` (S, 1) are each
    slot's last accepted token and ``lengths`` (S,) int32 its valid prefix.
    Each layer appends its k/v at the row's length and attends, in one fused
    step: the kernel for a cache on the card (which raises on a shape it
    cannot take), its plain twin for a cache on the CPU. The caches are
    updated IN PLACE. Returns fp32 logits (S, V). Free slots compute rows the
    engine ignores; the shapes never change."""
    cfg = model.cfg
    S = tokens.shape[0]
    positions = lengths.long()[:, None]
    x = _embed(model, tokens, positions)
    step = (fused_decode_step if cache["k"][0].is_cuda
            else fused_decode_step_plain)
    for blk, K, V in zip(model.blocks, cache["k"], cache["v"]):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions)
        out, _, _ = step(q.contiguous(), k.to(K.dtype).contiguous(),
                         v.to(V.dtype).contiguous(), K, V, lengths)
        x = x + _attn_out_proj(blk.attn, out, S, 1)
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x))
    x = model.final_norm(x)
    return _head_logits(x, model.head)[:, 0]


@torch.no_grad()
def forward_with_cache(model: Transformer, tokens: torch.Tensor, cache: dict,
                       length: int) -> torch.Tensor:
    """The one-shot decode forward: ``tokens`` (B, Tq) at positions
    [length, length + Tq), their k/v written IN PLACE into the per-layer
    (B, Hkv, Tmax, hd) ``cache`` buffers there, attention over the first
    ``length + Tq`` positions (``decode_attention``). Returns fp32 logits
    (B, Tq, V). The caller keeps ``length + Tq <= Tmax``."""
    cfg = model.cfg
    B, Tq = tokens.shape
    positions = torch.arange(length, length + Tq, device=tokens.device)
    x = _embed(model, tokens, positions)
    for blk, K, V in zip(model.blocks, cache["k"], cache["v"]):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions)
        K[:, :, length:length + Tq] = k.transpose(1, 2).to(K.dtype)
        V[:, :, length:length + Tq] = v.transpose(1, 2).to(V.dtype)
        out = decode_attention(q, K, V, q_positions=positions,
                               kv_length=length + Tq)
        x = x + _attn_out_proj(blk.attn, out, B, Tq)
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x))
    x = model.final_norm(x)
    return _head_logits(x, model.head)


def build_model(cfg: ModelConfig, seed: int,
                device: torch.device | str = "cuda") -> Transformer:
    """A model with seeded random weights made on ``device``."""
    from building_llm_from_scratch_tpu_torch.device import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Transformer(cfg, init_params(cfg, gen, device))


__all__ = ["Transformer", "build_model", "decode_slots", "forward",
           "forward_hidden", "forward_with_cache", "init_params",
           "init_slot_cache", "param_shapes", "prefill_into_slot"]
