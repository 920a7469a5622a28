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
trainable once ``requires_grad_(True)`` is called (the pretraining trainer
does), and attention goes through ``ops.attention.causal_attention`` (the
fused flash kernels for the shapes they take). With a seed and
``deterministic=False`` a config's ``drop_rate`` drops the embedding
output, the attention weights and both residual branches of every block,
each site with its own seed (``utils.seeding.site_seed``); residual and
embedding dropout go through the fused kernel B3 (``ops/fused_dropout.py``)
for the shapes it takes. A config with ``use_actv_ckpt`` recomputes each
block in the backward (``torch.utils.checkpoint``, the JAX ``jax.remat``
of the block), with the same seeds, so the recomputed values are the
saved ones bit for bit. ``params=`` hands the forward stand-ins for any
of the model's leaves, stacked as the model holds them: a LoRA train step
passes the merged projection weights (W + s A@B,
``models.lora.merge_lora``), a precision policy's step the cast copy of
every leaf, so autograd carries their gradients back to the adapter or
the masters, as the JAX step trains through ``merge_lora`` and
``cast_floating``. ``lora=`` instead applies one adapter unmerged at
every adapted projection and the head (``forward``, ``forward_with_cache``
and ``generate``: the trainer's merge-free sampling).

The serving functions (``prefill_into_slot``, ``prefill_chunk_into_slot``,
``decode_slots`` and their paged siblings ``paged_prefill_chunk_into_slot``
and ``paged_decode_slots``) mirror the JAX ones: the same masks, the same
zeroed pads, the same fp32 logits. The contiguous decode step goes through
the fused kernel B5 and the paged one through the paged attention kernel B7
(``ops/decode_step.py``) for caches on the card, and through their plain
twins on the CPU. The paged k/v scatters and the chunks' attention are
plain tensor code, as the JAX package leaves them to XLA.
The serving functions take an optional ``adapter`` (a stacked pool of
LoRA adapters and each row's pool row, ``serving/adapters.py``) applied
unmerged at every adapted projection and the head. ``decode_slots`` sends
the block projections' deltas through the kernel B6 (``lora_bgmv``), as
the JAX package's ``_bgmv_block_adp`` does; the other slot functions
gather each row's adapter and apply it with plain products, as the JAX
package does by default. ``forward_with_cache`` is the one-shot
``generate()``'s cached forward, with ``decode_attention`` over the cache
as the JAX default does. No int8 caches.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.models.lora import apply_lora, lora_delta
from building_llm_from_scratch_tpu_torch.ops.activations import gelu, silu
from building_llm_from_scratch_tpu_torch.ops.attention import (
    causal_attention,
    decode_attention,
    xla_attention,
)
from building_llm_from_scratch_tpu_torch.ops.decode_step import (
    fused_decode_step,
    fused_decode_step_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_view,
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

    def forward(self, x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The norm with the module's scale and bias, or the stand-ins
        given (``forward_hidden(params=)``)."""
        scale = self.scale if scale is None else scale
        if self.kind == "rmsnorm":
            return rmsnorm(x, scale, eps=self.eps)
        return layernorm(x, scale, self.bias if bias is None else bias,
                         eps=self.eps)


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
           positions: torch.Tensor, params: Optional[Flat] = None
           ) -> torch.Tensor:
    params = params or {}
    x = params.get("tok_emb/weight", model.tok_emb)[tokens]
    if model.pos_emb is not None:
        x = x + params.get("pos_emb/weight", model.pos_emb)[positions]
    return x


def _adp_nodes(adp: Optional[dict]):
    """(node lookup, scale) of one group's adapter argument; no adapter
    gives None nodes, the exact base projection."""
    if adp is None:
        return (lambda _: None), None
    return adp.get, adp["s"]


def _qkv_proj(cfg: ModelConfig, p: ParamGroup, x: torch.Tensor, rope,
              positions: torch.Tensor, adp: Optional[dict] = None):
    """q/k/v projections (+ biases, head reshape, RoPE). ``adp``: the
    attention group's unmerged LoRA nodes (wq/wk/wv + ``"s"``), applied
    before the biases, the reshape and RoPE, where a merged weight's delta
    would land."""
    B, Tq, _ = x.shape
    hd = cfg.head_dim
    n, s = _adp_nodes(adp)
    q = apply_lora(x, p.wq, n("wq"), s)
    k = apply_lora(x, p.wk, n("wk"), s)
    v = apply_lora(x, p.wv, n("wv"), s)
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


def _attn_out_proj(p: ParamGroup, out: torch.Tensor, B: int, Tq: int,
                   adp: Optional[dict] = None) -> torch.Tensor:
    n, s = _adp_nodes(adp)
    out = apply_lora(out.reshape(B, Tq, -1), p.wo, n("wo"), s)
    if p.has("bo"):
        out = out + p.bo
    return out


def _mlp(cfg: ModelConfig, p: ParamGroup, x: torch.Tensor,
         adp: Optional[dict] = None) -> torch.Tensor:
    n, s = _adp_nodes(adp)
    if cfg.activation == "swiglu":
        g = apply_lora(x, p.gate, n("gate"), s)
        u = apply_lora(x, p.up, n("up"), s)
        return apply_lora(silu(g) * u, p.down, n("down"), s)
    h = apply_lora(x, p.up, n("up"), s)
    if p.has("b_up"):
        h = h + p.b_up
    h = apply_lora(gelu(h), p.down, n("down"), s)
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
# LoRA adapters of the slot functions: ``adapter`` = {"pool": stacked
# adapter tree (every leaf with a leading (capacity,) axis), "scaling":
# (capacity,) fp32, "ids": (rows,) int32}, id -1 the base model (exact zero
# delta). Adapter identity is data: any mix of ids runs the same code.
# ---------------------------------------------------------------------------

def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _block_adp(lb: dict, s) -> dict:
    """One layer's adapter argument: the attn/mlp nodes plus the scale."""
    return {"attn": dict(lb["attn"], s=s), "mlp": dict(lb["mlp"], s=s)}


def _adapter_rows(pool: dict, scaling: torch.Tensor, ids: torch.Tensor):
    """Each row's adapter gathered from the pool: ids clamp into range and
    a row with id -1 gets scale 0, so its delta is exactly zero whatever
    the clamped row holds. Returns (gathered tree, (rows,) fp32 scales)."""
    idx = ids.long().clamp(0, scaling.shape[0] - 1)
    s = torch.where(ids >= 0, scaling.index_select(0, idx),
                    torch.zeros((), dtype=scaling.dtype, device=scaling.device))
    return _tree_map(lambda a: a.index_select(0, idx), pool), s


def _slot_adapter_layers(adapter: Optional[dict], cfg: ModelConfig):
    """(per-layer adapter arguments, head node, scales) of the gathered
    path; all None without an adapter (the exact base path)."""
    if adapter is None:
        return None, None, None
    rows, s = _adapter_rows(adapter["pool"], adapter["scaling"], adapter["ids"])
    layers = [_block_adp(_tree_map(lambda a, l=l: a[:, l], rows["blocks"]), s)
              for l in range(cfg.n_layers)]
    return layers, rows["head"]["weight"], s


def _bgmv_adapter_layers(adapter: dict, cfg: ModelConfig):
    """``decode_slots``' adapter arguments: every block projection carries
    its layer's (N, in, r)/(N, r, out) slice of the pool, read in place by
    B6 (the twin on the CPU), which gathers each row's panes itself; the
    head's delta stays on the gathered path."""
    ids, scaling = adapter["ids"], adapter["scaling"]
    blocks = adapter["pool"]["blocks"]

    def group(name: str, l: int) -> dict:
        nodes = {proj: {"bgmv": (n["A"][:, l], n["B"][:, l], ids, scaling)}
                 for proj, n in blocks[name].items()}
        return dict(nodes, s=None)

    layers = [{"attn": group("attn", l), "mlp": group("mlp", l)}
              for l in range(cfg.n_layers)]
    head, s = _adapter_rows({"head": adapter["pool"]["head"]}, scaling, ids)
    return layers, head["head"]["weight"], s


def _logits(x: torch.Tensor, w: torch.Tensor, node: Optional[dict],
            s) -> torch.Tensor:
    """fp32 head logits plus the head's LoRA delta in fp32."""
    logits = _head_logits(x, w)
    if node is None:
        return logits
    return logits + lora_delta(x, node, s).float()


def _layer_adp(layers: Optional[list], l: int, group: str) -> Optional[dict]:
    return None if layers is None else layers[l][group]


def _lora_layers(lora: Optional[dict], scaling, n_layers: int):
    """(per-layer adapter arguments, head node) of one unmerged adapter
    tree shared by every row (``lora=``); None, None without one."""
    if lora is None:
        return None, None
    layers = [_block_adp(_tree_map(lambda a, l=l: a[l], lora["blocks"]), scaling)
              for l in range(n_layers)]
    return layers, lora["head"]["weight"]


class _Weights:
    """One layer's projection group read from stacked stand-in leaves (a
    LoRA step's merged weights, a policy's cast copy), the layer's own
    ``ParamGroup`` for the rest: the same attribute-by-JAX-name and
    ``has()`` interface."""

    def __init__(self, group: ParamGroup, leaves: Dict[str, torch.Tensor]):
        self._group, self._leaves = group, leaves

    def __getattr__(self, name: str):
        leaves = self.__dict__["_leaves"]
        return leaves[name] if name in leaves else getattr(self.__dict__["_group"], name)

    def has(self, name: str) -> bool:
        return self._group.has(name)


def _layer_groups(model: Transformer, params: Optional[Flat]) -> list:
    """(norm1, attn, norm2, mlp) of every layer: the norms as callables,
    the projections as weight groups. ``params``' stacked ``blocks/...``
    leaves replace the model's: each is split into its layers by one
    ``unbind(0)``, whose backward writes one stacked gradient (a per-layer
    index would allocate a zero stack per layer). Its other keys (the
    embeddings, the final norm and the head) are read where they are
    used."""
    if not params:
        return [(blk.norm1, blk.attn, blk.norm2, blk.mlp) for blk in model.blocks]
    per = [{"norm1": {}, "attn": {}, "norm2": {}, "mlp": {}} for _ in model.blocks]
    for key, t in params.items():
        root, *rest = key.split("/")
        if root != "blocks":
            continue
        group, leaf = rest
        for l, view in enumerate(t.unbind(0)):
            per[l][group][leaf] = view

    def norm(module: Norm, leaves: Flat):
        if not leaves:
            return module
        return lambda x: module(x, leaves.get("scale"), leaves.get("bias"))

    return [(norm(blk.norm1, p["norm1"]), _Weights(blk.attn, p["attn"]),
             norm(blk.norm2, p["norm2"]), _Weights(blk.mlp, p["mlp"]))
            for blk, p in zip(model.blocks, per)]


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
                   deterministic: bool = True,
                   params: Optional[Flat] = None,
                   lora: Optional[dict] = None,
                   lora_scaling=1.0) -> torch.Tensor:
    """(B, T) token ids -> the final-normed (B, T, D) hidden states before
    the head (the JAX ``forward_hidden``). ``seed`` is the step's 64-bit
    dropout seed (None: deterministic); each dropout site draws from its own
    ``site_seed(seed, layer, site)``, as the JAX package splits its rng.
    ``params``: stacked leaves that stand in for the model's (any of them;
    ``_layer_groups``). ``lora``: one unmerged adapter tree applied at
    every adapted block projection with ``lora_scaling`` (alpha / rank).
    With the config's ``use_actv_ckpt`` and autograd on, each block is
    recomputed in the backward."""
    cfg = model.cfg
    B, T = tokens.shape
    if seed is None:
        deterministic = True
    rate = cfg.drop_rate

    def sites(layer: int, site: str) -> Optional[int]:
        return None if deterministic else site_seed(seed, layer, site)

    params = params or {}
    adp, _ = _lora_layers(lora, lora_scaling, cfg.n_layers)
    positions = torch.arange(T, device=tokens.device)
    x = _dropout(_embed(model, tokens, positions, params), rate,
                 sites(-1, "embedding"), deterministic)

    def block(x, layer, norm1, attn, norm2, mlp):
        q, k, v = _qkv_proj(cfg, attn, norm1(x), model.rope, positions,
                            _layer_adp(adp, layer, "attn"))
        out = causal_attention(q, k, v, dropout_rate=rate,
                               seed=sites(layer, "attention"),
                               deterministic=deterministic)
        x = _residual_dropout(
            x, _attn_out_proj(attn, out, B, T, _layer_adp(adp, layer, "attn")),
            rate, sites(layer, "residual1"), deterministic)
        return _residual_dropout(
            x, _mlp(cfg, mlp, norm2(x), _layer_adp(adp, layer, "mlp")),
            rate, sites(layer, "residual2"), deterministic)

    remat = cfg.use_actv_ckpt and torch.is_grad_enabled()
    for layer, groups in enumerate(_layer_groups(model, params)):
        if remat:
            # the masks are keyed on (seed, element), not on torch's RNG,
            # so the recompute needs no RNG state
            x = checkpoint(block, x, layer, *groups, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, layer, *groups)
    return model.final_norm(x, params.get("final_norm/scale"),
                            params.get("final_norm/bias"))


def forward(model: Transformer, tokens: torch.Tensor, *,
            lora: Optional[dict] = None, lora_scaling=1.0) -> torch.Tensor:
    """(B, T) token ids -> fp32 logits (B, T, V), without dropout; with
    ``lora``, the adapter unmerged at every projection and the head (its
    delta in fp32)."""
    x = forward_hidden(model, tokens, lora=lora, lora_scaling=lora_scaling)
    head_node = None if lora is None else lora["head"]["weight"]
    return _logits(x, model.head, head_node, lora_scaling)


# ---------------------------------------------------------------------------
# slot cache + serving forward passes
# ---------------------------------------------------------------------------

def init_slot_cache(cfg: ModelConfig, n_slots: int, max_length: int,
                    device: torch.device | str, policy=None) -> dict:
    """Per-layer k/v buffers as ``policy`` (serving/kvcache.KVCachePolicy,
    default contiguous) lays them out: (n_slots, Hkv, Tmax, hd) rows, or a
    paged policy's (n_pages, Hkv, P, hd) pool."""
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        DEFAULT_POLICY,
    )

    return (policy or DEFAULT_POLICY).alloc(cfg, n_slots, max_length, device)


@torch.no_grad()
def prefill_into_slot(model: Transformer, tokens: torch.Tensor,
                      prompt_len: int, slot: int, cache: dict,
                      adapter: Optional[dict] = None) -> torch.Tensor:
    """Run one prompt (``tokens`` (1, Tpb), right-padded to its bucket) and
    write its k/v panes into row ``slot`` of ``cache`` IN PLACE (positions
    [0, Tpb); pad positions are written as zeros, as in the JAX package).
    ``adapter`` (ids (1,)): the request's LoRA adapter, gathered. Returns
    the fp32 logits (V,) at the last real position."""
    cfg = model.cfg
    _, Tpb = tokens.shape
    dev = tokens.device
    positions = torch.arange(Tpb, device=dev)
    x = _embed(model, tokens, positions)
    valid = (positions < prompt_len)[None, :, None, None]
    kv_len = torch.tensor(prompt_len, device=dev)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, (blk, K, V) in enumerate(zip(model.blocks, cache["k"], cache["v"])):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        out = xla_attention(q, k, v, q_positions=positions, kv_length=kv_len)
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=dev))
        v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=dev))
        K[slot, :, :Tpb] = k[0].transpose(0, 1)
        V[slot, :, :Tpb] = v[0].transpose(0, 1)
        x = x + _attn_out_proj(blk.attn, out, 1, Tpb, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    last = x[:, prompt_len - 1: prompt_len]
    return _logits(last, model.head, head_node, head_s)[0, 0]


def _chunk_positions(cfg: ModelConfig, chunk_start: int, C: int,
                     device) -> tuple:
    """(positions, lookup) of a C-token chunk: the chunk's absolute
    positions, and the same clipped to the context for the embedding and
    RoPE tables (only pad positions past the prompt can pass the end; the
    JAX gathers clamp them the same way)."""
    positions = torch.arange(chunk_start, chunk_start + C, device=device)
    return positions, positions.clamp(max=cfg.context_length - 1)


def _chunk_logits(model: Transformer, x: torch.Tensor, chunk_start: int,
                  prompt_len: int, head_node=None, head_s=None) -> torch.Tensor:
    """fp32 logits (V,) at the chunk row of position ``prompt_len - 1``,
    clamped into the chunk (plus the head's adapter delta)."""
    C = x.shape[1]
    idx = min(max(prompt_len - 1 - chunk_start, 0), C - 1)
    x = model.final_norm(x[:, idx:idx + 1])
    return _logits(x, model.head, head_node, head_s)[0, 0]


@torch.no_grad()
def prefill_chunk_into_slot(model: Transformer, tokens: torch.Tensor,
                            chunk_start: int, prompt_len: int, slot: int,
                            cache: dict,
                            adapter: Optional[dict] = None) -> torch.Tensor:
    """Chunked prefill (the JAX ``prefill_chunk_into_slot``): ``tokens``
    (1, C) are the prompt span [chunk_start, chunk_start + C), right-padded
    past ``prompt_len``, run against row ``slot`` whose positions
    [0, chunk_start) already hold valid k/v (earlier chunks or a copied
    prefix pane). The chunk's k/v are written IN PLACE (pad positions as
    zeros; the write start clamps so the chunk fits, like the JAX
    dynamic-update-slice) and the chunk attends over the slot's whole row
    with ``kv_length = min(chunk_start + C, prompt_len)``. ``adapter`` (ids
    (1,)): the request's LoRA adapter, gathered. Returns the fp32 logits
    (V,) at position ``prompt_len - 1`` (clamped into the chunk)."""
    cfg = model.cfg
    _, C = tokens.shape
    dev = tokens.device
    positions, lookup = _chunk_positions(cfg, chunk_start, C, dev)
    x = _embed(model, tokens, lookup)
    valid = (positions < prompt_len)[None, :, None, None]
    kv_len = torch.tensor([min(chunk_start + C, prompt_len)], device=dev)
    start = min(max(chunk_start, 0), cache["k"][0].shape[2] - C)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, (blk, K, V) in enumerate(zip(model.blocks, cache["k"], cache["v"])):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, lookup,
                            _layer_adp(adp, l, "attn"))
        K[slot, :, start:start + C] = torch.where(valid, k, zero)[0].transpose(0, 1)
        V[slot, :, start:start + C] = torch.where(valid, v, zero)[0].transpose(0, 1)
        out = decode_attention(q, K[slot:slot + 1], V[slot:slot + 1],
                               q_positions=positions[None, :], kv_length=kv_len)
        x = x + _attn_out_proj(blk.attn, out, 1, C, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    return _chunk_logits(model, x, chunk_start, prompt_len, head_node, head_s)


@torch.no_grad()
def decode_slots(model: Transformer, tokens: torch.Tensor,
                 lengths: torch.Tensor, cache: dict,
                 adapter: Optional[dict] = None) -> torch.Tensor:
    """One decode tick for the whole slot batch: ``tokens`` (S, 1) are each
    slot's last accepted token and ``lengths`` (S,) int32 its valid prefix.
    Each layer appends its k/v at the row's length and attends, in one fused
    step: the kernel for a cache on the card (which raises on a shape it
    cannot take), its plain twin for a cache on the CPU. The caches are
    updated IN PLACE. ``adapter`` (ids (S,) int32): per-slot LoRA adapters;
    every block projection's delta goes through B6 (``lora_bgmv``: the
    kernel for a pool on the card, the twin for one on the CPU), the head's
    through the gathered path. Returns fp32 logits (S, V). Free slots
    compute rows the engine ignores; the shapes never change."""
    cfg = model.cfg
    S = tokens.shape[0]
    positions = lengths.long()[:, None]
    x = _embed(model, tokens, positions)
    step = (fused_decode_step if cache["k"][0].is_cuda
            else fused_decode_step_plain)
    adp, head_node, head_s = (_bgmv_adapter_layers(adapter, cfg)
                              if adapter is not None else (None, None, None))
    for l, (blk, K, V) in enumerate(zip(model.blocks, cache["k"], cache["v"])):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        out, _, _ = step(q.contiguous(), k.to(K.dtype).contiguous(),
                         v.to(V.dtype).contiguous(), K, V, lengths)
        x = x + _attn_out_proj(blk.attn, out, S, 1, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    return _logits(x, model.head, head_node, head_s)[:, 0]


# ---------------------------------------------------------------------------
# paged KV: the slot rows' positions live in pages of one shared pool
# ((n_pages, Hkv, P, hd) per layer), addressed through a per-slot page
# table (S, M). Table entry 0 is the trash page: unallocated positions (a
# free row's garbage append, a chunk's pad tail) scatter there and are only
# ever read masked. The scatters are plain tensor indexing, as the JAX
# package leaves them to XLA.
# ---------------------------------------------------------------------------

def _paged_scatter(leaf: torch.Tensor, vals: torch.Tensor,
                   rows: torch.Tensor) -> None:
    """Write ``vals`` (R, Hkv, hd) into the pool ``leaf`` (N, Hkv, P, hd) at
    the flat pool rows ``rows`` (R * Hkv,) of ``_paged_rows``, IN PLACE: one
    ``index_copy_``, which costs the host a tenth of an advanced-index
    assignment."""
    hd = leaf.shape[-1]
    leaf.view(-1, hd).index_copy_(0, rows, vals.reshape(-1, hd).to(leaf.dtype))


def _paged_rows(page_table: torch.Tensor, pos: torch.Tensor, P: int, Hkv: int,
                cache_len: int) -> torch.Tensor:
    """Flat pool rows ((page * Hkv + head) * P + offset, position-major) of
    the logical positions ``pos`` (S, Tq) through the table (S, M), every
    kv head of each. Positions clamp to ``cache_len - 1`` (only ever binding
    for garbage lanes, which are masked everywhere)."""
    pos = pos.clamp(max=cache_len - 1)
    phys = page_table.long().gather(1, pos // P).reshape(-1, 1)
    heads = torch.arange(Hkv, device=pos.device)
    return ((phys * Hkv + heads) * P + (pos % P).reshape(-1, 1)).reshape(-1)


@torch.no_grad()
def paged_decode_slots(model: Transformer, tokens: torch.Tensor,
                       lengths: torch.Tensor, page_table: torch.Tensor,
                       cache: dict, cache_len: int,
                       adapter: Optional[dict] = None) -> torch.Tensor:
    """Paged sibling of ``decode_slots``: each layer scatters the rows' new
    k/v at their lengths through ``page_table`` ((S, M) int32) and attends
    over each row's pages. For pools on the card the attention is always
    the paged kernel B7 (which raises on what it cannot take); on the CPU
    its twin over the ``cache_len``-long row views, whose logits are
    bit-equal to the contiguous ``decode_slots``' without adapters.
    ``adapter`` (ids (S,)): per-slot LoRA adapters, gathered (as the JAX
    ``paged_decode_slots``). Returns fp32 logits (S, V)."""
    cfg = model.cfg
    S = tokens.shape[0]
    positions = lengths.long()[:, None]
    x = _embed(model, tokens, positions)
    K0 = cache["k"][0]
    rows = _paged_rows(page_table, positions, K0.shape[2], K0.shape[1], cache_len)
    if K0.is_cuda:
        attend = paged_decode_attention
    else:
        def attend(q, K, V, table, lens):
            return paged_decode_attention_plain(q, K, V, table, lens,
                                                cache_len=cache_len)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, (blk, K, V) in enumerate(zip(model.blocks, cache["k"], cache["v"])):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        _paged_scatter(K, k[:, 0], rows)
        _paged_scatter(V, v[:, 0], rows)
        out = attend(q.contiguous(), K, V, page_table, lengths)
        x = x + _attn_out_proj(blk.attn, out, S, 1, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    return _logits(x, model.head, head_node, head_s)[:, 0]


@torch.no_grad()
def paged_prefill_chunk_into_slot(model: Transformer, tokens: torch.Tensor,
                                  chunk_start: int, prompt_len: int,
                                  row_table: torch.Tensor, cache: dict,
                                  cache_len: int,
                                  adapter: Optional[dict] = None) -> torch.Tensor:
    """Paged sibling of ``prefill_chunk_into_slot``: the chunk's C positions
    scatter into the slot's pages through ``row_table`` ((1, M), the slot's
    table row), pad positions as zeros and positions past the allocated
    frontier onto the trash page, and the chunk attends over the slot's
    gathered ``cache_len``-long row view (plain ``decode_attention``, as in
    the JAX package). ``adapter`` (ids (1,)): the request's LoRA adapter,
    gathered. Returns the fp32 logits (V,) at ``prompt_len - 1``."""
    cfg = model.cfg
    _, C = tokens.shape
    dev = tokens.device
    positions, lookup = _chunk_positions(cfg, chunk_start, C, dev)
    x = _embed(model, tokens, lookup)
    valid = (positions < prompt_len)[None, :, None, None]
    kv_len = torch.tensor([min(chunk_start + C, prompt_len)], device=dev)
    K0 = cache["k"][0]
    rows = _paged_rows(row_table, positions[None, :], K0.shape[2], K0.shape[1],
                       cache_len)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, (blk, K, V) in enumerate(zip(model.blocks, cache["k"], cache["v"])):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, lookup,
                            _layer_adp(adp, l, "attn"))
        _paged_scatter(K, torch.where(valid, k, zero)[0], rows)
        _paged_scatter(V, torch.where(valid, v, zero)[0], rows)
        out = decode_attention(q, paged_view(K, row_table, cache_len),
                               paged_view(V, row_table, cache_len),
                               q_positions=positions[None, :], kv_length=kv_len)
        x = x + _attn_out_proj(blk.attn, out, 1, C, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    return _chunk_logits(model, x, chunk_start, prompt_len, head_node, head_s)


@torch.no_grad()
def forward_with_cache(model: Transformer, tokens: torch.Tensor, cache: dict,
                       length: int, lora: Optional[dict] = None,
                       lora_scaling=1.0) -> torch.Tensor:
    """The one-shot decode forward: ``tokens`` (B, Tq) at positions
    [length, length + Tq), their k/v written IN PLACE into the per-layer
    (B, Hkv, Tmax, hd) ``cache`` buffers there, attention over the first
    ``length + Tq`` positions (``decode_attention``). ``lora``: one adapter
    applied unmerged, as in ``forward``. Returns fp32 logits (B, Tq, V).
    The caller keeps ``length + Tq <= Tmax``."""
    cfg = model.cfg
    B, Tq = tokens.shape
    positions = torch.arange(length, length + Tq, device=tokens.device)
    x = _embed(model, tokens, positions)
    adp, head_node = _lora_layers(lora, lora_scaling, cfg.n_layers)
    for l, (blk, K, V) in enumerate(zip(model.blocks, cache["k"], cache["v"])):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        K[:, :, length:length + Tq] = k.transpose(1, 2).to(K.dtype)
        V[:, :, length:length + Tq] = v.transpose(1, 2).to(V.dtype)
        out = decode_attention(q, K, V, q_positions=positions,
                               kv_length=length + Tq)
        x = x + _attn_out_proj(blk.attn, out, B, Tq, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    return _logits(x, model.head, head_node, lora_scaling)


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
           "init_slot_cache", "paged_decode_slots",
           "paged_prefill_chunk_into_slot", "param_shapes",
           "prefill_chunk_into_slot", "prefill_into_slot"]
