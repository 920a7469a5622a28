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
for the shapes it takes. Under autograd each block keeps only what its
backward needs (``remat_mode``): by default the JAX selective-save policy
(post-RoPE q, k, v, the attention's output and lse, resid_mid, up_out,
gate_out; ``_BlockFn``), whose backward recomputes the norms, the
activations and the residual adds onto those tensors and runs no GEMM or
attention forward again; with ``use_actv_ckpt`` the block's input alone
(the JAX ``jax.remat`` of the block), the whole block recomputed; with
``_SAVE_ALL`` (the comparison run) every activation. The seeds are the same, so the
three give the same loss and gradients bit for bit. ``par=`` (a
``parallel.tensor.Parallel``) runs a tensor-parallel rank's heads and
features, a sequence-parallel rank's T block (ring attention), and fsdp's
per-layer weight gathers. ``params=`` hands the forward stand-ins for any
of the model's leaves, stacked as the model holds them: a LoRA train step
passes the merged projection weights (W + s A@B,
``models.lora.merge_lora``), a precision policy's step the cast copy of
every leaf, so autograd carries their gradients back to the adapter or
the masters, as the JAX step trains through ``merge_lora`` and
``cast_floating``. ``lora=`` instead applies one adapter unmerged at
every adapted projection and the head (``forward``, ``forward_with_cache``
and ``generate``: the trainer's merge-free sampling). ``stage_forward`` is
one pipeline stage's share of the same forward (``parallel/pipeline.py``):
the embedding on the first stage, then the stage's blocks through the same
machinery.

The serving functions (``prefill_into_slot``, ``prefill_chunk_into_slot``,
``decode_slots``, the speculative ``verify_slots`` and the paged siblings
``paged_prefill_chunk_into_slot``, ``paged_decode_slots`` and
``paged_verify_slots``) mirror the JAX ones: the same masks, the same
zeroed pads, the same fp32 logits. The contiguous decode step goes through
the fused kernel B5 and the paged one through the paged attention kernel B7
(``ops/decode_step.py``) for model-dtype caches on the card, and through
their plain twins on the CPU. The paged k/v scatters, the chunks' and the
verify's attention and every read of an int8 cache (quantized on write,
its scales folded into ``decode_attention``) are plain tensor code, as the
JAX package leaves them to XLA.
The serving functions take an optional ``adapter`` (a stacked pool of
LoRA adapters and each row's pool row, ``serving/adapters.py``) applied
unmerged at every adapted projection and the head. ``decode_slots`` sends
the block projections' deltas through the kernel B6 (``lora_bgmv``), as
the JAX package's ``_bgmv_block_adp`` does; the other slot functions
gather each row's adapter and apply it with plain products, as the JAX
package does by default. ``forward_with_cache`` is the one-shot
``generate()``'s cached forward, with ``decode_attention`` over the cache
as the JAX default does (model-dtype caches only).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

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
    quantize_kv,
    slot_cache_append,
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
    apply_rope_backward,
    precompute_rope_params,
)
from building_llm_from_scratch_tpu_torch.ops.xent_fwd import matmul_fp32
from building_llm_from_scratch_tpu_torch.serving.kvcache import (
    DEFAULT_POLICY,
    cache_is_quantized,
)
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
    copies nothing. ``shapes`` False takes leaves of other shapes than the
    config's (a tensor-parallel rank's slices of them)."""

    def __init__(self, cfg: ModelConfig, flat: Flat, shapes: bool = True):
        super().__init__()
        expected = param_shapes(cfg)
        if set(flat) != set(expected):
            raise KeyError(f"parameters differ from the config's: missing "
                           f"{sorted(set(expected) - set(flat))}, unexpected "
                           f"{sorted(set(flat) - set(expected))}")
        for k, shape in expected.items():
            if shapes and tuple(flat[k].shape) != shape:
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


def _layer_weights(model: Transformer, params: Optional[Flat]) -> list:
    """Every layer's weights by "<group>/<leaf>" ("norm1/scale", "attn/wq",
    ...): the model's per-layer parameters, with ``params``' stacked
    ``blocks/...`` leaves in their place, each split into its layers by one
    ``unbind(0)``, whose backward writes one stacked gradient (a per-layer
    index would allocate a zero stack per layer). ``params``' other keys
    (the embeddings, the final norm and the head) are read where they are
    used."""
    per = [{} for _ in model.blocks]
    for l, blk in enumerate(model.blocks):
        for group in ("norm1", "attn", "norm2", "mlp"):
            for name, p in getattr(blk, group).named_parameters():
                per[l][f"{group}/{name}"] = p
    for key, t in (params or {}).items():
        root, *rest = key.split("/")
        if root != "blocks":
            continue
        for l, view in enumerate(t.unbind(0)):
            per[l]["/".join(rest)] = view
    return per


# ---------------------------------------------------------------------------
# dropout (the JAX package's helpers of the same names)
# ---------------------------------------------------------------------------

def _dropout(x: torch.Tensor, rate: float, seed: Optional[int],
             deterministic: bool, layout=None) -> torch.Tensor:
    """dropout(x): the fused kernel B3 for the shapes it takes (its twin on
    the CPU), else ``x / (1 - rate)`` on the kept elements, rounded in x's
    dtype as the JAX ``_dropout`` does, with the same mask function.
    ``layout``: x is a sequence-parallel block, whose mask is its part of
    the whole activation's (``parallel.tensor.Parallel.drop_layout``)."""
    if rate <= 0.0 or deterministic:
        return x
    if dropout_supports_shape(x.shape):
        return fused_dropout(x, rate, seed, layout)
    keep = flat_keep_mask(seed, x.shape, rate, x.device, layout)
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _residual_dropout(x: torch.Tensor, h: torch.Tensor, rate: float,
                      seed: Optional[int], deterministic: bool,
                      layout=None) -> torch.Tensor:
    """x + dropout(h), the pre-norm residual update: one fused kernel for
    the shapes B3 takes."""
    if rate <= 0.0 or deterministic:
        return x + h
    if dropout_supports_shape(h.shape):
        return fused_dropout_add(x, h, rate, seed, layout)
    return x + _dropout(h, rate, seed, deterministic, layout)


# ---------------------------------------------------------------------------
# full-sequence forward (training / evaluation)
# ---------------------------------------------------------------------------

# the training block: one pre-norm layer, written once over an ``ops``
# object that says how each of its expensive steps runs (autograd, a record
# of the named tensors, or a rebuild from them)

#: the tensors a block keeps for its backward under selective-save remat
#: (the JAX ``save_only_these_names`` policy); "attn_lse" with "attn_out"
#: is the fused kernel's or the ring's log-sum-exp
SAVED_NAMES = ("q", "k", "v", "attn_out", "attn_lse", "resid_mid", "up_out",
               "gate_out")


#: save every activation instead (remat mode "none"): the comparison run
#: that the tests and ``chip_smoke.py`` switch on; no flag sets it
_SAVE_ALL = False


def remat_mode(cfg: ModelConfig) -> str:
    """How a training block keeps what its backward needs: "full" with the
    config's ``use_actv_ckpt`` (recompute the block), else "selective" (the
    JAX policy: save ``SAVED_NAMES``, recompute the norms, activations and
    residual adds), or "none" (save every activation) where ``_SAVE_ALL``
    is set."""
    if cfg.use_actv_ckpt:
        return "full"
    return "none" if _SAVE_ALL else "selective"


class _Env:
    """What one layer's block needs besides its input and weights."""

    def __init__(self, cfg, layer, rope, positions, rate, deterministic, seeds,
                 par, adp=None):
        self.cfg, self.layer, self.rope, self.positions = cfg, layer, rope, positions
        self.rate, self.deterministic, self.par, self.adp = (rate, deterministic,
                                                             par, adp)
        self.seeds = seeds

    def seed(self, site: str) -> Optional[int]:
        return self.seeds(self.layer, site)

    def attention_kind(self, q: torch.Tensor, k: torch.Tensor) -> str:
        """"ring" under sp, "flash" for the shapes B1/B2 take, else "xla"."""
        from building_llm_from_scratch_tpu_torch.ops.fused_attention import (
            supports_shape,
        )

        if self.par.sp:
            return "ring"
        return "flash" if supports_shape(q.shape[1], k.shape[1], q.shape[3]) else "xla"

    def _attn_args(self, q: torch.Tensor) -> dict:
        rate = 0.0 if self.deterministic else self.rate
        return dict(rate=rate, seed=int(self.seed("attention") or 0),
                    h0=self.par.head_offset(q.shape[2]))

    def _ring(self, q: torch.Tensor) -> dict:
        a = self._attn_args(q)
        return dict(group=self.par.seq_group, n=self.par.n_seq,
                    rank=self.par.seq_rank, **a)

    def attend(self, q, k, v) -> torch.Tensor:
        """Differentiable attention (autograd saves its residuals)."""
        kind = self.attention_kind(q, k)
        if kind == "ring":
            from building_llm_from_scratch_tpu_torch.ops.ring_attention import (
                RingAttention,
            )

            return RingAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), self._ring(q))
        a = self._attn_args(q)
        return causal_attention(q, k, v, dropout_rate=a["rate"],
                                seed=self.seed("attention"),
                                deterministic=self.deterministic, h0=a["h0"])

    def attend_fwd(self, q, k, v):
        """(out, lse) of the kernel or the ring (no graph)."""
        if self.attention_kind(q, k) == "ring":
            from building_llm_from_scratch_tpu_torch.ops.ring_attention import (
                ring_attention_fwd,
            )

            return ring_attention_fwd(q.contiguous(), k.contiguous(),
                                      v.contiguous(), **self._ring(q))
        from building_llm_from_scratch_tpu_torch.ops.fused_attention import (
            flash_attention_fwd,
        )

        a = self._attn_args(q)
        return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                   a["rate"], a["seed"], a["h0"])

    def attend_bwd(self, q, k, v, out, lse, do):
        if self.attention_kind(q, k) == "ring":
            from building_llm_from_scratch_tpu_torch.ops.ring_attention import (
                ring_attention_bwd,
            )

            return ring_attention_bwd(q, k, v, out, lse, do, **self._ring(q))
        from building_llm_from_scratch_tpu_torch.ops.fused_attention import (
            flash_backward,
        )

        a = self._attn_args(q)
        return flash_backward(q, k, v, out, lse, do, a["rate"], a["seed"], a["h0"])

    def resid(self, x, h, site: str) -> torch.Tensor:
        return _residual_dropout(x, h, self.rate, self.seed(site), self.deterministic,
                                 self.par.drop_layout(h.shape))


class _Plain:
    """Every step through autograd (save-all, full remat's recompute,
    evaluation); under ``no_grad``, a block's plain forward."""

    def __init__(self, env: _Env):
        self.env = env

    def enter(self, h):
        return self.env.par.copy_to_model(h)

    def linear(self, x, w, node=None, s=None):
        return apply_lora(x, w, node, s)

    def name(self, t, name: str):
        return t

    def rope(self, t):
        cos, sin = self.env.rope
        return apply_rope(t, cos, sin, self.env.positions)

    def attention(self, q, k, v):
        return self.env.attend(q, k, v)

    def leave(self, a):
        return self.env.par.reduce_from_model(a)

    def resid(self, x, h, site: str):
        return self.env.resid(x, h, site)


class _Record(_Plain):
    """The forward of a selective block (under ``no_grad``), keeping the
    named tensors, the attention's out and lse among them."""

    def __init__(self, env: _Env):
        super().__init__(env)
        self.saved: Flat = {}

    def name(self, t, name: str):
        self.saved[name] = t
        return t

    def attention(self, q, k, v):
        if self.env.attention_kind(q, k) == "xla":
            # no kernel residuals: the backward recomputes it from q, k, v
            return self.env.attend(q, k, v)
        out, lse = self.env.attend_fwd(q, k, v)
        self.saved["attn_lse"] = lse
        return out


class _Value(torch.autograd.Function):
    """A named tensor in the rebuilt graph: its recorded value forward,
    the identity backward."""

    @staticmethod
    def forward(ctx, t, value):
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Linear(torch.autograd.Function):
    """``x @ w`` in the rebuilt graph: an unused placeholder forward (the
    value that matters comes from a ``_Value`` after it), the matmul's
    backward: dx = g w^T, dw = x^T g on the 2-d folds, as autograd's own
    mm backward computes them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.new_empty(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = g2.mm(w.t()).view(x.shape) if ctx.needs_input_grad[0] else None
        dw = x.reshape(-1, x.shape[-1]).t().mm(g2) if ctx.needs_input_grad[1] else None
        return dx, dw


class _Rope(torch.autograd.Function):
    """RoPE in the rebuilt graph: an unused placeholder forward (a
    ``_Value`` gives q and k their values), the rotation's backward, which
    needs only the tables."""

    @staticmethod
    def forward(ctx, t, env):
        ctx.env = env
        return torch.empty_like(t)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.env.rope
        return apply_rope_backward(g, cos, sin, ctx.env.positions), None


class _Attention(torch.autograd.Function):
    """The attention in the rebuilt graph: the recorded output forward, the
    kernel's (or the ring's) backward from the recorded q, k, v, out and
    lse."""

    @staticmethod
    def forward(ctx, q, k, v, env, saved):
        ctx.env, ctx.saved = env, saved
        out = saved["attn_out"]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, do):
        s = ctx.saved
        dq, dk, dv = ctx.env.attend_bwd(s["q"], s["k"], s["v"], s["attn_out"],
                                        s["attn_lse"], do.contiguous())
        return dq, dk, dv, None, None


class _Resid(torch.autograd.Function):
    """x + dropout(h) in the rebuilt graph: an unused placeholder forward
    (a ``_Value`` gives resid_mid its value), the backward dx = g and dh
    = B3's backward (or the plain mask's, or g without dropout)."""

    @staticmethod
    def forward(ctx, x, h, env, site):
        ctx.env, ctx.site = env, site
        return torch.empty_like(h)

    @staticmethod
    def backward(ctx, g):
        env = ctx.env
        if env.rate <= 0.0 or env.deterministic:
            dh = g
        elif dropout_supports_shape(g.shape):
            from building_llm_from_scratch_tpu_torch.ops.fused_dropout import (
                dropout_bwd,
            )

            dh = dropout_bwd(g.contiguous(), env.seed(ctx.site), env.rate,
                             env.par.drop_layout(g.shape))
        else:
            # the plain mask's backward, through autograd as the forward ran
            with torch.enable_grad():
                hl = torch.zeros_like(g).requires_grad_(True)
                y = _dropout(hl, env.rate, env.seed(ctx.site), False,
                             env.par.drop_layout(g.shape))
                (dh,) = torch.autograd.grad(y, hl, g)
        return (g if ctx.needs_input_grad[0] else None), dh, None, None


class _Recompute(_Plain):
    """The backward's graph of a fully rematerialised block: every step
    recomputed by autograd, but the last residual add, whose value nothing
    in the backward reads (its dropout is not drawn again)."""

    def resid(self, x, h, site: str):
        if site == "residual2":
            return _Resid.apply(x, h, self.env, site)
        return super().resid(x, h, site)


class _Rebuild(_Plain):
    """The backward's graph of a selective block: the norms, activations
    and residual adds recomputed by autograd, every matmul and the
    attention grafted onto the recorded tensors, so no GEMM and no
    attention kernel runs forward again."""

    def __init__(self, env: _Env, saved: Flat):
        super().__init__(env)
        self.saved = saved

    def linear(self, x, w, node=None, s=None):
        return _Linear.apply(x, w)

    def name(self, t, name: str):
        return _Value.apply(t, self.saved[name])

    def rope(self, t):
        return _Rope.apply(t, self.env)

    def attention(self, q, k, v):
        if "attn_lse" not in self.saved:
            return self.env.attend(q, k, v)
        return _Attention.apply(q, k, v, self.env, self.saved)

    def leave(self, a):
        # g's backward is the identity, and the value is a placeholder
        return a

    def resid(self, x, h, site: str):
        return _Resid.apply(x, h, self.env, site)


def _norm(cfg: ModelConfig, x: torch.Tensor, w: Flat, group: str) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, w[f"{group}/scale"], eps=cfg.rmsnorm_eps)
    return layernorm(x, w[f"{group}/scale"], w.get(f"{group}/bias"),
                     eps=cfg.layernorm_eps)


def _block(env: _Env, x: torch.Tensor, w: Flat, ops) -> torch.Tensor:
    """One pre-norm block (the JAX ``_block``): attention and MLP, each with
    its residual dropout; Megatron's f before the column-parallel
    projections and g after the row-parallel ones under tp, their
    replicated biases added once, after g."""
    cfg = env.cfg
    B, T, _ = x.shape
    hd = cfg.head_dim
    adp = env.adp or {}
    a_n, a_s = _adp_nodes(adp.get("attn"))
    m_n, m_s = _adp_nodes(adp.get("mlp"))
    h = ops.enter(_norm(cfg, x, w, "norm1"))
    q = ops.linear(h, w["attn/wq"], a_n("wq"), a_s)
    k = ops.linear(h, w["attn/wk"], a_n("wk"), a_s)
    v = ops.linear(h, w["attn/wv"], a_n("wv"), a_s)
    if "attn/bq" in w:
        q, k, v = q + w["attn/bq"], k + w["attn/bk"], v + w["attn/bv"]
    q, k, v = (t.reshape(B, T, -1, hd) for t in (q, k, v))
    if env.rope is not None:
        q, k = ops.rope(q), ops.rope(k)
    q, k, v = ops.name(q, "q"), ops.name(k, "k"), ops.name(v, "v")
    out = ops.name(ops.attention(q, k, v), "attn_out")
    a = ops.leave(ops.linear(out.reshape(B, T, -1), w["attn/wo"], a_n("wo"), a_s))
    if "attn/bo" in w:
        a = a + w["attn/bo"]
    x = ops.name(ops.resid(x, a, "residual1"), "resid_mid")
    h = ops.enter(_norm(cfg, x, w, "norm2"))
    if cfg.activation == "swiglu":
        g = ops.name(ops.linear(h, w["mlp/gate"], m_n("gate"), m_s), "gate_out")
        u = ops.name(ops.linear(h, w["mlp/up"], m_n("up"), m_s), "up_out")
        h = silu(g) * u
    else:
        u = ops.linear(h, w["mlp/up"], m_n("up"), m_s)
        if "mlp/b_up" in w:
            u = u + w["mlp/b_up"]
        h = gelu(ops.name(u, "up_out"))
    d = ops.leave(ops.linear(h, w["mlp/down"], m_n("down"), m_s))
    if "mlp/b_down" in w:
        d = d + w["mlp/b_down"]
    return ops.resid(x, d, "residual2")


class _BlockRun:
    """One layer's block under ``_BlockFn``: the layer's weights by name
    (``keys``, in the order of the Function's tensor inputs), fsdp's
    per-layer weight source for the rest, and the remat mode."""

    def __init__(self, env: _Env, keys: list, source, selective: bool):
        self.env, self.keys, self.source, self.selective = env, keys, source, selective

    def weights(self, tensors) -> Flat:
        w = dict(zip(self.keys, tensors))
        if self.source is not None:
            w.update(self.source.acquire(self.env.layer))
        return w


class _BlockFn(torch.autograd.Function):
    """A block that keeps only what its backward needs: under selective
    remat the named tensors (``SAVED_NAMES``), under full remat its input
    alone; the backward rebuilds the block's graph (grafted onto the
    record, or recomputed) and differentiates it. Under fsdp the source
    gathers the layer's sharded weights before the forward and again before
    the backward, and reduce-scatters their gradients as soon as the
    layer's backward has made them."""

    @staticmethod
    def forward(ctx, x, run: _BlockRun, *tensors):
        ops = _Record(run.env) if run.selective else _Plain(run.env)
        with torch.no_grad():
            y = _block(run.env, x, run.weights(tensors), ops)
        saved = ops.saved if run.selective else {}
        ctx.run, ctx.names, ctx.n = run, list(saved), len(tensors)
        ctx.save_for_backward(x, *tensors, *saved.values())
        return y

    @staticmethod
    def backward(ctx, g):
        run = ctx.run
        x, *rest = ctx.saved_tensors
        tensors, saved = rest[:ctx.n], dict(zip(ctx.names, rest[ctx.n:]))
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            xr = x.detach().requires_grad_(needs[0])
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(tensors, needs[2:])]
            w = dict(zip(run.keys, leaves))
            held = {}
            if run.source is not None:
                held = {k: t.detach().requires_grad_(True)
                        for k, t in run.source.acquire(run.env.layer).items()}
                w.update(held)
            ops = _Rebuild(run.env, saved) if run.selective else _Recompute(run.env)
            y = _block(run.env, xr, w, ops)
            inputs = ([xr] if needs[0] else []) + [t for t in leaves if t.requires_grad]
            grads = list(torch.autograd.grad(y, inputs + list(held.values()), g,
                                             allow_unused=True))
        dx = grads.pop(0) if needs[0] else None
        dws = [grads.pop(0) if t.requires_grad else None for t in leaves]
        if run.source is not None:
            run.source.reduce(run.env.layer, dict(zip(held, grads)))
        return (dx, None, *dws)


def forward_hidden(model: Transformer, tokens: torch.Tensor, *,
                   seed: Optional[int] = None,
                   deterministic: bool = True,
                   params: Optional[Flat] = None,
                   lora: Optional[dict] = None,
                   lora_scaling=1.0,
                   par=None) -> torch.Tensor:
    """(B, T) token ids -> the final-normed (B, T, D) hidden states before
    the head (the JAX ``forward_hidden``). ``seed`` is the step's 64-bit
    dropout seed (None: deterministic); each dropout site draws from its own
    ``site_seed(seed, layer, site)``, as the JAX package splits its rng.
    ``params``: stacked leaves that stand in for the model's (any of them;
    ``_layer_weights``). ``lora``: one unmerged adapter tree applied at
    every adapted block projection with ``lora_scaling`` (alpha / rank).
    ``par`` (``parallel.tensor.Parallel``): this rank's part of a tensor-
    or sequence-parallel forward (its heads and features, its T block at
    global positions) and fsdp's per-layer weight source.

    With autograd on, each block keeps what ``remat_mode`` says: the named
    tensors (selective, the default), its input alone (full remat,
    ``use_actv_ckpt``) or every activation; the first two run through
    ``_BlockFn``, whose backward rebuilds the block with the same seeds, so
    every mode gives the same loss and gradients bit for bit."""
    from building_llm_from_scratch_tpu_torch.parallel.tensor import SINGLE

    par = par or SINGLE
    if seed is None:
        deterministic = True

    def sites(layer: int, site: str) -> Optional[int]:
        return None if deterministic else site_seed(seed, layer, site)

    params = params or {}
    adp, _ = _lora_layers(lora, lora_scaling, model.cfg.n_layers)
    positions = par.positions(tokens.shape[1], tokens.device)
    x = _embedding(model, tokens, positions, params, sites, deterministic, par)
    x = _blocks(model, x, positions, params, sites, deterministic, par, adp)
    return model.final_norm(x, params.get("final_norm/scale"),
                            params.get("final_norm/bias"))


def _embedding(model: Transformer, tokens: torch.Tensor, positions: torch.Tensor,
               params: Flat, sites, deterministic: bool, par) -> torch.Tensor:
    """The token (and position) embedding with its dropout."""
    tok_emb = params.get("tok_emb/weight", model.tok_emb)
    x = (par.vocab_embed(tok_emb, tokens) if par.vocab_parallel_emb
         else tok_emb[tokens])
    if model.pos_emb is not None:
        x = x + params.get("pos_emb/weight", model.pos_emb)[positions]
    return _dropout(x, model.cfg.drop_rate, sites(-1, "embedding"), deterministic,
                    par.drop_layout(x.shape))


def _blocks(model: Transformer, x: torch.Tensor, positions: torch.Tensor,
            params: Flat, sites, deterministic: bool, par, adp) -> torch.Tensor:
    """Every block of ``model`` in turn (``sites(layer, site)``: each
    dropout site's seed), each keeping what ``remat_mode`` says."""
    cfg = model.cfg
    source = par.layers
    mode = remat_mode(cfg)
    grad = torch.is_grad_enabled()
    if source is not None and mode == "none":
        raise ValueError("save-all remat keeps every layer's gathered weights; "
                         "fsdp's per-layer gathers need selective or full remat")
    for layer, w in enumerate(_layer_weights(model, params)):
        env = _Env(cfg, layer, model.rope, positions, cfg.drop_rate, deterministic,
                   sites, par, None if adp is None else adp[layer])
        if grad and adp is None and mode != "none":
            keys = [k for k in w if source is None or k not in source.names]
            run = _BlockRun(env, keys, source, mode == "selective")
            x = _BlockFn.apply(x, run, *(w[k] for k in keys))
            continue
        if source is not None:
            w = dict(w, **source.acquire(layer))
        x = _block(env, x, w, _Plain(env))
    return x


def stage_forward(model: Transformer, x: Optional[torch.Tensor] = None, *,
                  tokens: Optional[torch.Tensor] = None, sites=None,
                  params: Optional[Flat] = None, par=None) -> torch.Tensor:
    """One pipeline stage's forward (the JAX pp body's work on one
    microbatch): ``model`` holds the stage's layers; the first stage
    embeds ``tokens`` (with embedding dropout), a later one takes the
    received activation ``x``; then the stage's blocks through
    ``forward_hidden``'s machinery (so every remat mode gives the same loss
    and gradients). ``sites(layer, site)``: the microbatch's dropout seeds
    (``parallel.pipeline.dropout_sites``; None: deterministic). Returns
    the activation before the final norm."""
    from building_llm_from_scratch_tpu_torch.parallel.tensor import SINGLE

    par = par or SINGLE
    params = params or {}
    deterministic = sites is None
    seeds = sites or (lambda layer, site: None)
    T = (tokens if x is None else x).shape[1]
    device = (tokens if x is None else x).device
    positions = par.positions(T, device)
    if x is None:
        x = _embedding(model, tokens, positions, params, seeds, deterministic, par)
    return _blocks(model, x, positions, params, seeds, deterministic, par, None)


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
    paged policy's (n_pages, Hkv, P, hd) pool; an int8 policy adds the
    ``k_scale`` / ``v_scale`` sidecars."""
    return (policy or DEFAULT_POLICY).alloc(cfg, n_slots, max_length, device)


def _slot_write(cache: dict, l: int, k: torch.Tensor, v: torch.Tensor,
                index: tuple) -> None:
    """Write one layer's cache-native (Hkv, T, hd) k/v panes at ``index``
    of its buffers, IN PLACE; an int8 cache gets the codes and their scale
    sidecars (``quantize_kv``: one scale per written position and head),
    as the JAX ``_slot_write``."""
    for name, pane in (("k", k), ("v", v)):
        if cache_is_quantized(cache):
            pane, scale = quantize_kv(pane)
            cache[name + "_scale"][l][index] = scale
        buf = cache[name][l]
        buf[index] = pane.to(buf.dtype)


def _slot_append_kv(cache: dict, l: int, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> None:
    """Append one layer's fresh k/v (model layout (S, Tq, Hkv, hd)) at each
    row's offset ``lengths`` (S,), quantizing on write for an int8 cache:
    the one append rule of ``decode_slots``' plain path (Tq 1) and
    ``verify_slots`` (Tq k+1), as the JAX ``_slot_append_kv``."""
    for name, new in (("k", k), ("v", v)):
        new = new.transpose(1, 2)
        if cache_is_quantized(cache):
            new, scale = quantize_kv(new)
            slot_cache_append(cache[name + "_scale"][l], scale, lengths)
        slot_cache_append(cache[name][l], new, lengths)


def _layer_scales(cache: dict, l: int, rows: slice = slice(None)) -> dict:
    """``decode_attention``'s scale arguments for layer ``l`` (empty for an
    unquantized cache), for the slot rows ``rows``."""
    if not cache_is_quantized(cache):
        return {}
    return {"k_scale": cache["k_scale"][l][rows],
            "v_scale": cache["v_scale"][l][rows]}


@torch.no_grad()
def prefill_into_slot(model: Transformer, tokens: torch.Tensor,
                      prompt_len: int, slot: int, cache: dict,
                      adapter: Optional[dict] = None) -> torch.Tensor:
    """Run one prompt (``tokens`` (1, Tpb), right-padded to its bucket) and
    write its k/v panes into row ``slot`` of ``cache`` IN PLACE (positions
    [0, Tpb); pad positions are written as zeros, as in the JAX package;
    an int8 cache quantizes them on write, after the prompt attended to its
    own unquantized k/v). ``adapter`` (ids (1,)): the request's LoRA
    adapter, gathered. Returns the fp32 logits (V,) at the last real
    position."""
    cfg = model.cfg
    _, Tpb = tokens.shape
    dev = tokens.device
    positions = torch.arange(Tpb, device=dev)
    x = _embed(model, tokens, positions)
    valid = (positions < prompt_len)[None, :, None, None]
    kv_len = torch.tensor(prompt_len, device=dev)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        out = xla_attention(q, k, v, q_positions=positions, kv_length=kv_len)
        _slot_write(cache, l, torch.where(valid, k, zero)[0].transpose(0, 1),
                    torch.where(valid, v, zero)[0].transpose(0, 1),
                    (slot, slice(None), slice(0, Tpb)))
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
    zeros, quantized on write for an int8 cache; the write start clamps so
    the chunk fits, like the JAX dynamic-update-slice) and the chunk
    attends over the slot's whole row with ``kv_length = min(chunk_start +
    C, prompt_len)``. ``adapter`` (ids (1,)): the request's LoRA adapter,
    gathered. Returns the fp32 logits (V,) at position ``prompt_len - 1``
    (clamped into the chunk)."""
    cfg = model.cfg
    _, C = tokens.shape
    dev = tokens.device
    positions, lookup = _chunk_positions(cfg, chunk_start, C, dev)
    x = _embed(model, tokens, lookup)
    valid = (positions < prompt_len)[None, :, None, None]
    kv_len = torch.tensor([min(chunk_start + C, prompt_len)], device=dev)
    start = min(max(chunk_start, 0), cache["k"][0].shape[2] - C)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    row = slice(slot, slot + 1)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, lookup,
                            _layer_adp(adp, l, "attn"))
        _slot_write(cache, l, torch.where(valid, k, zero)[0].transpose(0, 1),
                    torch.where(valid, v, zero)[0].transpose(0, 1),
                    (slot, slice(None), slice(start, start + C)))
        out = decode_attention(q, cache["k"][l][row], cache["v"][l][row],
                               q_positions=positions[None, :], kv_length=kv_len,
                               **_layer_scales(cache, l, row))
        x = x + _attn_out_proj(blk.attn, out, 1, C, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    return _chunk_logits(model, x, chunk_start, prompt_len, head_node, head_s)


@torch.no_grad()
def decode_slots(model: Transformer, tokens: torch.Tensor,
                 lengths: torch.Tensor, cache: dict,
                 adapter: Optional[dict] = None) -> torch.Tensor:
    """One decode tick for the whole slot batch: ``tokens`` (S, 1) are each
    slot's last accepted token and ``lengths`` (S,) int32 its valid prefix.
    Each layer appends its k/v at the row's length and attends. For a cache
    in the model dtype that is one fused step: the kernel B5 for a cache on
    the card (which raises on a shape it cannot take), its plain twin for a
    cache on the CPU. An int8 cache takes the plain path on either device,
    as in the JAX package, where the kernel takes no int8: the append
    quantizes on write and ``decode_attention`` reads the scales. The
    caches are updated IN PLACE. ``adapter`` (ids (S,) int32): per-slot
    LoRA adapters; every block projection's delta goes through B6
    (``lora_bgmv``: the kernel for a pool on the card, the twin for one on
    the CPU), whatever the cache holds, the head's through the gathered
    path. Returns fp32 logits (S, V). Free slots compute rows the engine
    ignores; the shapes never change."""
    cfg = model.cfg
    S = tokens.shape[0]
    positions = lengths.long()[:, None]
    x = _embed(model, tokens, positions)
    quantized = cache_is_quantized(cache)
    step = (fused_decode_step if cache["k"][0].is_cuda
            else fused_decode_step_plain)
    adp, head_node, head_s = (_bgmv_adapter_layers(adapter, cfg)
                              if adapter is not None else (None, None, None))
    for l, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        K, V = cache["k"][l], cache["v"][l]
        if quantized:
            _slot_append_kv(cache, l, k, v, lengths)
            out = decode_attention(q, K, V, q_positions=positions,
                                   kv_length=lengths + 1,
                                   **_layer_scales(cache, l))
        else:
            out, _, _ = step(q.contiguous(), k.to(K.dtype).contiguous(),
                             v.to(V.dtype).contiguous(), K, V, lengths)
        x = x + _attn_out_proj(blk.attn, out, S, 1, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    return _logits(x, model.head, head_node, head_s)[:, 0]


def _verify_positions(cfg: ModelConfig, lengths: torch.Tensor, Tq: int
                      ) -> torch.Tensor:
    """(S, Tq) positions of the verify candidates, clamped to the context:
    near capacity the tail candidates (never committable, since prompt plus
    budget fits the slot) would index past the position tables."""
    pos = lengths.long()[:, None] + torch.arange(Tq, device=lengths.device)
    return pos.clamp(max=cfg.context_length - 1)


@torch.no_grad()
def verify_slots(model: Transformer, tokens: torch.Tensor,
                 lengths: torch.Tensor, cache: dict,
                 adapter: Optional[dict] = None) -> torch.Tensor:
    """Speculative verify, the Tq = k+1 sibling of ``decode_slots`` (the JAX
    ``verify_slots``): ``tokens`` (S, Tq) are each slot's last accepted
    token and its k drafts. One forward scores every position; position j
    conditions on the cache and tokens[:, :j+1], so its logits are the
    model's next-token distribution exactly when the drafts before it were
    all accepted, which is all the accept rule commits. All Tq candidates'
    k/v are appended at lengths .. lengths + k (quantized on write for an
    int8 cache); the engine advances a row by its accepted count only, so a
    rejected tail lies past the valid prefix, masked and overwritten next
    tick. Query j attends the keys at positions <= lengths + j. Attention is
    plain ``decode_attention`` on either device: no kernel takes Tq > 1.
    ``adapter`` (ids (S,)): per-slot LoRA adapters, gathered (B6 is
    single-token). Returns fp32 logits (S, Tq, V)."""
    cfg = model.cfg
    S, Tq = tokens.shape
    positions = _verify_positions(cfg, lengths, Tq)
    x = _embed(model, tokens, positions)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        _slot_append_kv(cache, l, k, v, lengths)
        out = decode_attention(q, cache["k"][l], cache["v"][l],
                               q_positions=positions, kv_length=lengths + Tq,
                               **_layer_scales(cache, l))
        x = x + _attn_out_proj(blk.attn, out, S, Tq, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    return _logits(x, model.head, head_node, head_s)


# ---------------------------------------------------------------------------
# paged KV: the slot rows' positions live in pages of one shared pool
# ((n_pages, Hkv, P, hd) per layer, and (n_pages, Hkv, P, 1) scale pages
# for an int8 pool), addressed through a per-slot page table (S, M). Table
# entry 0 is the trash page: unallocated positions (a free row's garbage
# append, a chunk's pad tail) scatter there and are only ever read masked.
# The scatters are plain tensor indexing, as the JAX package leaves them to
# XLA.
# ---------------------------------------------------------------------------

def _paged_scatter(leaf: torch.Tensor, vals: torch.Tensor,
                   rows: torch.Tensor) -> None:
    """Write ``vals`` (R, Hkv, hd) into the pool ``leaf`` (N, Hkv, P, hd) at
    the flat pool rows ``rows`` (R * Hkv,) of ``_paged_rows``, IN PLACE: one
    ``index_copy_``, which costs the host a tenth of an advanced-index
    assignment."""
    hd = leaf.shape[-1]
    leaf.view(-1, hd).index_copy_(0, rows, vals.reshape(-1, hd).to(leaf.dtype))


def _paged_store(cache: dict, l: int, k: torch.Tensor, v: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """Scatter one layer's k/v (R, Hkv, hd) at the pool rows ``rows``,
    quantizing on write for an int8 pool (codes and scale pages at the same
    rows: the contiguous layout's values, as the JAX ``_paged_scatter``)."""
    for name, vals in (("k", k), ("v", v)):
        if cache_is_quantized(cache):
            vals, scale = quantize_kv(vals)
            _paged_scatter(cache[name + "_scale"][l], scale, rows)
        _paged_scatter(cache[name][l], vals, rows)


def _paged_layer_views(cache: dict, l: int, page_table: torch.Tensor,
                       cache_len: int) -> tuple:
    """(K, V, scale arguments) of layer ``l`` as (rows, Hkv, cache_len, ..)
    row views gathered through ``page_table``: what the JAX package's
    ``decode_attention`` reads on its plain paged path."""
    K = paged_view(cache["k"][l], page_table, cache_len)
    V = paged_view(cache["v"][l], page_table, cache_len)
    scales = {}
    if cache_is_quantized(cache):
        scales = {"k_scale": paged_view(cache["k_scale"][l], page_table, cache_len),
                  "v_scale": paged_view(cache["v_scale"][l], page_table, cache_len)}
    return K, V, scales


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
    over each row's pages. For a model-dtype pool on the card the attention
    is always the paged kernel B7 (which raises on what it cannot take); on
    the CPU its twin over the ``cache_len``-long row views, whose logits
    are bit-equal to the contiguous ``decode_slots``' without adapters. An
    int8 pool takes the plain path on either device (the JAX package gates
    int8 pools out of its kernel): the scatter quantizes on write and
    ``decode_attention`` reads the gathered scale pages. ``adapter`` (ids
    (S,)): per-slot LoRA adapters, gathered (as the JAX
    ``paged_decode_slots``). Returns fp32 logits (S, V)."""
    cfg = model.cfg
    S = tokens.shape[0]
    positions = lengths.long()[:, None]
    x = _embed(model, tokens, positions)
    K0 = cache["k"][0]
    rows = _paged_rows(page_table, positions, K0.shape[2], K0.shape[1], cache_len)
    kernel = K0.is_cuda and not cache_is_quantized(cache)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        _paged_store(cache, l, k[:, 0], v[:, 0], rows)
        if kernel:
            out = paged_decode_attention(q.contiguous(), cache["k"][l],
                                         cache["v"][l], page_table, lengths)
        elif not cache_is_quantized(cache):
            out = paged_decode_attention_plain(q, cache["k"][l], cache["v"][l],
                                               page_table, lengths,
                                               cache_len=cache_len)
        else:
            K, V, scales = _paged_layer_views(cache, l, page_table, cache_len)
            out = decode_attention(q, K, V, q_positions=positions,
                                   kv_length=lengths + 1, **scales)
        x = x + _attn_out_proj(blk.attn, out, S, 1, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    return _logits(x, model.head, head_node, head_s)[:, 0]


@torch.no_grad()
def paged_verify_slots(model: Transformer, tokens: torch.Tensor,
                       lengths: torch.Tensor, page_table: torch.Tensor,
                       cache: dict, cache_len: int,
                       adapter: Optional[dict] = None) -> torch.Tensor:
    """Paged sibling of ``verify_slots`` (the JAX ``paged_verify_slots``):
    the Tq = k+1 candidates' k/v scatter at lengths .. lengths + k through
    ``page_table`` (positions clamped to ``cache_len - 1``; quantized on
    write for an int8 pool) and every query attends the gathered row views
    with plain ``decode_attention``. Returns fp32 logits (S, Tq, V)."""
    cfg = model.cfg
    S, Tq = tokens.shape
    positions = _verify_positions(cfg, lengths, Tq)
    x = _embed(model, tokens, positions)
    K0 = cache["k"][0]
    write = lengths.long()[:, None] + torch.arange(Tq, device=lengths.device)
    rows = _paged_rows(page_table, write, K0.shape[2], K0.shape[1], cache_len)
    adp, head_node, head_s = _slot_adapter_layers(adapter, cfg)
    for l, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, positions,
                            _layer_adp(adp, l, "attn"))
        _paged_store(cache, l, k.reshape(S * Tq, *k.shape[2:]),
                     v.reshape(S * Tq, *v.shape[2:]), rows)
        K, V, scales = _paged_layer_views(cache, l, page_table, cache_len)
        out = decode_attention(q, K, V, q_positions=positions,
                               kv_length=lengths + Tq, **scales)
        x = x + _attn_out_proj(blk.attn, out, S, Tq, _layer_adp(adp, l, "attn"))
        x = x + _mlp(cfg, blk.mlp, blk.norm2(x), _layer_adp(adp, l, "mlp"))
    x = model.final_norm(x)
    return _logits(x, model.head, head_node, head_s)


@torch.no_grad()
def paged_prefill_chunk_into_slot(model: Transformer, tokens: torch.Tensor,
                                  chunk_start: int, prompt_len: int,
                                  row_table: torch.Tensor, cache: dict,
                                  cache_len: int,
                                  adapter: Optional[dict] = None) -> torch.Tensor:
    """Paged sibling of ``prefill_chunk_into_slot``: the chunk's C positions
    scatter into the slot's pages through ``row_table`` ((1, M), the slot's
    table row), pad positions as zeros and positions past the allocated
    frontier onto the trash page (quantized on write for an int8 pool), and
    the chunk attends over the slot's gathered ``cache_len``-long row view
    (plain ``decode_attention``, as in the JAX package). ``adapter`` (ids
    (1,)): the request's LoRA adapter, gathered. Returns the fp32 logits
    (V,) at ``prompt_len - 1``."""
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
    for l, blk in enumerate(model.blocks):
        h = blk.norm1(x)
        q, k, v = _qkv_proj(cfg, blk.attn, h, model.rope, lookup,
                            _layer_adp(adp, l, "attn"))
        _paged_store(cache, l, torch.where(valid, k, zero)[0],
                     torch.where(valid, v, zero)[0], rows)
        K, V, scales = _paged_layer_views(cache, l, row_table, cache_len)
        out = decode_attention(q, K, V, q_positions=positions[None, :],
                               kv_length=kv_len, **scales)
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
           "paged_prefill_chunk_into_slot", "paged_verify_slots",
           "param_shapes", "prefill_chunk_into_slot", "prefill_into_slot",
           "verify_slots"]
