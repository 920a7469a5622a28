"""The training step (port of the single-device half of the JAX package's
``training/train_step.py``).

One step: zero the gradient buffers, forward to the final-normed hidden
states (with the config's dropout, drawn from the step's seed), the
weighted token-mean cross entropy, backward, then the hand-written
optax-formula AdamW (``training/optim.py``). Metrics are the JAX step's
``loss``, ``grad_norm`` (pre-clip), ``update_norm``, ``tokens`` (every input
token, masked or not) and ``lr``; the tensors among them stay on the device
(no host sync).

The state's trainable leaves are the model's stacked parameters
(pretraining), or a LoRA adapter's A and B over a frozen model
(``init_train_state(lora, optimizer, seed, frozen=model)``). A LoRA step
trains through the merge, as the JAX ``make_full_params_fn`` does: every
call builds W' = W + (alpha / rank) A@B (``models.lora.merge_lora``), the
forward and the loss run on W', and the gradients reach A and B through
the merge; the base gets no gradient and stays bit-unchanged.

A precision policy (``training/precision.py``) runs the forward and the
backward on a copy of every leaf cast to its compute dtype, made anew each
call after the LoRA merge; the gradients reach the masters through the
cast in the masters' dtype. The fp16 policy adds dynamic loss scaling:
the loss is scaled by the state's ``loss_scale`` before the backward and
the gradients are unscaled in fp32. A step whose loss or gradient norm is
not finite keeps the parameters and the optimizer state (its count too,
so the LR schedule does not advance) and halves the scale (floor 1); a
streak of ``scale_growth_interval`` finite steps doubles it. ``step``
always advances, and the metrics add ``loss_scale`` and ``skipped``. The
decision reads one flag from the device each step.

``grad_accum`` > 1 splits the batch into that many microbatches, each
with its own dropout seed folded from the step's, and sums their
gradients in fp32 together with the loss's two pieces (sum of nll x
weight, sum of weights); one division by max(sum w, 1) (times the loss
scale) gives the full batch's weighted mean and its gradient (the JAX
``train_step_accum``).

The loss is the JAX ``make_loss_fns`` choice: the chunked custom-VJP cross
entropy (``ops/softmax_xent.py``) for ``emb_dim <= 1024``, else fp32 logits
from the head and a dense ``cross_entropy_loss``. Both weight each token by
the batch's ``weights`` (instruction finetuning's prompt mask) when it has
them: sum(nll * w) / max(sum(w), 1).

``checkpoint_tree`` lays the state out as the JAX train state's tree
(``trainable``, ``frozen``, the optax chain's ``opt_state``, ``step``,
``rng`` and, with loss scaling, ``loss_scale`` and ``growth_count``) for
``training/checkpoint.save_checkpoint``; ``restore_train_state`` refills
it in place from a checkpoint of either package.

Not ported here: sharded steps and the per-layer-group ``health`` bundle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.models.lora import (
    flatten_lora,
    merge_lora,
)
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    _head_logits,
    forward_hidden,
)
from building_llm_from_scratch_tpu_torch.ops.softmax_xent import (
    fused_cross_entropy_loss,
    fused_cross_entropy_sums,
    weighted_mean,
    weighted_sums,
)
from building_llm_from_scratch_tpu_torch.training.optim import (
    AdamState,
    AdamW,
    global_norm,
)
from building_llm_from_scratch_tpu_torch.training.precision import (
    PrecisionPolicy,
    cast_floating,
)
from building_llm_from_scratch_tpu_torch.utils.seeding import step_seed

Flat = Dict[str, torch.Tensor]


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted token-mean cross entropy in fp32."""
    return weighted_mean(_token_nll(logits, targets), weights)


def cross_entropy_sums(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None):
    """(weighted nll sum, weight sum) in fp32: the unnormalised pieces of
    ``cross_entropy_loss`` (the JAX ``cross_entropy_sums``)."""
    return weighted_sums(_token_nll(logits, targets), weights)


def dense_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX ``make_loss_fns`` dense branch: fp32 logits from the head
    (``head``, else the model's), then ``cross_entropy_loss``."""
    w = model.head if head is None else head
    return cross_entropy_loss(_head_logits(hidden, w), targets, weights)


def dense_sums(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               head: Optional[torch.Tensor] = None):
    """``dense_loss``'s (nll sum, weight sum)."""
    w = model.head if head is None else head
    return cross_entropy_sums(_head_logits(hidden, w), targets, weights)


def fused_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX ``make_loss_fns`` fused branch: the chunked cross entropy."""
    w = model.head if head is None else head
    return fused_cross_entropy_loss(hidden, w, targets, weights)


def fused_sums(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               head: Optional[torch.Tensor] = None):
    """``fused_loss``'s (nll sum, weight sum)."""
    w = model.head if head is None else head
    return fused_cross_entropy_sums(hidden, w, targets, weights)


def _auto_fused_xent(cfg: ModelConfig, use_fused_xent: Optional[bool]) -> bool:
    """The JAX rule: the chunked loss for ``emb_dim <= 1024`` unless the
    caller says otherwise."""
    if use_fused_xent is not None:
        return use_fused_xent
    return cfg.emb_dim <= 1024


def make_loss_fns(cfg: ModelConfig, use_fused_xent: Optional[bool] = None
                  ) -> Callable:
    """``loss(model, hidden, targets, weights=None, head=None)`` of the
    config (the JAX ``make_loss_fns``'s ``loss``)."""
    return fused_loss if _auto_fused_xent(cfg, use_fused_xent) else dense_loss


def make_sums_fn(cfg: ModelConfig, use_fused_xent: Optional[bool] = None
                 ) -> Callable:
    """``sums(model, hidden, targets, weights=None, head=None)`` of the
    config (the JAX ``make_loss_fns``'s ``sums``)."""
    return fused_sums if _auto_fused_xent(cfg, use_fused_xent) else dense_sums


@dataclass
class TrainState:
    """The model, the trainable leaves by flat name (the model's stacked
    parameters, or the adapter's ``"blocks/attn/wq/A"``...), their gradient
    buffers, the optimizer state, the number of steps taken and the run's
    dropout seed (the JAX state's ``rng``). ``lora`` is the adapter tree
    of a LoRA run (the same tensors as ``params``); the model is then the
    frozen base. ``loss_scale`` (None without loss scaling) and
    ``growth_count`` are the fp16 policy's dynamic scale and its streak of
    finite steps, kept on the host."""

    model: Transformer
    params: Flat
    grads: Flat
    opt_state: AdamState
    step: int = 0
    seed: int = 0
    lora: Optional[Dict[str, Any]] = None
    loss_scale: Optional[float] = None
    growth_count: int = 0


def init_train_state(trainable, optimizer: AdamW, seed: int = 0,
                     frozen: Optional[Transformer] = None,
                     policy: Optional[PrecisionPolicy] = None) -> TrainState:
    """The JAX ``init_train_state``. Pretraining (``frozen`` None):
    ``trainable`` is the model, made trainable with one stacked gradient
    buffer per JAX leaf: through its per-layer parameters
    (``Transformer.attach_grads``), or, under a ``policy`` (whose step runs
    on a cast copy of every leaf), on the stacked masters themselves. LoRA:
    ``trainable`` is the adapter tree and ``frozen`` the model; the
    adapter's leaves get gradient buffers and the optimizer sees them
    alone, the model none. The fp16 policy adds the loss scale."""
    if frozen is None:
        model = trainable
        params = model.stacked
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        if policy is None:
            model.requires_grad_(True)
            model.attach_grads(grads)
        else:
            model.requires_grad_(False)
            for k, leaf in params.items():
                leaf.requires_grad_(True)
                leaf.grad = grads[k]
        state = TrainState(model, params, grads, optimizer.init(params),
                           seed=seed)
    else:
        frozen.requires_grad_(False)
        params = {"/".join(p): leaf for p, leaf in flatten_lora(trainable).items()}
        grads = {}
        for k, leaf in params.items():
            leaf.requires_grad_(True)
            grads[k] = leaf.grad = torch.zeros_like(leaf)
        state = TrainState(frozen, params, grads, optimizer.init(params),
                           seed=seed, lora=trainable)
    if policy is not None and policy.loss_scaling:
        state.loss_scale = float(policy.init_loss_scale)
    return state


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """The state as the JAX train state's flat tree: ``trainable/<leaf>``
    (the stacked parameters, or the adapter's ``blocks/attn/wq/A``...),
    ``frozen/<leaf>`` (the base of a LoRA run; nothing otherwise), the
    optax chain's state under its indices (``opt_state/1`` scale_by_adam's
    ``count``, ``mu``, ``nu``; ``opt_state/3/count`` the schedule's), the
    ``step``, the ``rng`` and, with loss scaling, ``loss_scale`` (fp32) and
    ``growth_count`` (int32). The port's dropout stream is keyed on its
    seed, so ``rng`` is written as ``PRNGKey(seed)`` is laid out ([0,
    seed] as uint32), the key the JAX trainer keeps; it is not read back.
    Tensor leaves are the state's own tensors (no copies)."""
    opt = state.opt_state
    count = np.asarray(opt.count, np.int32)
    tree: Dict[str, Any] = {}
    if state.lora is not None:
        tree.update({f"frozen/{k}": v.detach()
                     for k, v in state.model.stacked.items()})
    for k, v in state.params.items():
        tree[f"trainable/{k}"] = v.detach()
        tree[f"opt_state/1/mu/{k}"] = opt.mu[k]
        tree[f"opt_state/1/nu/{k}"] = opt.nu[k]
    tree.update({"opt_state/1/count": count, "opt_state/3/count": count,
                 "step": np.asarray(state.step, np.int32),
                 "rng": np.asarray([0, state.seed & 0xFFFFFFFF], np.uint32)})
    if state.loss_scale is not None:
        tree["loss_scale"] = np.asarray(state.loss_scale, np.float32)
        tree["growth_count"] = np.asarray(state.growth_count, np.int32)
    return tree


def restore_train_state(state: TrainState, ckpt_dir: str) -> TrainState:
    """Refill ``state`` from the train-state checkpoint at ``ckpt_dir``
    (``training/checkpoint.load_checkpoint``): every tensor in place, so the
    model's per-layer parameters, which are views of its stacked leaves,
    and the gradient buffers attached to them stay valid; then the optimizer
    count, the step and the loss scale. Moments that a checkpoint holds in
    fp32 for 16-bit parameters (promoted by fp32 gradients, ``optim``) are
    made fp32 first. The dropout seed stays the state's (the checkpoint's
    ``rng`` is a JAX key)."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        leaf_dtypes,
        load_checkpoint,
    )

    opt = state.opt_state
    dtypes = leaf_dtypes(ckpt_dir)
    for name, moments in (("mu", opt.mu), ("nu", opt.nu)):
        for k, m in moments.items():
            if (dtypes.get(f"opt_state/1/{name}/{k}") == "float32"
                    and m.dtype != torch.float32):
                moments[k] = m.float()
    restored = load_checkpoint(ckpt_dir, checkpoint_tree(state))
    opt.count = int(restored["opt_state/1/count"])
    state.step = int(restored["step"])
    if state.loss_scale is not None:
        state.loss_scale = float(restored["loss_scale"])
        state.growth_count = int(restored["growth_count"])
    return state


def make_full_params_fn(lora_alpha: Optional[float] = None,
                        lora_rank: Optional[int] = None,
                        policy: Optional[PrecisionPolicy] = None) -> Callable:
    """``full_params(state) -> Flat``: the weights the step's forward and
    loss run on instead of the model's own (the JAX
    ``make_full_params_fn``), built anew in every call so that autograd
    reaches the trainable leaves. Without LoRA or a policy none; with LoRA
    the merged adapted weights; with a policy every leaf (the merged ones
    included) cast to its compute dtype."""
    if lora_rank is None and policy is None:
        return lambda state: {}

    def full_params(state: TrainState) -> Flat:
        base = state.model.stacked
        params = base
        if lora_rank is not None:
            names = {"/".join(p[:-1]) for p in flatten_lora(state.lora)}
            merged = merge_lora({n: base[n] for n in names}, state.lora,
                                lora_alpha, lora_rank)
            params = merged if policy is None else {**base, **merged}
        if policy is not None:
            params = cast_floating(params, policy.torch_compute_dtype)
        return params

    return full_params


def _hidden(full_params: Callable, state: TrainState, inputs: torch.Tensor,
            **fwd):
    params = full_params(state)
    return params, forward_hidden(state.model, inputs, params=params, **fwd)


def _update_loss_scale(state: TrainState, finite: bool,
                       policy: PrecisionPolicy) -> None:
    """The JAX rule, in fp32: a non-finite step halves the scale (floor 1)
    and ends the streak; ``scale_growth_interval`` finite steps in a row
    double it."""
    f32 = np.float32
    scale = f32(state.loss_scale)
    growth = state.growth_count + 1 if finite else 0
    grow = growth >= policy.scale_growth_interval
    if not finite:
        scale = max(scale * f32(0.5), f32(1.0))
    elif grow:
        scale = scale * f32(2.0)
    state.loss_scale = float(scale)
    state.growth_count = 0 if grow else growth


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    use_fused_xent: Optional[bool] = None, *,
                    lora_alpha: Optional[float] = None,
                    lora_rank: Optional[int] = None,
                    policy: Optional[PrecisionPolicy] = None,
                    grad_accum: int = 1) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; ``batch`` is
    {"inputs": (B, T) int64, "targets": (B, T) int64, optionally "weights":
    (B, T) fp32} on the model's device. ``lora_alpha``/``lora_rank``: a
    LoRA state's adapter, merged in every call. ``policy``: the precision
    policy the state was made with. ``grad_accum``: microbatches a step
    (module docstring). The step's dropout seed is
    ``step_seed(state.seed, state.step)``. The state is updated in place
    and returned."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_fn = make_loss_fns(cfg, use_fused_xent)
    sums_fn = make_sums_fn(cfg, use_fused_xent)
    full_params = make_full_params_fn(lora_alpha, lora_rank, policy)
    deterministic = cfg.drop_rate <= 0.0

    def finish(state: TrainState, loss: torch.Tensor, grads: Flat,
               n_tokens: int):
        """The update, or with loss scaling the skip rule (module
        docstring), then the step count and the metrics."""
        if state.loss_scale is None:
            metrics = optimizer.step(state.params, grads, state.opt_state)
        else:
            if policy is None or not policy.loss_scaling:
                raise ValueError("a loss-scaled state needs its fp16 policy "
                                 "in make_train_step(policy=)")
            grad_norm = global_norm(grads)
            finite = bool(torch.isfinite(grad_norm) & torch.isfinite(loss))
            if finite:
                metrics = optimizer.step(state.params, grads, state.opt_state,
                                         grad_norm=grad_norm)
            else:
                metrics = dict(grad_norm=grad_norm,
                               update_norm=torch.full_like(grad_norm, float("nan")))
            # the JAX metric: the schedule at the step, which runs ahead
            # of the optimizer's count once a step was skipped
            metrics["lr"] = optimizer.schedule(state.step)
            _update_loss_scale(state, finite, policy)
            metrics.update(loss_scale=state.loss_scale, skipped=int(not finite))
        state.step += 1
        metrics.update(loss=loss.detach(), tokens=n_tokens)
        return state, metrics

    def unscaled(state: TrainState, grads: Flat) -> Flat:
        """The gradients in fp32 with the loss scale divided out."""
        if state.loss_scale is None:
            return grads
        return {k: g.float().div_(state.loss_scale) for k, g in grads.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        for g in state.grads.values():
            g.zero_()
        params, hidden = _hidden(full_params, state, batch["inputs"],
                                 seed=step_seed(state.seed, state.step),
                                 deterministic=deterministic)
        loss = loss_fn(state.model, hidden, batch["targets"], batch.get("weights"),
                       head=params.get("head/weight"))
        (loss if state.loss_scale is None else loss * state.loss_scale).backward()
        return finish(state, loss, unscaled(state, state.grads),
                      batch["inputs"].numel())

    def train_step_accum(state: TrainState, batch: Dict[str, torch.Tensor]):
        inputs, targets = batch["inputs"], batch["targets"]
        B = inputs.shape[0]
        if B % grad_accum:
            raise ValueError(
                f"batch size {B} not divisible by grad_accum {grad_accum}")
        mb = B // grad_accum
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(targets.shape, dtype=torch.float32,
                                 device=targets.device)
        scale = state.loss_scale
        seed = step_seed(state.seed, state.step)
        for g in state.grads.values():
            g.zero_()
        # fp32 gradients sum in their own buffers (autograd adds each
        # microbatch's in place); 16-bit ones are widened into fp32 sums
        wide = {k: torch.zeros_like(g, dtype=torch.float32)
                for k, g in state.grads.items() if g.dtype != torch.float32}
        nll_sum = torch.zeros((), dtype=torch.float32, device=inputs.device)
        w_sum = torch.zeros_like(nll_sum)
        for i in range(grad_accum):
            rows = slice(i * mb, (i + 1) * mb)
            # each microbatch's dropout stream: the step's seed folded
            # with the microbatch index, as the step's is folded with the step
            params, hidden = _hidden(full_params, state, inputs[rows],
                                     seed=step_seed(seed, i),
                                     deterministic=deterministic)
            nll, w = sums_fn(state.model, hidden, targets[rows], weights[rows],
                             head=params.get("head/weight"))
            (nll if scale is None else nll * scale).backward()
            for k, acc in wide.items():
                acc += state.grads[k].float()
                state.grads[k].zero_()
            nll_sum = nll_sum + nll.detach()
            w_sum = w_sum + w
        grads = {k: wide.get(k, g) for k, g in state.grads.items()}
        denom = w_sum.clamp_min(1.0)
        if scale is not None:
            # the gradients carry the loss scale: divide it out with the
            # weight sum
            denom = denom * scale
        for g in grads.values():
            g.div_(denom)
        loss = nll_sum / w_sum.clamp_min(1.0)
        return finish(state, loss, grads, inputs.numel())

    return train_step if grad_accum == 1 else train_step_accum


def make_eval_step(cfg: ModelConfig, *, lora_alpha: Optional[float] = None,
                   lora_rank: Optional[int] = None,
                   policy: Optional[PrecisionPolicy] = None) -> Callable:
    """Build ``eval_step(state, batch) -> loss`` (0-d fp32 tensor, no
    gradients, no dropout; the train step's loss route, weights and
    policy cast)."""
    loss_fn = make_loss_fns(cfg)
    full_params = make_full_params_fn(lora_alpha, lora_rank, policy)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params, hidden = _hidden(full_params, state, batch["inputs"])
        return loss_fn(state.model, hidden, batch["targets"],
                       batch.get("weights"), head=params.get("head/weight"))

    return eval_step
