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

The loss is the JAX ``make_loss_fns`` choice: the chunked custom-VJP cross
entropy (``ops/softmax_xent.py``) for ``emb_dim <= 1024``, else fp32 logits
from the head and a dense ``cross_entropy_loss``. Both weight each token by
the batch's ``weights`` (instruction finetuning's prompt mask) when it has
them: sum(nll * w) / max(sum(w), 1).

``checkpoint_tree`` lays the state out as the JAX train state's tree
(``trainable``, ``frozen``, the optax chain's ``opt_state``, ``step`` and
``rng``) for ``training/checkpoint.save_checkpoint``; ``restore_train_state``
refills it in place from a checkpoint of either package.

Not ported here: gradient accumulation and the loss ``sums`` it needs
(ROADMAP queue 1, gradient accumulation), loss scaling and precision
policies, remat, sharded steps and the per-layer-group ``health`` bundle.
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
    weighted_mean,
)
from building_llm_from_scratch_tpu_torch.training.optim import AdamState, AdamW
from building_llm_from_scratch_tpu_torch.utils.seeding import step_seed

Flat = Dict[str, torch.Tensor]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted token-mean cross entropy in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return weighted_mean(nll, weights)


def dense_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX ``make_loss_fns`` dense branch: fp32 logits from the head
    (``head``, else the model's), then ``cross_entropy_loss``."""
    w = model.head if head is None else head
    return cross_entropy_loss(_head_logits(hidden, w), targets, weights)


def fused_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX ``make_loss_fns`` fused branch: the chunked cross entropy."""
    w = model.head if head is None else head
    return fused_cross_entropy_loss(hidden, w, targets, weights)


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


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse what this step does not carry yet."""
    if cfg.use_actv_ckpt:
        raise NotImplementedError(
            "activation checkpointing (--use_actv_ckpt) is not ported yet "
            "(ROADMAP queue 1, remat)")


@dataclass
class TrainState:
    """The model, the trainable leaves by flat name (the model's stacked
    parameters, or the adapter's ``"blocks/attn/wq/A"``...), their gradient
    buffers, the optimizer state, the number of steps taken and the run's
    dropout seed (the JAX state's ``rng``). ``lora`` is the adapter tree
    of a LoRA run (the same tensors as ``params``); the model is then the
    frozen base."""

    model: Transformer
    params: Flat
    grads: Flat
    opt_state: AdamState
    step: int = 0
    seed: int = 0
    lora: Optional[Dict[str, Any]] = None


def init_train_state(trainable, optimizer: AdamW, seed: int = 0,
                     frozen: Optional[Transformer] = None) -> TrainState:
    """The JAX ``init_train_state``. Pretraining (``frozen`` None):
    ``trainable`` is the model, made trainable with one stacked gradient
    buffer per JAX leaf (``Transformer.attach_grads``). LoRA: ``trainable``
    is the adapter tree and ``frozen`` the model; the adapter's leaves get
    gradient buffers and the optimizer sees them alone, the model none."""
    if frozen is None:
        model = trainable
        model.requires_grad_(True)
        params = model.stacked
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        model.attach_grads(grads)
        return TrainState(model, params, grads, optimizer.init(params), seed=seed)
    frozen.requires_grad_(False)
    params = {"/".join(p): leaf for p, leaf in flatten_lora(trainable).items()}
    grads = {}
    for k, leaf in params.items():
        leaf.requires_grad_(True)
        grads[k] = leaf.grad = torch.zeros_like(leaf)
    return TrainState(frozen, params, grads, optimizer.init(params), seed=seed,
                      lora=trainable)


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """The state as the JAX train state's flat tree: ``trainable/<leaf>``
    (the stacked parameters, or the adapter's ``blocks/attn/wq/A``...),
    ``frozen/<leaf>`` (the base of a LoRA run; nothing otherwise), the
    optax chain's state under its indices (``opt_state/1`` scale_by_adam's
    ``count``, ``mu``, ``nu``; ``opt_state/3/count`` the schedule's), the
    ``step`` and the ``rng``. The port's dropout stream is keyed on its
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
    return tree


def restore_train_state(state: TrainState, ckpt_dir: str) -> TrainState:
    """Refill ``state`` from the train-state checkpoint at ``ckpt_dir``
    (``training/checkpoint.load_checkpoint``): every tensor in place, so the
    model's per-layer parameters, which are views of its stacked leaves,
    and the gradient buffers attached to them stay valid; then the optimizer
    count and the step. The dropout seed stays the state's (the checkpoint's
    ``rng`` is a JAX key)."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_checkpoint,
    )

    restored = load_checkpoint(ckpt_dir, checkpoint_tree(state))
    state.opt_state.count = int(restored["opt_state/1/count"])
    state.step = int(restored["step"])
    return state


def make_full_params_fn(lora_alpha: Optional[float] = None,
                        lora_rank: Optional[int] = None) -> Callable:
    """``full_params(state) -> Flat``: the weights the step's forward and
    loss run on beyond the model's own. Without LoRA none; with it the
    merged adapted weights (the JAX ``make_full_params_fn``), built anew in
    every call so that autograd reaches A and B."""
    if lora_rank is None:
        return lambda state: {}

    def full_params(state: TrainState) -> Flat:
        base = state.model.stacked
        names = {"/".join(p[:-1]) for p in flatten_lora(state.lora)}
        return merge_lora({n: base[n] for n in names}, state.lora,
                          lora_alpha, lora_rank)

    return full_params


def _step_loss(loss_fn: Callable, full_params: Callable, state: TrainState,
               batch: Dict[str, torch.Tensor], **fwd) -> torch.Tensor:
    params = full_params(state)
    hidden = forward_hidden(state.model, batch["inputs"], params=params, **fwd)
    return loss_fn(state.model, hidden, batch["targets"], batch.get("weights"),
                   head=params.get("head/weight"))


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    use_fused_xent: Optional[bool] = None, *,
                    lora_alpha: Optional[float] = None,
                    lora_rank: Optional[int] = None) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; ``batch`` is
    {"inputs": (B, T) int64, "targets": (B, T) int64, optionally "weights":
    (B, T) fp32} on the model's device. ``lora_alpha``/``lora_rank``: a
    LoRA state's adapter, merged in every call. The step's dropout seed is
    ``step_seed(state.seed, state.step)``. The state is updated in place
    and returned."""
    check_trainable(cfg)
    loss_fn = make_loss_fns(cfg, use_fused_xent)
    full_params = make_full_params_fn(lora_alpha, lora_rank)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        for g in state.grads.values():
            g.zero_()
        loss = _step_loss(loss_fn, full_params, state, batch,
                          seed=step_seed(state.seed, state.step),
                          deterministic=cfg.drop_rate <= 0.0)
        loss.backward()
        metrics = optimizer.step(state.params, state.grads, state.opt_state)
        state.step += 1
        metrics.update(loss=loss.detach(), tokens=batch["inputs"].numel())
        return state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, lora_alpha: Optional[float] = None,
                   lora_rank: Optional[int] = None) -> Callable:
    """Build ``eval_step(state, batch) -> loss`` (0-d fp32 tensor, no
    gradients, no dropout; the train step's loss route and weights)."""
    loss_fn = make_loss_fns(cfg)
    full_params = make_full_params_fn(lora_alpha, lora_rank)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return _step_loss(loss_fn, full_params, state, batch)

    return eval_step
