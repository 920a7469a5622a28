"""The training step (port of the single-device half of the JAX package's
``training/train_step.py``).

One step: zero the stacked gradient buffers, forward to the final-normed
hidden states (with the config's dropout, drawn from the step's seed), the
token-mean cross entropy, backward, then the hand-written optax-formula
AdamW (``training/optim.py``). Metrics are the JAX step's ``loss``,
``grad_norm`` (pre-clip), ``update_norm``, ``tokens`` and ``lr``; the
tensors among them stay on the device (no host sync).

The loss is the JAX ``make_loss_fns`` choice: the chunked custom-VJP cross
entropy (``ops/softmax_xent.py``) for ``emb_dim <= 1024``, else fp32 logits
from the head and a dense ``cross_entropy_loss``.

Not ported here: gradient accumulation, loss scaling and precision
policies, remat, LoRA, per-token loss weights (instruction finetuning),
sharded steps and the per-layer-group ``health`` bundle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    _head_logits,
    forward_hidden,
)
from building_llm_from_scratch_tpu_torch.ops.softmax_xent import (
    fused_cross_entropy_loss,
)
from building_llm_from_scratch_tpu_torch.training.optim import AdamState, AdamW
from building_llm_from_scratch_tpu_torch.utils.seeding import step_seed

Flat = Dict[str, torch.Tensor]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """Token-mean cross entropy in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def dense_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor
               ) -> torch.Tensor:
    """The JAX ``make_loss_fns`` dense branch: fp32 logits from the head,
    then ``cross_entropy_loss``."""
    return cross_entropy_loss(_head_logits(hidden, model.head), targets)


def fused_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor
               ) -> torch.Tensor:
    """The JAX ``make_loss_fns`` fused branch: the chunked cross entropy."""
    return fused_cross_entropy_loss(hidden, model.head, targets)


def _auto_fused_xent(cfg: ModelConfig, use_fused_xent: Optional[bool]) -> bool:
    """The JAX rule: the chunked loss for ``emb_dim <= 1024`` unless the
    caller says otherwise."""
    if use_fused_xent is not None:
        return use_fused_xent
    return cfg.emb_dim <= 1024


def make_loss_fns(cfg: ModelConfig, use_fused_xent: Optional[bool] = None
                  ) -> Callable:
    """``loss(model, hidden, targets)`` of the config (the JAX
    ``make_loss_fns``'s ``loss``; its weighted ``sums`` is not ported)."""
    return fused_loss if _auto_fused_xent(cfg, use_fused_xent) else dense_loss


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse what this step does not carry yet."""
    if cfg.use_actv_ckpt:
        raise NotImplementedError(
            "activation checkpointing (--use_actv_ckpt) is not ported yet "
            "(ROADMAP queue 1, remat)")


@dataclass
class TrainState:
    """The model (whose parameters are views of ``params``), the stacked
    parameters, the stacked gradient buffers, the optimizer state, the
    number of steps taken and the run's dropout seed (the JAX state's
    ``rng``)."""

    model: Transformer
    params: Flat
    grads: Flat
    opt_state: AdamState
    step: int = 0
    seed: int = 0


def init_train_state(model: Transformer, optimizer: AdamW, seed: int = 0
                     ) -> TrainState:
    """Make ``model`` trainable and attach one stacked gradient buffer per
    JAX leaf (``Transformer.attach_grads``)."""
    model.requires_grad_(True)
    params = model.stacked
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    model.attach_grads(grads)
    return TrainState(model, params, grads, optimizer.init(params), seed=seed)


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    use_fused_xent: Optional[bool] = None) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; ``batch`` is
    {"inputs": (B, T) int64, "targets": (B, T) int64} on the model's
    device. The step's dropout seed is ``step_seed(state.seed,
    state.step)``. The state is updated in place and returned."""
    check_trainable(cfg)
    loss_fn = make_loss_fns(cfg, use_fused_xent)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        for g in state.grads.values():
            g.zero_()
        model = state.model
        hidden = forward_hidden(model, batch["inputs"],
                                seed=step_seed(state.seed, state.step),
                                deterministic=cfg.drop_rate <= 0.0)
        loss = loss_fn(model, hidden, batch["targets"])
        loss.backward()
        metrics = optimizer.step(state.params, state.grads, state.opt_state)
        state.step += 1
        metrics.update(loss=loss.detach(), tokens=batch["inputs"].numel())
        return state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """Build ``eval_step(state, batch) -> loss`` (0-d fp32 tensor, no
    gradients, no dropout; the train step's loss route)."""
    loss_fn = make_loss_fns(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        hidden = forward_hidden(model, batch["inputs"])
        return loss_fn(model, hidden, batch["targets"])

    return eval_step
