"""The training step (port of the dense-loss, single-device half of the JAX
package's ``training/train_step.py``).

One step: zero the stacked gradient buffers, forward to the final-normed
hidden states, fp32 logits from the head (a model-dtype GEMM with fp32
accumulation), token-mean cross entropy in fp32, backward, then the
hand-written optax-formula AdamW (``training/optim.py``). Metrics are the
JAX step's ``loss``, ``grad_norm`` (pre-clip), ``update_norm``, ``tokens``
and ``lr``; the tensors among them stay on the device (no host sync).

Not ported here: gradient accumulation, loss scaling and precision
policies, LoRA, per-token loss weights (instruction finetuning), sharded
steps, the chunked custom-VJP cross entropy (the
JAX package takes it for ``emb_dim <= 1024``; the port always takes the
dense loss) and the per-layer-group ``health`` bundle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    _head_logits,
    forward_hidden,
)
from building_llm_from_scratch_tpu_torch.training.optim import AdamState, AdamW

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


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse what this step does not carry yet."""
    if cfg.drop_rate > 0.0:
        raise NotImplementedError(
            f"{cfg.name} has drop_rate={cfg.drop_rate}: dropout training (GPT-2 "
            "pretraining, with the fused attention dropout and the dropout "
            "kernels) is not ported yet (ROADMAP queue 1, GPT-2 pretraining)")
    if cfg.use_actv_ckpt:
        raise NotImplementedError(
            "activation checkpointing (--use_actv_ckpt) is not ported yet "
            "(ROADMAP queue 1, GPT-2 pretraining: remat)")


@dataclass
class TrainState:
    """The model (whose parameters are views of ``params``), the stacked
    parameters, the stacked gradient buffers, the optimizer state and the
    number of steps taken."""

    model: Transformer
    params: Flat
    grads: Flat
    opt_state: AdamState
    step: int = 0


def init_train_state(model: Transformer, optimizer: AdamW) -> TrainState:
    """Make ``model`` trainable and attach one stacked gradient buffer per
    JAX leaf (``Transformer.attach_grads``)."""
    model.requires_grad_(True)
    params = model.stacked
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    model.attach_grads(grads)
    return TrainState(model, params, grads, optimizer.init(params))


def make_train_step(cfg: ModelConfig, optimizer: AdamW) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; ``batch`` is
    {"inputs": (B, T) int64, "targets": (B, T) int64} on the model's
    device. The state is updated in place and returned."""
    check_trainable(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        for g in state.grads.values():
            g.zero_()
        model = state.model
        hidden = forward_hidden(model, batch["inputs"])
        loss = dense_loss(model, hidden, batch["targets"])
        loss.backward()
        metrics = optimizer.step(state.params, state.grads, state.opt_state)
        state.step += 1
        metrics.update(loss=loss.detach(), tokens=batch["inputs"].numel())
        return state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """Build ``eval_step(state, batch) -> loss`` (0-d fp32 tensor, no
    gradients)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        hidden = forward_hidden(model, batch["inputs"])
        return dense_loss(model, hidden, batch["targets"])

    return eval_step
