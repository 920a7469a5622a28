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

``make_sharded_train_step`` is the step of a ``parallel.MeshPlan`` (dp,
fsdp, zero1; one process per device, the JAX ``make_sharded_train_step``).
Every collective is explicit and owns its dtype:

  1. fsdp: every sharded master is cast to the compute dtype (the
     policy's, else its own) and all-gathered into the model's full-size
     working copy (``gather_params``; dp and zero1 hold whole parameters);
  2. the global weight sum (an all-reduce) scales the rank's loss: its
     weighted mean times its share of the weights, so the sum over ranks
     is the global weighted mean (the JAX step's ``nll_sum / w_global``)
     and the reduced gradients are the global batch's. Prompt-masked SFT
     batches give ranks unequal shares; a mean of per-rank means would be
     wrong there;
  3. the backward on the rank's rows, with the rank folded into the
     dropout seed (the JAX step folds ``axis_index(data)``);
  4. the gradients (unscaled first under loss scaling, as the JAX step
     does) are cast to the policy's ``reduce_dtype`` (bf16 under
     bf16_hybrid; the gradient's own dtype without a policy), all-reduced
     (dp, zero1, fsdp's replicated leaves) or reduce-scattered onto the
     rank's shard (fsdp), and cast back;
  5. the clipping norm: from the whole reduced gradients under dp and zero1
     (so zero1 is bit-equal to dp); under fsdp each leaf's fp32 sum of
     squares over the rank's shard, all-reduced as one vector, then
     rounded and summed in leaf order as ``optim.global_norm`` does. Under
     loss scaling the skip decision is agreed (all-reduce MIN);
  6. AdamW on the rank's slice with its slice of ``mu`` / ``nu`` (zero1,
     fsdp), the same ``AdamW.step`` formulas; zero1 then all-gathers the
     updated slices into the whole parameters.

At a world of one the step is the single-device step: the collectives are
identities on one rank, the loss share is exactly 1, no reduce-dtype cast
and no rank fold happen, so its losses equal ``make_train_step``'s bit for
bit. ``grad_accum`` microbatches reduce once per step. The metrics' loss is
the global one; ``tokens`` counts the global batch.

Under a plan the state (``init_train_state(plan=)``) holds the rank's
masters in ``params`` (fsdp: contiguous shards of the sharded leaves),
the full-size working leaves in ``full`` (the model's stacked leaves or
the adapter's; autograd's leaves, with full-size gradient buffers), and
the moments sharded as ``plan.opt_spec`` says. A LoRA run's frozen base
stays whole in the model; under fsdp its checkpoint leaves are the rank's
slices. fsdp frees the sharded leaves' working copy and their full-size
gradient buffers once the gradients are reduced (``release_params``), so
between steps a rank holds its masters and moments only; inside a step it
holds the whole working copy and gradients, as zero1 does (the JAX step
under XLA may gather layer by layer; that is not ported).

Not ported here: tensor, sequence and pipeline parallelism and the
per-layer-group ``health`` bundle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP, ModelConfig
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
from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
from building_llm_from_scratch_tpu_torch.parallel.sharding import (
    MeshPlan,
    spec_axis,
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
from building_llm_from_scratch_tpu_torch.utils.seeding import (
    derive_seed,
    step_seed,
)

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
    finite steps, kept on the host.

    Under a ``plan`` (module docstring): ``params`` holds the rank's
    masters, ``full`` the full-size working leaves (``params`` itself
    without a plan), ``param_axes`` / ``opt_axes`` / ``frozen_axes`` each
    leaf's sharded dimension (None: whole on every rank) for the masters,
    the moments and a LoRA run's frozen base, and ``gathered`` the (step,
    exact) of the working copy's last fsdp gather (exact: the masters
    themselves, not their compute-dtype casts)."""

    model: Transformer
    params: Flat
    grads: Flat
    opt_state: AdamState
    step: int = 0
    seed: int = 0
    lora: Optional[Dict[str, Any]] = None
    loss_scale: Optional[float] = None
    growth_count: int = 0
    plan: Optional[MeshPlan] = None
    full: Optional[Flat] = None
    param_axes: Dict[str, Optional[int]] = field(default_factory=dict)
    opt_axes: Dict[str, Optional[int]] = field(default_factory=dict)
    frozen_axes: Dict[str, Optional[int]] = field(default_factory=dict)
    gathered: Optional[Tuple[int, bool]] = None
    #: the policy's compute dtype, which fsdp's step gathers in
    compute_dtype: Optional[torch.dtype] = None


def _local_shape(shape, axis: Optional[int], n: int) -> tuple:
    shape = list(shape)
    if axis is not None:
        shape[axis] //= n
    return tuple(shape)


def init_train_state(trainable, optimizer: AdamW, seed: int = 0,
                     frozen: Optional[Transformer] = None,
                     policy: Optional[PrecisionPolicy] = None,
                     plan: Optional[MeshPlan] = None) -> TrainState:
    """The JAX ``init_train_state``. Pretraining (``frozen`` None):
    ``trainable`` is the model, made trainable with one stacked gradient
    buffer per JAX leaf: through its per-layer parameters
    (``Transformer.attach_grads``), or, under a ``policy`` (whose step runs
    on a cast copy of every leaf), on the stacked masters themselves. LoRA:
    ``trainable`` is the adapter tree and ``frozen`` the model; the
    adapter's leaves get gradient buffers and the optimizer sees them
    alone, the model none. The fp16 policy adds the loss scale. ``plan``:
    the rank's masters, moments and axes as the plan places them (the
    TrainState docstring)."""
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
        lora = None
    else:
        model = frozen
        frozen.requires_grad_(False)
        params = {"/".join(p): leaf for p, leaf in flatten_lora(trainable).items()}
        grads = {}
        for k, leaf in params.items():
            leaf.requires_grad_(True)
            grads[k] = leaf.grad = torch.zeros_like(leaf)
        lora = trainable
    if plan is None:
        state = TrainState(model, params, grads, optimizer.init(params),
                           seed=seed, lora=lora, full=params)
    else:
        state = _placed_state(model, params, grads, optimizer, seed, lora, plan)
        if policy is not None:
            state.compute_dtype = policy.torch_compute_dtype
    if policy is not None and policy.loss_scaling:
        state.loss_scale = float(policy.init_loss_scale)
    return state


def _placed_state(model: Transformer, full: Flat, grads: Flat,
                  optimizer: AdamW, seed: int, lora, plan: MeshPlan) -> TrainState:
    """The TrainState of ``plan``'s rank: fsdp masters cloned from the
    rank's slices, the moments made at their slices' shapes."""
    names = lambda k: tuple(k.split("/"))  # noqa: E731
    param_axes = {k: spec_axis(plan.param_spec(names(k), tuple(v.shape)))
                  for k, v in full.items()}
    opt_axes = {k: spec_axis(plan.opt_spec(names(k), tuple(v.shape)))
                for k, v in full.items()}
    params = {k: v if param_axes[k] is None
              else plan.local(v.detach(), param_axes[k]).clone()
              for k, v in full.items()}
    zeros = lambda k, v: torch.zeros(  # noqa: E731
        _local_shape(v.shape, opt_axes[k], plan.n_data), dtype=v.dtype,
        device=v.device)
    opt = AdamState(count=0, mu={k: zeros(k, v) for k, v in full.items()},
                    nu={k: zeros(k, v) for k, v in full.items()})
    frozen_axes = {}
    if lora is not None:
        frozen_axes = {k: spec_axis(plan.param_spec(names(k), tuple(v.shape)))
                       for k, v in model.stacked.items()}
    return TrainState(model, params, grads, opt, seed=seed, lora=lora,
                      plan=plan, full=full, param_axes=param_axes,
                      opt_axes=opt_axes, frozen_axes=frozen_axes,
                      gathered=(0, True))


def gather_params(state: TrainState, exact: bool = True) -> None:
    """Make the working copy (``state.full``) current: under fsdp, every
    sharded master all-gathered into it, on every rank (a collective:
    every rank calls it at the same point). ``exact`` False casts the
    shards to the policy's compute dtype first (the train step's gather);
    True gathers the masters as they are (samples, exports, evaluation
    outside a policy). A no-op without sharded masters or when the copy is
    already current."""
    if state.plan is None or not any(a is not None for a in state.param_axes.values()):
        return
    if state.gathered is not None and state.gathered[0] == state.step \
            and (state.gathered[1] or not exact):
        return
    dtype = None if exact else state.compute_dtype
    with torch.no_grad():
        for k, axis in state.param_axes.items():
            if axis is None:
                continue
            src = state.params[k]
            if dtype is not None and src.is_floating_point() and src.dtype != dtype:
                src = src.to(dtype)
            coll.gather_full(src, axis, out=_allocated(state.full[k]))
    state.gathered = (state.step, exact or dtype is None)


def _allocated(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its storage allocated again after ``release_params``."""
    st = t.untyped_storage()
    need = (t.storage_offset() + t.numel()) * t.element_size()
    if st.nbytes() < need:
        st.resize_(need)
    return t


def release_params(state: TrainState) -> None:
    """fsdp, once the gradients are reduced: free the storage of the
    sharded leaves' working copy and of their full-size gradient buffers.
    The tensors (and the model's per-layer views of them) stay, with no
    memory behind them until ``gather_params`` and the next step allocate
    it again. Only a tensor that owns its whole storage, and a storage
    torch may resize (not a numpy array's), is freed."""
    for k, axis in state.param_axes.items():
        if axis is None:
            continue
        for t in (state.full[k], state.grads[k]):
            st = t.untyped_storage()
            if st.resizable() and t.storage_offset() == 0 \
                    and st.nbytes() == t.numel() * t.element_size():
                st.resize_(0)
    state.gathered = None


def checkpoint_layout(state: TrainState) -> Dict[str, Tuple[tuple, int]]:
    """{checkpoint path: (global shape, sharded dimension)} of the leaves
    that ``checkpoint_tree`` holds as this rank's slices (empty without a
    plan)."""
    if state.plan is None:
        return {}
    out = {}
    for k, v in state.full.items():
        shape = tuple(v.shape)
        if state.param_axes.get(k) is not None:
            out[f"trainable/{k}"] = (shape, state.param_axes[k])
        if state.opt_axes.get(k) is not None:
            out[f"opt_state/1/mu/{k}"] = (shape, state.opt_axes[k])
            out[f"opt_state/1/nu/{k}"] = (shape, state.opt_axes[k])
    for k, axis in state.frozen_axes.items():
        if axis is not None:
            out[f"frozen/{k}"] = (tuple(state.model.stacked[k].shape), axis)
    return out


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
    Tensor leaves are the state's own tensors (no copies); under a plan the
    rank's masters and moments, and its slices of a frozen base
    (``checkpoint_layout`` gives their global shapes)."""
    opt = state.opt_state
    count = np.asarray(opt.count, np.int32)
    tree: Dict[str, Any] = {}
    if state.lora is not None:
        tree.update({f"frozen/{k}": v.detach() if state.plan is None
                     else state.plan.local(v.detach(), state.frozen_axes.get(k))
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
    ``rng`` is a JAX key). Under a plan each rank reads its slices (from a
    checkpoint of any world size: the shards are assembled by index)."""
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
    restored = load_checkpoint(ckpt_dir, checkpoint_tree(state),
                               layout=checkpoint_layout(state))
    if state.plan is not None:
        # every rank read its slices: make the working copy and a sharded
        # frozen base whole again (collectives, on every rank)
        state.gathered = None
        with torch.no_grad():
            for k, axis in state.frozen_axes.items():
                if axis is not None:
                    full = state.model.stacked[k]
                    coll.gather_full(state.plan.local(full, axis).clone(),
                                     axis, out=full)
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


class _Collectives:
    """The sharded step's communication (module docstring, steps 1-6) for
    ``plan``: every method is a collective, called by every rank at the
    same point of the step."""

    def __init__(self, plan: MeshPlan, policy: Optional[PrecisionPolicy]):
        self.plan = plan
        self.world = plan.n_data
        # one rank reduces nothing: no reduce-dtype round trip there
        self.reduce_dtype = (DTYPE_MAP[policy.reduce_dtype]
                             if policy is not None and self.world > 1 else None)

    def seed(self, seed: int) -> int:
        """The rank's dropout seed: the step's with the rank folded in."""
        return derive_seed(seed, self.plan.rank) if self.world > 1 else seed

    def share(self, inputs: torch.Tensor, weights: Optional[torch.Tensor]):
        """The rank's share of the global weighted mean: its weight sum over
        the global one (an all-reduce; each floored at 1, as the mean's
        denominator; without weights every token weighs 1)."""
        if weights is None:
            local = torch.full((), float(inputs.numel()), dtype=torch.float32,
                               device=inputs.device)
        else:
            local = weights.float().sum()
        total = coll.all_reduce(local.clone())
        return local.clamp_min(1.0) / total.clamp_min(1.0)

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss: the sum of the ranks' shares."""
        return coll.all_reduce(loss.detach().clone())

    def reduce(self, state: TrainState, grads: Flat) -> Flat:
        """The global gradients: each leaf cast to the reduce dtype,
        all-reduced or reduce-scattered onto the rank's shard (fsdp), cast
        back to its dtype."""
        out = {}
        for k, g in grads.items():
            x = g if self.reduce_dtype in (None, g.dtype) else g.to(self.reduce_dtype)
            axis = state.param_axes[k]
            if axis is None:
                coll.all_reduce(x)
                out[k] = g.copy_(x) if x is not g else g
                continue
            n = g.shape[axis] // self.world
            shard = torch.empty(_local_shape(g.shape, axis, self.world),
                                dtype=x.dtype, device=x.device)
            # rank r's part contiguous: the sharded dimension split into
            # (world, n) and the world factor moved in front
            coll.reduce_scatter_into(
                shard, x.unflatten(axis, (self.world, n)).movedim(axis, 0))
            out[k] = shard if shard.dtype == g.dtype else shard.to(g.dtype)
        return out

    def norm(self, tree: Flat, axes: Dict[str, Optional[int]]) -> torch.Tensor:
        """``optim.global_norm`` of a tree whose ``axes`` leaves are this
        rank's shards: their fp32 sums of squares all-reduced as one
        vector, then rounded and summed in leaf order."""
        sums = [torch.linalg.vector_norm(t, dtype=torch.float32).square()
                for t in tree.values()]
        idx = [i for i, k in enumerate(tree) if axes.get(k) is not None]
        if idx:
            vec = coll.all_reduce(torch.stack([sums[i] for i in idx]))
            for j, i in enumerate(idx):
                sums[i] = vec[j]
        total = None
        for sq, t in zip(sums, tree.values()):
            sq = sq.to(t.dtype)
            total = sq if total is None else total + sq
        return total.sqrt()

    def update(self, optimizer: AdamW, state: TrainState, grads: Flat,
               grad_norm: Optional[torch.Tensor] = None) -> dict:
        """AdamW on the rank's slices, then (zero1) the updated slices
        all-gathered into the whole parameters."""
        if grad_norm is None:
            # the clipping norm: of the whole gradients under dp and zero1,
            # of the shards under fsdp
            grad_norm = self.norm(grads, state.param_axes)
        zero1 = {k: a for k, a in state.opt_axes.items()
                 if a is not None and state.param_axes[k] is None}
        params = {k: self.plan.local(p, zero1.get(k))
                  for k, p in state.params.items()}
        g = {k: self.plan.local(v, zero1.get(k)) for k, v in grads.items()}
        metrics = optimizer.step(
            params, g, state.opt_state, grad_norm=grad_norm,
            norm=lambda u: self.norm(u, state.opt_axes))
        with torch.no_grad():
            for k, axis in zero1.items():
                coll.gather_full(params[k], axis, out=state.params[k])
        return metrics


def make_sharded_train_step(cfg: ModelConfig, optimizer: AdamW,
                            plan: MeshPlan,
                            use_fused_xent: Optional[bool] = None, *,
                            lora_alpha: Optional[float] = None,
                            lora_rank: Optional[int] = None,
                            policy: Optional[PrecisionPolicy] = None,
                            grad_accum: int = 1) -> Callable:
    """The train step of ``plan`` (dp, fsdp or zero1) on a state made with
    ``init_train_state(plan=plan)``: the rank's rows in, the global loss
    and an identical update on every rank out (module docstring). The
    arguments are ``make_train_step``'s."""
    return _build_train_step(cfg, optimizer, use_fused_xent,
                             lora_alpha=lora_alpha, lora_rank=lora_rank,
                             policy=policy, grad_accum=grad_accum, plan=plan)


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
    return _build_train_step(cfg, optimizer, use_fused_xent,
                             lora_alpha=lora_alpha, lora_rank=lora_rank,
                             policy=policy, grad_accum=grad_accum)


def _build_train_step(cfg: ModelConfig, optimizer: AdamW,
                      use_fused_xent: Optional[bool], *,
                      lora_alpha: Optional[float], lora_rank: Optional[int],
                      policy: Optional[PrecisionPolicy], grad_accum: int,
                      plan: Optional[MeshPlan] = None) -> Callable:
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_fn = make_loss_fns(cfg, use_fused_xent)
    sums_fn = make_sums_fn(cfg, use_fused_xent)
    full_params = make_full_params_fn(lora_alpha, lora_rank, policy)
    deterministic = cfg.drop_rate <= 0.0
    comm = _Collectives(plan, policy) if plan is not None else None
    world = 1 if comm is None else comm.world

    def check(state: TrainState) -> None:
        if (state.plan is None) != (plan is None) or (
                plan is not None and state.plan.shard_mode != plan.shard_mode):
            raise ValueError("the train state was made for another plan "
                             "(init_train_state(plan=) and the step's must agree)")

    def finish(state: TrainState, loss: torch.Tensor, grads: Flat,
               n_tokens: int):
        """The update, or with loss scaling the skip rule (module
        docstring), then the step count and the metrics."""
        update = (optimizer.step if comm is None else
                  lambda p, g, o, **kw: comm.update(optimizer, state, g, **kw))
        if state.loss_scale is None:
            metrics = update(state.params, grads, state.opt_state)
        else:
            if policy is None or not policy.loss_scaling:
                raise ValueError("a loss-scaled state needs its fp16 policy "
                                 "in make_train_step(policy=)")
            grad_norm = (global_norm(grads) if comm is None
                         else comm.norm(grads, state.param_axes))
            finite = bool(torch.isfinite(grad_norm) & torch.isfinite(loss))
            if comm is not None:
                # every rank must take the same branch: a rank that skipped
                # alone would leave the others in a later collective
                finite = coll.agree(finite, "min")
            if finite:
                metrics = update(state.params, grads, state.opt_state,
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
        metrics.update(loss=loss.detach(), tokens=n_tokens * world)
        return state, metrics

    def unscaled(state: TrainState, grads: Flat) -> Flat:
        """The gradients in fp32 with the loss scale divided out."""
        if state.loss_scale is None:
            return grads
        return {k: g.float().div_(state.loss_scale) for k, g in grads.items()}

    def start(state: TrainState) -> int:
        """Zero the gradient buffers, (fsdp) gather the working copy;
        returns the step's dropout seed."""
        check(state)
        for g in state.grads.values():
            _allocated(g).zero_()
        seed = step_seed(state.seed, state.step)
        if comm is None:
            return seed
        gather_params(state, exact=False)
        return comm.seed(seed)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        seed = start(state)
        weights = batch.get("weights")
        params, hidden = _hidden(full_params, state, batch["inputs"],
                                 seed=seed, deterministic=deterministic)
        loss = loss_fn(state.model, hidden, batch["targets"], weights,
                       head=params.get("head/weight"))
        if comm is not None:
            loss = loss * comm.share(batch["inputs"], weights)
        (loss if state.loss_scale is None else loss * state.loss_scale).backward()
        grads = unscaled(state, state.grads)
        if comm is not None:
            grads, loss = comm.reduce(state, grads), comm.loss(loss)
            release_params(state)
        return finish(state, loss, grads, batch["inputs"].numel())

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
        seed = start(state)
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
        if comm is not None:
            # the global batch's weight sum is the mean's denominator
            w_sum = coll.all_reduce(w_sum.detach().clone())
        denom = w_sum.clamp_min(1.0)
        if scale is not None:
            # the gradients carry the loss scale: divide it out with the
            # weight sum
            denom = denom * scale
        for g in grads.values():
            g.div_(denom)
        loss = nll_sum / w_sum.clamp_min(1.0)
        if comm is not None:
            grads, loss = comm.reduce(state, grads), comm.loss(loss)
            release_params(state)
        return finish(state, loss, grads, inputs.numel())

    return train_step if grad_accum == 1 else train_step_accum


def make_eval_step(cfg: ModelConfig, *, lora_alpha: Optional[float] = None,
                   lora_rank: Optional[int] = None,
                   policy: Optional[PrecisionPolicy] = None,
                   plan: Optional[MeshPlan] = None) -> Callable:
    """Build ``eval_step(state, batch) -> loss`` (0-d fp32 tensor, no
    gradients, no dropout; the train step's loss route, weights and
    policy cast). Under a ``plan`` the loss is the global batch's: each
    rank's weighted mean times its share of the weights, summed over the
    ranks (fsdp gathers the working copy first)."""
    loss_fn = make_loss_fns(cfg)
    full_params = make_full_params_fn(lora_alpha, lora_rank, policy)
    comm = _Collectives(plan, policy) if plan is not None else None

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if comm is not None:
            gather_params(state, exact=False)
        params, hidden = _hidden(full_params, state, batch["inputs"])
        loss = loss_fn(state.model, hidden, batch["targets"],
                       batch.get("weights"), head=params.get("head/weight"))
        if comm is None:
            return loss
        return comm.loss(loss * comm.share(batch["inputs"], batch.get("weights")))

    return eval_step
