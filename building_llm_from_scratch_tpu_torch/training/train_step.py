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
fsdp, zero1, tp, tp_fsdp, each with sequence parallelism when the mesh's
seq axis is > 1; one process per device, the JAX ``make_train_step`` on a
GSPMD mesh and, for a policy that reduces in another dtype than it
computes (bf16_hybrid), ``make_sharded_train_step``). Every collective is
explicit and owns its dtype:

  1. fsdp: the leaves outside the blocks (embeddings, head, final norm)
     are cast to the compute dtype and all-gathered whole over the data
     axis (``gather_params``); the blocks' sharded leaves are gathered
     layer by layer, as the JAX GSPMD step slices them inside its layer
     scan (``_LayerGather``: layer l's slice, cast, into one of two
     buffers just before block l's forward, and again before its
     backward; its gradients reduce-scattered as soon as the block's
     backward has made them). bf16_hybrid, whose JAX step is the explicit
     one, and LoRA runs (whose merge needs the whole adapter) gather the
     whole working copy;
  2. the global weight sum (an all-reduce over data and seq) scales the
     rank's loss: its weighted mean times its share of the weights, so
     the sum over ranks is the global weighted mean (the JAX step's
     ``nll_sum / w_global``) and the reduced gradients are the global
     batch's. Prompt-masked SFT batches give ranks unequal shares; a mean
     of per-rank means would be wrong there;
  3. the backward on the rank's rows (under sp its T block), with the
     data index folded into the dropout seed (the JAX step folds
     ``axis_index(data)``); the seq and model ranks of one data index draw
     one run's masks, keyed on global heads and positions;
  4. the gradients (unscaled first under loss scaling, as the JAX step
     does) are cast to the policy's ``reduce_dtype`` (bf16 under
     bf16_hybrid; the gradient's own dtype without a policy), all-reduced
     over data and seq (dp, zero1, the replicated leaves) or
     reduce-scattered onto the rank's data shard (fsdp, then summed over
     seq), and cast back. Nothing reduces over the model axis: Megatron's
     f and g (``parallel/tensor.py``) sum the activations' partial
     products and gradients inside the forward and the backward, so every
     model rank holds its slices' whole gradients and the replicated
     leaves' identical ones;
  5. the clipping norm: from the whole reduced gradients under dp and zero1
     (so zero1 is bit-equal to dp); each leaf's fp32 sum of squares over
     the rank's shard (fsdp) or slice (tp), all-reduced as one vector over
     the axis it is split on, then rounded and summed in leaf order as
     ``optim.global_norm`` does. Under loss scaling the skip decision is
     agreed (all-reduce MIN);
  6. AdamW on the rank's slice with its slice of ``mu`` / ``nu`` (zero1,
     fsdp, tp), the same ``AdamW.step`` formulas; zero1 then all-gathers
     the updated slices into the whole parameters.

``make_pp_train_step`` / ``make_pp_eval_step`` are the steps of a
``parallel.pipeline.PipelinePlan`` (``--shard_mode pp``; the JAX
``make_pp_train_step`` / ``make_pp_eval_step``): the rank's stage of the
model (its L / S blocks, under tp their Megatron slices, and the whole
embeddings, final norm and head) runs the GPipe schedule
(``parallel.pipeline.run_gpipe``) on the global batch, the LoRA merge and
the policy cast made once a step before it (``make_full_params_fn``, so
gradients reach the adapter alone); then the block gradients are summed
over the data line and the replicated leaves' over data x stage, the loss
is sum(nll) / max(sum(w), 1) all-reduced over data x stage, and the finish
is the other steps': the global-norm clip (the block leaves' squares summed
over the stage line, each replicated leaf counted once), AdamW, the
schedule and the tokens (the global batch). fp16 and bf16_hybrid are
refused (``_check_pp_policy``), as in JAX.

At a world of one the step is the single-device step: the collectives are
identities on one rank, the loss share is exactly 1, no reduce-dtype cast
and no rank fold happen, so its losses equal ``make_train_step``'s bit for
bit. ``grad_accum`` microbatches reduce once per step (fsdp then adds each
layer's gradients into the full-size buffers). The metrics' loss is the
global one; ``tokens`` counts the global batch.

Under a plan the state (``init_train_state(plan=)``) holds the rank's
masters in ``params`` (fsdp: contiguous shards of the sharded leaves),
the rank's working leaves in ``full`` (the model's stacked leaves or the
adapter's; autograd's leaves, with their gradient buffers; under tp /
tp_fsdp the rank's model-axis slices, in a model of the rank's shapes,
while ``whole`` is the whole model that samples and exports gather into,
``gather_whole``), and the moments sharded as ``plan.opt_spec`` says. A
LoRA run's frozen base stays whole in the model; under fsdp its
checkpoint leaves are the rank's slices. fsdp frees the sharded leaves'
working copy and their full-size gradient buffers once the gradients are
reduced (``release_params``), so between steps a rank holds its masters
and moments only, and inside a step at most two layers' gathered block
weights.

Not ported here: the per-layer-group ``health`` bundle.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP, ModelConfig
from building_llm_from_scratch_tpu_torch.models.lora import (
    flatten_lora,
    merge_lora,
    unflatten_lora,
)
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    _head_logits,
    forward_hidden,
    stage_forward,
)
from building_llm_from_scratch_tpu_torch.obs.health import (
    GroupLayout,
    GroupSums,
)
from building_llm_from_scratch_tpu_torch.ops.softmax_xent import (
    fused_cross_entropy_loss,
    fused_cross_entropy_sums,
    kernel_refusal,
    vocab_parallel_cross_entropy,
    weighted_mean,
    weighted_sums,
    xent_kernel_requested,
)
from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
from building_llm_from_scratch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
)
from building_llm_from_scratch_tpu_torch.parallel.pipeline import (
    STAGE_AXIS,
    PipelinePlan,
    check_pp_config,
    dropout_sites,
    microbatches,
    run_gpipe,
)
from building_llm_from_scratch_tpu_torch.parallel.sharding import (
    MeshPlan,
    spec_axis,
)
from building_llm_from_scratch_tpu_torch.parallel.tensor import Parallel
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
    masters, ``full`` the rank's working leaves (``params`` itself without
    a plan; under tp / tp_fsdp the rank's model-axis slices, the leaves of
    ``model``, a model of the rank's shapes, while ``whole`` is the whole
    model that samples and exports gather into), ``param_axes`` /
    ``opt_axes`` / ``frozen_axes`` each leaf's data-sharded dimension
    (None: whole on every data rank) for the masters, the moments and a
    LoRA run's frozen base, ``tp_axes`` each leaf's model-sharded dimension
    (in the whole leaf's shape), and ``gathered`` the (step, exact) of the
    working copy's last fsdp gather (exact: the masters themselves, not
    their compute-dtype casts). Under pp (``init_train_state(plan=)`` with a
    ``PipelinePlan``) ``model`` is the rank's stage (a model of its L / S
    layers), ``stage_axes`` says which leaves split over the stages and
    ``whole`` / ``whole_lora`` are gathered by ``gather_whole``."""

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
    tp_axes: Dict[str, Optional[int]] = field(default_factory=dict)
    gathered: Optional[Tuple[int, bool]] = None
    #: the policy's compute dtype, which fsdp's step gathers in
    compute_dtype: Optional[torch.dtype] = None
    #: the whole model (under tp / tp_fsdp and pp; ``model`` otherwise)
    whole: Optional[Transformer] = None
    #: each trainable leaf's whole shape (the checkpoint's global shapes)
    whole_shapes: Dict[str, tuple] = field(default_factory=dict)
    #: pp: each leaf's stage-split dimension (0 for the blocks, None when
    #: whole on every stage)
    stage_axes: Dict[str, Optional[int]] = field(default_factory=dict)
    #: pp with LoRA: the whole adapter's leaves by flat name (the trainer's
    #: tree, which samples and exports gather into)
    whole_lora: Optional[Flat] = None


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
    TrainState docstring); under tp / tp_fsdp the rank trains a model of
    its slices, and the whole model keeps no memory until a sample or an
    export gathers it (``gather_whole``)."""
    if isinstance(plan, PipelinePlan):
        return _pipeline_state(trainable, optimizer, seed, frozen, policy, plan)
    whole = None
    if plan is not None and plan.n_model > 1 and plan.shard_mode in ("tp", "tp_fsdp"):
        if frozen is not None:
            raise ValueError("LoRA does not compose with --shard_mode tp / tp_fsdp "
                             "in the port (the adapter multiplies the whole "
                             "weights)")
        whole = trainable
        trainable = _model_slices(whole, plan)
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
                           seed=seed, lora=lora, full=params, whole=model)
    else:
        state = _placed_state(model, params, grads, optimizer, seed, lora, plan)
        state.whole = whole or model
        if whole is not None:
            state.tp_axes = {k: spec_axis(plan.param_spec(_names(k), tuple(v.shape)),
                                          MODEL_AXIS)
                             for k, v in whole.stacked.items()}
            _release(whole.stacked.values())
        if policy is not None:
            state.compute_dtype = policy.torch_compute_dtype
    if policy is not None and policy.loss_scaling:
        state.loss_scale = float(policy.init_loss_scale)
    return state


def _names(k: str) -> tuple:
    return tuple(k.split("/"))


def _pipeline_state(trainable, optimizer: AdamW, seed: int,
                    frozen: Optional[Transformer], policy: Optional[PrecisionPolicy],
                    plan: PipelinePlan) -> TrainState:
    """The TrainState of a pp rank: the rank's stage of the model (and of a
    LoRA adapter) in storage of its own, trained as one device trains its
    model; the whole model and adapter keep no memory until
    ``gather_whole``."""
    whole = trainable if frozen is None else frozen
    check_pp_config(whole.cfg, plan)
    stage = Transformer(dataclasses.replace(whole.cfg,
                                            n_layers=whole.cfg.n_layers // plan.n_stages),
                        _rank_slices(whole.stacked, plan), shapes=False)
    whole_lora = None
    local = stage
    if frozen is not None:
        whole_lora = {"/".join(p): leaf for p, leaf in flatten_lora(trainable).items()}
        local = unflatten_lora({tuple(k.split("/")): v for k, v in
                                _rank_slices(whole_lora, plan).items()})
    state = init_train_state(local, optimizer, seed,
                             frozen=None if frozen is None else stage, policy=policy)
    shapes = {k: tuple(v.shape) for k, v in (whole_lora or whole.stacked).items()}
    specs = {k: plan.param_spec(_names(k), shape) for k, shape in shapes.items()}
    state.plan, state.whole, state.whole_lora = plan, whole, whole_lora
    state.whole_shapes = shapes
    state.stage_axes = {k: spec_axis(spec, STAGE_AXIS) for k, spec in specs.items()}
    state.tp_axes = {k: spec_axis(spec, MODEL_AXIS) for k, spec in specs.items()}
    state.param_axes = dict.fromkeys(shapes)
    state.opt_axes = dict.fromkeys(shapes)
    _release(list(whole.stacked.values()) + list((whole_lora or {}).values()))
    return state


def _rank_slices(flat: Flat, plan: MeshPlan) -> Flat:
    """This rank's slice of every whole leaf of ``flat`` (the plan's
    specs), each in storage of its own."""
    return {k: plan.local_slice(v.detach(), plan.param_spec(_names(k), tuple(v.shape))
                                ).clone() for k, v in flat.items()}


def _model_slices(whole: Transformer, plan: MeshPlan) -> Transformer:
    """A model of this rank's model-axis slices of ``whole``'s leaves (the
    Megatron rule of ``plan``), in storage of its own."""
    flat = {}
    for k, v in whole.stacked.items():
        axis = spec_axis(plan.param_spec(_names(k), tuple(v.shape)), MODEL_AXIS)
        flat[k] = plan.local_model(v.detach(), axis).clone()
    return Transformer(whole.cfg, flat, shapes=False)


def _placed_state(model: Transformer, full: Flat, grads: Flat,
                  optimizer: AdamW, seed: int, lora, plan: MeshPlan) -> TrainState:
    """The TrainState of ``plan``'s rank: fsdp masters cloned from the
    rank's slices, the moments made at their slices' shapes. The specs
    are the whole leaves'; the data axis is the same dimension of the
    rank's model-axis slice."""
    whole_shape = _whole_shapes(model, full, plan)
    param_axes = {k: spec_axis(plan.param_spec(_names(k), whole_shape[k]))
                  for k in full}
    opt_axes = {k: spec_axis(plan.opt_spec(_names(k), whole_shape[k]))
                for k in full}
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
        frozen_axes = {k: spec_axis(plan.param_spec(_names(k), tuple(v.shape)))
                       for k, v in model.stacked.items()}
    return TrainState(model, params, grads, opt, seed=seed, lora=lora,
                      plan=plan, full=full, param_axes=param_axes,
                      opt_axes=opt_axes, frozen_axes=frozen_axes,
                      gathered=(0, True), whole_shapes=whole_shape)


def _whole_shapes(model: Transformer, full: Flat, plan: MeshPlan) -> dict:
    """Each working leaf's whole shape (a model-axis slice's times the
    model size along its tp axis)."""
    from building_llm_from_scratch_tpu_torch.models.transformer import param_shapes

    if plan.n_model == 1 or model.cfg is None:
        return {k: tuple(v.shape) for k, v in full.items()}
    shapes = param_shapes(model.cfg)
    return {k: shapes.get(k, tuple(v.shape)) for k, v in full.items()}


def gather_params(state: TrainState, exact: bool = True, skip=()) -> None:
    """Make the working copy (``state.full``) current: under fsdp, every
    sharded master all-gathered into it over the data axis, on every rank
    (a collective: every rank calls it at the same point). ``exact`` False
    casts the shards to the policy's compute dtype first (the train step's
    gather); True gathers the masters as they are (samples, exports,
    evaluation outside a policy). A no-op without sharded masters or when
    the copy is already current. ``skip``: leaves left to fsdp's per-layer
    gathers (the copy then counts as not gathered)."""
    if state.plan is None or not any(a is not None for a in state.param_axes.values()):
        return
    if state.gathered is not None and state.gathered[0] == state.step \
            and (state.gathered[1] or not exact):
        return
    dtype = None if exact else state.compute_dtype
    group = state.plan.group(DATA_AXIS)
    with torch.no_grad():
        for k, axis in state.param_axes.items():
            if axis is None or k in skip:
                continue
            src = state.params[k]
            if dtype is not None and src.is_floating_point() and src.dtype != dtype:
                src = src.to(dtype)
            coll.gather_full(src, axis, out=_allocated(state.full[k]), group=group)
    state.gathered = None if skip else (state.step, exact or dtype is None)


def gather_whole(state: TrainState) -> Transformer:
    """The whole model with the masters' current values, on every rank (a
    collective): the working copy gathered (``gather_params``), and under
    tp / tp_fsdp every model-axis slice gathered into ``state.whole``."""
    gather_params(state, exact=True)
    if state.stage_axes:
        return _gather_stages(state)
    if not state.tp_axes:
        return state.whole or state.model
    group = state.plan.group(MODEL_AXIS)
    with torch.no_grad():
        for k, v in state.whole.stacked.items():
            coll.gather_full(state.full[k], state.tp_axes[k], out=_allocated(v),
                             group=group, label=MODEL_AXIS)
    return state.whole


def gather_slice(state: TrainState, k: str, local: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pp: the whole value of leaf ``k`` (a parameter or moment of
    ``whole_shapes``, or a frozen base leaf) from every rank's ``local``
    slice: gathered over the model line, then over the stage line (a
    collective)."""
    plan = state.plan
    shape = state.whole_shapes.get(k) or tuple(state.whole.stacked[k].shape)
    spec = plan.param_spec(_names(k), shape)
    tp, st = spec_axis(spec, MODEL_AXIS), spec_axis(spec, STAGE_AXIS)
    if tp is not None and plan.n_model > 1:
        local = coll.gather_full(local, tp, group=plan.group(MODEL_AXIS),
                                 label=MODEL_AXIS)
    if st is None or plan.n_stages == 1:
        return local if out is None else out.copy_(local)
    return coll.gather_full(local, st, out=out, group=plan.group(STAGE_AXIS),
                            label=STAGE_AXIS)


def _gather_stages(state: TrainState) -> Transformer:
    """pp's ``gather_whole``: the whole model (and a LoRA run's whole
    adapter) from every rank's stage, on every rank."""
    with torch.no_grad():
        for k, v in state.whole.stacked.items():
            gather_slice(state, k, state.model.stacked[k], out=_allocated(v))
        for k, v in (state.whole_lora or {}).items():
            gather_slice(state, k, state.full[k], out=_allocated(v))
    return state.whole


def _allocated(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its storage allocated again after ``release_params``."""
    st = t.untyped_storage()
    need = (t.storage_offset() + t.numel()) * t.element_size()
    if st.nbytes() < need:
        st.resize_(need)
    return t


def _release(tensors) -> None:
    """Free the storage of each tensor that owns its whole storage (one a
    torch may resize: not a numpy array's); the tensors stay, with no
    memory behind them until ``_allocated``."""
    for t in tensors:
        st = t.untyped_storage()
        if st.resizable() and t.storage_offset() == 0 \
                and st.nbytes() == t.numel() * t.element_size():
            st.resize_(0)


def release_params(state: TrainState) -> None:
    """fsdp, once the gradients are reduced: free the storage of the
    sharded leaves' working copy and of their full-size gradient buffers.
    The tensors (and the model's per-layer views of them) stay, with no
    memory behind them until ``gather_params`` and the next step allocate
    it again."""
    sharded = [k for k, axis in state.param_axes.items() if axis is not None]
    _release([state.full[k] for k in sharded] + [state.grads[k] for k in sharded])
    state.gathered = None


def checkpoint_layout(state: TrainState) -> Dict[str, tuple]:
    """{checkpoint path: ``MeshPlan.leaf_layout``} of the leaves that
    ``checkpoint_tree`` holds as this rank's slices (empty without a
    plan)."""
    if state.plan is None:
        return {}
    plan, out = state.plan, {}
    shapes = state.whole_shapes
    for k in state.full:
        shape = shapes[k]
        spec = plan.param_spec(_names(k), shape)
        if spec:
            out[f"trainable/{k}"] = plan.leaf_layout(shape, spec)
        ospec = plan.opt_spec(_names(k), shape)
        if ospec:
            for m in ("mu", "nu"):
                out[f"opt_state/1/{m}/{k}"] = plan.leaf_layout(shape, ospec)
    if state.lora is not None:
        for k, v in state.whole.stacked.items():
            shape = tuple(v.shape)
            spec = plan.param_spec(_names(k), shape)
            if spec:
                out[f"frozen/{k}"] = plan.leaf_layout(shape, spec)
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
                                     axis, out=full,
                                     group=state.plan.group(DATA_AXIS))
    opt.count = int(restored["opt_state/1/count"])
    state.step = int(restored["step"])
    if state.loss_scale is not None:
        state.loss_scale = float(restored["loss_scale"])
        state.growth_count = int(restored["growth_count"])
    return state


def make_full_params_fn(lora_alpha: Optional[float] = None,
                        lora_rank: Optional[int] = None,
                        policy: Optional[PrecisionPolicy] = None) -> Callable:
    """``full_params(state, skip=()) -> Flat``: the weights the step's
    forward and loss run on instead of the model's own (the JAX
    ``make_full_params_fn``), built anew in every call so that autograd
    reaches the trainable leaves. Without LoRA or a policy none; with LoRA
    the merged adapted weights; with a policy every leaf (the merged ones
    included) cast to its compute dtype, but those in ``skip`` (fsdp's
    per-layer leaves, which its gathers cast)."""
    if lora_rank is None and policy is None:
        return lambda state, skip=(): {}

    def full_params(state: TrainState, skip=()) -> Flat:
        base = {k: v for k, v in state.model.stacked.items() if k not in skip}
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
    same point of the step. The data rank's replicas (the ranks of one
    data index along seq and model) share the weights; gradients and the
    loss reduce over data and seq, never over model."""

    def __init__(self, plan: MeshPlan, policy: Optional[PrecisionPolicy]):
        self.plan = plan
        self.world = plan.n_data
        self.replicas = plan.n_data * plan.n_seq
        # one rank reduces nothing: no reduce-dtype round trip there
        self.reduce_dtype = (DTYPE_MAP[policy.reduce_dtype]
                             if policy is not None and self.replicas > 1 else None)

    def _reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """All-reduce ``t`` over this rank's line along ``axis`` (none on a
        line of one rank inside a larger mesh)."""
        mesh = self.plan.mesh
        if mesh.size > 1 and len(mesh.line(self.plan.rank, axis)) == 1:
            return t
        label = None if axis in (DATA_AXIS, "data_seq") else axis
        return coll.all_reduce(t, op=op, group=self.plan.group(axis), label=label)

    def seed(self, seed: int) -> int:
        """The rank's dropout seed: the step's with the data index folded
        in (seq and model ranks of one data index draw one run's masks)."""
        return derive_seed(seed, self.plan.data_rank) if self.world > 1 else seed

    def share(self, inputs: torch.Tensor, weights: Optional[torch.Tensor]):
        """The rank's share of the global weighted mean: its weight sum over
        the global one (an all-reduce over data and seq; each floored at 1,
        as the mean's denominator; without weights every token weighs 1)."""
        if weights is None:
            local = torch.full((), float(inputs.numel()), dtype=torch.float32,
                               device=inputs.device)
        else:
            local = weights.float().sum()
        total = self._reduce(local.clone(), "data_seq")
        return local.clamp_min(1.0) / total.clamp_min(1.0)

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss: the sum of the ranks' shares."""
        return self._reduce(loss.detach().clone(), "data_seq")

    def reduce_leaf(self, g: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        """One gradient cast to the reduce dtype, all-reduced over data and
        seq (``axis`` None) or reduce-scattered onto the rank's data shard
        along ``axis`` (then summed over seq), cast back to its dtype."""
        x = g if self.reduce_dtype in (None, g.dtype) else g.to(self.reduce_dtype)
        if axis is None:
            self._reduce(x, "data_seq")
            return g.copy_(x) if x is not g else g
        n = g.shape[axis] // self.world
        shard = torch.empty(_local_shape(g.shape, axis, self.world),
                            dtype=x.dtype, device=x.device)
        # rank r's part contiguous: the sharded dimension split into
        # (world, n) and the world factor moved in front
        coll.reduce_scatter_into(
            shard, x.unflatten(axis, (self.world, n)).movedim(axis, 0),
            group=self.plan.group(DATA_AXIS))
        if self.plan.n_seq > 1:
            self._reduce(shard, SEQ_AXIS)
        return shard if shard.dtype == g.dtype else shard.to(g.dtype)

    def reduce(self, state: TrainState, grads: Flat) -> Flat:
        """The global gradients of ``grads`` (``reduce_leaf`` each)."""
        return {k: self.reduce_leaf(g, state.param_axes[k]) for k, g in grads.items()}

    def splits(self, state: TrainState, moments: bool = False) -> tuple:
        """(mesh axis, {leaf: its split dimension}) for each axis the rank's
        parameters (``moments``: its moments) are split on: their data
        shards and their model slices."""
        return ((DATA_AXIS, state.opt_axes if moments else state.param_axes),
                (MODEL_AXIS, state.tp_axes))

    def norm(self, tree: Flat, splits: tuple) -> torch.Tensor:
        """``optim.global_norm`` of a tree whose leaves are this rank's
        parts along ``splits`` (``splits()``): their fp32 sums of squares
        all-reduced (one vector per mesh axis), then rounded and summed in
        leaf order."""
        sums = [torch.linalg.vector_norm(t, dtype=torch.float32).square()
                for t in tree.values()]
        for mesh_axis, where in splits:
            idx = [i for i, k in enumerate(tree) if where.get(k) is not None]
            if idx:
                vec = self._reduce(torch.stack([sums[i] for i in idx]), mesh_axis)
                for j, i in enumerate(idx):
                    sums[i] = vec[j]
        total = None
        for sq, t in zip(sums, tree.values()):
            sq = sq.to(t.dtype)
            total = sq if total is None else total + sq
        return total.sqrt()

    def update(self, optimizer: AdamW, state: TrainState, grads: Flat,
               grad_norm: Optional[torch.Tensor] = None, on_updates=None) -> dict:
        """AdamW on the rank's slices, then (zero1) the updated slices
        all-gathered into the whole parameters."""
        if grad_norm is None:
            # the clipping norm: of the whole gradients under dp and zero1,
            # of the shards under fsdp and the slices under tp
            grad_norm = self.norm(grads, self.splits(state))
        zero1 = {k: a for k, a in state.opt_axes.items()
                 if a is not None and state.param_axes[k] is None}
        params = {k: self.plan.local(p, zero1.get(k))
                  for k, p in state.params.items()}
        g = {k: self.plan.local(v, zero1.get(k)) for k, v in grads.items()}
        metrics = optimizer.step(
            params, g, state.opt_state, grad_norm=grad_norm,
            norm=lambda u: self.norm(u, self.splits(state, moments=True)),
            on_updates=on_updates)
        with torch.no_grad():
            for k, axis in zero1.items():
                coll.gather_full(params[k], axis, out=state.params[k],
                                 group=self.plan.group(DATA_AXIS))
        return metrics


class _LayerGather:
    """fsdp's per-layer working copy of the sharded block leaves (the JAX
    GSPMD step slices them inside its layer scan, so XLA gathers them
    layer by layer): ``acquire(l)`` all-gathers layer l's slice of each
    sharded master over the data axis (cast to the compute dtype under a
    policy) into one of two buffers used in turn, and ``reduce(l, grads)``
    reduce-scatters layer l's full-size gradients onto the rank's shards
    as soon as the layer's backward has made them (loss scale divided out
    first, in the reduce dtype, as the whole-tree reduce does). With
    ``defer`` (gradient accumulation: one reduce a step) the gradients add
    into the full-size buffers instead and reduce with the rest."""

    def __init__(self, state: TrainState, comm: _Collectives, defer: bool):
        self.state, self.comm, self.defer = state, comm, defer
        self.keys = [k for k, a in state.param_axes.items()
                     if a is not None and k.startswith("blocks/")]
        self.names = {k[len("blocks/"):] for k in self.keys}
        self.slots: Dict[int, Tuple[int, Flat]] = {}
        self.shard_grads: Flat = {}
        #: (layer acquired, the layers whose weights the slots then hold)
        #: at each acquire
        self.held: list = []

    def acquire(self, layer: int) -> Flat:
        slot = self.slots.get(layer % 2)
        if slot is not None and slot[0] == layer:
            self.held.append((layer, sorted(s[0] for s in self.slots.values())))
            return slot[1]
        bufs = {} if slot is None else slot[1]
        st, dtype = self.state, self.state.compute_dtype
        group = st.plan.group(DATA_AXIS)
        with torch.no_grad():
            for k in self.keys:
                src = st.params[k][layer]
                if dtype is not None and src.is_floating_point() and src.dtype != dtype:
                    src = src.to(dtype)
                name = k[len("blocks/"):]
                if name not in bufs:
                    bufs[name] = torch.empty(st.full[k].shape[1:], dtype=src.dtype,
                                             device=src.device)
                coll.gather_full(src, st.param_axes[k] - 1, out=bufs[name], group=group)
        self.slots[layer % 2] = (layer, bufs)
        self.held.append((layer, sorted(s[0] for s in self.slots.values())))
        return bufs

    def reduce(self, layer: int, grads: Flat) -> None:
        st = self.state
        for name, g in grads.items():
            k = f"blocks/{name}"
            g = g.to(st.grads[k].dtype)
            if self.defer:
                st.grads[k][layer].add_(g)
                continue
            if st.loss_scale is not None:
                g = g.float().div_(st.loss_scale)
            shard = self.comm.reduce_leaf(g, st.param_axes[k] - 1)
            if k not in self.shard_grads:
                self.shard_grads[k] = torch.zeros(st.params[k].shape, dtype=shard.dtype,
                                                  device=shard.device)
            self.shard_grads[k][layer].copy_(shard)

    def close(self) -> None:
        self.slots.clear()


def make_sharded_train_step(cfg: ModelConfig, optimizer: AdamW,
                            plan: MeshPlan,
                            use_fused_xent: Optional[bool] = None, *,
                            lora_alpha: Optional[float] = None,
                            lora_rank: Optional[int] = None,
                            policy: Optional[PrecisionPolicy] = None,
                            grad_accum: int = 1) -> Callable:
    """The train step of ``plan`` (dp, fsdp, zero1, tp, tp_fsdp; with seq >
    1 sequence parallel) on a state made with ``init_train_state(plan=
    plan)``: the data rank's rows in (under sp the step keeps the rank's
    T block), the global loss and an identical update on every replica out
    (module docstring). The arguments are ``make_train_step``'s."""
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


def _parallel_losses(cfg: ModelConfig, use_fused_xent: Optional[bool],
                     par: Parallel):
    """The (loss, sums) functions of a rank of ``par``: the config's
    (``make_loss_fns``), or with a vocab-parallel head the vocab-parallel
    cross entropy over the rank's columns (``ops/softmax_xent.py``), or,
    when B4 is asked for (``BLLM_XENT_PALLAS=1``) and the config takes the
    chunked loss, that loss on the head all-gathered over the model axis,
    which raises on the card where B4 would not run."""
    loss_fn = make_loss_fns(cfg, use_fused_xent)
    sums_fn = make_sums_fn(cfg, use_fused_xent)
    if not par.vocab_parallel_head:
        return loss_fn, sums_fn
    gathered = xent_kernel_requested() and _auto_fused_xent(cfg, use_fused_xent)

    def head_of(model, head, hidden):
        w = model.head if head is None else head
        if gathered and hidden.is_cuda:
            why = kernel_refusal(hidden.reshape(-1, hidden.shape[-1]), w.shape[1] * par.n_model)
            if why is not None:
                raise ValueError(f"BLLM_XENT_PALLAS=1 gathers the vocab-parallel head "
                                 f"for B4, but {why}; unset it for the vocab-parallel loss")
        return w

    def vocab_parallel_nll(hidden, w, targets):
        # f before the column-parallel head: the hidden states' gradient
        # sums every rank's columns
        logits = _head_logits(par.copy_to_model(hidden), w)
        V = w.shape[1]
        return vocab_parallel_cross_entropy(logits.reshape(-1, V), targets.reshape(-1),
                                            par.model_rank * V, par.model_group)

    def loss(model, hidden, targets, weights=None, head=None):
        w = head_of(model, head, hidden)
        if gathered:
            return loss_fn(model, hidden, targets, weights, head=par.gather_vocab(w))
        return weighted_mean(vocab_parallel_nll(hidden, w, targets), weights)

    def sums(model, hidden, targets, weights=None, head=None):
        w = head_of(model, head, hidden)
        if gathered:
            return sums_fn(model, hidden, targets, weights, head=par.gather_vocab(w))
        return weighted_sums(vocab_parallel_nll(hidden, w, targets), weights)

    return loss, sums


def _health_sums(state: TrainState, comm: Optional["_Collectives"]) -> GroupSums:
    """The step's health accumulator (``obs/health.GroupSums``): the groups
    of the trainable tree; under a plan each leaf's split axes (the
    gradients' and parameters', the moments' for the updates) and the
    plan's reduce; under pp the whole model's layers, this stage's from
    its first."""
    if comm is None:
        return GroupSums(GroupLayout.of(state.params))
    if state.stage_axes:
        L = state.whole.cfg.n_layers
        layout = GroupLayout(list(state.params), L,
                             state.plan.stage_rank * (L // state.plan.n_stages))
    else:
        layout = GroupLayout.of(state.params)
    return GroupSums(layout, comm.splits(state), comm.splits(state, moments=True),
                     comm._reduce)


def _discarded(state: TrainState) -> TrainState:
    """A copy of the state's parameters and moments for the update a
    skipped step discards (the JAX step still reports it in its health
    bundle)."""
    opt = state.opt_state
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    return dataclasses.replace(state, params=clone(state.params),
                               opt_state=AdamState(opt.count, clone(opt.mu),
                                                   clone(opt.nu)))


def _finish(state: TrainState, loss: torch.Tensor, grads: Flat, tokens: int,
            optimizer: AdamW, comm: Optional["_Collectives"],
            policy: Optional[PrecisionPolicy]):
    """The update, or with loss scaling the skip rule (module docstring),
    then the step count and the metrics (``tokens``: the global batch's)
    with the per-layer-group ``health`` bundle: the gradients' sums taken
    before the clip scales them, the updates' inside the optimizer, the
    parameters' after it; on a skipped step the update it discards, made
    on copies."""
    with torch.profiler.record_function("optimizer"):
        sums = _health_sums(state, comm)
        sums.add("grad", grads)

        def update(st: TrainState, **kw) -> dict:
            kw["on_updates"] = lambda u: sums.add("update", u)
            if comm is None:
                return optimizer.step(st.params, grads, st.opt_state, **kw)
            return comm.update(optimizer, st, grads, **kw)

        after = state
        if state.loss_scale is None:
            metrics = update(state)
        else:
            if policy is None or not policy.loss_scaling:
                raise ValueError("a loss-scaled state needs its fp16 policy "
                                 "in make_train_step(policy=)")
            grad_norm = (global_norm(grads) if comm is None
                         else comm.norm(grads, comm.splits(state)))
            finite = bool(torch.isfinite(grad_norm) & torch.isfinite(loss))
            if comm is not None:
                # every rank must take the same branch: a rank that skipped
                # alone would leave the others in a later collective
                finite = coll.agree(finite, "min")
            if finite:
                metrics = update(state, grad_norm=grad_norm)
            else:
                after = _discarded(state)
                update(after, grad_norm=grad_norm)
                metrics = dict(grad_norm=grad_norm,
                               update_norm=torch.full_like(grad_norm, float("nan")))
            # the JAX metric: the schedule at the step, which runs ahead of the
            # optimizer's count once a step was skipped
            metrics["lr"] = optimizer.schedule(state.step)
            _update_loss_scale(state, finite, policy)
            metrics.update(loss_scale=state.loss_scale, skipped=int(not finite))
        sums.add("param", after.params)
        metrics["health"] = sums.bundle()
    state.step += 1
    metrics.update(loss=loss.detach(), tokens=tokens)
    return state, metrics


def _build_train_step(cfg: ModelConfig, optimizer: AdamW,
                      use_fused_xent: Optional[bool], *,
                      lora_alpha: Optional[float], lora_rank: Optional[int],
                      policy: Optional[PrecisionPolicy], grad_accum: int,
                      plan: Optional[MeshPlan] = None) -> Callable:
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    base_par = Parallel.of(plan, cfg)
    loss_fn, sums_fn = _parallel_losses(cfg, use_fused_xent, base_par)
    full_params = make_full_params_fn(lora_alpha, lora_rank, policy)
    deterministic = cfg.drop_rate <= 0.0
    comm = _Collectives(plan, policy) if plan is not None else None
    replicas = 1 if comm is None else comm.replicas
    # the JAX trainer's GSPMD step slices fsdp's block leaves inside its
    # layer scan; a policy that reduces in another dtype than it computes
    # (bf16_hybrid) takes the explicit step, which gathers them whole
    by_layer = policy is None or policy.reduce_dtype == policy.compute_dtype

    def check(state: TrainState) -> None:
        if (state.plan is None) != (plan is None) or (
                plan is not None and state.plan.shard_mode != plan.shard_mode):
            raise ValueError("the train state was made for another plan "
                             "(init_train_state(plan=) and the step's must agree)")

    def finish(state: TrainState, loss: torch.Tensor, grads: Flat,
               n_tokens: int):
        return _finish(state, loss, grads, n_tokens * replicas, optimizer, comm,
                       policy)

    def unscaled(state: TrainState, grads: Flat) -> Flat:
        """The gradients in fp32 with the loss scale divided out."""
        if state.loss_scale is None:
            return grads
        return {k: None if g is None else g.float().div_(state.loss_scale)
                for k, g in grads.items()}

    def start(state: TrainState, defer: bool):
        """Zero the gradient buffers, (fsdp) gather the working copy: the
        whole leaves, and for the sharded block leaves the per-layer
        source; returns the step's dropout seed and the rank's forward
        context."""
        check(state)
        gather = None
        if comm is not None and by_layer and state.lora is None and any(
                a is not None and k.startswith("blocks/")
                for k, a in state.param_axes.items()):
            # the blocks' working copy is gathered layer by layer: what a
            # sample or an evaluation gathered whole goes first
            release_params(state)
            gather = _LayerGather(state, comm, defer)
        for k, g in state.grads.items():
            if gather is None or k not in gather.keys or defer:
                _allocated(g).zero_()
        seed = step_seed(state.seed, state.step)
        par = dataclasses.replace(base_par, layers=gather)
        if comm is None:
            return seed, par
        gather_params(state, exact=False, skip=gather.keys if gather else ())
        return comm.seed(seed), par

    def params_of(state: TrainState, par: Parallel) -> Flat:
        skip = par.layers.keys if par.layers is not None else ()
        return full_params(state, skip)

    def reduced(state: TrainState, grads: Flat, par: Parallel) -> Flat:
        """The global gradients: the per-layer source's shards, the rest
        reduced here; then the working copy and gradients freed."""
        layered = par.layers is not None and not par.layers.defer
        rest = {k: g for k, g in grads.items()
                if not (layered and k in par.layers.keys)}
        out = comm.reduce(state, rest)
        if layered:
            out.update(par.layers.shard_grads)
            par.layers.close()
            out = {k: out[k] for k in grads}
        release_params(state)
        return out

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        seed, par = start(state, defer=False)
        if plan is not None:
            batch = plan.shard_batch(batch)
        weights = batch.get("weights")
        with torch.profiler.record_function("forward"):
            params = params_of(state, par)
            hidden = forward_hidden(state.model, batch["inputs"], params=params,
                                    seed=seed, deterministic=deterministic, par=par)
            loss = loss_fn(state.model, hidden, batch["targets"], weights,
                           head=params.get("head/weight"))
            if comm is not None:
                loss = loss * comm.share(batch["inputs"], weights)
        with torch.profiler.record_function("backward"):
            (loss if state.loss_scale is None else loss * state.loss_scale).backward()
        if comm is None:
            return finish(state, loss, unscaled(state, state.grads),
                          batch["inputs"].numel())
        layered = par.layers.keys if par.layers is not None else ()
        grads = unscaled(state, {k: None if k in layered else g
                                 for k, g in state.grads.items()})
        grads, loss = reduced(state, grads, par), comm.loss(loss)
        return finish(state, loss, grads, batch["inputs"].numel())

    def train_step_accum(state: TrainState, batch: Dict[str, torch.Tensor]):
        if plan is not None:
            batch = plan.shard_batch(batch)
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
        seed, par = start(state, defer=True)
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
            with torch.profiler.record_function("forward"):
                params = params_of(state, par)
                hidden = forward_hidden(state.model, inputs[rows], params=params,
                                        seed=step_seed(seed, i),
                                        deterministic=deterministic, par=par)
                nll, w = sums_fn(state.model, hidden, targets[rows], weights[rows],
                                 head=params.get("head/weight"))
            with torch.profiler.record_function("backward"):
                (nll if scale is None else nll * scale).backward()
            for k, acc in wide.items():
                acc += state.grads[k].float()
                state.grads[k].zero_()
            nll_sum = nll_sum + nll.detach()
            w_sum = w_sum + w
        grads = {k: wide.get(k, g) for k, g in state.grads.items()}
        if comm is not None:
            # the global batch's weight sum is the mean's denominator
            w_sum = comm._reduce(w_sum.detach().clone(), "data_seq")
        denom = w_sum.clamp_min(1.0)
        if scale is not None:
            # the gradients carry the loss scale: divide it out with the
            # weight sum
            denom = denom * scale
        for g in grads.values():
            g.div_(denom)
        loss = nll_sum / w_sum.clamp_min(1.0)
        if comm is not None:
            grads, loss = reduced(state, grads, par), comm.loss(loss)
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
    data and seq ranks (fsdp gathers the working copy first)."""
    par = Parallel.of(plan, cfg)
    loss_fn, _ = _parallel_losses(cfg, None, par)
    full_params = make_full_params_fn(lora_alpha, lora_rank, policy)
    comm = _Collectives(plan, policy) if plan is not None else None

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if comm is not None:
            gather_params(state, exact=False)
            batch = plan.shard_batch(batch)
        params = full_params(state)
        hidden = forward_hidden(state.model, batch["inputs"], params=params, par=par)
        loss = loss_fn(state.model, hidden, batch["targets"],
                       batch.get("weights"), head=params.get("head/weight"))
        if comm is None:
            return loss
        return comm.loss(loss * comm.share(batch["inputs"], batch.get("weights")))

    return eval_step


# ---------------------------------------------------------------------------
# pipeline parallelism (--shard_mode pp)
# ---------------------------------------------------------------------------

def _check_pp_policy(policy: Optional[PrecisionPolicy]) -> None:
    """The pipelined loss has no loss-scaling state and reduces in the
    gradients' own dtype, so fp16 (the scaler) and bf16_hybrid (another
    reduce dtype) are refused here, at the layer that owns the constraint,
    in the JAX words."""
    if policy is None:
        return
    if policy.compute_dtype == "fp16" or policy.reduce_dtype != policy.compute_dtype:
        raise ValueError(f"pipeline parallelism supports bf16/fp32 policies only; "
                         f"got '{policy.name}'")


class _PipelineCollectives(_Collectives):
    """pp's reduces (module docstring): the block gradients over the data
    line, the replicated leaves' over data x stage (stage 0 holds the
    embeddings' share, the last stage the final norm's and the head's); the
    loss's nll sum over data x stage; the clip norm's block squares over
    the stage line (and the model line under tp), a replicated leaf counted
    once. Nothing else reduces over the model axis: Megatron's f and g run
    inside the stage body. A one-rank line reduces nothing."""

    #: the group the replicated leaves' gradients sum over
    REPLICATED = "data_stage"

    def __init__(self, plan: PipelinePlan):
        self.plan = plan
        self.world = plan.n_data
        self.replicas = 1
        self.reduce_dtype = None

    def _reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        if len(self.plan.mesh.line(self.plan.rank, axis)) == 1:
            return t
        return coll.all_reduce(t, op=op, group=self.plan.group(axis),
                               label=None if axis == DATA_AXIS else axis)

    def splits(self, state: TrainState, moments: bool = False) -> tuple:
        return ((STAGE_AXIS, state.stage_axes), (MODEL_AXIS, state.tp_axes))

    def reduce(self, state: TrainState, grads: Flat) -> Flat:
        for k, g in grads.items():
            self._reduce(g, DATA_AXIS if state.stage_axes.get(k) is not None
                         else self.REPLICATED)
        return grads

    def mean(self, nll: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
        """The global loss: every rank's nll sum over the global weight
        sum."""
        return self._reduce(nll.detach().clone(), "data_stage") / total.clamp_min(1.0)


def _pp_runner(cfg: ModelConfig, plan: PipelinePlan, full_params: Callable,
               dropout_stages: Optional[int]) -> Callable:
    """``run(state, batch, seed, train) -> (nll sum, weight sum)``: one
    step's schedule on this rank (``parallel.pipeline.run_gpipe``) over the
    rank's stage, each microbatch's masks from ``dropout_sites``."""
    check_pp_config(cfg, plan)
    par = Parallel.of(plan, cfg)
    per_stage = cfg.n_layers // (dropout_stages or plan.n_stages)
    layer0 = plan.stage_rank * (cfg.n_layers // plan.n_stages)

    def run(state: TrainState, batch: Dict[str, torch.Tensor], seed: int, train: bool):
        inputs, targets, weights, total = microbatches(plan, batch)
        params = full_params(state)
        model = state.model
        denom = total.clamp_min(1.0)
        dropout = train and cfg.drop_rate > 0.0

        def stage(m: int, x: Optional[torch.Tensor]) -> torch.Tensor:
            sites = (dropout_sites(seed, plan.data_rank, m, layer0, per_stage)
                     if dropout else None)
            return stage_forward(model, x, tokens=inputs[m], sites=sites,
                                 params=params, par=par)

        def sums(m: int, y: torch.Tensor):
            # the last stage: the final norm and the dense fp32 loss (the JAX
            # pp body's ``loss_terms``, never the chunked loss)
            h = model.final_norm(y, params.get("final_norm/scale"),
                                 params.get("final_norm/bias"))
            nll, _ = dense_sums(model, h, targets[m],
                                None if weights is None else weights[m],
                                head=params.get("head/weight"))
            return nll / denom, nll.detach()

        act = (inputs.shape[1], inputs.shape[2], cfg.emb_dim)
        dtype = params.get("tok_emb/weight", model.tok_emb).dtype
        nll = run_gpipe(plan, act, dtype, inputs.device, stage, sums, train)
        return nll, total

    return run


def _check_pp_state(state: TrainState, plan: PipelinePlan) -> None:
    if not isinstance(state.plan, PipelinePlan):
        raise ValueError("the train state was made for another plan "
                         "(init_train_state(plan=) and the step's must agree)")


def make_pp_train_step(cfg: ModelConfig, optimizer: AdamW, plan: PipelinePlan, *,
                       lora_alpha: Optional[float] = None,
                       lora_rank: Optional[int] = None,
                       policy: Optional[PrecisionPolicy] = None,
                       dropout_stages: Optional[int] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` of a pp rank on a
    state made with ``init_train_state(plan=plan)`` (module docstring; the
    JAX ``make_pp_train_step``). ``batch`` is the global batch on every
    rank. ``dropout_stages``: the stage count whose per-stage seeds the
    masks follow (default the plan's): one rank with a pipelined run's
    count draws that run's masks, the comparison run."""
    _check_pp_policy(policy)
    comm = _PipelineCollectives(plan)
    run = _pp_runner(cfg, plan, make_full_params_fn(lora_alpha, lora_rank, policy),
                     dropout_stages)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _check_pp_state(state, plan)
        for g in state.grads.values():
            g.zero_()
        nll, total = run(state, batch, step_seed(state.seed, state.step), True)
        grads = comm.reduce(state, state.grads)
        return _finish(state, comm.mean(nll, total), grads, batch["inputs"].numel(),
                       optimizer, comm, None)

    return train_step


def make_pp_eval_step(cfg: ModelConfig, plan: PipelinePlan, *,
                      lora_alpha: Optional[float] = None,
                      lora_rank: Optional[int] = None,
                      policy: Optional[PrecisionPolicy] = None) -> Callable:
    """``eval_step(state, batch) -> loss`` on the pipelined forward (no
    dropout, no gradients; the JAX ``make_pp_eval_step``): the global
    batch's loss on every rank."""
    _check_pp_policy(policy)
    comm = _PipelineCollectives(plan)
    run = _pp_runner(cfg, plan, make_full_params_fn(lora_alpha, lora_rank, policy), None)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _check_pp_state(state, plan)
        return comm.mean(*run(state, batch, 0, False))

    return eval_step
