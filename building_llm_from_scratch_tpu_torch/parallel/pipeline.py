"""Pipeline parallelism (port of the JAX package's ``parallel/pipeline.py``):
GPipe over a ``stage`` mesh axis, one process per device.

The L blocks split into S contiguous stages: stage s holds blocks
[s L/S, (s+1) L/S) (under tp their Megatron slices, ``_PP_TP_RULES``), and
every rank holds ``tok_emb``, ``pos_emb``, ``final_norm`` and ``head``
whole: there is no vocab-parallel embedding or loss under pp x tp, as the
JAX rules carry no entry for them. The mesh is (data, stage, model),
stage-major (``make_pp_mesh``): stage s owns the contiguous ranks
[s D T, (s+1) D T), so on several hosts the stage axis maps over hosts and
a hop is the only traffic between them. Every rank takes the whole global
batch; each microbatch is the (M, Bm, T) reshape of it, and a data column
takes the contiguous Bm / D rows of each (the JAX ``P(None, data)``).

The JAX schedule is one differentiable ``lax.scan`` over M + S - 1 ticks
with a ``ppermute`` hop, transposed by ``jax.grad``. The port writes it as
explicit GPipe on ``torch.distributed`` point-to-point (``run_gpipe``):
the forward of every microbatch in order (stage 0 embeds it, a later stage
receives its activation from stage s - 1; each sends its output to s + 1
and the last stage takes the loss's sums), then the backward in reverse
order (the last stage from its loss, the others from the activation
gradient stage s + 1 sends; each sends its input's gradient to s - 1). A
stage computes only the microbatches it holds: the JAX warmup and drain
ticks, which its ``lax.cond`` gates off, do not exist here. The loss is
sum(nll) / max(sum(w), 1) over every microbatch; every rank holds the
global batch, so it knows sum(w) before its backward.

Dropout seeds fold per (step, data index, stage, microbatch) and, within
the stage, per local layer j (``dropout_sites``); the embedding's is the
microbatch's folded with 10,000, the structure of the JAX keys.

Not ported: pp with sequence parallelism (refused, as in JAX), and JAX's
``GATE_INVALID_TICKS`` ablation switch (no tick is invalid here).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
from building_llm_from_scratch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    _Lines,
)
from building_llm_from_scratch_tpu_torch.parallel.sharding import MeshPlan, Spec
from building_llm_from_scratch_tpu_torch.utils.seeding import (
    derive_seed,
    site_seed,
)

STAGE_AXIS = "stage"

#: Megatron rules on the per-layer block tree for pp x tp (the JAX
#: ``_PP_TP_RULES``): path suffix -> the axis of the unstacked per-layer
#: shape that shards over the model axis
_PP_TP_RULES = {
    ("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
    ("attn", "bq"): 0, ("attn", "bk"): 0, ("attn", "bv"): 0,
    ("attn", "wo"): 0,
    ("mlp", "up"): 1, ("mlp", "gate"): 1, ("mlp", "b_up"): 0,
    ("mlp", "down"): 0,
}

#: what the embedding's dropout seed folds into the microbatch's (the JAX
#: ``fold_in(mb_key, 10_000)``)
EMBED_FOLD = 10_000


@dataclasses.dataclass(frozen=True)
class PPMesh(_Lines):
    """The (data, stage, model) mesh of pipeline parallelism, stage-major:
    global rank ``r`` sits at stage ``r // (data * model)``, data index
    ``(r // model) % data``, model index ``r % model`` (the JAX
    ``devices.reshape(stage, data, model).transpose(1, 0, 2)``)."""

    data: int
    stage: int
    model: int = 1

    #: the stage line (hops, loss totals), the data line (block
    #: gradients), the model line (Megatron's reduces), and data x stage
    #: (the replicated leaves' gradients)
    group_axes = (STAGE_AXIS, DATA_AXIS, MODEL_AXIS, "data_stage")

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, STAGE_AXIS: self.stage, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.stage * self.model

    def coords(self, rank: int) -> dict:
        return {DATA_AXIS: (rank // self.model) % self.data,
                STAGE_AXIS: rank // (self.data * self.model),
                MODEL_AXIS: rank % self.model}

    def rank_of(self, data: int, stage: int, model: int) -> int:
        return (stage * self.data + data) * self.model + model

    def line(self, rank: int, axis: str) -> list:
        """The global ranks of ``rank``'s line along ``axis`` (in axis
        order; "data_stage": stage-major over both)."""
        c = self.coords(rank)
        d, s, m = c[DATA_AXIS], c[STAGE_AXIS], c[MODEL_AXIS]
        if axis == DATA_AXIS:
            return [self.rank_of(i, s, m) for i in range(self.data)]
        if axis == STAGE_AXIS:
            return [self.rank_of(d, i, m) for i in range(self.stage)]
        if axis == MODEL_AXIS:
            return [self.rank_of(d, s, i) for i in range(self.model)]
        return [self.rank_of(j, i, m) for i in range(self.stage)
                for j in range(self.data)]


def make_pp_mesh(n_stages: int, tp: int = 1,
                 world_size: Optional[int] = None) -> PPMesh:
    """The (data, stage, model) mesh over ``world_size`` ranks (the
    group's, else 1): ``n_stages`` stages of ``tp`` model ranks, the data
    axis taking the rest (the JAX ``make_pp_mesh``)."""
    if world_size is None:
        world_size = coll.world()
    if n_stages < 1 or tp < 1 or world_size % (n_stages * tp) != 0:
        raise ValueError(f"{world_size} devices not divisible by {n_stages} stages "
                         f"x {tp} model shards")
    return PPMesh(data=world_size // n_stages // tp, stage=n_stages, model=tp)


def _tp_rule_axis(names: Tuple[str, ...]) -> Optional[int]:
    """The model-shard axis of a block leaf's per-layer shape, or None."""
    for suffix, ax in _PP_TP_RULES.items():
        if names[-len(suffix):] == suffix:
            return ax
    return None


@dataclasses.dataclass
class PipelinePlan(MeshPlan):
    """``--shard_mode pp``: block leaves (and their moments) split their
    layer axis over the stage axis and, under tp, their Megatron axis over
    the model axis; everything else is whole on every rank; every rank
    takes the global batch (the JAX ``PipelinePlan``). The shard rules,
    this rank's slices and the checkpoint layout are ``MeshPlan``'s over
    this mesh."""

    mesh: PPMesh = None
    shard_mode: str = "pp"
    n_micro: int = 8

    def __post_init__(self):
        if not isinstance(self.mesh, PPMesh) or self.shard_mode != "pp":
            raise ValueError("a PipelinePlan takes a PPMesh (make_pp_mesh) and "
                             "shard_mode 'pp'")
        if self.n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {self.n_micro}")
        if not 0 <= self.rank < self.mesh.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.mesh.size}")

    @property
    def n_stages(self) -> int:
        return self.mesh.stage

    @property
    def n_seq(self) -> int:
        return 1

    @property
    def seq_rank(self) -> int:
        return 0

    @property
    def stage_rank(self) -> int:
        return self.coords[STAGE_AXIS]

    def stage_peer(self, step: int) -> int:
        """The global rank of this rank's neighbour ``step`` stages on."""
        c = self.coords
        return self.mesh.rank_of(c[DATA_AXIS], c[STAGE_AXIS] + step, c[MODEL_AXIS])

    def tp_axis(self, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Optional[int]:
        """The stacked (L, ...) leaf's dimension that shards on the model
        axis (None: whole on it; never the embedding or the head)."""
        if self.n_model <= 1 or "blocks" not in names:
            return None
        ax = _tp_rule_axis(names)
        if ax is None or ax + 1 >= len(shape) or shape[ax + 1] % self.n_model:
            return None
        return ax + 1

    def param_spec(self, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        """Block leaves: the stage axis on the layer axis, plus the
        Megatron model axis (the JAX ``_block_leaf_spec`` with lead 1);
        everything else whole."""
        if "blocks" not in names or not shape or shape[0] % self.n_stages:
            return ()
        spec = [STAGE_AXIS] + [None] * (len(shape) - 1)
        tp = self.tp_axis(names, shape)
        if tp is not None:
            spec[tp] = MODEL_AXIS
        return tuple(spec)

    def opt_spec(self, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        return self.param_spec(names, shape)

    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The global batch itself: the schedule cuts the rank's rows of
        each microbatch (``microbatches``)."""
        return batch


def build_pp_plan(n_stages: int = 0, n_micro: int = 8, tp: int = 1,
                  world_size: Optional[int] = None,
                  rank: Optional[int] = None) -> PipelinePlan:
    """The plan over the process group: ``n_stages`` stages (0: the world
    over ``tp``, one stage per device otherwise, as the JAX
    ``build_plan``) of ``tp`` model ranks."""
    world = coll.world() if world_size is None else world_size
    stages = n_stages or max(1, world // tp)
    return PipelinePlan(mesh=make_pp_mesh(stages, tp=tp, world_size=world),
                        n_micro=n_micro, rank=coll.rank() if rank is None else rank)


def check_pp_config(cfg, plan: PipelinePlan) -> None:
    """The JAX loss's shape checks, in its words."""
    S, n_tp = plan.n_stages, plan.n_model
    if cfg.n_layers % S != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by {S} stages")
    if n_tp > 1 and (cfg.n_heads % n_tp or cfg.n_kv_groups % n_tp
                     or cfg.hidden_dim % n_tp):
        raise ValueError(f"tp={n_tp} must divide n_heads {cfg.n_heads}, n_kv_groups "
                         f"{cfg.n_kv_groups} and hidden_dim {cfg.hidden_dim}")


def microbatches(plan: PipelinePlan, batch: Dict[str, torch.Tensor]):
    """(inputs, targets, weights) of this rank's data column, each (M, Bm /
    D, T): the (M, Bm, T) reshape of the global batch, the column's
    contiguous rows of each microbatch; and the global batch's weight sum
    (its token count without weights), the loss's denominator."""
    M, D = plan.n_micro, plan.n_data
    inputs, targets = batch["inputs"], batch["targets"]
    B = inputs.shape[0]
    if B % M != 0:
        raise ValueError(f"batch size {B} not divisible by n_micro {M}")
    Bm = B // M
    if Bm % D != 0:
        raise ValueError(f"microbatch rows {Bm} not divisible by the data axis {D} "
                         f"(batch {B} / n_micro {M})")
    n, d = Bm // D, plan.data_rank
    weights = batch.get("weights")
    if weights is None:
        total = torch.full((), float(targets.numel()), dtype=torch.float32,
                           device=targets.device)
    else:
        total = weights.float().sum()

    def cut(x):
        return None if x is None else x.reshape(M, Bm, *x.shape[1:])[:, d * n:(d + 1) * n]
    return cut(inputs), cut(targets), cut(weights), total


def dropout_sites(seed: int, data: int, micro: int, layer0: int,
                  per_stage: int) -> Callable[[int, str], int]:
    """The dropout seeds of one microbatch of one data column: layer l of
    the rank's model is global layer ``layer0 + l``, local layer j of stage
    s (``divmod(layer0 + l, per_stage)``), drawing ``site_seed`` of the
    (step, data, stage, micro) fold at j; the embedding (stage 0) draws the
    micro's stage-0 fold folded with ``EMBED_FOLD``. One process holding
    every layer (``layer0`` 0) with a pipelined run's ``per_stage`` draws
    that run's masks."""
    def sites(layer: int, site: str) -> int:
        if site == "embedding":
            return derive_seed(derive_seed(seed, data, 0, micro), EMBED_FOLD)
        s, j = divmod(layer0 + layer, per_stage)
        return site_seed(derive_seed(seed, data, s, micro), j, site)
    return sites


def hop_forward(y: torch.Tensor, dst: int) -> None:
    """A microbatch's activation to the next stage."""
    coll.send(y, dst, label=STAGE_AXIS)


def hop_backward(g: torch.Tensor, dst: int) -> None:
    """A microbatch's activation gradient to the previous stage."""
    coll.send(g, dst, label=STAGE_AXIS)


def run_gpipe(plan: PipelinePlan, shape: tuple, dtype: torch.dtype, device,
              stage: Callable, sums: Callable, train: bool) -> torch.Tensor:
    """One step's GPipe schedule on this rank (module docstring).
    ``stage(m, x)`` runs the rank's layers on microbatch m (x None on the
    first stage, which embeds; else the received activation of ``shape`` /
    ``dtype``) and returns the output; ``sums(m, y)`` (last stage) returns
    the microbatch's (loss term to differentiate, its detached nll sum).
    With ``train`` the backward runs too (gradients accumulate in the
    leaves' buffers). Returns this rank's nll sum over its microbatches
    (0 off the last stage), fp32."""
    S, s = plan.n_stages, plan.stage_rank
    first, last = s == 0, s == S - 1
    nll_sum = torch.zeros((), dtype=torch.float32, device=device)
    held = []
    with torch.profiler.record_function("forward"):
        for m in range(plan.n_micro):
            x = None
            if not first:
                x = coll.recv(torch.empty(shape, dtype=dtype, device=device),
                              plan.stage_peer(-1))
                x.requires_grad_(train)
            y = stage(m, x)
            if last:
                y, nll = sums(m, y)
                nll_sum += nll
            else:
                hop_forward(y.detach(), plan.stage_peer(1))
            if train:
                held.append((x, y))
    if not train:
        return nll_sum
    with torch.profiler.record_function("backward"):
        for m in reversed(range(plan.n_micro)):
            x, y = held[m]
            # the microbatches' graphs share the step's merged / cast
            # weights: all but the last backward keep that shared part
            keep = m > 0
            if last:
                y.backward(retain_graph=keep)
            else:
                g = coll.recv(torch.empty_like(y), plan.stage_peer(1))
                y.backward(g, retain_graph=keep)
            if not first:
                hop_backward(x.grad, plan.stage_peer(-1))
            held[m] = None
    return nll_sum
