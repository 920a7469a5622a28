"""Tensor and sequence parallelism inside the forward (the port's
counterpart of the JAX package's GSPMD tp rules and ``sp_mesh`` ring
path): what one rank of a (data, seq, model) mesh needs to run its part of
``models.transformer.forward_hidden``.

Tensor parallelism is Megatron's, on the ``model`` axis, with the
``parallel/sharding.py`` rules: each rank holds its heads' columns of wq,
wk, wv (and their biases), its features of up / gate / b_up, and the
matching rows of wo and down. The autograd-aware operators:

  ``copy_to_model``      f: identity forward, all-reduce of the gradient
                         over the model group backward (before every
                         column-parallel projection)
  ``reduce_from_model``  g: all-reduce over the model group forward,
                         identity backward (after every row-parallel one;
                         replicated biases are added once, after it)
  ``vocab_embed``        the vocab-parallel embedding: the rank's rows
                         looked up with the other ids masked to 0, then g
  ``gather_vocab``       the head's vocabulary columns all-gathered
                         (backward: the rank's slice of the gradient)

Residual and embedding dropout act on the replicated activations with the
same seed on every model rank, so every rank draws the one-rank mask;
attention dropout keys its mask on the global head (``head_offset``).

Sequence parallelism splits T over the ``seq`` axis: each rank embeds and
projects its contiguous T / seq block at its global positions
(``positions``), attention runs the ring (``ops/ring_attention.py``), and
the dropout sites key their masks on global elements (``drop_layout``), so
a seq run draws a one-rank run's masks.

``Parallel()`` (no plan) is the one-device forward; every hook is then an
identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
from building_llm_from_scratch_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS


class _CopyToModel(torch.autograd.Function):
    """f: the identity, whose backward sums the gradient over the model
    group (every rank's columns contributed to it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g.contiguous().clone(), group=ctx.group,
                               label=MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the sum of the ranks' partial products, whose backward is the
    identity (the output is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        return coll.all_reduce(x.contiguous().clone(), group=group,
                               label=MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherVocab(torch.autograd.Function):
    """The head's (D, V / tp) columns all-gathered into (D, V); the
    backward keeps the rank's columns of the (identical on every rank)
    full gradient."""

    @staticmethod
    def forward(ctx, w, group, rank, n):
        ctx.rank, ctx.n = rank, n
        return coll.gather_full(w.contiguous(), 1, group=group, label=MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        v = g.shape[1] // ctx.n
        return g[:, ctx.rank * v:(ctx.rank + 1) * v].contiguous(), None, None, None


@dataclasses.dataclass
class Parallel:
    """One rank's place in the forward: its model-axis and seq-axis group,
    size and index (1 and 0 without a plan), and what the step passes down
    (``layers``: fsdp's per-layer weight source,
    ``training/train_step._LayerGather``)."""

    n_model: int = 1
    model_rank: int = 0
    model_group: object = None
    n_seq: int = 1
    seq_rank: int = 0
    seq_group: object = None
    #: whether tok_emb / head are split over the vocabulary on the model
    #: axis (their rows / columns: the rank's V / tp)
    vocab_parallel_emb: bool = False
    vocab_parallel_head: bool = False
    layers: object = None

    @classmethod
    def of(cls, plan, cfg=None) -> "Parallel":
        """The rank's context under ``plan`` (None: one device); ``cfg``
        tells whether its vocabulary splits."""
        if plan is None:
            return cls()
        par = cls(n_model=plan.n_model, model_rank=plan.model_rank,
                  n_seq=plan.n_seq, seq_rank=plan.seq_rank)
        if plan.n_model > 1:
            par.model_group = plan.group(MODEL_AXIS)
        if plan.n_seq > 1:
            par.seq_group = plan.group(SEQ_AXIS)
        if cfg is not None:
            V, D = cfg.vocab_size, cfg.emb_dim
            par.vocab_parallel_emb = plan.tp_axis(("tok_emb", "weight"), (V, D)) == 0
            par.vocab_parallel_head = plan.tp_axis(("head", "weight"), (D, V)) == 1
        return par

    @property
    def tp(self) -> bool:
        return self.n_model > 1

    @property
    def sp(self) -> bool:
        return self.n_seq > 1

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.model_group) if self.tp else x

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.model_group) if self.tp else x

    def head_offset(self, local_heads: int) -> int:
        """The global index of this rank's first (query) head."""
        return self.model_rank * local_heads

    def positions(self, T_local: int, device) -> torch.Tensor:
        """The global positions of this rank's T_local tokens."""
        return torch.arange(T_local, device=device) + self.seq_rank * T_local

    def drop_layout(self, shape) -> Optional[tuple]:
        """The dropout sites' mask layout of a (B, T_local, ...) activation
        under sp: (chunk, stride, offset) in groups of four elements, so
        local group i draws global group (i // chunk) * stride + offset +
        i % chunk (``ops/philox.flat_keep_mask``); None without sp."""
        if not self.sp:
            return None
        row = 1
        for d in shape[1:]:
            row *= int(d)
        if row % 4:
            raise ValueError(f"sequence-parallel dropout needs rows of a multiple "
                             f"of 4 elements; got {tuple(shape)}")
        return (row // 4, row * self.n_seq // 4, self.seq_rank * row // 4)

    def vocab_embed(self, w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding of global ``tokens`` from this rank's rows of a
        vocab-parallel table: masked lookup, then the sum over ranks
        (exactly one rank holds each row)."""
        V_local = w.shape[0]
        lo = self.model_rank * V_local
        local = tokens - lo
        inside = (local >= 0) & (local < V_local)
        x = w[torch.where(inside, local, torch.zeros_like(local))]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        return self.reduce_from_model(x)

    def gather_vocab(self, w: torch.Tensor) -> torch.Tensor:
        """The whole (D, V) head from this rank's (D, V / tp) columns."""
        return _GatherVocab.apply(w, self.model_group, self.model_rank, self.n_model)


#: the one-device context
SINGLE = Parallel()
