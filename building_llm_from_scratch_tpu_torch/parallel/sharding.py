"""The sharding rule table (port of the JAX package's
``parallel/sharding.py``): data parallelism, FSDP, ZeRO-1 and Megatron
tensor parallelism as rules over one (data, seq, model) mesh, applied to
the port's flat JAX-layout trees (``blocks/...`` stacked on the layer axis
L, linear weights ``(in, out)``, the head ``(D, V)``):

  mode     params            optimizer state      batch       collectives
  ----     ------            ---------------      -----       -----------
  dp       replicated        replicated           data axis   gradient all-reduce
  fsdp     sharded on data   sharded on data      data axis   param all-gather +
                                                              gradient reduce-scatter
  zero1    replicated        sharded on data      data axis   gradient all-reduce;
                                                              state sharded, params
                                                              gathered after the update
  tp       heads / features  follows params       data axis   activation all-reduces
           on model                                           over model (Megatron)
  tp_fsdp  tp, then fsdp on  follows params       data axis   both
           another axis

The FSDP rule is the JAX one: shard the largest axis that divides by the
data size; stacked ``blocks`` leaves never shard their leading L axis;
leaves under ``fsdp_min_size`` elements stay replicated. ZeRO-1 places only
the optimizer state (``opt_spec``). GPT-2's vocabulary (50257) is odd, so
at data size 2 its ``tok_emb`` and ``head`` shard on D: the rule picks it,
there is no special case.

The tensor-parallel rule is the JAX ``_TP_RULES``: column-parallel wq, wk,
wv, up and gate (and their biases) shard their output features on
``model``, row-parallel wo and down their input features, ``tok_emb`` and
``head`` their vocabulary; an axis that does not divide by the model size
keeps the leaf whole (GPT-2's V = 50,257 at tp 2), and tp_fsdp's fsdp axis
excludes the tp axis. With seq > 1 (``--sp``) batches shard over (data,
seq), along T (``batch_spec``).

A spec is a tuple with one entry per dimension, ``"data"`` / ``"model"``
on the sharded ones and None elsewhere, ``()`` when the leaf is
replicated: the JAX ``PartitionSpec`` as a tuple. A shard is the rank's
contiguous slice along each sharded dimension, at its index on that mesh
axis, as ``jax.sharding`` lays a leaf out; ``leaf_layout`` lists a leaf's
unique shards in the JAX checkpoint's order with the rank that writes each
(the lowest rank holding it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    make_mesh,
)

SHARD_MODES = ("dp", "fsdp", "zero1", "tp", "tp_fsdp")

#: Megatron rules: path suffix -> the axis (of the per-layer shape) that
#: shards on the model axis (the JAX ``_TP_RULES``)
_TP_RULES: Dict[Tuple[str, ...], int] = {
    ("blocks", "attn", "wq"): 1,
    ("blocks", "attn", "wk"): 1,
    ("blocks", "attn", "wv"): 1,
    ("blocks", "attn", "bq"): 0,
    ("blocks", "attn", "bk"): 0,
    ("blocks", "attn", "bv"): 0,
    ("blocks", "attn", "wo"): 0,
    ("blocks", "mlp", "up"): 1,
    ("blocks", "mlp", "gate"): 1,
    ("blocks", "mlp", "b_up"): 0,
    ("blocks", "mlp", "down"): 0,
    ("tok_emb", "weight"): 0,
    ("head", "weight"): 1,
}

Spec = Tuple[Optional[str], ...]


def path_names(path: str) -> Tuple[str, ...]:
    """A flat tree path's names, without the positional (numeric) parts:
    ``opt_state/1/mu/blocks/attn/wq`` -> ("opt_state", "mu", "blocks",
    "attn", "wq"), as the JAX ``_path_names`` skips sequence keys."""
    return tuple(p for p in path.split("/") if not p.isdigit())


def _fsdp_axis(shape: Tuple[int, ...], n_shards: int,
               skip_leading_layer_axis: bool,
               exclude: Optional[int] = None) -> Optional[int]:
    """The largest axis divisible by ``n_shards`` (None: replicate), never
    ``exclude`` (the axis tensor parallelism took)."""
    if not shape:
        return None
    start = 1 if (skip_leading_layer_axis and len(shape) >= 2) else 0
    best, best_size = None, 0
    for i in range(start, len(shape)):
        if i == exclude:
            continue
        if shape[i] % n_shards == 0 and shape[i] >= n_shards \
                and shape[i] > best_size:
            best, best_size = i, shape[i]
    return best


def _spec_with_axis(ndim: int, axis: Optional[int]) -> Spec:
    if axis is None:
        return ()
    spec = [None] * ndim
    spec[axis] = DATA_AXIS
    return tuple(spec)


def spec_axis(spec: Spec, mesh_axis: str = DATA_AXIS) -> Optional[int]:
    """The dimension of ``spec`` sharded on ``mesh_axis`` (None: none)."""
    for i, name in enumerate(spec):
        if name == mesh_axis:
            return i
    return None


@dataclasses.dataclass
class MeshPlan:
    """A mesh, a shard mode and this process's rank: where each leaf of a
    train state lives, and this rank's slice of it."""

    mesh: Mesh
    shard_mode: str = "dp"
    #: leaves with fewer elements stay replicated in fsdp (and zero1's
    #: state), as the JAX plan's
    fsdp_min_size: int = 1024
    rank: int = 0

    def __post_init__(self):
        if self.shard_mode not in SHARD_MODES:
            raise ValueError(
                f"shard_mode '{self.shard_mode}' not in {SHARD_MODES}")
        if not 0 <= self.rank < self.mesh.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.mesh.size}")

    @property
    def n_data(self) -> int:
        return self.mesh.data

    @property
    def n_seq(self) -> int:
        return self.mesh.seq

    @property
    def n_model(self) -> int:
        return self.mesh.model

    @property
    def coords(self) -> dict:
        return self.mesh.coords(self.rank)

    @property
    def data_rank(self) -> int:
        return self.coords[DATA_AXIS]

    @property
    def seq_rank(self) -> int:
        return self.coords[SEQ_AXIS]

    @property
    def model_rank(self) -> int:
        return self.coords[MODEL_AXIS]

    def group(self, axis: str):
        """This rank's process group along ``axis`` (``Mesh.group``)."""
        return self.mesh.group(axis)

    # -- spec rules (the JAX plan's) ------------------------------------

    @staticmethod
    def _is_stacked(names: Tuple[str, ...]) -> bool:
        return "blocks" in names

    def tp_axis(self, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Optional[int]:
        """The dimension the Megatron rule shards on ``model`` (None: the
        leaf stays whole on the model axis)."""
        if self.shard_mode not in ("tp", "tp_fsdp") or self.n_model <= 1:
            return None
        for suffix, ax in _TP_RULES.items():
            if names[-len(suffix):] == suffix:
                axis = ax + 1 if self._is_stacked(names) else ax
                if axis >= len(shape) or shape[axis] % self.n_model != 0:
                    return None
                return axis
        return None

    def param_spec(self, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        """Spec of a model (or adapter) parameter leaf."""
        tp = self.tp_axis(names, shape)
        axis = None
        if self.shard_mode in ("fsdp", "tp_fsdp") and self.n_data > 1 \
                and int(np.prod(shape)) >= self.fsdp_min_size:
            axis = _fsdp_axis(tuple(shape), self.n_data,
                              skip_leading_layer_axis=self._is_stacked(names),
                              exclude=tp)
        spec = [None] * len(shape)
        if tp is not None:
            spec[tp] = MODEL_AXIS
        if axis is not None:
            spec[axis] = DATA_AXIS
        return tuple(spec) if any(x is not None for x in spec) else ()

    def opt_spec(self, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        """Spec of an optimizer-state leaf (the Adam moments mirror the
        parameters; scalars replicate)."""
        if self.shard_mode == "zero1":
            axis = _fsdp_axis(tuple(shape), self.n_data,
                              skip_leading_layer_axis=self._is_stacked(names))
            if int(np.prod(shape)) < self.fsdp_min_size:
                axis = None
            return _spec_with_axis(len(shape), axis)
        return self.param_spec(names, shape)

    def state_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Spec of a train-state leaf by its checkpoint path
        (``trainable/...``, ``frozen/...``, ``opt_state/...``; the rest
        replicate), as the JAX ``state_shardings``."""
        names = path_names(path)
        shape = tuple(shape)
        if not shape or len(names) < 2:
            return ()
        if names[0] in ("trainable", "frozen"):
            return self.param_spec(names[1:], shape)
        if names[0] == "opt_state":
            return self.opt_spec(names[1:], shape)
        return ()

    # -- this rank's slice ----------------------------------------------

    def state_index(self, path: str, shape: Sequence[int]) -> List[List[int]]:
        """This rank's ``[start, stop]`` per dimension of the train-state
        leaf ``path`` of global ``shape``: what the checkpoint manifest
        records for the shard this rank holds."""
        return self.bounds(shape, self.state_spec(path, tuple(shape)), self.rank)

    def bounds(self, shape: Sequence[int], spec: Spec, rank: int) -> List[List[int]]:
        """Global rank ``rank``'s ``[start, stop]`` per dimension of a leaf
        of ``shape`` laid out as ``spec``."""
        c = self.mesh.coords(rank)
        out = [[0, int(d)] for d in shape]
        for i, name in enumerate(spec):
            if name is not None:
                size = int(shape[i]) // self.mesh.shape[name]
                out[i] = [c[name] * size, (c[name] + 1) * size]
        return out

    def leaf_layout(self, shape: Sequence[int], spec: Spec) -> tuple:
        """(global shape, unique shards' bounds in the JAX save's order
        (sorted by index), the index of the shard this rank writes (None:
        another rank owns it), this rank's own bounds). A shard's writer is
        the lowest rank holding it."""
        owners: Dict[tuple, int] = {}
        for r in range(self.mesh.size):
            key = tuple(map(tuple, self.bounds(shape, spec, r)))
            owners.setdefault(key, r)
        keys = sorted(owners)
        mine = next((i for i, k in enumerate(keys) if owners[k] == self.rank), None)
        return (tuple(int(d) for d in shape), [list(map(list, k)) for k in keys],
                mine, self.bounds(shape, spec, self.rank))

    def local_slice(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t`` laid out as ``spec``
        (a view)."""
        for i, (a, b) in enumerate(self.bounds(t.shape, spec, self.rank)):
            if b - a != t.shape[i]:
                t = t.narrow(i, a, b - a)
        return t

    def local(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        """This rank's shard of ``t`` along ``axis`` on the data axis (a
        view; ``t`` itself when ``axis`` is None)."""
        if axis is None:
            return t
        n = t.shape[axis] // self.n_data
        return t.narrow(axis, self.data_rank * n, n)

    def local_model(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        """This rank's shard of ``t`` along ``axis`` on the model axis (a
        view; ``t`` itself when ``axis`` is None)."""
        if axis is None:
            return t
        n = t.shape[axis] // self.n_model
        return t.narrow(axis, self.model_rank * n, n)

    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's part of its data rank's rows: the loaders cut the
        rows; with seq > 1 the rank keeps its contiguous T / seq block of
        every row (the JAX ``batch_spec`` P(data, seq))."""
        if self.n_seq == 1:
            return batch
        out = {}
        for k, v in batch.items():
            T = v.shape[1]
            if T % self.n_seq:
                raise ValueError(f"sequence length {T} not divisible by seq "
                                 f"axis {self.n_seq}")
            n = T // self.n_seq
            out[k] = v[:, self.seq_rank * n:(self.seq_rank + 1) * n]
        return out


def build_mesh_plan(shard_mode: str = "dp", *, tp: int = 1, sp: int = 1,
                    world_size: Optional[int] = None,
                    rank: Optional[int] = None) -> MeshPlan:
    """The plan of ``shard_mode`` over the process group: a (data, sp, tp)
    mesh with data taking the rest of the world (the JAX
    ``build_mesh_plan``)."""
    from building_llm_from_scratch_tpu_torch.parallel import collectives

    mesh = make_mesh(data=-1, seq=sp, model=tp, world_size=world_size)
    return MeshPlan(mesh=mesh, shard_mode=shard_mode,
                    rank=collectives.rank() if rank is None else rank)
