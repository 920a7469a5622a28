"""The sharding rule table (port of the JAX package's
``parallel/sharding.py``): data parallelism, FSDP and ZeRO-1 as rules over
one mesh, applied to the port's flat JAX-layout trees (``blocks/...``
stacked on the layer axis L, linear weights ``(in, out)``, the head
``(D, V)``):

  mode     params            optimizer state      batch       collectives
  ----     ------            ---------------      -----       -----------
  dp       replicated        replicated           data axis   gradient all-reduce
  fsdp     sharded on data   sharded on data      data axis   param all-gather +
                                                              gradient reduce-scatter
  zero1    replicated        sharded on data      data axis   gradient all-reduce;
                                                              state sharded, params
                                                              gathered after the update

The FSDP rule is the JAX one: shard the largest axis that divides by the
data size; stacked ``blocks`` leaves never shard their leading L axis;
leaves under ``fsdp_min_size`` elements stay replicated. ZeRO-1 places only
the optimizer state (``opt_spec``). GPT-2's vocabulary (50257) is odd, so
at data size 2 its ``tok_emb`` and ``head`` shard on D: the rule picks it,
there is no special case.

A spec is a tuple with one entry per dimension, ``"data"`` on the sharded
one and None elsewhere, ``()`` when the leaf is replicated: the JAX
``PartitionSpec`` as a tuple. A shard is the rank's contiguous slice along
that axis, in rank order, as ``jax.sharding`` lays out a data-sharded leaf.
tp and tp_fsdp are not ported (``args.QUEUE_ITEMS``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    make_mesh,
)

SHARD_MODES = ("dp", "fsdp", "zero1")

Spec = Tuple[Optional[str], ...]


def path_names(path: str) -> Tuple[str, ...]:
    """A flat tree path's names, without the positional (numeric) parts:
    ``opt_state/1/mu/blocks/attn/wq`` -> ("opt_state", "mu", "blocks",
    "attn", "wq"), as the JAX ``_path_names`` skips sequence keys."""
    return tuple(p for p in path.split("/") if not p.isdigit())


def _fsdp_axis(shape: Tuple[int, ...], n_shards: int,
               skip_leading_layer_axis: bool) -> Optional[int]:
    """The largest axis divisible by ``n_shards`` (None: replicate)."""
    if not shape:
        return None
    start = 1 if (skip_leading_layer_axis and len(shape) >= 2) else 0
    best, best_size = None, 0
    for i in range(start, len(shape)):
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


def spec_axis(spec: Spec) -> Optional[int]:
    """The data-sharded dimension of ``spec`` (None: replicated)."""
    for i, name in enumerate(spec):
        if name == DATA_AXIS:
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
        if not 0 <= self.rank < self.n_data:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.n_data}")

    @property
    def n_data(self) -> int:
        return self.mesh.data

    # -- spec rules (the JAX plan's) ------------------------------------

    @staticmethod
    def _is_stacked(names: Tuple[str, ...]) -> bool:
        return "blocks" in names

    def param_spec(self, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        """Spec of a model (or adapter) parameter leaf."""
        axis = None
        if self.shard_mode == "fsdp" and self.n_data > 1 \
                and int(np.prod(shape)) >= self.fsdp_min_size:
            axis = _fsdp_axis(tuple(shape), self.n_data,
                              skip_leading_layer_axis=self._is_stacked(names))
        return _spec_with_axis(len(shape), axis)

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
        axis = spec_axis(self.state_spec(path, tuple(shape)))
        return shard_bounds(shape, axis, self.n_data)[self.rank if axis is not None else 0]

    def local(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        """This rank's shard of the full tensor ``t`` along ``axis`` (a
        view; ``t`` itself when ``axis`` is None)."""
        if axis is None:
            return t
        n = t.shape[axis] // self.n_data
        return t.narrow(axis, self.rank * n, n)

    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A rank's batch is already its rows (the loaders cut them): a
        no-op, kept for the JAX plan's interface."""
        return batch


def shard_bounds(shape: Sequence[int], axis: Optional[int],
                 n: int) -> List[List[List[int]]]:
    """Each shard's ``[start, stop]`` per dimension, in rank order, of a
    leaf of global ``shape`` split ``n`` ways along ``axis`` (one shard, the
    whole leaf, when ``axis`` is None)."""
    full = [[0, int(d)] for d in shape]
    if axis is None:
        return [full]
    size = int(shape[axis]) // n
    out = []
    for r in range(n):
        b = [list(x) for x in full]
        b[axis] = [r * size, (r + 1) * size]
        out.append(b)
    return out


def build_mesh_plan(shard_mode: str = "dp", *,
                    world_size: Optional[int] = None,
                    rank: Optional[int] = None) -> MeshPlan:
    """The plan of ``shard_mode`` over the process group (data parallel over
    every rank)."""
    from building_llm_from_scratch_tpu_torch.parallel import collectives

    mesh = make_mesh(world_size=world_size)
    return MeshPlan(mesh=mesh, shard_mode=shard_mode,
                    rank=collectives.rank() if rank is None else rank)
