"""The process group and the mesh (port of the JAX package's
``parallel/mesh.py``).

One process per device, as the reference's ``mp.spawn`` + NCCL
rendezvous ran it: a port rank is a JAX process that holds one device.
``initialize_distributed`` joins the group:

  1. explicit arguments (``rank``, ``world_size``, ``init_method``: the
     tests' ``file://`` rendezvous, chip_smoke's two ranks);
  2. torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
     ``MASTER_ADDR``/``MASTER_PORT``; ``BLLM_INIT_METHOD`` replaces the
     ``env://`` rendezvous with another URL, e.g. ``file://``), the
     counterpart of ``JAX_NUM_PROCESSES`` + ``coordinator_address``;
  3. neither: one process, no group.

The backend is ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``. A caller may
ask for ``gloo`` on ``cuda`` by name (two ranks on one card: NCCL refuses
two ranks on one device); nothing picks gloo, or the CPU, on its own, and a
failed NCCL init raises.

The mesh is ``(data, seq, model)`` as in the JAX package
(``make_mesh(data=-1, seq=, model=)``): global rank ``r`` sits at
``(r // (seq * model), (r // model) % seq, r % model)``, the JAX
``reshape(data, seq, model)`` of the device list. With seq = model = 1 the
data axis is the whole group (the default process group, as dp / fsdp /
zero1 ran before). Otherwise ``Mesh.group(axis)`` is this rank's
``torch.distributed`` subgroup along one axis (or over data and seq
together, ``"data_seq"``): every rank builds every line's group once, in
one order, as ``new_group`` requires.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from building_llm_from_scratch_tpu_torch.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

#: the rendezvous URL that replaces ``env://`` under torchrun's environment
INIT_METHOD_ENV = "BLLM_INIT_METHOD"


def default_backend(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's index among its host's ranks (torchrun's
    ``LOCAL_RANK``; the global rank when that is unset)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: torch.device | str) -> torch.device:
    """The device this rank runs on: ``cuda:<local rank>`` for a bare
    ``cuda``, else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           device: torch.device | str = "cuda",
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group (module docstring for the discovery order).
    Returns whether a group exists afterwards. A no-op when one already
    does. ``device``: the rank's device (``cuda`` is made
    ``cuda:<local rank>`` and made current before an NCCL init, which is
    eager, so a card that cannot join fails here). ``timeout_s`` bounds
    every collective of the group."""
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", "0"))
        init_method = init_method or os.environ.get(INIT_METHOD_ENV, "env://")
    if world_size is None:
        return False
    if rank is None or init_method is None:
        raise ValueError("initialize_distributed needs rank and init_method "
                         "with an explicit world_size")
    dev = rank_device(resolve_device(device))
    backend = backend or default_backend(dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    elif dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if there is one (its subgroups with it)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


#: the axes a rank's subgroups run along; "data_seq" is the data and seq
#: axes together (the ranks that share one model index)
GROUP_AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS, "data_seq")

#: (mesh type, shape) -> {axis: this rank's group}, built once per group
_GROUPS: dict = {}


class _Lines:
    """The subgroups of a mesh that has ``shape``, ``size``, ``line(rank,
    axis)`` and ``group_axes``: ``group(axis)`` is this rank's
    ``torch.distributed`` subgroup along one axis (or a pair of axes)."""

    group_axes: tuple = ()

    def group(self, axis: str):
        """This rank's process group along ``axis``: None (the default
        group) when the axis spans the whole world, its subgroup
        otherwise. A one-rank line's group is never used for a collective
        (the callers skip axes of size 1)."""
        if len(self.line(0, axis)) == self.size:
            return None
        key = (type(self).__name__, tuple(self.shape.values()))
        if key not in _GROUPS:
            _GROUPS[key] = self._build_groups()
        return _GROUPS[key][axis]

    def _build_groups(self) -> dict:
        """Every line's group on every rank, in one order; this rank's
        kept."""
        me = dist.get_rank()
        mine = {}
        for axis in self.group_axes:
            seen = set()
            for r in range(self.size):
                ranks = tuple(self.line(r, axis))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if me in ranks:
                    mine[axis] = g
        return mine


@dataclasses.dataclass(frozen=True)
class Mesh(_Lines):
    """The (data, seq, model) mesh over the process group's ranks."""

    data: int
    seq: int = 1
    model: int = 1

    group_axes = GROUP_AXES

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.seq * self.model

    def coords(self, rank: int) -> dict:
        """The (data, seq, model) indices of global rank ``rank``."""
        return {DATA_AXIS: rank // (self.seq * self.model),
                SEQ_AXIS: (rank // self.model) % self.seq,
                MODEL_AXIS: rank % self.model}

    def rank_of(self, data: int, seq: int, model: int) -> int:
        return (data * self.seq + seq) * self.model + model

    def line(self, rank: int, axis: str) -> list:
        """The global ranks of ``rank``'s line along ``axis`` (in axis
        order; "data_seq": data-major over both)."""
        c = self.coords(rank)
        d, s, m = c[DATA_AXIS], c[SEQ_AXIS], c[MODEL_AXIS]
        if axis == DATA_AXIS:
            return [self.rank_of(i, s, m) for i in range(self.data)]
        if axis == SEQ_AXIS:
            return [self.rank_of(d, i, m) for i in range(self.seq)]
        if axis == MODEL_AXIS:
            return [self.rank_of(d, s, i) for i in range(self.model)]
        return [self.rank_of(i, j, m) for i in range(self.data)
                for j in range(self.seq)]


def make_mesh(data: int = -1, seq: int = 1, model: int = 1,
              world_size: Optional[int] = None) -> Mesh:
    """The (data, seq, model) mesh over ``world_size`` ranks (the group's,
    else 1). ``data=-1`` takes what seq x model leaves of the world (the
    JAX ``make_mesh``); a product that is not the world raises."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if seq < 1 or model < 1:
        raise ValueError(f"mesh seq={seq} and model={model} must be >= 1")
    if data == -1:
        if world_size % (seq * model) != 0:
            raise ValueError(f"{world_size} ranks not divisible by "
                             f"seq*model={seq * model}")
        data = world_size // (seq * model)
    if data * seq * model != world_size:
        raise ValueError(f"mesh {data}x{seq}x{model} != {world_size} ranks")
    return Mesh(data=data, seq=seq, model=model)
