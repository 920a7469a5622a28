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

The mesh is ``(data, seq, model)`` as in the JAX package, with data = the
world size and seq = model = 1: sequence and tensor parallelism are not
ported.
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
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, seq, model) mesh over the process group's ranks: data
    parallel over every rank, seq = model = 1 (sequence and tensor
    parallelism are not ported)."""

    data: int

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SEQ_AXIS: 1, MODEL_AXIS: 1}


def make_mesh(data: int = -1, world_size: Optional[int] = None) -> Mesh:
    """The mesh over ``world_size`` ranks (the group's, else 1). ``data=-1``
    takes the whole world; any other data size raises."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        data = world_size
    if data != world_size:
        raise ValueError(f"mesh data={data} != {world_size} ranks")
    return Mesh(data=data)
