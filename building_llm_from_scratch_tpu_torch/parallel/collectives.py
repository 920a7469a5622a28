"""Collectives (port of the JAX package's ``parallel/collectives.py``).

The JAX package leaves its gradient all-reduce, the FSDP gathers and the
reduce-scatters to GSPMD, or writes them as ``psum`` / ``all_gather`` /
``psum_scatter`` inside ``shard_map``. The port calls them explicitly
through the thin wrappers below, one process per device:

  ``is_coordinator``          rank 0 (the reference's ``rank == 0``)
  ``sync_global_devices``     a barrier
  ``all_reduce``              sum (or max / min) in place
  ``all_gather_into``         every rank's tensor into one flat output
  ``reduce_scatter_into``     the sum of every rank's input, each rank
                              keeping its contiguous part
  ``gather_full``             a sharded leaf's full value on every rank
  ``ring_shift``              tensors sent one hop round a ring, the
                              previous rank's received (ring attention)
  ``send`` / ``recv``         one tensor to / from one rank (the pipeline's
                              hops between stages)
  ``broadcast_object``        a picklable object from rank 0

The reductions and gathers take a ``group`` (a mesh axis's subgroup,
``parallel.mesh.Mesh.group``; None is the whole group) and the axis name
``label`` it runs along. Every wrapper counts its calls and the bytes this
rank sends into it (the input's), by operation, dtype and, for an axis
other than the data axis of a data-only mesh, ``@<label>``
(``all_reduce@model/fp32``; ``counters``); ``reset_counters`` zeroes
them. On gloo a CUDA tensor is staged through the host explicitly (gloo is
a host backend: chip_smoke's two ranks on one card). Without a process
group every wrapper is the identity and counts nothing.

The gathers and reduce-scatters go through ``all_gather_into_tensor`` /
``reduce_scatter_tensor`` on flat 1-d tensors: torch 2.11 and 2.13 both
take that spelling (2.13 warns that it is deprecated).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_COUNTS: Dict[tuple, list] = collections.defaultdict(lambda: [0, 0])

_DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16",
                torch.float16: "fp16", torch.int32: "int32",
                torch.int64: "int64"}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """Rank 0 (the reference's ``rank == 0`` pattern)."""
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def group_device() -> torch.device:
    """Where a collective's own small tensors live: the current card under
    NCCL, the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def counters() -> Dict[str, Dict[str, int]]:
    """``{"<op>/<dtype>": {"calls": n, "bytes": b}}`` since the last reset."""
    return {f"{op}/{dt}": {"calls": c, "bytes": b}
            for (op, dt), (c, b) in sorted(_COUNTS.items())}


def reset_counters() -> None:
    _COUNTS.clear()


def group_size(group=None) -> int:
    """The number of ranks in ``group`` (None: the whole group)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This rank's index in ``group`` (None: its global rank)."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _count(op: str, t: torch.Tensor, label: Optional[str] = None) -> None:
    if label:
        op = f"{op}@{label}"
    entry = _COUNTS[(op, _DTYPE_NAMES.get(t.dtype, str(t.dtype)))]
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` must go through the host: a CUDA tensor on gloo."""
    return t.is_cuda and backend() == "gloo"


def sync_global_devices(name: str = "barrier") -> None:
    """Cross-rank barrier (reference ``dist.barrier``); ``name`` labels the
    call site."""
    del name
    if dist.is_initialized() and world() > 1:
        dist.barrier()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None,
               label: Optional[str] = None) -> torch.Tensor:
    """Reduce ``t`` over every rank of ``group`` in place (its own dtype)
    and return it."""
    if not dist.is_initialized():
        return t
    _count(f"all_reduce_{op}" if op != "sum" else "all_reduce", t, label)
    if _staged(t):
        host = t.cpu()
        dist.all_reduce(host, op=_OPS[op], group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group=None,
                    label: Optional[str] = None) -> torch.Tensor:
    """``out`` (contiguous, ``n x x.numel()`` elements for the ``n`` ranks
    of ``group``) <- every rank's ``x`` in rank order."""
    if not dist.is_initialized():
        out.view(-1).copy_(x.reshape(-1))
        return out
    _count("all_gather", x, label)
    src = x.reshape(-1).contiguous()
    if _staged(out):
        host = torch.empty(out.numel(), dtype=out.dtype)
        dist.all_gather_into_tensor(host, src.cpu(), group=group)
        out.view(-1).copy_(host)
    else:
        dist.all_gather_into_tensor(out.view(-1), src, group=group)
    return out


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group=None,
                        label: Optional[str] = None) -> torch.Tensor:
    """``out`` (contiguous, ``x.numel() / n`` elements) <- this rank's
    part of the sum over the ``n`` ranks of ``group`` of ``x`` (rank r
    keeps elements [r m, (r + 1) m) of the flat sum)."""
    if not dist.is_initialized():
        out.view(-1).copy_(x.reshape(-1))
        return out
    _count("reduce_scatter", x, label)
    src = x.reshape(-1).contiguous()
    if _staged(out):
        host = torch.empty(out.numel(), dtype=out.dtype)
        dist.reduce_scatter_tensor(host, src.cpu(), group=group)
        out.view(-1).copy_(host)
    else:
        dist.reduce_scatter_tensor(out.view(-1), src, group=group)
    return out


def gather_full(shard: torch.Tensor, axis: Optional[int],
                out: Optional[torch.Tensor] = None, group=None,
                label: Optional[str] = None) -> torch.Tensor:
    """The full value of a leaf sharded along ``axis`` over the ranks of
    ``group`` in rank order (the analog of FSDP's full-state gather), on
    every rank; ``axis`` None returns ``shard``. ``out``: the full-shape
    tensor to fill in place."""
    if axis is None:
        if out is not None and out is not shard:
            out.copy_(shard)
            return out
        return shard
    n = group_size(group)
    buf = torch.empty((n,) + tuple(shard.shape), dtype=shard.dtype,
                      device=shard.device)
    all_gather_into(buf, shard, group, label)
    full = torch.cat(buf.unbind(0), dim=axis)
    if out is None:
        return full
    out.copy_(full)
    return out


def ring_shift(tensors: list, group=None, label: Optional[str] = None) -> list:
    """Send each of ``tensors`` to the next rank of ``group`` (index i + 1
    mod n) and return what the previous rank sent (new tensors of the same
    shapes and dtypes): one hop of a ring."""
    n = group_size(group)
    if n == 1:
        return [t.clone() for t in tensors]
    me = group_rank(group)
    to = dist.get_global_rank(group, (me + 1) % n) if group is not None else (me + 1) % n
    frm = dist.get_global_rank(group, (me - 1) % n) if group is not None else (me - 1) % n
    out = []
    for t in tensors:
        _count("send", t, label)
        src = t.contiguous()
        staged = _staged(src)
        if staged:
            src = src.cpu()
        recv = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, to, group),
               dist.P2POp(dist.irecv, recv, frm, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out.append(recv.to(t.device) if staged else recv)
    return out


def send(t: torch.Tensor, dst: int, label: Optional[str] = None) -> None:
    """Send ``t`` to global rank ``dst`` (blocking until it is taken)."""
    _count("send", t, label)
    src = t.contiguous()
    dist.send(src.cpu() if _staged(src) else src, dst)


def recv(out: torch.Tensor, src: int) -> torch.Tensor:
    """``out`` <- the tensor global rank ``src`` sends (blocking)."""
    if _staged(out):
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.recv(host, src)
        out.copy_(host)
    else:
        dist.recv(out, src)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if not dist.is_initialized() or world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=group_device())
    return box[0]


def agree(flag: bool, op: str = "max", group=None) -> bool:
    """One boolean agreed over ranks: ``max`` (any rank), ``min`` (every
    rank)."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(flag)], dtype=torch.int32, device=group_device())
    return bool(all_reduce(t, op=op, group=group).item())
