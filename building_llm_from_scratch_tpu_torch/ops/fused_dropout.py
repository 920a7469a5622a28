"""Fused residual and embedding dropout (B3; port of the JAX package's
``ops/fused_dropout.py``).

Two entry points, one kernel (``csrc/fused_dropout.cu``):

  fused_dropout(h, rate, seed)          -> dropout(h)        (embedding)
  fused_dropout_add(x, h, rate, seed)   -> x + dropout(h)    (residual)

The keep mask of flat element i is a pure function of the 64-bit ``seed``
and i (``ops/philox.py``), regenerated by the backward kernel, so nothing
mask-shaped is stored. The arithmetic is the Pallas kernel's:
``h * (1/(1-p)).astype(h.dtype)``, rounded in h's dtype (``_dropout``'s
``x / (1-p)`` in the transformer is the non-kernel route, for shapes
``supports_shape`` refuses, with the same mask).

``dropout_fwd`` and ``dropout_bwd`` launch the kernel for tensors on the
card (counted on ``.launches``) on the grid of ``dropout_plan`` and compute
their twins (``*_plain``) for tensors on the CPU; a CUDA call the kernel
cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from building_llm_from_scratch_tpu_torch.ops.philox import (
    flat_keep_mask,
    keep_threshold,
    split_seed,
)

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_ROWS = 512
# below this row-block size the JAX package's grid degenerates toward one
# PRNG reseed per handful of rows, and it takes the XLA path instead
_MIN_ROWS = 8
# the kernel's block (kThreads), the 16-byte vectors a thread loads in a
# pass before drawing their bits (kUnroll) and its resident blocks an SM
# (kBlocksPerSM, its __launch_bounds__): csrc/fused_dropout.cu
_THREADS = 256
_UNROLL = 1
_BLOCKS_PER_SM = 8


def _best_rows(n: int) -> int:
    r = min(_ROWS, n)
    while n % r:
        r -= 1
    return r


def supports_shape(shape) -> bool:
    """The JAX package's rule: the last dim a multiple of 128 and the folded
    leading dims admitting a row block of at least 8 (512 rows at most)."""
    if len(shape) < 2 or shape[-1] % 128 != 0:
        return False
    n = 1
    for d in shape[:-1]:
        n *= int(d)
    return _best_rows(n) >= _MIN_ROWS


def inv_keep(rate: float, dtype: torch.dtype) -> float:
    """1/(1-rate) rounded to ``dtype`` (``jnp.asarray(inv, h.dtype)``)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float64).to(dtype))


def dropout_plan(n: int, dtype: torch.dtype, sms: int) -> dict:
    """The kernel's grid for n elements of ``dtype`` on a card of ``sms``
    SMs (it reads no data): ``n_vec`` 16-byte vectors of ``vec`` elements
    and the ``tail`` elements past them (0, or 4 in the 16-bit types, one
    Philox group); ``blocks`` of ``threads``, at most one wave of resident
    blocks, the fewest whose threads make the same number of full
    ``passes`` of ``unroll`` vectors each. Pass p of thread j takes vectors
    p * unroll * S + j + u * S (u < unroll, S = blocks * threads) below
    n_vec; thread 0 also takes the tail."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    n_vec = n // vec
    per_pass = _THREADS * _UNROLL
    passes = max(1, -(-n_vec // (sms * _BLOCKS_PER_SM * per_pass)))
    blocks = max(1, -(-n_vec // (passes * per_pass)))
    return dict(vec=vec, n_vec=n_vec, tail=n - n_vec * vec, threads=_THREADS,
                unroll=_UNROLL, blocks=blocks, passes=passes)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def dropout_fwd_plain(x: Optional[torch.Tensor], h: torch.Tensor, seed: int,
                      rate: float, layout=None) -> torch.Tensor:
    """[x +] where(keep, h * inv, 0), every operation rounded to h's dtype.
    ``layout``: h is a block of a larger tensor whose bits it draws
    (``ops/philox.flat_keep_mask``)."""
    keep = flat_keep_mask(seed, h.shape, rate, h.device, layout)
    inv = torch.tensor(inv_keep(rate, h.dtype), dtype=h.dtype, device=h.device)
    out = torch.where(keep, h * inv, torch.zeros((), dtype=h.dtype, device=h.device))
    return out if x is None else x + out


def dropout_bwd_plain(g: torch.Tensor, seed: int, rate: float,
                      layout=None) -> torch.Tensor:
    """dh = where(keep, g * inv, 0) with the forward's mask."""
    return dropout_fwd_plain(None, g, seed, rate, layout)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, x: Optional[torch.Tensor], h: torch.Tensor, seed: int,
            rate: float, layout=None) -> torch.Tensor:
    ts = [h] if x is None else [x, h]
    if h.dtype not in _DTYPE_CODES or any(t.dtype != h.dtype for t in ts):
        raise TypeError(f"{name} takes one dtype of {list(_DTYPE_CODES)}; got "
                        f"{[t.dtype for t in ts]}")
    if x is not None and x.shape != h.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} and h {tuple(h.shape)} differ")
    if any(t.device != h.device for t in ts):
        raise ValueError(f"{name}: all tensors must be on one device")
    if h.numel() % 4:
        raise ValueError(f"{name}: the kernel takes groups of 4 elements; "
                         f"got {h.numel()}")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                             "aligned (vector loads)")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    out = torch.empty_like(h)
    lo, hi = split_seed(seed)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    plan = dropout_plan(h.numel(), h.dtype, sms)
    chunk, stride, offset = layout or (0, 0, 0)
    err = lib.bllm_dropout(_DTYPE_CODES[h.dtype], h.numel(), plan["blocks"],
                           keep_threshold(rate),
                           inv_keep(rate, h.dtype), lo, hi, chunk, stride, offset,
                           None if x is None else ctypes.c_void_p(x.data_ptr()),
                           ctypes.c_void_p(h.data_ptr()),
                           ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.bllm_error_string(err).decode()}")
    return out


def dropout_fwd(x: Optional[torch.Tensor], h: torch.Tensor, seed: int,
                rate: float, layout=None) -> torch.Tensor:
    """B3a: [x +] dropout(h). Kernel on CUDA (counted on
    ``dropout_fwd.launches``), ``dropout_fwd_plain`` on the CPU.
    ``layout``: the mask of a block of a larger tensor
    (``ops/philox.flat_keep_mask``)."""
    if h.device.type == "cpu":
        return dropout_fwd_plain(x, h, seed, rate, layout)
    if h.device.type != "cuda":
        raise ValueError(f"dropout_fwd runs on cpu or cuda, not {h.device}")
    out = _launch("dropout_fwd", x, h, seed, rate, layout)
    dropout_fwd.launches += 1
    return out


def dropout_bwd(g: torch.Tensor, seed: int, rate: float,
                layout=None) -> torch.Tensor:
    """B3b: dh = dropout(g) with the forward's mask. Kernel on CUDA (counted
    on ``dropout_bwd.launches``), ``dropout_bwd_plain`` on the CPU."""
    if g.device.type == "cpu":
        return dropout_bwd_plain(g, seed, rate, layout)
    if g.device.type != "cuda":
        raise ValueError(f"dropout_bwd runs on cpu or cuda, not {g.device}")
    out = _launch("dropout_bwd", None, g, seed, rate, layout)
    dropout_bwd.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
dropout_fwd.launches = 0
dropout_bwd.launches = 0


class _FusedDropout(torch.autograd.Function):
    """[x +] dropout(h); backward dx = g, dh = B3b(g). Only the seed is
    kept for the backward."""

    @staticmethod
    def forward(ctx, x, h, seed, rate, layout):
        ctx.seed, ctx.rate, ctx.add, ctx.layout = seed, rate, x is not None, layout
        return dropout_fwd(x, h, seed, rate, layout)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return (g if ctx.add else None,
                dropout_bwd(g, ctx.seed, ctx.rate, ctx.layout), None, None, None)


def fused_dropout(h: torch.Tensor, rate: float, seed: int,
                  layout=None) -> torch.Tensor:
    """dropout(h) with the mask drawn in the kernel (never stored)."""
    return _FusedDropout.apply(None, h.contiguous(), int(seed), float(rate), layout)


def fused_dropout_add(x: torch.Tensor, h: torch.Tensor, rate: float,
                      seed: int, layout=None) -> torch.Tensor:
    """x + dropout(h), the pre-norm residual update, in one pass."""
    return _FusedDropout.apply(x.contiguous(), h.contiguous(), int(seed),
                               float(rate), layout)
