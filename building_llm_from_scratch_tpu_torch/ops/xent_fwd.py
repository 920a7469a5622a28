"""The vocab-streamed cross-entropy forward (B4; port of the JAX package's
``ops/xent_fwd_pallas.py``): for hidden states x (N, D), the head W (D, V)
and targets (N,), per-row ``(nll, lse)`` in fp32 with the online
logsumexp over vocab chunks, padded columns masked to -1e30, and no (N, V)
logits in device memory.

``xent_fwd`` launches the CUDA kernel (``csrc/xent_fwd.cu``) for tensors on
the card (counted on ``xent_fwd.launches``) and computes the twin
``xent_fwd_plain`` (the same chunked online logsumexp in plain torch) for
tensors on the CPU; a CUDA call the kernel cannot take raises. The training
loss reaches it through ``ops/softmax_xent.py`` when ``BLLM_XENT_PALLAS=1``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_NEG_BIG = -1e30
#: the accumulator lane width of the TPU kernel, kept for its VMEM rule
_LANES = 128
#: vocab columns of one kernel tile (csrc/xent_fwd.cu kBN)
_TILE = 128


def supports_shape(N: int, D: int, V: int, bv: int = 512) -> bool:
    """The JAX package's rule (its VMEM budget): N % 8 == 0, D % 128 == 0,
    N >= 128, and the resident buffers under 90 MB."""
    x_mb = N * D * 2 / 1e6
    s_mb = N * bv * 4 / 1e6
    acc_mb = 4 * N * _LANES * 4 / 1e6
    return (N % 8 == 0 and D % 128 == 0 and N >= 128
            and x_mb + s_mb + acc_mb + D * bv * 2 / 1e6 < 90)


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and an fp32 result (the JAX
    package's ``preferred_element_type=float32``): one GEMM with an fp32
    output on the card, the operands upcast first elsewhere (products of
    16-bit floats are exact in fp32, so the two are the same contraction)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def xent_fwd_plain(x2: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                   chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4's twin, and the forward of the chunked cross entropy
    (``ops/softmax_xent.py``, the JAX ``_xent_fwd_impl``'s scan):
    ``chunk``-wide vocab slices, fp32 logits, an online max and sum in fp32,
    the target logit picked; (nll, lse) (N,) fp32. The JAX package pads W
    to whole chunks and masks the padded columns to -1e30, whose terms are
    exact zeros of the sums and never the max; the last slice here is
    simply narrower, the same values without the padded copy of W."""
    N, V = x2.shape[0], w.shape[1]
    dev = x2.device
    m = torch.full((N,), _NEG_BIG, device=dev)
    s = torch.zeros(N, device=dev)
    tl = torch.full((N,), _NEG_BIG, device=dev)
    tgt = targets.long()
    for c0 in range(0, V, chunk):
        logits = matmul_fp32(x2, w[:, c0:c0 + chunk])
        width = logits.shape[1]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = tgt - c0
        in_range = (local >= 0) & (local < width)
        picked = logits.gather(1, local.clamp(0, width - 1)[:, None])[:, 0]
        tl = torch.where(in_range, picked, tl)
    lse = m + torch.log(s)
    return lse - tl, lse


def _splits(N: int, V: int, device: torch.device) -> int:
    """Vocab shares per row block: enough blocks for two per SM, each share
    owning at least one 128-column tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-V // _TILE)
    want = max(1, min(tiles, -(-2 * sms // -(-N // 128))))
    per = -(-tiles // want)
    return -(-tiles // per)


def xent_fwd(x2: torch.Tensor, w: torch.Tensor, targets: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: (nll (N,), lse (N,)) fp32. CUDA tensors launch the kernel (one
    count on ``xent_fwd.launches``), CPU tensors compute ``xent_fwd_plain``."""
    if x2.ndim != 2 or w.ndim != 2 or x2.shape[1] != w.shape[0] or \
            targets.shape != (x2.shape[0],):
        raise ValueError(f"xent_fwd takes x (N, D), w (D, V), targets (N,); got "
                         f"{tuple(x2.shape)}, {tuple(w.shape)}, {tuple(targets.shape)}")
    if len({x2.device, w.device, targets.device}) != 1:
        raise ValueError("xent_fwd: all tensors must be on one device")
    if x2.device.type == "cpu":
        return xent_fwd_plain(x2, w, targets)
    if x2.device.type != "cuda":
        raise ValueError(f"xent_fwd runs on cpu or cuda, not {x2.device}")
    N, D = x2.shape
    V = w.shape[1]
    if x2.dtype not in _DTYPE_CODES or w.dtype != x2.dtype:
        raise TypeError(f"xent_fwd takes x and w of one dtype of "
                        f"{list(_DTYPE_CODES)}; got {x2.dtype}, {w.dtype}")
    if D % 32 or not (x2.is_contiguous() and w.is_contiguous()) or x2.data_ptr() % 16:
        raise ValueError(f"xent_fwd: the kernel takes contiguous x (16-byte "
                         f"aligned) and w with D % 32 == 0; got D={D}")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    tgt = targets.to(torch.int64).contiguous()
    splits = _splits(N, V, x2.device)
    part = torch.empty(2, splits, N, dtype=torch.float32, device=x2.device)
    tl = torch.full((N,), _NEG_BIG, dtype=torch.float32, device=x2.device)
    nll = torch.empty(N, dtype=torch.float32, device=x2.device)
    lse = torch.empty_like(nll)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.bllm_xent_fwd(_DTYPE_CODES[x2.dtype], N, D, V, splits, ptr(x2), ptr(w),
                            ptr(tgt), ptr(part[0]), ptr(part[1]), ptr(tl), ptr(nll),
                            ptr(lse), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"xent_fwd kernel launch failed: "
                           f"{lib.bllm_error_string(err).decode()}")
    xent_fwd.launches += 1
    return nll, lse


#: kernel launches since the last reset (set to 0 to reset)
xent_fwd.launches = 0
