"""Fused causal flash attention for training: forward (B1), dq (B2a) and
dk/dv summed over each kv head's query heads (B2b), wired as one
``torch.autograd.Function``, with the in-kernel attention dropout (port of
the JAX package's ``ops/fused_attention.py``).

``flash_attention_fwd``, ``flash_attention_dq`` and ``flash_attention_dkv``
launch the hand-written Hopper kernels for tensors on the card
(``kernel_source`` names the route: bf16 and fp16 ``csrc/attn_fwd_sm90.cu``,
``attn_dq_sm90.cu``, ``attn_dkv_sm90.cu``; fp32 the 3xTF32 kernels
``csrc/attn_fwd_f32_sm90.cu``, ``attn_dq_f32_sm90.cu``,
``attn_dkv_f32_sm90.cu``, all behind the entry points of
``csrc/fused_attention.cu``) and compute their plain twins (``*_plain``)
for tensors on the CPU. There is no fallback between the two: a CUDA call
the kernels cannot take raises. Each wrapper counts its launches
(``.launches``).

Layouts are the model's: q (B, T, Hq, D), k/v (B, T, Hkv, D); the softmax
statistics lse and delta are (B, Hq, T) fp32 (the JAX kernel's lane
replication is a TPU layout and is not carried over). Query head ``h``
reads kv head ``h // G``.

Dropout (``rate > 0``) follows the JAX kernels: the keep mask M multiplies
the exp terms that feed P.V but not the running denominator, the output is
scaled by 1/(1-p), and the backward uses dS = P (M (dO.V^T) / (1-p) - delta)
with delta = rowsum(dO * out) over the dropped output and P M / (1-p) for
dv. M is a pure function of (seed, b, h, q, k) (``ops/philox.py``), so the
three kernels and the twins draw the same mask; ``keep_mask`` dumps it.

The fp32 kernels take every product as three TF32 products (3xTF32);
``tf32_split_plain`` is the CPU model of their operand split, and the twins
take an ``einsum`` so that a test can run them on products built from it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from building_llm_from_scratch_tpu_torch.ops.philox import (
    attention_keep_mask,
    keep_threshold,
    split_seed,
)

#: dtype codes of the C entry points (csrc/fused_attention.cu)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: head dims the kernels are instantiated for
_KERNEL_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30


def kernel_source(dtype: torch.dtype, kernel: str) -> str:
    """The CUDA source that ``flash_attention_{kernel}`` (``kernel`` "fwd",
    "dq" or "dkv") launches for ``dtype`` (the route): the 3xTF32 kernels
    for fp32, the 16-bit Hopper kernels for bf16 and fp16."""
    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"no flash kernel {kernel!r}")
    return (f"attn_{kernel}_f32_sm90.cu" if dtype == torch.float32
            else f"attn_{kernel}_sm90.cu")


def tf32_split_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 kernels' operand split, as a CPU model (used by no main
    path): ``hi`` is x rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero: ``cvt.rna.tf32.f32``) by integer masking on the fp32
    bits, ``lo`` the same rounding of ``x - hi``. Both fp32."""
    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x.float() - hi)


def supports_shape(Tq: int, Tkv: int, D: int, block: int = 512) -> bool:
    """Shapes the fused kernel handles, the JAX package's rule: self-
    attention, ``T >= 256``, ``T % 128 == 0`` and divisible by
    ``min(block, T)``, head dim a multiple of 64 up to 256."""
    b = min(block, Tq)
    return (Tq == Tkv and Tq >= 2 * 128 and Tq % b == 0 and Tq % 128 == 0
            and D % 64 == 0 and D <= 256)


def check_kernel_shape(T: int, D: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the CUDA kernels take a (B, T, H, D) call of
    ``dtype``: ``supports_shape`` narrowed to the head dims and dtypes the
    kernels are instantiated for."""
    if not (supports_shape(T, T, D) and D in _KERNEL_HEAD_DIMS
            and dtype in _DTYPE_CODES):
        raise ValueError(
            f"the CUDA flash-attention kernels take head dims "
            f"{_KERNEL_HEAD_DIMS}, dtypes {list(_DTYPE_CODES)} and shapes "
            f"supports_shape allows (T >= 256, T % 128 == 0, T % min(512, T) "
            f"== 0); got T={T}, D={D}, {dtype}")


def attention_scale(D: int) -> float:
    """1/sqrt(D) as the JAX kernel computes it (a Python double)."""
    return 1.0 / float(D) ** 0.5


def keep_mask(seed: int, B: int, H: int, T: int, rate: float,
              device=None, h0: int = 0) -> torch.Tensor:
    """The (B, H, T, T) bool keep mask the kernels draw for ``seed`` and
    ``rate`` over query heads h0 ... h0 + H - 1 (the role of the JAX test's
    mask dump)."""
    return attention_keep_mask(seed, B, H, T, T, rate, device, h0=h0)


def _grouped_mask(seed: int, rate: float, q: torch.Tensor, Hkv: int,
                  h0: int = 0) -> torch.Tensor:
    """keep_mask in the twins' grouped (B, Hkv, G, T, T) layout."""
    B, T, Hq, _ = q.shape
    return keep_mask(seed, B, Hq, T, rate, q.device, h0).reshape(
        B, Hkv, Hq // Hkv, T, T)


# ---------------------------------------------------------------------------
# plain twins: the kernels' math on whole tensors
# ---------------------------------------------------------------------------

def _grouped(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, T, Hq, D) -> (B, T, Hkv, G, D) fp32."""
    B, T, Hq, D = x.shape
    return x.reshape(B, T, Hkv, Hq // Hkv, D).float()


def _probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
           einsum: Callable = torch.einsum) -> torch.Tensor:
    """exp(s - lse) with s the scaled causal scores: (B, Hkv, G, T, T) fp32;
    masked positions are exactly 0."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    s = einsum("bqhgd,bkhd->bhgqk", _grouped(q, Hkv), k.float())
    s = s * attention_scale(D)
    pos = torch.arange(T, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    return torch.exp(s - lse.reshape(B, Hkv, Hq // Hkv, T)[..., None])


def fused_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, rate: float = 0.0, seed: int = 0,
                              *, einsum: Callable = torch.einsum, h0: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's twin: (out (B, T, Hq, D) in q's dtype, lse (B, Hq, T) fp32).
    The exp terms (times the keep mask) are rounded to v's dtype before P.V
    and the sums taken in fp32, as the JAX kernel does; out = acc / l, times
    1/(1-rate) with dropout. ``einsum`` takes every product (the twins of
    all three kernels take it)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    s = einsum("bqhgd,bkhd->bhgqk", _grouped(q, Hkv), k.float())
    s = s * attention_scale(D)
    pos = torch.arange(T, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        p = torch.where(_grouped_mask(seed, rate, q, Hkv, h0), p, 0.0)
    acc = einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 3, 1, 2, 4)
    if rate > 0.0:
        out = out * (1.0 / (1.0 - rate))
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, T)
    return out.reshape(B, T, Hq, D).to(q.dtype), lse


def _dropped(dp: torch.Tensor, q: torch.Tensor, Hkv: int, rate: float,
             seed: int, h0: int = 0) -> torch.Tensor:
    """M * dp / (1-rate): the kernels' dp~ (dp itself without dropout)."""
    if rate <= 0.0:
        return dp
    return torch.where(_grouped_mask(seed, rate, q, Hkv, h0),
                       dp * (1.0 / (1.0 - rate)), 0.0)


def fused_attention_dq_plain(q, k, v, do, lse, delta, rate: float = 0.0,
                             seed: int = 0, *, einsum: Callable = torch.einsum,
                             h0: int = 0) -> torch.Tensor:
    """B2a's twin: dq (B, T, Hq, D) in q's dtype, with dS rounded to the
    model dtype before dS.K."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    p = _probs(q, k, lse, einsum)
    dp = einsum("bqhgd,bkhd->bhgqk", _grouped(do, Hkv), v.float())
    dp = _dropped(dp, q, Hkv, rate, seed, h0)
    ds = p * (dp - delta.reshape(B, Hkv, Hq // Hkv, T)[..., None])
    ds = ds * attention_scale(D)
    dq = einsum("bhgqk,bkhd->bqhgd", ds.to(q.dtype).float(), k.float())
    return dq.reshape(B, T, Hq, D).to(q.dtype)


def fused_attention_dkv_plain(q, k, v, do, lse, delta, rate: float = 0.0,
                              seed: int = 0, *, einsum: Callable = torch.einsum,
                              h0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2b's twin: per-QUERY-head (dk, dv), each (B, T, Hq, D) in the model
    dtype, with P M / (1-rate) and dS rounded to it before their products."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    p = _probs(q, k, lse, einsum)
    dog = _grouped(do, Hkv)
    pt = _dropped(p, q, Hkv, rate, seed, h0)
    dv = einsum("bhgqk,bqhgd->bkhgd", pt.to(do.dtype).float(), dog)
    dp = _dropped(einsum("bqhgd,bkhd->bhgqk", dog, v.float()), q, Hkv,
                  rate, seed, h0)
    ds = p * (dp - delta.reshape(B, Hkv, Hq // Hkv, T)[..., None])
    ds = ds * attention_scale(D)
    dk = einsum("bhgqk,bqhgd->bkhgd", ds.to(q.dtype).float(),
                _grouped(q, Hkv))
    return (dk.reshape(B, T, Hq, D).to(q.dtype),
            dv.reshape(B, T, Hq, D).to(q.dtype))


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in fp32, (B, Hq, T): a plain tensor op, as
    it is an XLA op in the JAX package."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def group_sum(d: torch.Tensor, Hkv: int) -> torch.Tensor:
    """Per-query-head (B, T, Hq, D) gradients summed over each kv head's G
    query heads -> (B, T, Hkv, D), in fp32 and rounded once (GQA)."""
    B, T, Hq, D = d.shape
    if Hq == Hkv:
        return d
    return d.reshape(B, T, Hkv, Hq // Hkv, D).float().sum(dim=3).to(d.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q must be (B, T, Hq, D) and k/v (B, T, Hkv, D)")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if tuple(k.shape) != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} (self-attention only)")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of kv heads {Hkv}")
    ts = (q, k, v) + tuple(rest)
    if len({t.device for t in ts}) != 1:
        raise ValueError("all tensors must be on one device")
    if len({t.dtype for t in (q, k, v)}) != 1:
        raise TypeError("q, k and v must share one dtype")


def _launch(name: str, fn_name: str, tensors: dict, q: torch.Tensor,
            Hkv: int, rate: float, seed: int, h0: int = 0) -> None:
    """Check what the kernel takes, then launch ``fn_name`` with the
    tensors in order (dtype, hd, B, T, Hq, Hkv, scale, dropout threshold,
    1/(1-rate), seed words, first head's global index, pointers...,
    stream); None passes a null pointer."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    B, T, Hq, D = q.shape
    check_kernel_shape(T, D, q.dtype)
    for tname, t in tensors.items():
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned (the "
                             "kernels read rows with TMA or 16-byte loads)")
        want = torch.float32 if tname in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {tname} must be {want}, got {t.dtype}")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [ctypes.c_void_p(t.data_ptr() if t is not None and t.numel() else None)
            for t in tensors.values()]
    seed_lo, seed_hi = split_seed(seed)
    err = getattr(lib, fn_name)(_DTYPE_CODES[q.dtype], D, B, T, Hq, Hkv,
                                ctypes.c_float(attention_scale(D)),
                                keep_threshold(rate) if rate > 0.0 else 0,
                                ctypes.c_float(1.0 / (1.0 - rate)),
                                seed_lo, seed_hi, h0, *ptrs,
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.bllm_error_string(err).decode()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rate: float = 0.0, seed: int = 0, h0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: (out (B, T, Hq, D), lse (B, Hq, T) fp32), attention dropout at
    ``rate`` with the mask of ``seed`` (its heads h0 ... h0 + Hq - 1: a
    tensor-parallel rank's). CUDA tensors launch the kernel (one count on
    ``flash_attention_fwd.launches``), CPU tensors compute
    ``fused_attention_fwd_plain``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_fwd_plain(q, k, v, rate, seed, h0=h0)
    B, T, Hq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, T, dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", "bllm_attn_fwd",
            dict(q=q, k=k, v=v, out=out, lse=lse), q, k.shape[2], rate, seed, h0)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, rate: float = 0.0,
                       seed: int = 0, h0: int = 0) -> torch.Tensor:
    """B2a: dq (B, T, Hq, D); kernel on CUDA (counted on
    ``flash_attention_dq.launches``), twin on the CPU."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return fused_attention_dq_plain(q, k, v, do, lse, delta, rate, seed, h0=h0)
    dq = torch.empty_like(q)
    _launch("flash_attention_dq", "bllm_attn_bwd_dq",
            dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dq=dq), q,
            k.shape[2], rate, seed, h0)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, rate: float = 0.0,
                        seed: int = 0, h0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2b: (dk, dv), each (B, T, Hkv, D): every query head's gradient
    rounded to the model dtype and summed over the G query heads of its kv
    head in fp32 (the JAX ``_bwd``'s rounding). On CUDA one launch sums in
    place, with no workspace (counted on ``flash_attention_dkv.launches``);
    on the CPU the twin is the per-head ``fused_attention_dkv_plain``
    followed by ``group_sum``."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        dk, dv = fused_attention_dkv_plain(q, k, v, do, lse, delta, rate, seed,
                                           h0=h0)
        Hkv = k.shape[2]
        return group_sum(dk, Hkv), group_sum(dv, Hkv)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_dkv", "bllm_attn_bwd_dkv",
            dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dk=dk, dv=dv,
                 work=None), q, k.shape[2], rate, seed, h0)
    flash_attention_dkv.launches += 1
    return dk, dv


#: kernel launches since the last reset (set to 0 to reset)
flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class FusedCausalAttention(torch.autograd.Function):
    """Forward B1, saving q, k, v, out and lse (the JAX VJP's residuals;
    the mask is regenerated from the seed, never stored); backward delta,
    B2a and B2b, which returns dk/dv already summed over each kv head's
    query heads."""

    @staticmethod
    def forward(ctx, q, k, v, rate, seed, h0):
        out, lse = flash_attention_fwd(q, k, v, rate, seed, h0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.rate, ctx.seed, ctx.h0 = rate, seed, h0
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, ctx.rate, ctx.seed,
                                    ctx.h0)
        return dq, dk, dv, None, None, None


def flash_backward(q, k, v, out, lse, do, rate: float, seed: int, h0: int = 0):
    """(dq, dk, dv) from B1's saved residuals: delta, then B2a and B2b."""
    do = do.contiguous()
    delta = attention_delta(out, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, rate, seed, h0)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, rate, seed, h0)
    return dq, dk, dv


def fused_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, dropout_rate: float = 0.0,
                           seed: int | None = None, h0: int = 0) -> torch.Tensor:
    """Causal attention of (B, T, Hq, D) queries over (B, T, Hkv, D) keys and
    values through the fused kernels, differentiable, with attention-weight
    dropout at ``dropout_rate`` drawn from the 64-bit ``seed`` (required
    when the rate is positive, as the JAX op requires its rng) for heads
    h0 ... h0 + Hq - 1."""
    T, D = q.shape[1], q.shape[3]
    if not supports_shape(T, k.shape[1], D):
        raise ValueError(f"fused attention needs a supports_shape shape; got "
                         f"Tq={T}, Tkv={k.shape[1]}, D={D}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    return FusedCausalAttention.apply(q.contiguous(), k.contiguous(),
                                      v.contiguous(), float(dropout_rate),
                                      int(seed or 0), int(h0))
