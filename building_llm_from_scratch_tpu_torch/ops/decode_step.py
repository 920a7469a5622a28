"""Fused single-token decode step: append the new k/v rows into the slot
cache at each row's length, then attend (port of the JAX package's
``ops/decode_step.py::fused_decode_step``).

``fused_decode_step`` launches the hand-written CUDA kernel
(``csrc/decode_step.cu``) for tensors on the card and computes its plain
twin, ``fused_decode_step_plain``, for tensors on the CPU. There is no
fallback between the two: a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from building_llm_from_scratch_tpu_torch.ops.attention import decode_attention

#: dtype codes of the C entry point (csrc/decode_step.cu)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: head dims the kernel is instantiated for
_KERNEL_HEAD_DIMS = (64, 128)


def slot_cache_append(cache: torch.Tensor, new: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, Hkv, Tq, hd) into ``cache`` (B, Hkv, Tmax, hd) at the
    per-row offsets ``lengths`` (B,) (or one scalar offset), IN PLACE, and
    return ``cache``. Offsets clamp so the update fits, like the
    dynamic-update-slice of the JAX package."""
    B, _, Tmax, _ = cache.shape
    Tq = new.shape[2]
    lengths = torch.as_tensor(lengths, device=cache.device)
    starts = lengths.reshape(-1).expand(B).long().clamp(0, Tmax - Tq)
    pos = starts[:, None] + torch.arange(Tq, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, Tq)
    # (B, Tq, Hkv, hd) advanced-index view of the cache
    cache.permute(0, 2, 1, 3)[rows, pos] = new.permute(0, 2, 1, 3).to(
        cache.dtype)
    return cache


def supports_shape(Tq: int, Tmax: int, hd: int) -> bool:
    """Eligibility of the JAX package's kernel: single-token decode,
    head dim a multiple of 64 up to 256, Tmax <= 8192 and a multiple of 8."""
    return (Tq == 1 and hd % 64 == 0 and hd <= 256 and Tmax <= 8192
            and Tmax % 8 == 0)


def check_kernel_shape(Tmax: int, hd: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the CUDA kernel takes a single-token step
    over a (.., Tmax, hd) cache of ``dtype``: ``supports_shape`` narrowed to
    the head dims and dtypes the kernel is instantiated for. The wrapper
    runs it before every launch; the serving engine runs it once, when it
    is built on the card, so a model it cannot serve fails before any
    request is admitted."""
    if not (supports_shape(1, Tmax, hd) and hd in _KERNEL_HEAD_DIMS
            and dtype in _DTYPE_CODES):
        raise ValueError(
            f"the CUDA decode-step kernel takes head dims {_KERNEL_HEAD_DIMS}, "
            f"dtypes {list(_DTYPE_CODES)} and a cache length Tmax that is a "
            f"multiple of 8 and <= 8192; got hd={hd}, {dtype}, Tmax={Tmax}")


def fused_decode_step_plain(q, k_new, v_new, k_cache, v_cache, lengths):
    """The kernel's twin in plain PyTorch: ``slot_cache_append`` followed by
    ``decode_attention`` over ``kv_pos <= lengths[b]``. Updates the caches
    in place and returns (out, k_cache, v_cache)."""
    B = q.shape[0]
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1).expand(B)
    slot_cache_append(k_cache, k_new.permute(0, 2, 1, 3), lengths)
    slot_cache_append(v_cache, v_new.permute(0, 2, 1, 3), lengths)
    out = decode_attention(q, k_cache, v_cache, q_positions=lengths[:, None],
                           kv_length=lengths + 1)
    return out, k_cache, v_cache


def _check(q, k_new, v_new, k_cache, v_cache, lengths) -> None:
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError("q must be (S, 1, Hq, hd) and caches (S, Hkv, Tmax, hd)")
    S, Tq, Hq, hd = q.shape
    _, Hkv, Tmax, _ = k_cache.shape
    if Tq != 1:
        raise ValueError(f"fused_decode_step is single-token only; Tq={Tq}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of kv heads {Hkv}")
    if tuple(k_cache.shape) != (S, Hkv, Tmax, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (S, 1, Hkv, hd):
            raise ValueError(f"{name} must be {(S, 1, Hkv, hd)}, got {tuple(t.shape)}")
    if not supports_shape(Tq, Tmax, hd):
        raise ValueError(f"shape Tq={Tq} Tmax={Tmax} hd={hd} is not eligible "
                         "for the fused decode step")
    dts = {t.dtype for t in (q, k_new, v_new, k_cache, v_cache)}
    if len(dts) != 1:
        raise TypeError(f"q, k/v rows and caches must share one dtype, got {dts}")
    devs = {t.device for t in (q, k_new, v_new, k_cache, v_cache)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    if torch.is_tensor(lengths) and lengths.device != q.device:
        raise ValueError("lengths must be on the tensors' device")


def fused_decode_step(q, k_new, v_new, k_cache, v_cache, lengths):
    """Append ``k_new``/``v_new`` at ``lengths`` and attend.

    q:                (S, 1, Hq, hd)   model layout, single token
    k_new, v_new:     (S, 1, Hkv, hd)
    k_cache, v_cache: (S, Hkv, Tmax, hd)
    lengths:          (S,) int32 per-row valid prefix (the write position)

    Returns (out (S, 1, Hq, hd), k_cache, v_cache). Unlike the JAX original
    (which aliases outputs to inputs), the caches are UPDATED IN PLACE and
    returned as the same tensor objects.

    CUDA tensors go through the hand-written kernel, read their lengths on
    the device (no host sync) and add one to ``fused_decode_step.launches``
    per launch; CPU tensors compute ``fused_decode_step_plain``."""
    _check(q, k_new, v_new, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return fused_decode_step_plain(q, k_new, v_new, k_cache, v_cache,
                                       lengths)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_step runs on cpu or cuda, not {q.device}")
    S, _, Hq, hd = q.shape
    _, Hkv, Tmax, _ = k_cache.shape
    check_kernel_shape(Tmax, hd, q.dtype)
    if not torch.is_tensor(lengths) or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (S,):
        raise TypeError("on the card lengths must be an int32 (S,) tensor")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_new", k_new), ("k_cache", k_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads "
                             "its rows with 16-byte loads)")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.bllm_fused_decode_step(
        _DTYPE_CODES[q.dtype], hd, S, Hq, Hkv, Tmax,
        p(q), p(k_new), p(v_new), p(k_cache), p(v_cache), p(lengths), p(out),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_decode_step kernel launch failed: "
                           f"{lib.bllm_error_string(err).decode()}")
    fused_decode_step.launches += 1
    return out, k_cache, v_cache


#: kernel launches since the last reset (set to 0 to reset)
fused_decode_step.launches = 0
