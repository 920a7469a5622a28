"""Single-token decode kernels (port of the JAX package's
``ops/decode_step.py``):

  - ``fused_decode_step`` (B5): append the new k/v rows into the slot cache
    at each row's length, then attend (``csrc/decode_step.cu``);
  - ``paged_decode_attention`` (B7): attend each slot's logical row through
    its page table over a shared page pool (``csrc/paged_decode.cu``);
  - ``lora_bgmv`` (B6): each row's LoRA delta through its own adapter's
    panes of a stacked pool (``csrc/bgmv.cu``).

Each wrapper launches its hand-written CUDA kernel for tensors on the card
and computes its plain twin (``*_plain``) for tensors on the CPU. There is
no fallback between the two: a CUDA call the kernel cannot take raises.
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
    over a (.., Tmax, hd) cache of ``dtype``: a head dim it is instantiated
    for, one of its dtypes and ``Tmax >= 1``. The kernel needs no more: its
    shared memory does not depend on Tmax and it clamps the write position
    to ``Tmax - 1``, so the TPU kernel's VMEM rule in ``supports_shape``
    (Tmax <= 8192 and a multiple of 8) does not apply. The wrapper runs it
    before every launch; the serving engine runs it once, when it is built
    on the card, so a model it cannot serve fails before any request is
    admitted."""
    if not (Tmax >= 1 and hd in _KERNEL_HEAD_DIMS and dtype in _DTYPE_CODES):
        raise ValueError(
            f"the CUDA decode-step kernel takes head dims {_KERNEL_HEAD_DIMS}, "
            f"dtypes {list(_DTYPE_CODES)} and a cache length Tmax >= 1; got "
            f"hd={hd}, {dtype}, Tmax={Tmax}")


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
    # the CPU twin stands for the JAX op and keeps its eligibility rule; on
    # the card the kernel's own rule (check_kernel_shape) applies
    if q.device.type != "cuda" and not supports_shape(Tq, Tmax, hd):
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


# ---------------------------------------------------------------------------
# B7: paged decode attention
# ---------------------------------------------------------------------------

def paged_view(leaf: torch.Tensor, page_table: torch.Tensor,
               cache_len: int) -> torch.Tensor:
    """Gather a (rows, Hkv, cache_len, hd) row-major view out of the pool
    leaf (N, Hkv, P, hd) through ``page_table`` (rows, M) (the JAX
    ``transformer._paged_view``). Page ids are clipped to [0, N-1], as the
    JAX gather clamps them."""
    N = leaf.shape[0]
    g = leaf[page_table.long().clamp(0, N - 1)]     # (rows, M, Hkv, P, hd)
    g = g.transpose(1, 2)                           # (rows, Hkv, M, P, hd)
    rows, Hkv, M, P = g.shape[:4]
    return g.reshape(rows, Hkv, M * P, *g.shape[4:])[:, :, :cache_len]


def check_paged_kernel_shape(hd: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the CUDA paged kernel is instantiated for
    head dim ``hd`` and ``dtype``. Every page size >= 1 is taken. The
    serving engine runs it when it is built on the card with a paged
    policy."""
    if hd not in _KERNEL_HEAD_DIMS or dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the CUDA paged decode-attention kernel takes head dims "
            f"{_KERNEL_HEAD_DIMS} and dtypes {list(_DTYPE_CODES)}; got "
            f"hd={hd}, {dtype}")


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                 cache_len=None):
    """B7's twin in plain PyTorch: ``paged_view`` of each pool followed by
    ``decode_attention`` over ``kv_pos <= lengths[s]`` (the JAX reference
    path). ``cache_len`` trims the view (default: the table's M * P)."""
    M, P = page_table.shape[1], k_pool.shape[2]
    cache_len = M * P if cache_len is None else cache_len
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1)
    K = paged_view(k_pool, page_table, cache_len)
    V = paged_view(v_pool, page_table, cache_len)
    return decode_attention(q, K, V, q_positions=lengths[:, None],
                            kv_length=lengths + 1)


def _check_paged(q, k_pool, v_pool, page_table, lengths) -> None:
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError("q must be (S, 1, Hq, hd) and pools (N, Hkv, P, hd)")
    S, Tq, Hq, hd = q.shape
    _, Hkv, _, _ = k_pool.shape
    if Tq != 1:
        raise ValueError(f"paged_decode_attention is single-token only; Tq={Tq}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of kv heads {Hkv}")
    if k_pool.shape[3] != hd or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != S:
        raise ValueError(f"page_table must be (S={S}, M), got "
                         f"{tuple(page_table.shape)}")
    if {t.dtype for t in (q, k_pool, v_pool)} != {q.dtype}:
        raise TypeError("q and the pools must share one dtype")
    devs = {t.device for t in (q, k_pool, v_pool, page_table)}
    if torch.is_tensor(lengths):
        devs.add(lengths.device)
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths):
    """Single-token attention through a page table.

    q:              (S, 1, Hq, hd)   model layout
    k_pool, v_pool: (N, Hkv, P, hd)  shared page pool, page 0 the trash page
    page_table:     (S, M) int32     physical page of each logical page
    lengths:        (S,) int32       attends logical positions <= lengths[s]
                                     (the new token's, already scattered)

    Returns (S, 1, Hq, hd). CUDA tensors go through the hand-written kernel
    (``csrc/paged_decode.cu``), read table and lengths on the device and add
    one to ``paged_decode_attention.launches`` per launch; CPU tensors
    compute ``paged_decode_attention_plain``."""
    _check_paged(q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    S, _, Hq, hd = q.shape
    N, Hkv, P, _ = k_pool.shape
    M = page_table.shape[1]
    check_paged_kernel_shape(hd, q.dtype)
    if N * Hkv * P >= 2 ** 31:
        raise ValueError(f"pool of {N} pages x {Hkv} heads x {P} rows exceeds "
                         "the kernel's 32-bit row index")
    for name, t, shape in (("page_table", page_table, (S, M)),
                           ("lengths", lengths, (S,))):
        if (not torch.is_tensor(t) or t.dtype != torch.int32
                or tuple(t.shape) != shape):
            raise TypeError(f"on the card {name} must be an int32 {shape} tensor")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pool.data_ptr() % 16:
        raise ValueError("k_pool must be 16-byte aligned (the kernel reads its "
                         "rows with 16-byte loads)")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.bllm_paged_decode(
        _DTYPE_CODES[q.dtype], hd, S, Hq, Hkv, P, N, M,
        p(q), p(k_pool), p(v_pool), p(page_table), p(lengths), p(out),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"{lib.bllm_error_string(err).decode()}")
    paged_decode_attention.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# B6: batched gathered LoRA delta (BGMV)
# ---------------------------------------------------------------------------

#: largest rank the CUDA kernel takes (its shared-memory intermediate)
_KERNEL_MAX_RANK = 256


def supports_lora_shape(D: int, r: int, O: int) -> bool:
    """Eligibility of the JAX package's TPU kernel for one (in=D, rank=r,
    out=O) projection: lane-aligned in/out widths and a sublane-aligned
    rank. The port never branches on it: its kernel takes any D and O
    (``check_lora_kernel_shape``)."""
    return D % 128 == 0 and O % 128 == 0 and r % 8 == 0 and 8 <= r <= 256


def check_lora_kernel_shape(r: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the CUDA BGMV kernel takes rank ``r`` and
    ``dtype``: 1 <= r <= 256 and fp32, fp16 or bf16, any in/out width. The
    adapter registry runs it when it builds a pool on the card, so an
    adapter set the kernel cannot serve fails before any request."""
    if not (1 <= r <= _KERNEL_MAX_RANK and dtype in _DTYPE_CODES):
        raise ValueError(
            f"the CUDA BGMV kernel takes ranks 1..{_KERNEL_MAX_RANK} and "
            f"dtypes {list(_DTYPE_CODES)}; got r={r}, {dtype}")


def lora_bgmv_plain(x, a_pool, b_pool, ids, scales):
    """B6's twin in plain PyTorch, with the kernel's rounding: gather the
    rows' clamped pool panes, ``x @ A`` in fp32, rounded to B's dtype, then
    ``@ B`` in fp32 times the row's fp32 scale; rows with id < 0 are exactly
    0. Returns (S, O) fp32."""
    N = a_pool.shape[0]
    ids = torch.as_tensor(ids, device=x.device).reshape(-1)
    idx = ids.long().clamp(0, N - 1)
    A = a_pool.index_select(0, idx).float()             # (S, D, r)
    B = b_pool.index_select(0, idx).float()             # (S, r, O)
    xa = torch.bmm(x.float()[:, None], A).to(b_pool.dtype).float()
    out = torch.bmm(xa, B)[:, 0] * scales.float().index_select(0, idx)[:, None]
    return torch.where((ids >= 0)[:, None], out, torch.zeros((), device=x.device))


def _check_bgmv(x, a_pool, b_pool, ids, scales) -> None:
    if x.ndim != 2 or a_pool.ndim != 3 or b_pool.ndim != 3:
        raise ValueError("x must be (S, D) and pools (N, D, r) / (N, r, O)")
    S, D = x.shape
    N, _, r = a_pool.shape
    if tuple(a_pool.shape) != (N, D, r) or b_pool.shape[:2] != (N, r):
        raise ValueError(f"pool shapes {tuple(a_pool.shape)}/"
                         f"{tuple(b_pool.shape)} do not match x {tuple(x.shape)}")
    if tuple(ids.shape) != (S,) or tuple(scales.shape) != (N,):
        raise ValueError(f"ids must be ({S},) and scales ({N},), got "
                         f"{tuple(ids.shape)}/{tuple(scales.shape)}")
    if {x.dtype, a_pool.dtype, b_pool.dtype} != {x.dtype}:
        raise TypeError("x and the pools must share one dtype")
    devs = {t.device for t in (x, a_pool, b_pool, ids, scales)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")


def lora_bgmv(x, a_pool, b_pool, ids, scales):
    """Per-row LoRA delta through the row's own pool panes (BGMV).

    x:       (S, D)     one activation row per slot (single-token decode)
    a_pool:  (N, D, r)  stacked adapter A panes (N = pool capacity); each
                        pane contiguous, the pool rows at any stride (a
                        layer's slice of the stacked (N, L, D, r) pool)
    b_pool:  (N, r, O)
    ids:     (S,) int32 pool row per row; -1 = base model (exact zero)
    scales:  (N,) fp32  alpha / rank per pool row

    Returns (S, O) fp32: ``scales[i] * round(x[s] @ A[i]) @ B[i]`` with
    ``i = ids[s]``. CUDA tensors go through the hand-written kernel
    (``csrc/bgmv.cu``), read ids and scales on the device and add one to
    ``lora_bgmv.launches`` per launch; CPU tensors compute
    ``lora_bgmv_plain``."""
    _check_bgmv(x, a_pool, b_pool, ids, scales)
    if x.device.type == "cpu":
        return lora_bgmv_plain(x, a_pool, b_pool, ids, scales)
    if x.device.type != "cuda":
        raise ValueError(f"lora_bgmv runs on cpu or cuda, not {x.device}")
    S, D = x.shape
    N, _, r = a_pool.shape
    O = b_pool.shape[2]
    check_lora_kernel_shape(r, x.dtype)
    if S > 65535:
        raise ValueError(f"{S} rows exceed the kernel's grid (65535)")
    if ids.dtype != torch.int32 or scales.dtype != torch.float32:
        raise TypeError("on the card ids must be int32 and scales float32")
    for name, t in (("x", x), ("ids", ids), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("a_pool", a_pool), ("b_pool", b_pool)):
        if not t[0].is_contiguous():
            raise ValueError(f"{name}'s panes must be contiguous within a pool "
                             f"row, got strides {t.stride()}")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    out = torch.empty((S, O), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.bllm_lora_bgmv(
        _DTYPE_CODES[x.dtype], S, D, r, O, N, a_pool.stride(0), b_pool.stride(0),
        p(x), p(a_pool), p(b_pool), p(ids), p(scales), p(out),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"lora_bgmv kernel launch failed: "
                           f"{lib.bllm_error_string(err).decode()}")
    lora_bgmv.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
lora_bgmv.launches = 0
