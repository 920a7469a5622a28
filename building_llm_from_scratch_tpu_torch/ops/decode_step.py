"""Single-token decode kernels (port of the JAX package's
``ops/decode_step.py``):

  - ``fused_decode_step`` (B5): append the new k/v rows into the slot cache
    at each row's length, then attend, split over the cache axis
    (``csrc/decode_step.cu``; the plan is ``split_kv_plan``);
  - ``paged_decode_attention`` (B7): attend each slot's logical row through
    its page table over a shared page pool, with B5's split pass and merge
    (``csrc/paged_decode.cu`` on ``csrc/decode_split.cuh``);
  - ``lora_bgmv`` (B6): each row's LoRA delta through its own adapter's
    panes of a stacked pool, as a grouped split-D shrink and an expand
    (``csrc/bgmv.cu``; the plan is ``bgmv_plan``).

Each wrapper launches its hand-written CUDA kernel for tensors on the card
and computes its plain twin (``*_plain``) for tensors on the CPU. There is
no fallback between the two: a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from building_llm_from_scratch_tpu_torch.ops.attention import decode_attention

#: dtype codes of the C entry point (csrc/decode_step.cu)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: element bytes of those dtypes
_ELT = {torch.float32: 4, torch.float16: 2, torch.bfloat16: 2}
#: head dims the kernel is instantiated for
_KERNEL_HEAD_DIMS = (64, 128)
#: K and V bytes of one split of B5's cache axis: one block's loads, all in
#: flight at once (csrc/decode_step.cu kSplitBytes)
_SPLIT_BYTES = 65536
#: fp32 scratch of the two-pass kernels B6 and B7, one per (device, stream),
#: grown as needed: a call's second pass has read it before the next call
#: on the stream starts, so a call needs no allocation of its own
_WORKSPACES: dict = {}


def _workspace(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < numel:
        ws = _WORKSPACES[key] = torch.empty(numel, dtype=torch.float32, device=device)
    return ws


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


@functools.lru_cache(maxsize=None)
def split_kv_plan(Tmax: int, hd: int, dtype: torch.dtype) -> tuple:
    """B5's split of the cache axis: ``(C, n_splits)``, each (slot, kv head)
    pane cut into ``n_splits`` runs of ``C`` consecutive positions, one
    block each. ``C`` fills the 64 KB of K and V that one block keeps in
    flight (256 positions at hd 64 in 16 bits, 128 at hd 128 or in fp32, 64
    at hd 128 in fp32). It depends on the cache length, head dim and dtype
    only, never on the batch or a row's length, so a row's output has the
    same bits alone or co-batched."""
    check_kernel_shape(Tmax, hd, dtype)
    C = _SPLIT_BYTES // (2 * hd * _ELT[dtype])
    return C, -(-Tmax // C)


def split_kv_partials_plain(q, k_cache, v_cache, lengths, C: int) -> torch.Tensor:
    """B5's first pass in plain PyTorch (fp32), the model of its workspace:
    for split j of ``C`` positions, the partial (m, l, o[hd]) of positions
    [j C, min(j C + C, t + 1)), t the clamped length, with m the running
    max of the scores in the exp2 domain (scale * log2(e) folded in), l the
    sum of 2^(s - m) and o the unnormalised sum of 2^(s - m) v. Returns
    (S, Hq, n_splits, hd + 2); splits past t hold NaN (the kernel leaves
    them unwritten and the merge never reads them)."""
    S, _, Hq, hd = q.shape
    Hkv, Tmax = k_cache.shape[1], k_cache.shape[2]
    n = -(-Tmax // C)
    t = torch.as_tensor(lengths, device=q.device).reshape(-1).long().clamp(0, Tmax - 1)
    valid = torch.arange(n * C, device=q.device)[None, :] <= t[:, None]   # (S, nC)
    pad = (0, 0, 0, n * C - Tmax)
    K = torch.nn.functional.pad(k_cache.float(), pad)
    V = torch.nn.functional.pad(v_cache.float(), pad)
    V = V.masked_fill(~valid[:, None, :, None], 0.0)
    qg = q[:, 0].float().reshape(S, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, K) * (math.log2(math.e) / math.sqrt(hd))
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    s = s.reshape(S, Hkv, -1, n, C)
    m = s.amax(-1)                                        # -inf past t
    p = torch.exp2(s - m[..., None])
    o = torch.einsum("bhgnc,bhncd->bhgnd", p, V.reshape(S, Hkv, n, C, hd))
    ws = torch.cat([m[..., None], p.sum(-1)[..., None], o], dim=-1)
    return ws.reshape(S, Hq, n, hd + 2)


def split_kv_combine_plain(ws: torch.Tensor, lengths, C: int, Tmax: int) -> torch.Tensor:
    """B5's merge in plain PyTorch: splits 0 .. t // C of each (slot, query
    head) weighed by 2^(m_j - M), M their max; returns (S, 1, Hq, hd) fp32,
    the output before its rounding to the q dtype."""
    n = ws.shape[2]
    t = torch.as_tensor(lengths, device=ws.device).reshape(-1).long().clamp(0, Tmax - 1)
    used = torch.arange(n, device=ws.device)[None, :] <= (t // C)[:, None]   # (S, n)
    used = used[:, None, :]
    m = ws[..., 0].masked_fill(~used, -math.inf)
    w = torch.exp2(m - m.amax(-1, keepdim=True))
    L = torch.where(used, ws[..., 1] * w, 0.0).sum(-1)
    O = torch.where(used[..., None], ws[..., 2:] * w[..., None], 0.0).sum(-2)
    return (O / L[..., None])[:, None]


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

    CUDA tensors go through the hand-written kernel (a split pass over
    ``split_kv_plan``'s runs of the cache axis, then a fixed-order merge:
    two launches), read their lengths on the device (no host sync) and add
    one to ``fused_decode_step.launches`` per call; CPU tensors compute
    ``fused_decode_step_plain``."""
    _check(q, k_new, v_new, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return fused_decode_step_plain(q, k_new, v_new, k_cache, v_cache,
                                       lengths)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_step runs on cpu or cuda, not {q.device}")
    S, _, Hq, hd = q.shape
    _, Hkv, Tmax, _ = k_cache.shape
    C, n_splits = split_kv_plan(Tmax, hd, q.dtype)      # checks the shape
    if not torch.is_tensor(lengths) or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (S,):
        raise TypeError("on the card lengths must be an int32 (S,) tensor")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel moves "
                             "its rows by TMA and 16-byte stores)")
    if S > 65535 or S * Hkv * Tmax >= 2 ** 31:
        raise ValueError(f"S={S} x Hkv={Hkv} x Tmax={Tmax} exceeds the kernel's "
                         "grid or its 32-bit row index")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    out = torch.empty_like(q)
    ws = torch.empty((S, Hq, n_splits, hd + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.bllm_fused_decode_step(
        _DTYPE_CODES[q.dtype], hd, S, Hq, Hkv, Tmax, C, n_splits,
        p(q), p(k_new), p(v_new), p(k_cache), p(v_cache), p(lengths), p(ws),
        p(out), ctypes.c_void_p(stream))
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


def paged_box_rows(P: int) -> int:
    """Rows of one TMA box of B7's loads for page size ``P``: the largest
    power of two that divides both ``P`` and 32 (a warp's 32 rows). A
    warp's rows start at a multiple of 32, so every box lies inside one
    page and a page's run inside the warp's rows is a whole number of
    boxes, for any ``P >= 1``."""
    if P < 1:
        raise ValueError(f"page size must be >= 1, got {P}")
    return min(P & -P, 32)


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
    (``csrc/paged_decode.cu``: B5's split pass over
    ``split_kv_plan(M * P, hd, dtype)`` with its rows loaded through the
    table, then B5's merge: two launches), read table and lengths on the
    device and add one to ``paged_decode_attention.launches`` per call; CPU
    tensors compute ``paged_decode_attention_plain``."""
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
    C, n_splits = split_kv_plan(M * P, hd, q.dtype)
    if S > 65535 or N * Hkv * P >= 2 ** 31:
        raise ValueError(f"S={S} rows or a pool of {N} pages x {Hkv} heads x "
                         f"{P} rows exceed the kernel's grid or its 32-bit row "
                         "index")
    for name, t, shape in (("page_table", page_table, (S, M)),
                           ("lengths", lengths, (S,))):
        if (not torch.is_tensor(t) or t.dtype != torch.int32
                or tuple(t.shape) != shape):
            raise TypeError(f"on the card {name} must be an int32 {shape} tensor")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads "
                             "the pools by TMA)")
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = _workspace(q.device, stream, S * Hq * n_splits * (hd + 2))
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.bllm_paged_decode(
        _DTYPE_CODES[q.dtype], hd, S, Hq, Hkv, P, N, M, paged_box_rows(P), C,
        n_splits, p(q), p(k_pool), p(v_pool), p(page_table), p(lengths), p(ws),
        p(out), ctypes.c_void_p(stream))
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
#: threads of a B6 block (each takes 16 bytes of a split's A slice), the
#: bytes of an O-tile's B slice at r = rp (the least power of two >= r) and
#: the widest O-tile (csrc/bgmv.cu kThreads, kTileBytes, kMaxTile)
_BGMV_THREADS, _BGMV_TILE_BYTES, _BGMV_MAX_TILE = 256, 16384, 2048


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


@functools.lru_cache(maxsize=None)
def bgmv_plan(D: int, r: int, O: int, dtype: torch.dtype) -> tuple:
    """B6's plan: ``(Dc, n_splits, Ot, n_tiles)``. The shrink pass cuts the
    input width D into ``n_splits`` runs of ``Dc`` rows, so that a split's
    slice of an A pane, ``Dc x r`` elements, is one contiguous run of at
    most 4 KB (``Dc = (256 / rp) * (16 / element size)``, rp the least power
    of two >= r: one 16-byte load of x per thread); the expand pass cuts the
    output width O into ``n_tiles`` tiles of ``Ot = min(2048, 16 KB / (rp x
    element size))`` columns. It depends on D, r, O and the dtype only,
    never on the batch, the ids or the pool, so a row's output has the same
    bits alone or co-batched."""
    check_lora_kernel_shape(r, dtype)
    if D < 1 or O < 1:
        raise ValueError(f"B6 widths must be >= 1, got D={D}, O={O}")
    rp = 1 << (r - 1).bit_length()
    Dc = _BGMV_THREADS // rp * (16 // _ELT[dtype])
    Ot = min(_BGMV_MAX_TILE, _BGMV_TILE_BYTES // (rp * _ELT[dtype]))
    return Dc, -(-D // Dc), Ot, -(-O // Ot)


def bgmv_partials_plain(x, a_pool, ids, Dc: int) -> torch.Tensor:
    """B6's shrink pass in plain PyTorch (fp32), the model of its workspace:
    split j's partial of row s is ``x[s, jDc:jDc+Dc] @ A[i][jDc:jDc+Dc]``, i
    the row's clamped id. Returns (S, n_splits, r); rows with id < 0 hold
    NaN (the kernel never writes them and the expand never reads them)."""
    N, D, r = a_pool.shape
    S = x.shape[0]
    n = -(-D // Dc)
    ids = torch.as_tensor(ids, device=x.device).reshape(-1)
    A = a_pool.index_select(0, ids.long().clamp(0, N - 1)).float()   # (S, D, r)
    xs = torch.nn.functional.pad(x.float(), (0, n * Dc - D)).view(S, n, 1, Dc)
    As = torch.nn.functional.pad(A, (0, 0, 0, n * Dc - D)).view(S, n, Dc, r)
    ws = torch.matmul(xs, As)[:, :, 0]
    return ws.masked_fill((ids < 0)[:, None, None], math.nan)


def bgmv_expand_plain(ws: torch.Tensor, b_pool, ids, scales) -> torch.Tensor:
    """B6's expand pass in plain PyTorch: each row's partials folded in the
    order j = 0, 1, ..., rounded to B's dtype, then ``@ B[i]`` in fp32 times
    the row's fp32 scale; rows with id < 0 are exactly 0. Returns (S, O)
    fp32."""
    N = b_pool.shape[0]
    ids = torch.as_tensor(ids, device=ws.device).reshape(-1)
    idx = ids.long().clamp(0, N - 1)
    xa = ws[:, 0]
    for j in range(1, ws.shape[1]):
        xa = xa + ws[:, j]
    xa = xa.to(b_pool.dtype).float()
    B = b_pool.index_select(0, idx).float()
    out = torch.bmm(xa[:, None], B)[:, 0] * scales.float().index_select(0, idx)[:, None]
    return torch.where((ids >= 0)[:, None], out, torch.zeros((), device=ws.device))


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
    (``csrc/bgmv.cu``: a shrink pass over ``bgmv_plan``'s D-splits and an
    expand pass over its O-tiles, each adapter's panes read once for the
    rows that share it: two launches), read ids and scales on the device
    and add one to ``lora_bgmv.launches`` per call; CPU tensors compute
    ``lora_bgmv_plain``."""
    _check_bgmv(x, a_pool, b_pool, ids, scales)
    if x.device.type == "cpu":
        return lora_bgmv_plain(x, a_pool, b_pool, ids, scales)
    if x.device.type != "cuda":
        raise ValueError(f"lora_bgmv runs on cpu or cuda, not {x.device}")
    S, D = x.shape
    N, _, r = a_pool.shape
    O = b_pool.shape[2]
    Dc, n_splits, Ot, n_tiles = bgmv_plan(D, r, O, x.dtype)   # checks r, dtype
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
    ws = _workspace(x.device, stream, S * n_splits * r)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.bllm_lora_bgmv(
        _DTYPE_CODES[x.dtype], S, D, r, O, N, Dc, n_splits, Ot, n_tiles,
        a_pool.stride(0), b_pool.stride(0), p(x), p(a_pool), p(b_pool), p(ids),
        p(scales), p(ws), p(out), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"lora_bgmv kernel launch failed: "
                           f"{lib.bllm_error_string(err).decode()}")
    lora_bgmv.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
lora_bgmv.launches = 0
