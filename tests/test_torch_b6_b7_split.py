"""The host side of the B6 and B7 redesigns, against the JAX package on the
CPU with numpy inputs from a seed:

  - B6's plan (``bgmv_plan``) and its two passes in plain PyTorch
    (``bgmv_partials_plain``: each D-split's fp32 partial, the kernel's
    workspace; ``bgmv_expand_plain``: the fold in split order, the rounding
    to the pool dtype and the expand) against the JAX ``lora_bgmv`` in
    interpret mode and the exact float64 result;
  - B7's TMA box rule (``paged_box_rows``) and its paged split model: B5's
    ``split_kv_partials_plain`` + ``split_kv_combine_plain`` over the rows
    gathered through the page table, against the JAX
    ``paged_decode_attention`` in interpret mode (P 8 and 16) and the JAX
    ``_paged_view`` + ``decode_attention`` (P 1 and 24).

The CUDA kernels themselves are held against their twins on the card by
``tests/test_torch_cuda.py``. Bounds: B6 per output element relative to
M = scale * (|x @ A| @ |B|), chip_smoke.py's ``BGMV_TOL`` (against the
JAX kernel, which rounds the same rank-r intermediate from its own fp32
sum: fp32 1e-4, bf16 2^-7; against the exact result: fp32 1e-4, bf16
2^-8); B7 the decode kernel's (fp32 atol 1e-5, bf16 2e-2, as in
``test_torch_split_kv.py``). Each bound has a control that must fail it."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.models.transformer import (
    _paged_view as jax_paged_view,
)
from building_llm_from_scratch_tpu.ops.attention import (
    decode_attention as jax_decode_attention,
)
from building_llm_from_scratch_tpu.ops.decode_step import lora_bgmv as jax_bgmv
from building_llm_from_scratch_tpu.ops.decode_step import (
    paged_decode_attention as jax_paged_attention,
)
from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
from torch_port_helpers import to_np32

DTYPES = [torch.float32, torch.float16, torch.bfloat16]
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
#: (against the JAX kernel, against the exact result), relative to M
BGMV_TOL = {"fp32": (1e-4, 1e-4), "bf16": (2.0 ** -7, 2.0 ** -8)}
#: B7's model against JAX, atol (rtol 0)
PAGED_TOL = {"fp32": 1e-5, "bf16": 2e-2}


# ---------------------------------------------------------------------------
# B6: the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,r,O", [(2048, 16, 2048), (8192, 16, 2048), (2048, 16, 512),
                                   (2048, 16, 8192), (768, 16, 3072), (3072, 16, 768),
                                   (64, 7, 33), (96, 256, 200), (1, 1, 1), (1000, 3, 999)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bgmv_plan_covers_d_and_o_once(D, r, O, dtype):
    """The D-splits cover rows [0, D) exactly once and the O-tiles columns
    [0, O) exactly once, each owning at least one; a split's slice of an A
    pane is one contiguous run of at most 4 KB whose start stays 16-byte
    aligned, a thread's share of x is one 16-byte load, and a tile's slice
    of a B pane fits the kernel's 16 KB."""
    Dc, n_splits, Ot, n_tiles = tds.bgmv_plan(D, r, O, dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    for width, step, n in ((D, Dc, n_splits), (O, Ot, n_tiles)):
        owner = np.full(width, -1)
        for j in range(n):
            lo, hi = j * step, min(j * step + step, width)
            assert lo < hi
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = j
        assert (owner >= 0).all()
    assert Dc * r * elt <= 4096 and (Dc * r * elt) % 16 == 0 and (Dc * elt) % 16 == 0
    assert r * Ot * elt <= 16384 and (Ot * elt) % 16 == 0


def test_bgmv_plan_takes_only_widths_and_dtype():
    """The plan is a function of (D, r, O, dtype) alone, never of the
    batch, the ids or the pool: a row's splits, and so its output bits, do
    not depend on the rows beside it."""
    assert list(inspect.signature(tds.bgmv_plan).parameters) == ["D", "r", "O", "dtype"]
    with pytest.raises(ValueError, match="BGMV kernel"):
        tds.bgmv_plan(2048, 257, 2048, torch.bfloat16)
    with pytest.raises(ValueError, match="BGMV kernel"):
        tds.bgmv_plan(2048, 16, 2048, torch.float64)


# ---------------------------------------------------------------------------
# B6: the two passes against JAX
# ---------------------------------------------------------------------------

def bgmv_case(S, N, D, r, O, ids, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, D)).astype(np.float32)
    A = (rng.standard_normal((N, D, r)) / np.sqrt(D)).astype(np.float32)
    B = rng.standard_normal((N, r, O)).astype(np.float32)
    scales = rng.uniform(0.25, 2.0, N).astype(np.float32)
    return x, A, B, np.asarray(ids, np.int32), scales


def exact_and_magnitude(x, A, B, ids, scales):
    """float64 numpy: (exact B6 result, the magnitude M of the bounds)."""
    idx = np.clip(ids, 0, A.shape[0] - 1)
    xa = np.einsum("sd,sdr->sr", x.astype(np.float64), A[idx].astype(np.float64))
    keep = np.where(ids >= 0, scales[idx], 0.0)[:, None]
    Bs = B[idx].astype(np.float64)
    return (np.einsum("sr,sro->so", xa, Bs) * keep,
            np.einsum("sr,sro->so", np.abs(xa), np.abs(Bs)) * keep)


def within(out, ref, mag, tol) -> bool:
    return bool((np.abs(np.asarray(out, np.float64) - ref) <= tol * mag).all())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("r", [8, 16])
@pytest.mark.parametrize("Dc", [32, 96])
def test_bgmv_two_passes_match_jax(dt, r, Dc):
    """The kernel's shrink and expand modelled in plain PyTorch at small
    splits (Dc 32 and 96: 8 and 3 splits of D 256, the last one short)
    over ids with -1 rows, repeated ids and an id past the pool (clamped),
    against the JAX kernel in interpret mode and the exact result. A
    partial stands for each split of each row; rows with id -1 are exactly
    0. The same passes with the ids permuted (rows served by other
    adapters) fail the bound."""
    jdt, tdt = DT[dt]
    S, N, D, O = 7, 3, 256, 384
    x, A, B, ids, sc = bgmv_case(S, N, D, r, O, [0, -1, 2, 1, 2, 5, 0], seed=r + Dc)
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    tx, tA, tB, tid, tsc = t(x), t(A), t(B), torch.from_numpy(ids), torch.from_numpy(sc)
    ws = tds.bgmv_partials_plain(tx, tA, tid, Dc)
    assert tuple(ws.shape) == (S, -(-D // Dc), r)
    assert torch.isnan(ws[1]).all() and torch.isfinite(ws[ids >= 0]).all()
    out = tds.bgmv_expand_plain(ws, tB, tid, tsc)
    assert out.dtype == torch.float32 and tuple(out.shape) == (S, O)
    assert not out[1].any()
    ref = np.asarray(jax_bgmv(jnp.asarray(x, jdt), jnp.asarray(A, jdt), jnp.asarray(B, jdt),
                              jnp.asarray(ids), jnp.asarray(sc), interpret=True))
    exact, mag = exact_and_magnitude(to_np32(tx), to_np32(tA), to_np32(tB), ids, sc)
    t_jax, t_exact = BGMV_TOL[dt]
    assert within(out.numpy(), ref.astype(np.float64), mag, t_jax)
    assert within(out.numpy(), exact, mag, t_exact)
    perm = torch.from_numpy(ids[[1, 2, 3, 4, 5, 6, 0]])
    wrong = tds.bgmv_expand_plain(tds.bgmv_partials_plain(tx, tA, perm, Dc), tB, perm, tsc)
    assert not within(wrong.numpy(), exact, mag, t_jax)


def test_bgmv_passes_at_the_plan_equal_the_twin():
    """At the plan's own split the two passes agree with the kernel's twin
    (the reference the CUDA tests hold the kernel to) at LLaMA-3.2-1B's
    down projection."""
    tdt, D, r, O = torch.bfloat16, 8192, 16, 256
    Dc, n_splits, _, _ = tds.bgmv_plan(D, r, O, tdt)
    assert n_splits == 64
    x, A, B, ids, sc = bgmv_case(8, 4, D, r, O, [0, 1, 2, -1, 0, 2, 1, -1], seed=9)
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    tx, tA, tB, tid, tsc = t(x), t(A), t(B), torch.from_numpy(ids), torch.from_numpy(sc)
    out = tds.bgmv_expand_plain(tds.bgmv_partials_plain(tx, tA, tid, Dc), tB, tid, tsc)
    twin = tds.lora_bgmv_plain(tx, tA, tB, tid, tsc)
    _, mag = exact_and_magnitude(to_np32(tx), to_np32(tA), to_np32(tB), ids, sc)
    assert within(out.numpy(), twin.numpy().astype(np.float64), mag, BGMV_TOL["bf16"][0])


# ---------------------------------------------------------------------------
# B7: the box rule and the paged split model against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,box", [(1, 1), (8, 8), (16, 16), (24, 8), (32, 32), (48, 16),
                                   (5, 1), (64, 32), (1024, 32)])
def test_paged_box_rows(P, box):
    """A box is the largest power of two dividing both P and 32: it divides
    the page, so a box that starts on a multiple of itself lies inside one
    page, and it divides the warp's 32 rows, so the rows are whole boxes."""
    b = tds.paged_box_rows(P)
    assert b == box
    assert P % b == 0 and 32 % b == 0 and b & (b - 1) == 0
    assert not (P % (2 * b) == 0 and 32 % (2 * b) == 0)     # the largest
    for p0 in range(0, 4 * max(P, 32), 32):
        for j in range(32 // b):
            first = p0 + j * b
            assert first // P == (first + b - 1) // P     # one page


def paged_case(S, Hq, Hkv, hd, P, M, seed):
    """q, pools and a table over shuffled page ids: rows share page ids[0]
    (a prefix hit), columns past a row's frontier point at the trash page
    0 (garbage), row 0 has length 0, row 1 ends one short of a page
    boundary and row 2 at the table's end."""
    r = np.random.default_rng(seed)
    N = S * M + 1
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    q, K, V = f(S, 1, Hq, hd), f(N, Hkv, P, hd), f(N, Hkv, P, hd)
    ids = r.permutation(np.arange(1, N)).astype(np.int32)
    table = ids[:S * M].reshape(S, M).copy()
    table[:, 0] = ids[0]
    lens = np.concatenate([[0, 3 * P - 1, M * P - 1], r.integers(1, M * P, S - 3)])
    lens = lens.astype(np.int32)
    for s in range(S):
        table[s, lens[s] // P + 1:] = 0
    return q, K, V, table, lens


def paged_split_model(q, K, V, table, lens, C):
    """B7's two passes in plain PyTorch: B5's split partials over the rows
    gathered through the table (page ids clipped), then B5's merge."""
    Tmax = table.shape[1] * K.shape[2]
    Kr, Vr = tds.paged_view(K, table, Tmax), tds.paged_view(V, table, Tmax)
    ws = tds.split_kv_partials_plain(q, Kr, Vr, lens, C)
    return tds.split_kv_combine_plain(ws, lens, C, Tmax).to(q.dtype)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("P,M,reference", [(8, 6, "kernel"), (16, 3, "kernel"),
                                           (1, 40, "view"), (24, 2, "view")])
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 2, 64), (4, 4, 128)])
def test_paged_split_model_matches_jax(dt, P, M, reference, Hq, Hkv, hd):
    """The paged split model at a small split (C 16, so a row of a few
    pages has several) against the JAX paged kernel in interpret mode (P 8
    and 16, the page sizes its TPU gate takes) or the JAX row view +
    ``decode_attention`` (P 1 and 24); a shuffled table (rows read through
    other rows' pages) fails the bound."""
    jdt, tdt = DT[dt]
    S, C = 5, 16
    q, K, V, table, lens = paged_case(S, Hq, Hkv, hd, P, M, seed=P * hd + Hq)
    jq, jK, jV = (jnp.asarray(a, jdt) for a in (q, K, V))
    if reference == "kernel":
        ref = jax_paged_attention(jq, jK, jV, jnp.asarray(table), jnp.asarray(lens),
                                  interpret=True)
    else:
        ref = jax_decode_attention(
            jq, jax_paged_view(jK, jnp.asarray(table), M * P),
            jax_paged_view(jV, jnp.asarray(table), M * P),
            q_positions=jnp.asarray(lens)[:, None], kv_length=jnp.asarray(lens) + 1)
    ref = np.asarray(ref, np.float32)
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    out = paged_split_model(t(q), t(K), t(V), tt, tl, C)
    np.testing.assert_allclose(to_np32(out), ref, atol=PAGED_TOL[dt], rtol=0)
    shuffled = paged_split_model(t(q), t(K), t(V), tt.roll(1, 0), tl, C)
    assert not np.allclose(to_np32(shuffled), ref, atol=PAGED_TOL[dt], rtol=0)
