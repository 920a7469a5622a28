"""The host side of the two Hopper redesigns, against the JAX package on the
CPU with numpy inputs from a seed:

  - B5's split-KV plan (``split_kv_plan``) and its split-and-combine in
    plain PyTorch (``split_kv_partials_plain`` + ``split_kv_combine_plain``,
    the kernel's workspace and fixed-order merge) against the JAX
    ``slot_cache_append`` + ``decode_attention``;
  - B4's plan for the Hopper kernel (``sm90_plan``: W's padded width and the
    vocab shares) and its padded-and-masked product against the JAX
    ``_xent_fwd_impl``.

The CUDA kernels themselves are held against their twins on the card by
``tests/test_torch_cuda.py``. Tolerances: B5 fp32 atol 1e-5 (summation
order), bf16 2e-2 (the JAX decode kernel test's), as in
``test_torch_decode_step.py``; B4 the JAX kernel test's bounds (lse 1e-5;
nll 1e-4 relative, 2e-4 absolute), as in ``test_torch_xent.py``. Each
bound has a control that must fail it."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops import softmax_xent as jsx
from building_llm_from_scratch_tpu.ops.attention import decode_attention
from building_llm_from_scratch_tpu.ops.decode_step import slot_cache_append
from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf
from torch_port_helpers import bits, to_np32

DTYPES = [torch.float32, torch.float16, torch.bfloat16]
DT = {"fp32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


# ---------------------------------------------------------------------------
# B5: the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Tmax", [1, 8, 1000, 1024, 32768])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_plan_covers_the_cache_once(Tmax, hd, dtype):
    """The plan's splits cover positions [0, Tmax) exactly once, each split
    owns at least one position, and a split's K and V fill the 64 KB that
    one block keeps in flight, in whole 32-row warp tiles."""
    C, n = tds.split_kv_plan(Tmax, hd, dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    assert C % 32 == 0 and 2 * C * hd * elt == 65536
    owner = np.full(Tmax, -1)
    for j in range(n):
        lo, hi = j * C, min(j * C + C, Tmax)
        assert lo < hi
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = j
    assert (owner >= 0).all()
    # the split that holds position t, the one that writes the append
    for t in {0, Tmax // 2, Tmax - 1}:
        assert owner[t] == t // C


def test_split_plan_takes_no_batch_or_lengths():
    """The plan is a function of (Tmax, hd, dtype) alone: a row's splits,
    and so its output bits, do not depend on the batch it rides in."""
    assert list(inspect.signature(tds.split_kv_plan).parameters) == ["Tmax", "hd", "dtype"]
    with pytest.raises(ValueError, match="CUDA decode-step kernel"):
        tds.split_kv_plan(1024, 96, torch.bfloat16)


# ---------------------------------------------------------------------------
# B5: the split-and-combine against JAX
# ---------------------------------------------------------------------------

def _inputs(S, Hq, Hkv, hd, Tmax, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(S, 1, Hq, hd), f(S, 1, Hkv, hd), f(S, 1, Hkv, hd),
            f(S, Hkv, Tmax, hd), f(S, Hkv, Tmax, hd))


def _jax_reference(q, kn, vn, K, V, lens, jdt):
    q, kn, vn, K, V = (jnp.asarray(a, jdt) for a in (q, kn, vn, K, V))
    lens = jnp.asarray(lens)
    K2 = slot_cache_append(K, kn.transpose(0, 2, 1, 3), lens)
    V2 = slot_cache_append(V, vn.transpose(0, 2, 1, 3), lens)
    out = decode_attention(q, K2, V2, q_positions=lens[:, None],
                           kv_length=lens + 1)
    return out, K2, V2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("Hq,Hkv,hd", [(4, 4, 64), (8, 2, 64), (4, 2, 128), (12, 1, 64)])
def test_split_and_combine_matches_jax(dtype, Hq, Hkv, hd):
    """The kernel's two passes modelled in plain PyTorch at a small split
    (C 8, so tiny caches have many splits) over the appended caches, the
    output rounded once to the dtype, against the JAX reference, with rows
    ending at 0, C - 1, C, C + 1 and Tmax - 1 of a cache that is not a whole
    number of splits. Dropping each row's last split (the control) fails."""
    jdt, tdt, tol = DT[dtype]
    C, Tmax = 8, 37
    lens = np.array([0, C - 1, C, C + 1, Tmax - 1], np.int32)
    q, kn, vn, K, V = _inputs(len(lens), Hq, Hkv, hd, Tmax, seed=Hq * hd)
    ref_out, ref_K, ref_V = _jax_reference(q, kn, vn, K, V, lens, jdt)

    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    Kt, Vt, lt = t(K), t(V), torch.from_numpy(lens)
    tds.slot_cache_append(Kt, t(kn).permute(0, 2, 1, 3), lt)
    tds.slot_cache_append(Vt, t(vn).permute(0, 2, 1, 3), lt)
    np.testing.assert_array_equal(bits(Kt), bits(np.asarray(ref_K)))
    np.testing.assert_array_equal(bits(Vt), bits(np.asarray(ref_V)))

    ws = tds.split_kv_partials_plain(t(q), Kt, Vt, lt, C)
    assert tuple(ws.shape) == (len(lens), Hq, -(-Tmax // C), hd + 2)
    out = tds.split_kv_combine_plain(ws, lt, C, Tmax).to(tdt)
    ref = np.asarray(ref_out, np.float32)
    np.testing.assert_allclose(to_np32(out), ref, atol=tol, rtol=0)

    dropped = ws.clone()
    for b, length in enumerate(lens):
        last = int(length) // C
        if last:
            dropped[b, :, last, 0] = -np.inf
            dropped[b, :, last, 1:] = 0.0
    bad = tds.split_kv_combine_plain(dropped, lt, C, Tmax).to(tdt)
    assert not np.allclose(to_np32(bad), ref, atol=tol, rtol=0)


def test_split_model_at_the_plan_equals_the_twin():
    """At the plan's own C the model agrees with the kernel's twin (the
    reference path the CUDA tests hold the kernel to). (That a row alone
    and co-batched gives the same bits is the kernel's property, held on
    the card: the plan takes no batch.)"""
    tdt, Tmax, hd = torch.bfloat16, 600, 64
    C, _ = tds.split_kv_plan(Tmax, hd, tdt)
    lens = torch.tensor([0, C - 1, C, 2 * C + 1, Tmax - 1], dtype=torch.int32)
    q, kn, vn, K, V = (torch.from_numpy(a).to(tdt)
                       for a in _inputs(len(lens), 8, 2, hd, Tmax, seed=3))
    out_t, Kt, Vt = tds.fused_decode_step_plain(q, kn, vn, K.clone(), V.clone(), lens)
    ws = tds.split_kv_partials_plain(q, Kt, Vt, lens, C)
    out = tds.split_kv_combine_plain(ws, lens, C, Tmax)
    np.testing.assert_allclose(to_np32(out.to(tdt)), to_np32(out_t), atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# B4: the Hopper kernel's plan and its padded head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,V", [(8192, 50257), (1024, 50257), (256, 999), (200, 300),
                                 (128, 128), (64, 1), (65536, 128256)])
@pytest.mark.parametrize("sms", [132, 114])
def test_b4_plan_pads_and_shares_the_vocabulary(N, V, sms):
    """W's padded width is the least multiple of 8 at or past V; every
    128-column tile of it is owned by exactly one vocab share, each share
    owns at least one, and the grid stays within two blocks an SM unless a
    single share is already past that."""
    p = txf.sm90_plan(N, V, sms)
    assert p["Vp"] == txf.padded_width(V)
    assert p["Vp"] % 8 == 0 and V <= p["Vp"] < V + 8
    assert p["tiles"] == -(-p["Vp"] // 128) == -(-V // 128)
    owned = []
    for split in range(p["splits"]):
        tiles = range(split * p["per"], min(split * p["per"] + p["per"], p["tiles"]))
        assert len(tiles) >= 1
        owned.extend(tiles)
    assert owned == list(range(p["tiles"]))
    blocks = -(-N // 128) * p["splits"]
    assert blocks <= 2 * sms or p["splits"] == 1


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("V", [999, 300, 50257])
def test_b4_padded_head_masked_at_the_true_v(dtype, V, monkeypatch):
    """The Hopper kernel's product modelled on the CPU: W padded with zero
    columns to the plan's width and the mask at the true V gives the JAX
    ``_xent_fwd_impl`` at the B4 bounds; the mask at the padded width (the
    control) lets the zero columns into the sum and fails them."""
    monkeypatch.setenv("BLLM_XENT_PALLAS", "0")
    jdt, tdt, _ = DT[dtype]
    N, D = 64, 128
    r = np.random.default_rng(V)
    x = r.standard_normal((N, D)).astype(np.float32)
    w = (0.05 * r.standard_normal((D, V))).astype(np.float32)
    tg = r.integers(0, V, N)
    tg[0] = V - 1
    nll_j, lse_j = jsx._xent_fwd_impl(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                      jnp.asarray(tg, jnp.int32), 51200)
    Vp = txf.sm90_plan(N, V, 132)["Vp"]
    xt, tt = torch.from_numpy(x).to(tdt), torch.from_numpy(tg)
    wp = torch.nn.functional.pad(torch.from_numpy(w).to(tdt), (0, Vp - V))
    nll, lse = txf.xent_fwd_plain(xt, wp, tt, n_valid=V)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), rtol=1e-4, atol=2e-4)
    _, lse_c = txf.xent_fwd_plain(xt, wp, tt, n_valid=Vp)
    assert not np.allclose(lse_c.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
