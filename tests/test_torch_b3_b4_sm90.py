"""The Hopper kernels of the training loss and dropout, modelled on the CPU.

fp32 B4 (``csrc/xent_fwd_f32_sm90.cu``) takes every product of the logits
as three TF32 products: each operand v is split into hi = v rounded to TF32
and lo = the same rounding of v - hi (``fused_attention.tf32_split_plain``
is the model of the split), and x.W as lo_x.hi_W + hi_x.lo_W + hi_x.hi_W.
Here B4's twin runs on such products against the JAX ``_xent_fwd_impl`` in
fp32 (the Pallas route forced off, as tests/test_torch_xent.py does) at
D 768, V 1001 (not a multiple of 8) and N 128 / 256, within the JAX B4
test's bounds (lse 1e-5, nll 1e-4 relative / 2e-4 absolute); the same twin
on one TF32 product (hi.hi, what the tensor cores give without the split)
must fail them. The inputs are x ~ N(0, 1) and W ~ 0.05 N(0, 1) (the
existing xent tests' scale: logits with a spread of about 1.4); at 0.02,
chip_smoke's scale, one TF32 product stays inside the bounds.

B3 (``csrc/fused_dropout.cu``): the kernel's walk over
``fused_dropout.dropout_plan`` touches every element once and nothing past
n, within one wave of resident blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops import softmax_xent as jsx
from building_llm_from_scratch_tpu_torch.ops import fused_dropout as tfd
from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf
from building_llm_from_scratch_tpu_torch.ops.fused_attention import tf32_split_plain

D, V = 768, 1001


def tf32_matmul(n_terms: int):
    """a @ b on TF32-split operands: three products, small terms first (the
    kernel's order), or the hi product alone."""
    def matmul(a, b):
        ah, al = tf32_split_plain(a)
        bh, bl = tf32_split_plain(b)
        if n_terms == 1:
            return ah @ bh
        return (al @ bh + ah @ bl) + ah @ bh
    return matmul


def case(N: int):
    r = np.random.default_rng(N)
    x = r.standard_normal((N, D)).astype(np.float32)
    w = (0.05 * r.standard_normal((D, V))).astype(np.float32)
    t = r.integers(0, V, N)
    t[:2] = (V - 1, 0)             # the last and first columns are targets
    nll, lse = jsx._xent_fwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t, jnp.int32),
                                  51200)
    return x, w, t, np.asarray(nll), np.asarray(lse)


def within(nll, lse, nll_j, lse_j) -> bool:
    return bool(np.all(np.abs(lse - lse_j) <= 1e-5 + 1e-5 * np.abs(lse_j))
                and np.all(np.abs(nll - nll_j) <= 2e-4 + 1e-4 * np.abs(nll_j)))


@pytest.mark.parametrize("N", [128, 256])
@pytest.mark.parametrize("n_terms", [3, 1])
def test_fp32_xent_on_tf32_products(N, n_terms, monkeypatch):
    """3xTF32 holds B4's bounds against JAX's fp32 forward; 1xTF32 fails
    them at the same inputs."""
    monkeypatch.setenv("BLLM_XENT_PALLAS", "0")
    x, w, t, nll_j, lse_j = case(N)
    nll, lse = txf.xent_fwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(t), matmul=tf32_matmul(n_terms))
    assert nll.dtype == lse.dtype == torch.float32
    assert within(nll.numpy(), lse.numpy(), nll_j, lse_j) == (n_terms == 3), (
        np.abs(lse.numpy() - lse_j).max(), np.abs(nll.numpy() - nll_j).max())


def test_fp32_xent_twin_masks_at_the_true_vocab(monkeypatch):
    """The kernel tiles V in 128 columns (rows of W's split transpose past V
    are zeros): the twin over W padded with zero columns to whole tiles and
    the mask at V is the JAX result; without the mask it is not."""
    monkeypatch.setenv("BLLM_XENT_PALLAS", "0")
    x, w, t, nll_j, lse_j = case(128)
    plan = txf.f32_plan(128, V, sms=132)
    wp = torch.nn.functional.pad(torch.from_numpy(w), (0, plan["tiles"] * 128 - V))
    args = (torch.from_numpy(x), wp, torch.from_numpy(t))
    nll, lse = txf.xent_fwd_plain(*args, n_valid=V, matmul=tf32_matmul(3))
    assert within(nll.numpy(), lse.numpy(), nll_j, lse_j)
    nll_c, lse_c = txf.xent_fwd_plain(*args, matmul=tf32_matmul(3))
    assert not within(nll_c.numpy(), lse_c.numpy(), nll_j, lse_j)


@pytest.mark.parametrize("N,Vv", [(8192, 50257), (1024, 50257), (256, 999), (200, 300),
                                  (128, 1001)])
def test_fp32_xent_tma_pitches_and_plan(N, Vv):
    """The fp32 kernel's TMA operands need no padded copy of W: x's rows and
    W's split transpose's rows are D * 4 bytes apart, a multiple of
    16 for every D the wrapper takes (D % 32 == 0), at any V; the 16-bit
    route's padded width gives a 16-byte pitch in fp32 too. The plan's
    tiles cover V, every share owns a tile, and the grid stays within one
    block an SM where the row blocks allow (64 x 2 at GPT-2's N 8192)."""
    for d in (128, 768, 1024, 1600):
        assert (d * 4) % 16 == 0 and d % 32 == 0
    assert (txf.padded_width(Vv) * 4) % 16 == 0
    plan = txf.f32_plan(N, Vv, sms=132)
    tiles = plan["tiles"]
    assert tiles * 128 >= Vv > (tiles - 1) * 128
    assert (plan["splits"] - 1) * plan["per"] < tiles <= plan["splits"] * plan["per"]
    row_blocks = -(-N // 128)
    assert row_blocks * plan["splits"] <= max(132, row_blocks)
    if (N, Vv) == (8192, 50257):
        assert (row_blocks, plan["splits"]) == (64, 2)
    assert txf.kernel_source(torch.float32) == "xent_fwd_f32_sm90.cu"


def dropout_walk(plan: dict):
    """The kernel's walk over a plan (``csrc/fused_dropout.cu``): pass p of
    thread j loads vectors p * unroll * S + j + u * S (u < unroll,
    S = blocks * threads) below n_vec, and thread 0 then takes the tail
    group. Returns the flat elements touched, in walk order."""
    S = plan["blocks"] * plan["threads"]
    j = np.arange(S)[:, None, None]
    p = np.arange(plan["passes"] + 1)[None, :, None]     # one pass more than planned
    u = np.arange(plan["unroll"])[None, None, :]
    v = (p * plan["unroll"] * S + j + u * S).ravel()
    v = v[v < plan["n_vec"]]
    elems = (v[:, None] * plan["vec"] + np.arange(plan["vec"])[None, :]).ravel()
    tail = np.arange(plan["n_vec"] * plan["vec"], plan["n_vec"] * plan["vec"] + plan["tail"])
    return np.concatenate([elems, tail])


@pytest.mark.parametrize("n", [4, 12, 8 * 1001 + 4, 8 * 1024 * 768, 4 * 1024 * 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("sms", [132, 7])
def test_dropout_plan_covers_every_element_once(n, dtype, sms):
    """Every element once, nothing past n; 16-byte vectors (the tail is one
    group of 4 in the 16-bit types, none in fp32); at most one wave of
    resident blocks; the planned passes cover n_vec (a further pass would
    load nothing)."""
    plan = tfd.dropout_plan(n, dtype, sms)
    elt = torch.finfo(dtype).bits // 8
    assert plan["vec"] * elt == 16 and plan["tail"] in ((0, 4) if elt == 2 else (0,))
    assert plan["n_vec"] * plan["vec"] + plan["tail"] == n
    assert 1 <= plan["blocks"] <= sms * tfd._BLOCKS_PER_SM
    S = plan["blocks"] * plan["threads"]
    assert plan["passes"] * plan["unroll"] * S >= plan["n_vec"]
    walked = dropout_walk(plan)
    assert walked.max() < n and walked.min() >= 0
    assert np.array_equal(np.sort(walked), np.arange(n))


def test_dropout_plan_at_gpt2_training_shape():
    """(8 x 1024, 768) on 132 SMs: 1024 blocks (of a wave of 1056), bf16
    in three full passes, fp32 in six; every thread of the grid has work."""
    n = 8 * 1024 * 768
    bf16 = tfd.dropout_plan(n, torch.bfloat16, 132)
    fp32 = tfd.dropout_plan(n, torch.float32, 132)
    assert (bf16["passes"], bf16["blocks"], bf16["tail"]) == (3, 1024, 0)
    assert (fp32["passes"], fp32["blocks"], fp32["tail"]) == (6, 1024, 0)
    for plan in (bf16, fp32):
        assert plan["n_vec"] == plan["passes"] * plan["unroll"] * plan["blocks"] * 256
