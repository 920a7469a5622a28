"""The fp32 flash kernels' arithmetic, 3xTF32, modelled on the CPU.

The CUDA kernels take every fp32 product on the tensor cores as three TF32
products: each operand x is split into hi = x rounded to TF32 (10 mantissa
bits, to nearest, ties away from zero) and lo = the same rounding of
x - hi, and a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
(csrc/attn_f32_sm90.cuh). ``tf32_split_plain`` is the port's model of the
split. Here the forward, dq and dk/dv twins run with every product built
from it, on the same numpy inputs as JAX's exact XLA attention and
``jax.grad`` of it (as tests/test_torch_fused_attention.py does), and must
stay within the kernels' fp32 bound of tests/test_torch_cuda.py (max |port -
jax| / max |jax|: 1e-5 for out, 5e-5 for the gradients; lse 1e-5 absolute
against a float64 numpy logsumexp), at T 256 and 2048, head dims 64 and 128,
GQA groups 1 and 4. The same twins on one TF32 product (hi_a.hi_b, what
the tensor cores give without the split) must fail that bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops.attention import causal_attention
from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

TOL_OUT, TOL_GRAD = 1e-5, 5e-5
CASES = [(T, hd, G) for T in (256, 2048) for hd in (64, 128) for G in (1, 4)]


def tf32_einsum(n_terms: int):
    """An einsum whose operands are split by ``tf32_split_plain``: three
    products (small terms first) or the hi product alone."""
    def einsum(eq, a, b):
        ah, al = tfa.tf32_split_plain(a)
        bh, bl = tfa.tf32_split_plain(b)
        if n_terms == 1:
            return torch.einsum(eq, ah, bh)
        return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)
    return einsum


def inputs(T, hd, G, seed=0):
    """q, k, v, do for B 1 and G query heads over one kv head per group
    (G 1: 1 head; G 4: 4 query heads over 1 kv head)."""
    r = np.random.default_rng(seed + T + hd + G)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(1, T, G, hd), f(1, T, 1, hd), f(1, T, 1, hd), f(1, T, G, hd)


@functools.lru_cache(maxsize=None)
def jax_reference(T, hd, G):
    """out, (dq, dk, dv) of sum(out * do) through JAX's exact XLA path, and
    lse in float64 numpy."""
    q, k, v, do = inputs(T, hd, G)

    def f(q_, k_, v_):
        out = causal_attention(q_, k_, v_, impl="xla")
        return jnp.sum(out * jnp.asarray(do)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k.astype(np.float64), G, axis=2)) / np.sqrt(hd)
    s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    return np.asarray(out), [np.asarray(g) for g in grads], lse


def twins(T, hd, G, n_terms):
    """out, lse, dq, dk, dv of the three twins on TF32-split products (dk/dv
    summed over the kv head's query heads, as B2b writes them)."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs(T, hd, G))
    ein = tf32_einsum(n_terms)
    out, lse = tfa.fused_attention_fwd_plain(q, k, v, einsum=ein)
    delta = tfa.attention_delta(out, do)
    dq = tfa.fused_attention_dq_plain(q, k, v, do, lse, delta, einsum=ein)
    dk, dv = tfa.fused_attention_dkv_plain(q, k, v, do, lse, delta, einsum=ein)
    return out, lse, dq, tfa.group_sum(dk, 1), tfa.group_sum(dv, 1)


def errors(T, hd, G, n_terms) -> dict:
    out_j, grads_j, lse_j = jax_reference(T, hd, G)
    got = twins(T, hd, G, n_terms)
    rel = lambda a, b: float(np.abs(a.numpy() - b).max() / np.abs(b).max())  # noqa: E731
    err = {"out": rel(got[0], out_j),
           "lse": float(np.abs(got[1].numpy().astype(np.float64) - lse_j).max())}
    for name, g, gj in zip(("dq", "dk", "dv"), got[2:], grads_j):
        err[name] = rel(g, gj)
    return err


def bound(name: str) -> float:
    return TOL_OUT if name in ("out", "lse") else TOL_GRAD


@pytest.mark.parametrize("x", [1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                               1 + 2 ** -11 - 2 ** -23, 3.141592653589793, -2.5e7, 1e-30])
def test_tf32_split_plain_is_cvt_rna(x):
    """hi is x to 10 mantissa bits, to nearest with ties away from zero
    (a float64 model of cvt.rna.tf32.f32), lo the same of x - hi, both with
    the low 13 bits clear, and hi + lo within 2^-22 of x."""
    def rna(y: float) -> float:
        if y == 0.0:
            return 0.0
        e = np.floor(np.log2(abs(y)))
        step = 2.0 ** (e - 10)
        return float(np.sign(y) * np.floor(abs(y) / step + 0.5) * step)

    x32 = float(np.float32(x))
    hi, lo = tfa.tf32_split_plain(torch.tensor([x32]))
    assert hi.item() == rna(x32)
    assert lo.item() == rna(float(np.float32(x32 - hi.item())))
    for t in (hi, lo):
        assert int(t.view(torch.int32).item()) & 0x1FFF == 0
    assert abs(hi.item() + lo.item() - x32) <= 2.0 ** -22 * abs(x32)


@pytest.mark.parametrize("T,hd,G", CASES)
def test_3xtf32_twins_match_jax_exact_attention(T, hd, G):
    """Forward, dq and dk/dv on 3xTF32 products within the kernels' fp32
    bound of JAX's exact attention and its gradients."""
    err = errors(T, hd, G, 3)
    for name, e in err.items():
        assert e <= bound(name), (name, e)


@pytest.mark.parametrize("T,hd,G", CASES)
def test_1xtf32_control_fails_the_bound(T, hd, G):
    """One TF32 product (the split's hi alone) misses the same bound: in the
    output and in every gradient."""
    err = errors(T, hd, G, 1)
    for name in ("out", "dq", "dk", "dv"):
        assert err[name] > bound(name), (name, err[name])
