"""The fused flash-attention twins (B1 forward, B2a dq, B2b dk/dv, through
the port's ``FusedCausalAttention``) against the JAX package's exact XLA
attention (``causal_attention(..., impl="xla")``) and ``jax.grad`` of it,
on the same numpy inputs; the training dispatch rule; the checks of the
attention-dropout branch (its math is held against a same-mask oracle in
``tests/test_torch_dropout.py``). The CUDA kernels themselves are held against these twins
on the card by ``tests/test_torch_cuda.py``.

Tolerances, as max |port - jax| / max |jax| per tensor: fp32 1e-5 (the same
math, another summation order). bf16 2e-2: both round the softmax weights
to bf16 before P.V, but the twin rounds exp(s - max) and divides after the
product while XLA rounds the normalised weights, and JAX's autodiff rounds
the bf16 cotangents at other places than the twin's fp32 backward. lse is
held against a float64 numpy logsumexp of the masked scores to 1e-5
(absolute) in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops import fused_attention as jfa
from building_llm_from_scratch_tpu.ops.attention import causal_attention
from building_llm_from_scratch_tpu_torch.ops import attention as tatt
from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa
from torch_port_helpers import to_np32

DT = {"fp32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(B, T, Hq, Hkv, D, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, T, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D), f(B, T, Hq, D)


def rel(a, b) -> float:
    a, b = to_np32(a), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_reference(q, k, v, do, jdt):
    """out and (dq, dk, dv) of sum(out * do) through the exact XLA path."""
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]

    def f(q_, k_, v_):
        out = causal_attention(q_, k_, v_, impl="xla")
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do, jnp.float32)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    return np.asarray(out.astype(jnp.float32)), [
        np.asarray(g.astype(jnp.float32)) for g in grads]


def numpy_lse(q, k):
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    kk = np.repeat(k.astype(np.float64), G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(D)
    s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("T,Hkv", [(256, 2), (256, 4), (512, 2), (512, 4)])
def test_twin_matches_jax_xla_attention_and_grads(dtype, T, Hkv):
    B, Hq, D = 2, 4, 64
    jdt, tdt, tol = DT[dtype]
    q, k, v, do = inputs(B, T, Hq, Hkv, D, seed=T + Hkv)
    out_j, grads_j = jax_reference(q, k, v, do, jdt)

    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    before = tfa.flash_attention_fwd.launches
    out = tfa.fused_causal_attention(tq, tk, tv)
    out.float().backward(torch.from_numpy(do))
    assert tfa.flash_attention_fwd.launches == before   # CPU: the twin
    assert out.dtype == tdt and tq.grad.dtype == tdt
    assert tk.grad.shape == (B, T, Hkv, D)
    assert rel(out, out_j) <= tol
    for name, g, gj in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                           grads_j):
        assert rel(g, gj) <= tol, (name, rel(g, gj))


@pytest.mark.parametrize("Hkv", [1, 4])
def test_twin_lse_matches_numpy_logsumexp(Hkv):
    q, k, v, _ = inputs(1, 256, 4, Hkv, 64, seed=3)
    out, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 256)
    np.testing.assert_allclose(lse.numpy(), numpy_lse(q, k), atol=1e-5, rtol=0)


def test_twin_backward_matches_autograd_of_its_forward():
    """dq/dk/dv twins (the kernels' math: recomputed P, delta) equal
    autograd through the plain forward in fp32, per query head for dk/dv."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs(1, 256, 4, 2, 64, seed=5))
    out, lse = tfa.fused_attention_fwd_plain(q, k, v)
    delta = tfa.attention_delta(out, do)
    dq = tfa.fused_attention_dq_plain(q, k, v, do, lse, delta)
    dk, dv = tfa.fused_attention_dkv_plain(q, k, v, do, lse, delta)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    tatt.xla_attention(qa, ka, va).backward(do)
    torch.testing.assert_close(dq, qa.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tfa.group_sum(dk, 2), ka.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tfa.group_sum(dv, 2), va.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,D", [(16, 16), (128, 64), (255, 64), (256, 64),
                                 (300, 64), (384, 64), (512, 128), (640, 64),
                                 (1024, 64), (1536, 128), (2048, 256),
                                 (1024, 96)])
def test_dispatch_rule_is_the_jax_supports_shape(T, D, monkeypatch):
    """The port's rule equals the JAX ``supports_shape``; eligible shapes
    take the fused path (its twin on the CPU), the rest ``xla_attention``."""
    assert tfa.supports_shape(T, T, D) == jfa.supports_shape(T, T, D)
    taken = []
    monkeypatch.setattr(tfa, "fused_causal_attention",
                        lambda q, k, v, **kw: taken.append("fused") or q)
    monkeypatch.setattr(tatt, "xla_attention",
                        lambda q, k, v, **kw: taken.append("xla") or q)
    q = torch.zeros(1, T, 2, D)
    tatt.causal_attention(q, q[:, :, :1], q[:, :, :1])
    assert taken == ["fused" if jfa.supports_shape(T, T, D) else "xla"]


def test_attention_dropout_branch_takes_a_seed_and_eligible_shapes():
    """The fused op drops attention weights for a seed (and needs one), and
    refuses a shape the kernels cannot take; the dispatch sends such shapes
    with dropout to ``xla_attention``."""
    q = torch.randn(1, 256, 2, 64, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="seed"):
        tfa.fused_causal_attention(q, q, q, dropout_rate=0.1)
    out = tfa.fused_causal_attention(q, q, q, dropout_rate=0.1, seed=4)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert not torch.equal(out, tfa.fused_causal_attention(q, q, q))
    with pytest.raises(ValueError):
        tfa.fused_causal_attention(torch.zeros(1, 300, 2, 64),
                                   torch.zeros(1, 300, 2, 64),
                                   torch.zeros(1, 300, 2, 64))
    short = q[:, :100].contiguous()
    got = tatt.causal_attention(short, short, short, dropout_rate=0.1, seed=4,
                                deterministic=False)
    assert torch.equal(got, tatt.xla_attention(short, short, short,
                                               dropout_rate=0.1, seed=4,
                                               deterministic=False))
