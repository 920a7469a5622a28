"""The chunked custom-VJP cross entropy (``ops/softmax_xent.py``) and the
twin of the vocab-streamed forward B4 (``ops/xent_fwd.py``) against the JAX
package's ``softmax_xent`` forward and ``jax.grad`` of it, and against its
``_xent_fwd_impl`` with ``BLLM_XENT_PALLAS`` forced to 0 (as the JAX kernel
test does), on the same numpy inputs.

Tolerances: nll, lse and the fp32 gradients to 1e-5 (the same fp32 math
in another summation order); the JAX B4 test's bounds for the B4 twin (lse
1e-5, nll 1e-4 relative / 2e-4 absolute); bf16 gradients to 2e-2 of the
largest magnitude (dl is rounded to bf16 before both products, at other
places in XLA's and torch's GEMMs). Controls: a forward without the
padded-column mask and a backward without the one-hot term fail them.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops import softmax_xent as jsx
from building_llm_from_scratch_tpu.ops import xent_fwd_pallas as jxp
from building_llm_from_scratch_tpu_torch.ops import softmax_xent as tsx
from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf
from torch_port_helpers import to_np32

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def inputs(N, D, V, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((N, D)).astype(np.float32)
    w = (0.05 * r.standard_normal((D, V))).astype(np.float32)
    t = r.integers(0, V, N)
    t[:2] = (V - 1, 0)            # the last and first columns are targets
    return x, w, t


def rel(a, b) -> float:
    a, b = to_np32(a), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [51200, 256])
def test_chunked_xent_matches_jax(dtype, chunk, monkeypatch):
    """nll of the chunked forward and the gradients of sum(nll * g) against
    the JAX ``softmax_xent`` at V 999 (one padded chunk at 51200, four at
    256)."""
    monkeypatch.setenv("BLLM_XENT_PALLAS", "0")
    jdt, tdt = DT[dtype]
    N, D, V = 48, 64, 999
    x, w, t = inputs(N, D, V, seed=chunk)
    g = np.random.default_rng(1).standard_normal(N).astype(np.float32)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)

    def jf(x_, w_):
        nll = jsx.softmax_xent(x_, w_, jnp.asarray(t, jnp.int32), chunk)
        return jnp.sum(nll * g), nll

    (_, nll_j), (dx_j, dw_j) = jax.value_and_grad(jf, argnums=(0, 1),
                                                  has_aux=True)(xj, wj)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(True)
    nll = tsx.softmax_xent(xt, wt, torch.from_numpy(t), chunk)
    (nll * torch.from_numpy(g)).sum().backward()
    assert nll.dtype == torch.float32
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(nll_j),
                               rtol=1e-5, atol=1e-5)
    assert xt.grad.dtype == tdt and wt.grad.dtype == tdt
    tol = 1e-5 if dtype == "fp32" else 2e-2
    assert rel(xt.grad, dx_j) <= tol and rel(wt.grad, dw_j) <= tol, (
        rel(xt.grad, dx_j), rel(wt.grad, dw_j))


def test_chunked_xent_backward_control():
    """The gradient bound fails for a backward without the one-hot term."""
    N, D, V = 32, 64, 999
    x, w, t = inputs(N, D, V, seed=3)
    dx_j, dw_j = jax.grad(lambda x_, w_: jnp.sum(jsx.softmax_xent(
        x_, w_, jnp.asarray(t, jnp.int32), 256)), argnums=(0, 1))(x, w)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tsx.softmax_xent(xt, wt, torch.from_numpy(t + V), 256).sum().backward()
    assert rel(xt.grad, dx_j) > 1e-2 and rel(wt.grad, dw_j) > 1e-2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_b4_twin_matches_jax_forward(dtype, monkeypatch):
    """The B4 twin (512-wide chunks) against the JAX ``_xent_fwd_impl``
    with the Pallas route forced off, at the JAX test's bounds; the twin
    fed W padded with zero columns and no mask (the control) fails them."""
    monkeypatch.setenv("BLLM_XENT_PALLAS", "0")
    jdt, tdt = DT[dtype]
    N, D, V = 256, 128, 999
    x, w, t = inputs(N, D, V, seed=4)
    nll_j, lse_j = jsx._xent_fwd_impl(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                      jnp.asarray(t, jnp.int32), 51200)
    xt, wt, tt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(t)
    before = txf.xent_fwd.launches
    nll, lse = txf.xent_fwd(xt, wt, tt)
    assert txf.xent_fwd.launches == before          # CPU: the twin
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), rtol=1e-4, atol=2e-4)
    padded = torch.cat([wt, torch.zeros(D, 1024 - V, dtype=tdt)], dim=1)
    _, lse_c = txf.xent_fwd_plain(xt, padded, tt)
    assert not np.allclose(lse_c.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)


def test_b4_route_is_the_jax_switch(monkeypatch):
    """B4's shape rule equals the JAX one; the loss takes it only with
    BLLM_XENT_PALLAS=1 on a single CUDA device (never for CPU tensors)."""
    for shape in [(8192, 768, 50257), (100, 768, 50257), (65536, 4096, 128256),
                  (256, 128, 999), (128, 96, 999)]:
        assert txf.supports_shape(*shape) == jxp.supports_shape(*shape)
    def x(N, dev):                       # what the route reads of a tensor
        return SimpleNamespace(shape=(N, 768), device=torch.device(dev))

    monkeypatch.setenv("BLLM_XENT_PALLAS", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tsx._use_kernel_fwd(x(8192, "cuda"), 50257)
    assert not tsx._use_kernel_fwd(x(8192, "cpu"), 50257)
    assert not tsx._use_kernel_fwd(x(100, "cuda"), 50257)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert not tsx._use_kernel_fwd(x(8192, "cuda"), 50257)
    monkeypatch.setenv("BLLM_XENT_PALLAS", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert not tsx._use_kernel_fwd(x(8192, "cuda"), 50257)


def test_fused_loss_equals_the_dense_loss():
    """The token-mean chunked loss equals the dense fp32 cross entropy of
    the same logits."""
    from building_llm_from_scratch_tpu_torch.training.train_step import (
        cross_entropy_loss,
    )

    x, w, t = inputs(64, 32, 999, seed=5)
    h = torch.from_numpy(x).reshape(4, 16, 32)
    loss = tsx.fused_cross_entropy_loss(h, torch.from_numpy(w),
                                        torch.from_numpy(t).reshape(4, 16), 256)
    dense = cross_entropy_loss(h @ torch.from_numpy(w),
                               torch.from_numpy(t).reshape(4, 16))
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-6)
