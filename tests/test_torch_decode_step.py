"""The fused decode step: the port's plain twin vs the JAX reference
(``slot_cache_append`` + ``decode_attention``, since the Pallas kernel has
no CPU mode) and the wrapper's checks. The CUDA kernel itself is tested on
the card by ``tests/test_torch_cuda.py``.

Tolerances: fp32 atol 1e-5 (reduction order); bf16 atol 2e-2, the JAX
kernel test's own (``tests/test_decode_step.py``). Caches must match bit
for bit: the append is a copy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops.attention import decode_attention
from building_llm_from_scratch_tpu.ops.decode_step import slot_cache_append
from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
from torch_port_helpers import bits, to_np32

DT = {"fp32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(S, Hq, Hkv, hd, Tmax, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(S, 1, Hq, hd), f(S, 1, Hkv, hd), f(S, 1, Hkv, hd),
            f(S, Hkv, Tmax, hd), f(S, Hkv, Tmax, hd))


def jax_reference(q, kn, vn, K, V, lens, jdt):
    q, kn, vn, K, V = (jnp.asarray(a, jdt) for a in (q, kn, vn, K, V))
    lens = jnp.asarray(lens)
    K2 = slot_cache_append(K, kn.transpose(0, 2, 1, 3), lens)
    V2 = slot_cache_append(V, vn.transpose(0, 2, 1, 3), lens)
    out = decode_attention(q, K2, V2, q_positions=lens[:, None],
                           kv_length=lens + 1)
    return out, K2, V2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("Hq,Hkv,hd", [(4, 4, 64), (8, 2, 64), (4, 2, 128)])
def test_twin_matches_jax(dtype, Hq, Hkv, hd):
    jdt, tdt, tol = DT[dtype]
    S, Tmax = 3, 32
    q, kn, vn, K, V = inputs(S, Hq, Hkv, hd, Tmax)
    lens = np.array([0, 13, Tmax - 1], np.int32)
    ref_out, ref_K, ref_V = jax_reference(q, kn, vn, K, V, lens, jdt)

    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    Kt, Vt = t(K), t(V)
    before = tds.fused_decode_step.launches
    out, Ko, Vo = tds.fused_decode_step(t(q), t(kn), t(vn), Kt, Vt,
                                        torch.from_numpy(lens))
    assert Ko is Kt and Vo is Vt                    # updated in place
    assert tds.fused_decode_step.launches == before  # CPU: the twin, no launch
    np.testing.assert_array_equal(bits(Kt), bits(np.asarray(ref_K)))
    np.testing.assert_array_equal(bits(Vt), bits(np.asarray(ref_V)))
    np.testing.assert_allclose(to_np32(out), np.asarray(ref_out, np.float32),
                               atol=tol, rtol=0)


def test_slot_cache_append_scalar_and_clamp():
    cache = torch.zeros(2, 1, 8, 4)
    new = torch.ones(2, 1, 1, 4)
    tds.slot_cache_append(cache, new, torch.tensor(3))
    assert cache[:, :, 3].eq(1).all() and cache.sum() == 8
    # an offset past the end clamps so the write fits, like a DUS
    tds.slot_cache_append(cache, 2 * new, torch.tensor([9, 0]))
    assert cache[0, 0, 7].eq(2).all() and cache[1, 0, 0].eq(2).all()


@pytest.mark.parametrize("bad", ["tq2", "hd32", "tmax_odd", "heads", "dtype"])
def test_wrapper_rejects(bad):
    S, Hq, Hkv, hd, Tmax, Tq = 2, 4, 2, 64, 16, 1
    if bad == "hd32":
        hd = 32
    if bad == "tmax_odd":
        Tmax = 12 + 1
    if bad == "heads":
        Hq = 3
    if bad == "tq2":
        Tq = 2
    q = torch.zeros(S, Tq, Hq, hd)
    kn = torch.zeros(S, 1, Hkv, hd)
    K = torch.zeros(S, Hkv, Tmax, hd)
    if bad == "dtype":
        K = K.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        tds.fused_decode_step(q, kn, kn.clone(), K, K.clone(),
                              torch.zeros(S, dtype=torch.int32))


def test_supports_shape_matches_jax():
    from building_llm_from_scratch_tpu.ops.decode_step import supports_shape

    for args in [(1, 1024, 64), (1, 1024, 128), (2, 1024, 64), (1, 1020, 64),
                 (1, 8192, 256), (1, 8200, 64), (1, 1024, 96), (1, 64, 320)]:
        assert tds.supports_shape(*args) == supports_shape(*args)
    # the CUDA kernel takes head dims 64/128 and its three dtypes at any
    # cache length: its shared memory does not depend on Tmax, so the TPU
    # kernel's VMEM rule (Tmax <= 8192 and a multiple of 8) does not apply
    for Tmax, hd, dt in [(1024, 128, torch.bfloat16), (8192, 64, torch.float32),
                         (1001, 64, torch.bfloat16), (16384, 64, torch.bfloat16),
                         (32768, 64, torch.float16), (1, 128, torch.float32)]:
        tds.check_kernel_shape(Tmax, hd, dt)
    for Tmax, hd, dt in [(1024, 256, torch.bfloat16), (1024, 16, torch.float32),
                         (1024, 64, torch.float64), (0, 64, torch.bfloat16)]:
        with pytest.raises(ValueError, match="CUDA decode-step kernel"):
            tds.check_kernel_shape(Tmax, hd, dt)
