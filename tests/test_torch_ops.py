"""Port ops vs the JAX package's ops on the same numpy inputs (fp32, CPU):
norms, activations, RoPE tables and application, prefill attention and
decode attention. Tolerance: atol 1e-5 (fp32 reductions taken in another
order by the two frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.configs import RopeScaling as JRope
from building_llm_from_scratch_tpu.ops import activations as jact
from building_llm_from_scratch_tpu.ops import attention as jattn
from building_llm_from_scratch_tpu.ops import norms as jnorms
from building_llm_from_scratch_tpu.ops import rope as jrope
from building_llm_from_scratch_tpu_torch.configs import RopeScaling as TRope
from building_llm_from_scratch_tpu_torch.ops import activations as tact
from building_llm_from_scratch_tpu_torch.ops import attention as tattn
from building_llm_from_scratch_tpu_torch.ops import norms as tnorms
from building_llm_from_scratch_tpu_torch.ops import rope as trope

ATOL = 1e-5


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().numpy().astype(np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_layernorm(bias):
    x, s, b = rnd(3, 5, 64), rnd(64, seed=1), rnd(64, seed=2)
    ref = jnorms.layernorm(jnp.asarray(x), jnp.asarray(s),
                           jnp.asarray(b) if bias else None, eps=1e-5)
    got = tnorms.layernorm(torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(b) if bias else None, eps=1e-5)
    close(ref, got)


def test_rmsnorm():
    x, s = rnd(3, 5, 64), rnd(64, seed=1)
    close(jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=1e-5),
          tnorms.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), eps=1e-5))


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activations(name):
    x = rnd(4, 33) * 4
    close(getattr(jact, name)(jnp.asarray(x)),
          getattr(tact, name)(torch.from_numpy(x)))


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_tables(scaled):
    kw = dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
              original_context_length=8192)
    jc, js = jrope.precompute_rope_params(
        64, theta_base=500_000.0 * 1024 / 131_072, context_length=1024,
        rope_scaling=JRope(**kw) if scaled else None)
    tc, ts = trope.precompute_rope_params(
        64, theta_base=500_000.0 * 1024 / 131_072, context_length=1024,
        rope_scaling=TRope(**kw) if scaled else None)
    close(jc, tc)
    close(js, ts)


def test_apply_rope_per_row_positions():
    cos, sin = trope.precompute_rope_params(32, context_length=64)
    jcos, jsin = jrope.precompute_rope_params(32, context_length=64)
    x = rnd(3, 4, 2, 32)
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [60, 61, 62, 63]])
    ref = jrope.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    got = trope.apply_rope(torch.from_numpy(x), cos, sin, torch.from_numpy(pos))
    close(ref, got)
    # default positions (arange)
    close(jrope.apply_rope(jnp.asarray(x), jcos, jsin),
          trope.apply_rope(torch.from_numpy(x), cos, sin))


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_xla_attention_prefill(Hq, Hkv):
    B, T, D = 2, 12, 16
    q, k, v = rnd(B, T, Hq, D), rnd(B, T, Hkv, D, seed=1), rnd(B, T, Hkv, D, seed=2)
    pos = np.arange(T)
    kv_len = np.array([T, 5], np.int32)
    ref = jattn._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_length=jnp.asarray(kv_len),
        dropout_rate=0.0, dropout_rng=None, deterministic=True)
    got = tattn.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(pos), kv_length=torch.from_numpy(kv_len))
    close(ref, got)


@pytest.mark.parametrize("per_row", [True, False])
def test_decode_attention(per_row):
    B, Hq, Hkv, T, D = 3, 4, 2, 24, 16
    q = rnd(B, 1, Hq, D)
    K, V = rnd(B, Hkv, T, D, seed=1), rnd(B, Hkv, T, D, seed=2)
    if per_row:
        lens = np.array([0, 9, 23], np.int32)
        qpos, kvl = lens[:, None], lens + 1
    else:
        qpos, kvl = np.array([11]), np.int32(12)
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(K), jnp.asarray(V),
                                 q_positions=jnp.asarray(qpos),
                                 kv_length=jnp.asarray(kvl))
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(K),
                                 torch.from_numpy(V),
                                 q_positions=torch.from_numpy(np.asarray(qpos)),
                                 kv_length=torch.as_tensor(kvl))
    close(ref, got)
