"""The port's model vs the JAX package's on the same weights: the weight
carrier (bit-exact), the ``.npz`` export loader, and the serving forward
passes (``prefill_into_slot``, ``decode_slots``) on GPT-2-like and
LLaMA-like small configs. Logits are compared in fp32 with atol 1e-4 (two
layers of fp32 matmuls summed in another order); caches only over their
valid prefix, because the two packages write different things past it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.models import transformer as jtf
from building_llm_from_scratch_tpu.training.checkpoint import export_params
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    flatten_tree,
    load_exported_params,
    params_from_jax,
)
from torch_port_helpers import bits, jax_params, small_configs, to_np32

jax_prefill = jax.jit(jtf.prefill_into_slot, static_argnums=(1,))
jax_decode = jax.jit(jtf.decode_slots, static_argnums=(1,))


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_params_from_jax_round_trip_is_bit_exact(kind, dtype):
    jcfg, tcfg = small_configs(kind, dtype)
    _, np_params = jax_params(jcfg)
    model = params_from_jax(np_params, tcfg, device="cpu")
    flat = flatten_tree(np_params)
    back = model.flat_params()
    assert set(back) == set(flat) == set(ttf.param_shapes(tcfg))
    for k, v in flat.items():
        assert back[k].dtype == tcfg.torch_dtype
        np.testing.assert_array_equal(bits(back[k]), bits(v), err_msg=k)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_load_exported_params(tmp_path, dtype):
    jcfg, tcfg = small_configs("llama", dtype)
    params, np_params = jax_params(jcfg, seed=3)
    path = export_params(str(tmp_path / "model.npz"), params)
    model = load_exported_params(path, tcfg, device="cpu")
    back = model.flat_params()
    for k, v in flatten_tree(np_params).items():
        np.testing.assert_array_equal(bits(back[k]), bits(v), err_msg=k)


@pytest.mark.parametrize("kind,wide", [("gpt2", False), ("llama", False),
                                       ("llama", True)])
def test_prefill_and_decode_match_jax(kind, wide):
    # wide: head dim 64, a shape the CUDA kernel also takes
    jcfg, tcfg = small_configs(kind, **({"emb_dim": 256} if wide else {}))
    params, np_params = jax_params(jcfg, seed=1)
    model = params_from_jax(np_params, tcfg, device="cpu")
    S, Tmax = 3, 64
    jcache = jtf.init_slot_cache(jcfg, S, Tmax)
    tcache = ttf.init_slot_cache(tcfg, S, Tmax, "cpu")
    rng = np.random.default_rng(0)
    lens = np.array([5, 20, 33], np.int32)
    for slot, Tp in enumerate(lens):
        Tpb = 32 if Tp <= 32 else 64
        toks = np.zeros((1, Tpb), np.int32)
        toks[0, :Tp] = rng.integers(0, jcfg.vocab_size, Tp)
        jl, jcache = jax_prefill(params, jcfg, jnp.asarray(toks),
                                 jnp.int32(Tp), jnp.int32(slot), jcache)
        tl = ttf.prefill_into_slot(model, torch.from_numpy(toks).long(), int(Tp),
                                   slot, tcache)
        assert tl.dtype == torch.float32 and tl.shape == (jcfg.vocab_size,)
        np.testing.assert_allclose(to_np32(tl), np.asarray(jl), atol=1e-4, rtol=0)
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (S, 1)).astype(np.int32)
        jl, jcache = jax_decode(params, jcfg, jnp.asarray(toks),
                                jnp.asarray(lens), jcache)
        before = tds.fused_decode_step.launches
        tl = ttf.decode_slots(model, torch.from_numpy(toks).long(),
                              torch.from_numpy(lens), tcache)
        assert tds.fused_decode_step.launches == before   # CPU: the twin
        np.testing.assert_allclose(to_np32(tl), np.asarray(jl), atol=1e-4, rtol=0)
        lens = lens + 1
    for name in ("k", "v"):
        for jbuf, tbuf in zip(jcache[name], tcache[name]):
            for s in range(S):
                np.testing.assert_allclose(
                    to_np32(tbuf[s, :, :lens[s]]),
                    np.asarray(jbuf[s, :, :lens[s]], np.float32),
                    atol=1e-4, rtol=0)
