"""Tests of the port that need an NVIDIA GPU: the CUDA decode-step kernel
against its plain twin, and the serving engine on the card. They skip on a
machine without CUDA. This file imports neither JAX nor the JAX package, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu_torch.configs import get_config
from building_llm_from_scratch_tpu_torch.models.transformer import build_model
from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams

pytestmark = pytest.mark.cuda

# (atol, rtol) of the kernel against its twin, which rounds the softmax
# weights to the model dtype before P.V (the kernel keeps them in fp32),
# and against the exact result (the twin in fp32 on the same inputs), from
# which the kernel may differ by one unit in the last place of its output.
# The same limits as chip_smoke.py.
TWIN_TOL = {torch.float32: (1e-5, 1e-5), torch.float16: (2e-2, 2e-2),
            torch.bfloat16: (2e-2, 2e-2)}
EXACT_TOL = {torch.float32: (1e-5, 1e-5), torch.float16: (1e-5, 2.0 ** -10),
             torch.bfloat16: (1e-5, 2.0 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd", [(12, 12, 64), (32, 8, 64), (32, 8, 128),
                                       (24, 2, 64)])
def test_kernel_matches_twin(cuda, dtype, Hq, Hkv, hd):
    S, Tmax = 4, 512
    gen = torch.Generator(device=cuda).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)  # noqa: E731
    q, kn, vn = rnd(S, 1, Hq, hd), rnd(S, 1, Hkv, hd), rnd(S, 1, Hkv, hd)
    K, V = rnd(S, Hkv, Tmax, hd), rnd(S, Hkv, Tmax, hd)
    lens = torch.tensor([0, 5, 300, Tmax - 1], dtype=torch.int32, device=cuda)
    Kk, Vk, Kt, Vt = K.clone(), V.clone(), K.clone(), V.clone()
    before = tds.fused_decode_step.launches
    out, Ko, Vo = tds.fused_decode_step(q, kn, vn, Kk, Vk, lens)
    torch.cuda.synchronize()
    assert tds.fused_decode_step.launches == before + 1
    assert Ko is Kk and Vo is Vk
    ref, _, _ = tds.fused_decode_step_plain(q, kn, vn, Kt, Vt, lens)
    assert torch.equal(Kk, Kt) and torch.equal(Vk, Vt)
    atol, rtol = TWIN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    f32 = lambda t: t.float().clone()  # noqa: E731
    exact, _, _ = tds.fused_decode_step_plain(f32(q), f32(kn), f32(vn), f32(K),
                                              f32(V), lens)
    atol, rtol = EXACT_TOL[dtype]
    torch.testing.assert_close(out.float(), exact, atol=atol, rtol=rtol)


def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 1, 4, 256, device=cuda)        # hd 256: no instantiation
    kn = torch.zeros(2, 1, 2, 256, device=cuda)
    K = torch.zeros(2, 2, 16, 256, device=cuda)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tds.fused_decode_step(q, kn, kn.clone(), K, K.clone(), lens)
    q = torch.zeros(2, 1, 4, 64, device=cuda)
    kn = torch.zeros(2, 1, 2, 64, device=cuda)
    K = torch.zeros(2, 2, 16, 64, device=cuda)
    with pytest.raises(TypeError):                      # int64 lengths
        tds.fused_decode_step(q, kn, kn.clone(), K, K.clone(), lens.long())


@pytest.mark.parametrize("change", [dict(emb_dim=64),           # head dim 16
                                    dict(context_length=1001),  # Tmax % 8
                                    dict(context_length=16384)])
def test_card_refuses_shapes_the_kernel_cannot_take(cuda, change):
    """A model or slot length the kernel cannot take raises on the card when
    the engine is built, and a decode tick at such a shape raises too;
    neither computes the plain twin instead."""
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        decode_slots,
        init_slot_cache,
    )

    cfg = get_config("llama3_2", "1B").replace(
        emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=1, hidden_dim=256,
        vocab_size=512, context_length=128).replace(**change)
    model = build_model(cfg, seed=0, device=cuda)
    with pytest.raises(ValueError, match="CUDA decode-step kernel"):
        DecodeEngine(model, n_slots=2)
    cache = init_slot_cache(cfg, 2, cfg.context_length, cuda)
    before = tds.fused_decode_step.launches
    with pytest.raises(ValueError):
        decode_slots(model, torch.zeros(2, 1, dtype=torch.long, device=cuda),
                     torch.zeros(2, dtype=torch.int32, device=cuda), cache)
    assert tds.fused_decode_step.launches == before


def test_engine_on_the_card(cuda):
    """A small LLaMA-like model with head dim 64 served on the card: every
    decode tick launches the kernel once per layer, and a greedy request
    gives the same tokens alone as co-batched."""
    cfg = get_config("llama3_2", "1B").replace(
        emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=2, hidden_dim=512,
        vocab_size=512, context_length=128)
    model = build_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, n).tolist(),
             SamplingParams(max_new_tokens=m, temperature=0.7 if i % 3 else 0.0,
                            top_k=8, seed=i, ignore_eos=True))
            for i, (n, m) in enumerate([(5, 9), (40, 12), (17, 7), (60, 20)])]
    eng = DecodeEngine(model, n_slots=3, max_len=128)
    tds.fused_decode_step.launches = 0
    handles = [eng.submit(p, sp) for p, sp in reqs]
    eng.run_until_idle()
    assert tds.fused_decode_step.launches == cfg.n_layers * eng.n_ticks > 0
    assert [len(h.output_ids) for h in handles] == [9, 12, 7, 20]
    solo = DecodeEngine(model, n_slots=3, max_len=128)
    for i in (0, 1):
        h = solo.submit(*reqs[i])
        solo.run_until_idle()
        assert h.output_ids == handles[i].output_ids
