"""Tests of the port that need an NVIDIA GPU: the CUDA decode-step,
flash-attention (with and without dropout), fused-dropout and
vocab-streamed cross-entropy kernels against their plain twins, the serving
engine and LLaMA and GPT-2 training steps on the card. They skip on a
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
from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa
from building_llm_from_scratch_tpu_torch.ops import fused_dropout as tfd
from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf
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


# Flash-attention kernels (B1 forward, B2a dq, B2b per-query-head dk/dv)
# against their twins. Errors are measured as max |kernel - ref| / max |ref|
# per tensor (lse: absolute). fp32: the same arithmetic in another order
# (tiled online softmax vs one pass), 1e-5 for out and lse and 5e-5 for the
# gradients (sums over up to 2048 terms). bf16: the kernel rounds the exp
# terms with the running max and the twin with the final one, and both
# round P and dS to 8 bits before their products, so 2e-2, the twin
# tolerance of the decode kernel; the same bound holds against the exact
# result (the twin in fp32 on the same inputs).
FLASH_TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def flash_inputs(dev, B, T, Hq, Hkv, hd, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
    return (rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd),
            rnd(B, T, Hq, hd))


def flash_all(q, k, v, do, fwd, dq, dkv, rate=0.0, seed=0):
    out, lse = fwd(q, k, v, rate, seed)
    delta = tfa.attention_delta(out, do)
    return (out, lse, dq(q, k, v, do, lse, delta, rate, seed)) + tuple(
        dkv(q, k, v, do, lse, delta, rate, seed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,hd", [(2, 256, 4, 4, 64),
                                           (1, 512, 8, 2, 64),
                                           (1, 1024, 4, 2, 128),
                                           (1, 2048, 4, 1, 64)])
def test_flash_kernels_match_twin(cuda, dtype, B, T, Hq, Hkv, hd):
    q, k, v, do = flash_inputs(cuda, B, T, Hq, Hkv, hd, dtype)
    n0 = (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
          tfa.flash_attention_dkv.launches)
    got = flash_all(q, k, v, do, tfa.flash_attention_fwd,
                    tfa.flash_attention_dq, tfa.flash_attention_dkv)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == tuple(n + 1 for n in n0)
    twin = flash_all(q, k, v, do, tfa.fused_attention_fwd_plain,
                     tfa.fused_attention_dq_plain, tfa.fused_attention_dkv_plain)
    f32 = [t.float() for t in (q, k, v, do)]
    exact = flash_all(*f32, tfa.fused_attention_fwd_plain,
                      tfa.fused_attention_dq_plain, tfa.fused_attention_dkv_plain)
    tol_out, tol_grad = FLASH_TOL[dtype]
    for name, a, b, c in zip(("out", "lse", "dq", "dk", "dv"), got, twin, exact):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        tol = tol_out if name in ("out", "lse") else tol_grad
        if name == "lse":
            assert (a - b).abs().max().item() <= tol, name
            assert (a - c).abs().max().item() <= tol, name
        else:
            assert _rel(a, b) <= tol, (name, _rel(a, b))
            assert _rel(a, c) <= tol, (name, _rel(a, c))


def test_flash_autograd_group_sums_gqa(cuda):
    """The autograd Function's gradients equal the twins' with the G query
    heads of each kv head summed."""
    q, k, v, do = flash_inputs(cuda, 1, 256, 8, 2, 64, torch.bfloat16, seed=1)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = tfa.fused_causal_attention(q, k, v)
    out.backward(do)
    ref = flash_all(q.detach(), k.detach(), v.detach(), do,
                    tfa.fused_attention_fwd_plain, tfa.fused_attention_dq_plain,
                    tfa.fused_attention_dkv_plain)
    assert _rel(out, ref[0]) <= 2e-2
    assert _rel(q.grad, ref[2]) <= 2e-2
    assert k.grad.shape == k.shape and v.grad.shape == v.shape
    assert _rel(k.grad, tfa.group_sum(ref[3], 2)) <= 2e-2
    assert _rel(v.grad, tfa.group_sum(ref[4], 2)) <= 2e-2


@pytest.mark.parametrize("T,hd,dtype", [(300, 64, torch.bfloat16),   # T % 128
                                        (640, 64, torch.bfloat16),   # T % 512
                                        (256, 192, torch.bfloat16),  # no hd 192
                                        (256, 64, torch.int32)])
def test_flash_kernels_refuse_ineligible_shapes(cuda, T, hd, dtype):
    q = torch.zeros(1, T, 2, hd, device=cuda).to(dtype)
    before = tfa.flash_attention_fwd.launches
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention_fwd(q, q[:, :, :1].contiguous(),
                                q[:, :, :1].contiguous())
    assert tfa.flash_attention_fwd.launches == before


def _oracle(q, k, v, do, mask, rate):
    """fp32 dense attention with the keep mask on the softmax weights and
    its autograd gradients (the same-mask oracle)."""
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    qh, kh, vh = (t.float().transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    s = qh @ kh.repeat_interleave(G, 1).transpose(-1, -2) / D ** 0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=q.device).tril(),
                      -1e30)
    lse = torch.logsumexp(s, -1)
    p = torch.softmax(s, -1) * mask / (1 - rate)
    out = p @ vh.repeat_interleave(G, 1)
    out.backward(do.float().transpose(1, 2))
    return (out.detach().transpose(1, 2), lse.detach(), qh.grad.transpose(1, 2),
            kh.grad.transpose(1, 2), vh.grad.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,hd", [(2, 256, 4, 4, 64), (1, 512, 8, 2, 64),
                                           (1, 256, 4, 2, 128)])
def test_flash_dropout_kernels_match_twin_and_oracle(cuda, dtype, B, T, Hq, Hkv, hd):
    """With p = 0.1 the kernels draw the twins' mask: out, lse, dq, dk, dv
    within FLASH_TOL of the twin and of the fp32 same-mask oracle (dk/dv
    group-summed); the twin with the next seed fails the bound."""
    rate, seed = 0.1, 987654321987
    q, k, v, do = flash_inputs(cuda, B, T, Hq, Hkv, hd, dtype, seed=2)
    got = flash_all(q, k, v, do, tfa.flash_attention_fwd, tfa.flash_attention_dq,
                    tfa.flash_attention_dkv, rate, seed)
    torch.cuda.synchronize()
    plain = (tfa.fused_attention_fwd_plain, tfa.fused_attention_dq_plain,
             tfa.fused_attention_dkv_plain)
    twin = flash_all(q, k, v, do, *plain, rate, seed)
    mask = tfa.keep_mask(seed, B, Hq, T, rate, cuda)
    oracle = _oracle(q, k, v, do, mask, rate)
    tol_out, tol_grad = FLASH_TOL[dtype]
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        a, b = got[i], twin[i]
        c = tfa.group_sum(a, Hkv) if name in ("dk", "dv") else a
        assert torch.isfinite(a).all(), name
        tol = tol_out if name in ("out", "lse") else tol_grad
        if name == "lse":
            assert (a - b).abs().max().item() <= tol
            assert (a - oracle[i]).abs().max().item() <= tol
        else:
            assert _rel(a, b) <= tol, (name, _rel(a, b))
            assert _rel(c, oracle[i]) <= tol, (name, _rel(c, oracle[i]))
    control = flash_all(q, k, v, do, *plain, rate, seed + 1)
    for i, name in ((0, "out"), (2, "dq"), (3, "dk"), (4, "dv")):
        assert _rel(control[i], twin[i]) > FLASH_TOL[dtype][i > 0], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernels_are_bit_equal_to_twin(cuda, dtype):
    """B3 forward, forward with add, and backward equal their twins bit for
    bit; p = 0 is the identity; the keep fraction is within 1e-3 of 0.9."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4096, 768, generator=gen, device=cuda).to(dtype)
    h = torch.randn(4096, 768, generator=gen, device=cuda).to(dtype)
    n0 = (tfd.dropout_fwd.launches, tfd.dropout_bwd.launches)
    seed = 2 ** 63 + 12345
    for a, b in ((tfd.dropout_fwd(None, h, seed, 0.1), tfd.dropout_fwd_plain(None, h, seed, 0.1)),
                 (tfd.dropout_fwd(x, h, seed, 0.1), tfd.dropout_fwd_plain(x, h, seed, 0.1)),
                 (tfd.dropout_bwd(h, seed, 0.1), tfd.dropout_bwd_plain(h, seed, 0.1))):
        torch.cuda.synchronize()
        assert a.dtype == dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert (tfd.dropout_fwd.launches, tfd.dropout_bwd.launches) == (n0[0] + 2, n0[1] + 1)
    assert torch.equal(tfd.dropout_fwd(None, h, seed, 0.0), h)
    kept = (tfd.dropout_bwd(torch.ones_like(h), seed, 0.1) != 0).float().mean().item()
    assert abs(kept - 0.9) < 1e-3


def test_dropout_kernel_refuses_what_it_cannot_take(cuda):
    before = tfd.dropout_fwd.launches
    with pytest.raises(ValueError):                       # not a group of 4
        tfd.dropout_fwd(None, torch.zeros(7, device=cuda), 1, 0.1)
    with pytest.raises(ValueError):                       # not contiguous
        tfd.dropout_fwd(None, torch.zeros(8, 8, device=cuda).t(), 1, 0.1)
    with pytest.raises(TypeError):
        tfd.dropout_fwd(None, torch.zeros(8, dtype=torch.int32, device=cuda), 1, 0.1)
    assert tfd.dropout_fwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,V", [(1024, 768, 50257), (256, 128, 999), (200, 128, 300)])
def test_xent_kernel_matches_twin(cuda, dtype, N, D, V):
    """B4's (nll, lse) against its twin at the JAX kernel test's bounds; the
    twin over W padded with unmasked zero columns fails them."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(N, D, generator=gen, device=cuda).to(dtype)
    w = (0.02 * torch.randn(D, V, generator=gen, device=cuda)).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device=cuda)
    t[0] = V - 1
    before = txf.xent_fwd.launches
    nll, lse = txf.xent_fwd(x, w, t)
    torch.cuda.synchronize()
    assert txf.xent_fwd.launches == before + 1
    nll_t, lse_t = txf.xent_fwd_plain(x, w, t)
    torch.testing.assert_close(lse, lse_t, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nll, nll_t, rtol=1e-4, atol=2e-4)
    vp = -(-V // 512) * 512
    if vp != V:
        _, lse_c = txf.xent_fwd_plain(x, torch.nn.functional.pad(w, (0, vp - V)), t)
        assert not torch.allclose(lse, lse_c, rtol=1e-5, atol=1e-5)


def test_xent_kernel_refuses_what_it_cannot_take(cuda):
    before = txf.xent_fwd.launches
    x = torch.zeros(256, 100, device=cuda)                # D % 32
    with pytest.raises(ValueError):
        txf.xent_fwd(x, torch.zeros(100, 999, device=cuda),
                     torch.zeros(256, dtype=torch.long, device=cuda))
    with pytest.raises(TypeError):
        txf.xent_fwd(torch.zeros(256, 128, device=cuda),
                     torch.zeros(128, 999, device=cuda, dtype=torch.bfloat16),
                     torch.zeros(256, dtype=torch.long, device=cuda))
    assert txf.xent_fwd.launches == before


def test_train_step_launch_counts_on_the_card(cuda):
    """One bf16 train step of a small LLaMA-like model (T 256, head dim 64)
    launches each flash kernel once per layer; an eval step launches the
    forward once per layer and nothing else; the loss is finite."""
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    cfg = get_config("llama3_2", "1B", dtype="bf16").replace(
        emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=3, hidden_dim=512,
        vocab_size=512, context_length=256)
    model = build_model(cfg, seed=0, device=cuda)
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(model, opt)
    x = torch.randint(0, 512, (2, 257), device=cuda)
    batch = {"inputs": x[:, :-1], "targets": x[:, 1:]}
    for f in (tfa.flash_attention_fwd, tfa.flash_attention_dq,
              tfa.flash_attention_dkv):
        f.launches = 0
    state, m = tts.make_train_step(cfg, opt)(state, batch)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == (3, 3, 3)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    loss = tts.make_eval_step(cfg)(state, batch)
    assert torch.isfinite(loss)
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == (6, 3, 3)


def test_gpt2_train_step_with_dropout_on_the_card(cuda):
    """One bf16 train step of a small GPT-2-like model (T 256, head dim 64,
    width 128) with dropout 0.1: each flash kernel once per layer, B3 once
    for the embedding and twice per layer forward and backward, no B4 by
    default; the loss is finite and equals the CPU's step on the same
    weights and masks to 1e-3."""
    from building_llm_from_scratch_tpu_torch.models.transformer import Transformer
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    cfg = get_config("GPT2", "124M", dtype="bf16").replace(
        emb_dim=128, n_heads=2, n_kv_groups=2, n_layers=3, hidden_dim=512,
        vocab_size=999, context_length=256)
    model = build_model(cfg, seed=0, device=cuda)
    cpu = Transformer(cfg, {k: v.cpu() for k, v in model.flat_params().items()})
    x = torch.randint(0, 999, (2, 257))
    losses, launches = [], []
    kernels = (tfa.flash_attention_fwd, tfa.flash_attention_dq,
               tfa.flash_attention_dkv, tfd.dropout_fwd, tfd.dropout_bwd,
               txf.xent_fwd)
    for m in (model, cpu):
        opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
        state = tts.init_train_state(m, opt, seed=7)
        for f in kernels:
            f.launches = 0
        batch = {"inputs": x[:, :-1].to(m.device), "targets": x[:, 1:].to(m.device)}
        state, met = tts.make_train_step(cfg, opt)(state, batch)
        losses.append(met["loss"].item())
        launches.append([f.launches for f in kernels])
    assert launches == [[3, 3, 3, 7, 7, 0], [0] * 6], launches
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1]), losses
