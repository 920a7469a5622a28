"""Tests of the port that need an NVIDIA GPU: the CUDA decode-step, paged
decode-attention, BGMV, flash-attention (with and without dropout),
fused-dropout and vocab-streamed cross-entropy kernels against their plain
twins, the serving engine (contiguous, paged and with LoRA adapters),
LLaMA and GPT-2 training steps on the card (the fp16 policy with remat
and accumulation among them), the batch stager's copy stream and the
asynchronous checkpoint's snapshot, text prompts served with a BPE
tokenizer, the serving operations' kernel gates (a NaN-poisoned row
stays alone in B5 and B7, a NaN tail past a row's length never reaches
its output) and fault isolation on the card, and B1-B3 at a pipeline
microbatch's shapes and seeds with a one-rank pp step, the health bundle
on the card against the CPU and a ``--profile`` trace's kernel events.
They skip on a machine without
CUDA. This file imports neither JAX nor the JAX package, so
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tmax", [1000, 16384, 32768])
def test_kernel_matches_twin_at_long_and_unaligned_caches(cuda, dtype, Tmax):
    """B5 takes any cache length: Tmax not a multiple of 8, and caches past
    the TPU kernel's 8192 with rows whose lengths pass 8192; caches
    bit-equal to the twin's, outputs within its tolerance and one unit in
    the last place of the exact result."""
    S, Hq, Hkv, hd = 4, 16, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(Tmax)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)  # noqa: E731
    q, kn, vn = rnd(S, 1, Hq, hd), rnd(S, 1, Hkv, hd), rnd(S, 1, Hkv, hd)
    K, V = rnd(S, Hkv, Tmax, hd), rnd(S, Hkv, Tmax, hd)
    lens = ([0, 8191, 8193 + Tmax // 4, Tmax - 1] if Tmax > 8192
            else [0, 5, Tmax // 2 + 3, Tmax - 1])
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    Kk, Vk, Kt, Vt = K.clone(), V.clone(), K.clone(), V.clone()
    before = tds.fused_decode_step.launches
    out, _, _ = tds.fused_decode_step(q, kn, vn, Kk, Vk, lens)
    torch.cuda.synchronize()
    assert tds.fused_decode_step.launches == before + 1
    ref, _, _ = tds.fused_decode_step_plain(q, kn, vn, Kt, Vt, lens)
    assert torch.equal(Kk, Kt) and torch.equal(Vk, Vt)
    atol, rtol = TWIN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    f32 = lambda t: t.float().clone()  # noqa: E731
    exact, _, _ = tds.fused_decode_step_plain(f32(q), f32(kn), f32(vn), f32(K),
                                              f32(V), lens)
    atol, rtol = EXACT_TOL[dtype]
    torch.testing.assert_close(out.float(), exact, atol=atol, rtol=rtol)


def _split_case(dev, S, Hq, Hkv, hd, Tmax, dtype, lens, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
    q, kn, vn = rnd(S, 1, Hq, hd), rnd(S, 1, Hkv, hd), rnd(S, 1, Hkv, hd)
    K, V = rnd(S, Hkv, Tmax, hd), rnd(S, Hkv, Tmax, hd)
    return q, kn, vn, K, V, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 12])
def test_split_kv_kernel_at_split_boundaries(cuda, dtype, hd, G):
    """B5's split-KV kernel with rows ending on the plan's split boundaries
    (C - 1, C, C + 1), at 0, past 8192 and at Tmax - 1 of a cache that is
    not a multiple of 32: caches bit-equal to the twin's, outputs within
    its tolerance and one unit in the last place of the exact result."""
    Hkv, Tmax = 2, 9000
    C, n_splits = tds.split_kv_plan(Tmax, hd, dtype)
    assert n_splits == -(-Tmax // C)
    lens = [0, C - 1, C, C + 1, 2 * C + 5, 8193, Tmax - 2, Tmax - 1]
    q, kn, vn, K, V, lens = _split_case(cuda, len(lens), G * Hkv, Hkv, hd, Tmax,
                                        dtype, lens, seed=G * hd)
    Kk, Vk, Kt, Vt = K.clone(), V.clone(), K.clone(), V.clone()
    before = tds.fused_decode_step.launches
    out, _, _ = tds.fused_decode_step(q, kn, vn, Kk, Vk, lens)
    torch.cuda.synchronize()
    assert tds.fused_decode_step.launches == before + 1
    ref, _, _ = tds.fused_decode_step_plain(q, kn, vn, Kt, Vt, lens)
    assert torch.equal(Kk, Kt) and torch.equal(Vk, Vt)
    atol, rtol = TWIN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    f32 = lambda t: t.float().clone()  # noqa: E731
    exact, _, _ = tds.fused_decode_step_plain(f32(q), f32(kn), f32(vn), f32(K),
                                              f32(V), lens)
    atol, rtol = EXACT_TOL[dtype]
    torch.testing.assert_close(out.float(), exact, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_split_kv_kernel_is_batch_invariant_and_deterministic(cuda, dtype):
    """A row's output has the same bits alone (S = 1) as inside a batch of 8
    rows of other lengths, and two calls on the same inputs agree bit for
    bit: the plan never looks at S or the lengths, and the merge of the
    splits runs in a fixed order."""
    Hq, Hkv, hd, Tmax = 16, 4, 64, 4100
    lens = [7, 4099, 300, 1023, 0, 2600, 256, 1500]
    q, kn, vn, K, V, lens = _split_case(cuda, 8, Hq, Hkv, hd, Tmax, dtype, lens)
    out, Kb, Vb = tds.fused_decode_step(q, kn, vn, K.clone(), V.clone(), lens)
    again, _, _ = tds.fused_decode_step(q, kn, vn, K.clone(), V.clone(), lens)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    for r in (0, 1, 3, 5):
        sl = slice(r, r + 1)
        alone, Ka, Va = tds.fused_decode_step(
            q[sl].clone(), kn[sl].clone(), vn[sl].clone(), K[sl].clone(),
            V[sl].clone(), lens[sl].clone())
        torch.cuda.synchronize()
        assert torch.equal(alone, out[sl]), r
        assert torch.equal(Ka, Kb[sl]) and torch.equal(Va, Vb[sl])


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
                                    dict(emb_dim=1024)])        # head dim 256
def test_card_refuses_shapes_the_kernel_cannot_take(cuda, change):
    """A model whose head dim the kernel cannot take raises on the card
    when the engine is built, and a decode tick at such a shape raises too;
    neither computes the plain twin instead. (Any slot length is taken:
    test_engine_serves_long_and_unaligned_slots.)"""
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


@pytest.mark.parametrize("context", [1001, 16384])
def test_engine_serves_long_and_unaligned_slots(cuda, context):
    """Slot lengths the TPU kernel's rule refused (not a multiple of 8, past
    8192) are served on the card: a request whose row ends past 8192 (at
    16384) finishes its budget, and B5 launches once per layer a tick."""
    cfg = get_config("llama3_2", "1B").replace(
        emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=1, hidden_dim=256,
        vocab_size=512, context_length=context)
    model = build_model(cfg, seed=0, device=cuda)
    eng = DecodeEngine(model, n_slots=2, max_len=context)
    n_prompt = 8300 if context > 8192 else 900
    rng = np.random.default_rng(1)
    tds.fused_decode_step.launches = 0
    h = eng.submit(rng.integers(0, 512, n_prompt).tolist(),
                   SamplingParams(max_new_tokens=16, ignore_eos=True))
    eng.run_until_idle()
    assert len(h.output_ids) == 16
    assert tds.fused_decode_step.launches == cfg.n_layers * eng.n_ticks > 0


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


@pytest.mark.parametrize("paged", [False, True])
def test_spec_and_int8_engines_on_the_card(cuda, paged):
    """Speculative decoding and int8 KV on the card (fp32, head dim 64),
    contiguous and paged: spec_k 4 under the n-gram drafter and a drafter
    that never matches commits the same tokens, and no verify or int8 tick
    launches B5 or B7; the int8 cache's k/v are int8 with fp32 scales and
    its requests finish their budgets."""
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        KVCachePolicy,
    )
    from building_llm_from_scratch_tpu_torch.serving.spec import Drafter

    class Never(Drafter):
        def propose(self, history, k):
            return np.full((k,), 3, np.int32)

    cfg = _paged_cfg()
    model = build_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(2)
    span = rng.integers(0, 512, 12).tolist()
    reqs = [(span * 3 + rng.integers(0, 512, n).tolist(),
             SamplingParams(max_new_tokens=m, temperature=0.7 if i == 2 else 0.0,
                            top_k=8, seed=i, ignore_eos=True))
            for i, (n, m) in enumerate([(3, 30), (9, 24), (5, 16)])]
    pol = dict(paged=True, page_tokens=8, prefill_chunk=16) if paged else {}

    def run(**kw):
        quant = kw.pop("kv_quant", "model")
        eng = DecodeEngine(model, n_slots=3, max_len=128,
                           kv_policy=KVCachePolicy(kv_quant=quant, **pol), **kw)
        tds.fused_decode_step.launches = tds.paged_decode_attention.launches = 0
        handles = [eng.submit(p, sp) for p, sp in reqs]
        eng.run_until_idle()
        torch.cuda.synchronize()
        assert tds.fused_decode_step.launches == tds.paged_decode_attention.launches == 0
        assert [len(h.output_ids) for h in handles] == [30, 24, 16]
        return eng, [h.output_ids for h in handles]

    ngram, out = run(spec_k=4)
    never, out_never = run(spec_k=4, drafter=Never())
    assert out == out_never
    assert never.stats()["spec_tokens_accepted"] < ngram.stats()["spec_tokens_drafted"]
    eng, _ = run(kv_quant="int8")
    assert eng.cache["k"][0].dtype == torch.int8
    assert eng.cache["k_scale"][0].dtype == torch.float32


def test_engine_serves_text_prompts_on_the_card(cuda, tmp_path):
    """Three text prompts through the engine with a synthetic LLaMA-3 BPE
    (``scripts/build_local_bpe.py``, 300 merges, unpadded so its ids fit a
    small model's vocab) on a LLaMA-like model with head dim 64: the greedy
    ids equal those of the same requests sent as ``prompt_ids =
    encode(prompt)`` to an engine without a tokenizer, each request's text
    is ``decode(ids)`` and its stream joins to it, and every decode tick
    launched the kernel once per layer."""
    import os
    import runpy

    from building_llm_from_scratch_tpu_torch.data.tokenizers import Llama3Tokenizer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    writer = runpy.run_path(os.path.join(root, "scripts", "build_local_bpe.py"))
    tok = Llama3Tokenizer(writer["write_assets"](str(tmp_path), 300, full=False,
                                                 text_chars=60_000)["tokenizer_model"])
    cfg = get_config("llama3_2", "1B").replace(
        emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=2, hidden_dim=512,
        vocab_size=tok._enc.n_vocab, context_length=128)
    model = build_model(cfg, seed=0, device=cuda)
    prompts = ["Every effort moves you closer to mastery.",
               "Café naïve 中文 🙂 don't\r\n  1234567", "THEY'RE here\tnow"]
    sp = [SamplingParams(max_new_tokens=m, ignore_eos=True) for m in (24, 17, 31)]
    eng = DecodeEngine(model, tok, n_slots=3, max_len=128)
    tds.fused_decode_step.launches = 0
    handles = [eng.submit(p, s) for p, s in zip(prompts, sp)]
    eng.run_until_idle()
    assert tds.fused_decode_step.launches == cfg.n_layers * eng.n_ticks > 0
    plain = DecodeEngine(model, n_slots=3, max_len=128)
    ids = [plain.submit(tok.encode(p), s) for p, s in zip(prompts, sp)]
    plain.run_until_idle()
    for h, g, s in zip(handles, ids, sp):
        assert h.output_ids == g.output_ids and len(h.output_ids) == s.max_new_tokens
        assert h.text == tok.decode(h.output_ids)
        assert "".join(h.stream(timeout=5)) == h.text
        assert g.text == ""


def paged_inputs(dev, S, Hq, Hkv, hd, P, M, dtype, seed=0):
    """q, pools and a page table over shuffled page ids: rows share their
    first page (a prefix hit), trailing entries point at the trash page 0,
    row 0 has length 0 and row 1 ends one short of a page boundary
    (length + 1 == k P). Page 0 holds garbage, as the trash page does."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = S * M + 1
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
    q, K, V = rnd(S, 1, Hq, hd), rnd(N, Hkv, P, hd), rnd(N, Hkv, P, hd)
    ids = (torch.randperm(N - 1, generator=gen, device=dev) + 1).to(torch.int32)
    table = ids[:S * M].view(S, M).clone()
    table[:, 0] = table[0, 0]                          # shared prefix page
    lens = torch.tensor([0, 3 * P - 1] + [int(x) for x in torch.randint(
        1, M * P, (S - 2,), generator=gen, device=dev)], dtype=torch.int32,
        device=dev)
    for s in range(S):
        used = int(lens[s]) // P + 1
        table[s, used:] = 0                            # unmapped -> trash
    return q, K, V, table.contiguous(), lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [1, 5, 8, 16, 24, 32, 64])
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 2, 64), (4, 4, 128)])
def test_paged_kernel_matches_twin(cuda, dtype, P, Hq, Hkv, hd):
    """B7 against its twin (``paged_view`` + ``decode_attention``) and the
    exact fp32 result, at the decode kernel's tolerances, for page sizes
    whose TMA boxes (``paged_box_rows``) are 1, 8, 16 and 32 rows."""
    S, M = 5, max(4, 320 // P)
    q, K, V, table, lens = paged_inputs(cuda, S, Hq, Hkv, hd, P, M, dtype)
    before = tds.paged_decode_attention.launches
    out = tds.paged_decode_attention(q, K, V, table, lens)
    torch.cuda.synchronize()
    assert tds.paged_decode_attention.launches == before + 1
    assert torch.isfinite(out).all() and out.dtype == dtype
    ref = tds.paged_decode_attention_plain(q, K, V, table, lens)
    atol, rtol = TWIN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    exact = tds.paged_decode_attention_plain(q.float(), K.float(), V.float(),
                                             table, lens)
    atol, rtol = EXACT_TOL[dtype]
    torch.testing.assert_close(out.float(), exact, atol=atol, rtol=rtol)
    # a table that reads the wrong pages must fail the bound
    wrong = tds.paged_decode_attention_plain(q.float(), K.float(), V.float(),
                                             table.roll(1, 0), lens)
    assert not torch.allclose(out.float(), wrong, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,Hq,Hkv", [(torch.bfloat16, 32, 8), (torch.float32, 12, 12)])
def test_paged_kernel_is_bit_equal_to_b5_on_the_same_rows(cuda, dtype, Hq, Hkv):
    """At the served page size (16) B7 runs B5's split pass on the same
    rows: its output equals B5's on the rows laid out contiguously (B5's
    append rewrites each row's last position with the value it holds) bit
    for bit, and a row alone gives the bits it gives co-batched. One launch
    count per call."""
    S, P, M, hd = 6, 16, 64, 64
    q, K, V, table, lens = paged_inputs(cuda, S, Hq, Hkv, hd, P, M, dtype, seed=3)
    lens[2] = M * P - 1
    before = tds.paged_decode_attention.launches
    out = tds.paged_decode_attention(q, K, V, table, lens)
    torch.cuda.synchronize()
    assert tds.paged_decode_attention.launches == before + 1
    Kc = tds.paged_view(K, table, M * P).contiguous()
    Vc = tds.paged_view(V, table, M * P).contiguous()
    at = (torch.arange(S, device=cuda), slice(None), lens.long())
    kn, vn = Kc[at][:, None].contiguous(), Vc[at][:, None].contiguous()
    out_b5, _, _ = tds.fused_decode_step(q, kn, vn, Kc, Vc, lens)
    assert torch.equal(out, out_b5)
    alone = tds.paged_decode_attention(q[2:3].contiguous(), K, V,
                                       table[2:3].contiguous(), lens[2:3].contiguous())
    assert torch.equal(alone, out[2:3])


def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 1, 4, 256, device=cuda)           # hd 256
    K = torch.zeros(5, 2, 16, 256, device=cuda)
    table = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = tds.paged_decode_attention.launches
    with pytest.raises(ValueError):
        tds.paged_decode_attention(q, K, K.clone(), table, lens)
    q, K = q[..., :64].contiguous(), K[..., :64].contiguous()
    with pytest.raises(TypeError):                       # int64 table
        tds.paged_decode_attention(q, K, K.clone(), table.long(), lens)
    assert tds.paged_decode_attention.launches == before


def _paged_cfg(**kw):
    return get_config("llama3_2", "1B", dtype="fp32").replace(
        emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=2, hidden_dim=512,
        vocab_size=512, context_length=128).replace(**kw)


def _finite_rows(out):
    return torch.isfinite(out.float()).flatten(1).all(1).tolist()


@pytest.mark.parametrize("dtype,Hq,Hkv", [(torch.bfloat16, 32, 8),
                                          (torch.float32, 12, 12)])
def test_decode_kernel_isolates_nan_rows_and_ignores_nan_tails(cuda, dtype, Hq, Hkv):
    """B5's two serving-operations gates: one row's cache all NaN makes that
    row's output, and only it, non-finite (the twin's mask); NaN past each
    row's length (a freed slot's stale tail) leaves every output finite and
    within the twin's bounds on the clean cache, because the split pass
    reads V only up to the length. Controls: NaN inside a length reaches
    that row's output, and the twin itself (which weighs masked positions
    by an exact 0) turns every row with a NaN tail non-finite."""
    S, Tmax, hd = 4, 1024, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)  # noqa: E731
    q, kn, vn = rnd(S, 1, Hq, hd), rnd(S, 1, Hkv, hd), rnd(S, 1, Hkv, hd)
    K, V = rnd(S, Hkv, Tmax, hd), rnd(S, Hkv, Tmax, hd)
    lens = torch.tensor([0, 5, 300, Tmax - 24], dtype=torch.int32, device=cuda)
    nan = torch.full((), float("nan"), dtype=dtype, device=cuda)

    def kernel(Kx, Vx):
        out, _, _ = tds.fused_decode_step(q, kn, vn, Kx.clone(), Vx.clone(), lens)
        torch.cuda.synchronize()
        return out

    def twin(Kx, Vx):
        return tds.fused_decode_step_plain(q, kn, vn, Kx.clone(), Vx.clone(), lens)[0]

    atol, rtol = TWIN_TOL[dtype]
    Kp, Vp = K.clone(), V.clone()
    Kp[1], Vp[1] = nan, nan
    out, ref = kernel(Kp, Vp), twin(Kp, Vp)
    assert _finite_rows(out) == _finite_rows(ref) == [True, False, True, True]
    keep = torch.tensor([0, 2, 3], device=cuda)
    torch.testing.assert_close(out[keep].float(), ref[keep].float(), atol=atol, rtol=rtol)
    tail = (torch.arange(Tmax, device=cuda)[None, :] > lens[:, None].long())
    tail = tail[:, None, :, None]
    Kt, Vt = torch.where(tail, nan, K), torch.where(tail, nan, V)
    out = kernel(Kt, Vt)
    assert _finite_rows(out) == [True] * S
    torch.testing.assert_close(out.float(), twin(K, V).float(), atol=atol, rtol=rtol)
    assert not any(_finite_rows(twin(Kt, Vt)))
    Vc = V.clone()
    Vc[2, :, 299] = nan                                  # inside row 2's length
    assert _finite_rows(kernel(K, Vc)) == [True, True, False, True]


@pytest.mark.parametrize("dtype,Hq,Hkv", [(torch.bfloat16, 32, 8),
                                          (torch.float32, 12, 12)])
def test_paged_kernel_isolates_nan_rows_and_ignores_nan_tails(cuda, dtype, Hq, Hkv):
    """B7's gates, on a table whose rows share no page: one row's pages all
    NaN make that row alone non-finite; NaN in every position past each
    row's length and in the whole trash page leaves every output finite
    and within the twin's bounds on the clean pool; NaN inside a length
    reaches that row (the control)."""
    S, P, M, hd = 5, 16, 64, 64
    q, K, V, _, lens = paged_inputs(cuda, S, Hq, Hkv, hd, P, M, dtype, seed=5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    ids = (torch.randperm(S * M, generator=gen, device=cuda) + 1).to(torch.int32)
    table = ids.view(S, M).clone()
    for s in range(S):
        table[s, int(lens[s]) // P + 1:] = 0
    table = table.contiguous()
    nan = float("nan")

    def kernel(Kx, Vx):
        out = tds.paged_decode_attention(q, Kx, Vx, table, lens)
        torch.cuda.synchronize()
        return out

    def twin(Kx, Vx):
        return tds.paged_decode_attention_plain(q, Kx, Vx, table, lens)

    atol, rtol = TWIN_TOL[dtype]
    mine = table[1][table[1] > 0].long()
    Kp, Vp = K.clone(), V.clone()
    Kp[mine], Vp[mine] = nan, nan
    out, ref = kernel(Kp, Vp), twin(Kp, Vp)
    want = [s != 1 for s in range(S)]
    assert _finite_rows(out) == _finite_rows(ref) == want
    keep = torch.tensor([s for s in range(S) if s != 1], device=cuda)
    torch.testing.assert_close(out[keep].float(), ref[keep].float(), atol=atol, rtol=rtol)
    Kt, Vt = K.clone(), V.clone()
    Kt[0], Vt[0] = nan, nan                              # the trash page
    for s in range(S):
        t = int(lens[s])
        col, off = t // P, t % P
        page = int(table[s, col])
        Kt[page, :, off + 1:], Vt[page, :, off + 1:] = nan, nan
    out = kernel(Kt, Vt)
    assert _finite_rows(out) == [True] * S
    torch.testing.assert_close(out.float(), twin(K, V).float(), atol=atol, rtol=rtol)
    Vc = V.clone()
    Vc[int(table[2, 0]), :, 0] = nan                     # row 2's position 0
    assert _finite_rows(kernel(K, Vc))[2] is False


@pytest.mark.parametrize("paged", [False, True])
def test_poisoned_request_fails_alone_on_the_card(cuda, paged):
    """The engine on the card with a ``poison_nan`` hook: the poisoned
    request fails on non-finite logits, its co-residents' tokens equal a
    fault-free run's, the slot's next occupant is served, and every decode
    tick launched B5 (contiguous) or B7 (paged) once per layer."""
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        KVCachePolicy,
    )
    from building_llm_from_scratch_tpu_torch.serving.supervisor import (
        FaultHooks,
    )

    class Poison(FaultHooks):
        def poison_nan(self, req):
            return int(req.prompt_ids[0]) == 7

    cfg = _paged_cfg()
    model = build_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(10, 512, n).tolist(),
             SamplingParams(max_new_tokens=m, seed=i, ignore_eos=True))
            for i, (n, m) in enumerate([(20, 16), (33, 12), (9, 20)])]
    pol = KVCachePolicy(paged=True, page_tokens=16, prefill_chunk=16) if paged \
        else None

    def run(hooks=None, poison=False):
        eng = DecodeEngine(model, n_slots=3, max_len=128, kv_policy=pol,
                           hooks=hooks)
        tds.fused_decode_step.launches = tds.paged_decode_attention.launches = 0
        hs = [eng.submit(*reqs[0])]
        eng.step()
        bad = eng.submit([7, 8, 9], SamplingParams(max_new_tokens=8,
                                                   ignore_eos=True)) if poison else None
        hs += [eng.submit(*r) for r in reqs[1:]]
        eng.run_until_idle()
        again = eng.submit(*reqs[2])
        eng.run_until_idle()
        torch.cuda.synchronize()
        kernel = tds.paged_decode_attention if paged else tds.fused_decode_step
        assert kernel.launches == cfg.n_layers * eng.n_ticks > 0
        return [h.output_ids for h in hs], bad, again

    clean, _, _ = run()
    toks, bad, again = run(Poison(), poison=True)
    assert bad.finish_reason == "error" and "non-finite" in bad.error
    assert toks == clean
    assert again.output_ids == clean[2]


def test_paged_decode_slots_launches_b7_per_layer(cuda):
    """A decode step over a pool on the card launches B7 once per layer and
    B5 never; its fp32 logits agree with the CPU twin's on the same state
    (1e-3 absolute, phase 4's fp32 reference bound)."""
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        Transformer,
        init_slot_cache,
        paged_decode_slots,
    )
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        KVCachePolicy,
    )

    cfg = _paged_cfg(n_layers=3)
    model = build_model(cfg, seed=0, device=cuda)
    cpu = Transformer(cfg, {k: v.cpu() for k, v in model.flat_params().items()})
    pol = KVCachePolicy(paged=True, page_tokens=8, prefill_chunk=16)
    cache = init_slot_cache(cfg, 3, 64, cuda, policy=pol)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for bufs in cache.values():
        for b in bufs:
            b.normal_(generator=gen)
    cpu_cache = {k: [b.cpu() for b in v] for k, v in cache.items()}
    table = torch.tensor([[3, 4, 0, 0, 0, 0, 0, 0], [3, 5, 6, 0, 0, 0, 0, 0],
                          [0] * 8], dtype=torch.int32, device=cuda)
    lens = torch.tensor([12, 20, 0], dtype=torch.int32, device=cuda)
    toks = torch.tensor([[7], [9], [0]], device=cuda)
    b5, b7 = tds.fused_decode_step.launches, tds.paged_decode_attention.launches
    got = paged_decode_slots(model, toks, lens, table, cache, 64)
    torch.cuda.synchronize()
    assert tds.paged_decode_attention.launches == b7 + cfg.n_layers
    assert tds.fused_decode_step.launches == b5
    ref = paged_decode_slots(cpu, toks.cpu(), lens.cpu(), table.cpu(),
                             cpu_cache, 64)
    torch.testing.assert_close(got.cpu()[:2], ref[:2], atol=1e-3, rtol=1e-4)


def test_paged_engine_on_the_card(cuda):
    """Paged prefix-sharing serving on the card (fp32): B7 launches = layers
    x decode ticks and B5 none, prefix hits are page-table writes (no pane
    copy), greedy tokens equal the contiguous chunked engine's and a
    request's alone, and the idle pool holds only the store's pages."""
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        KVCachePolicy,
    )

    cfg = _paged_cfg()
    model = build_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 512, 40).tolist()
    reqs = [(prefix + rng.integers(0, 512, n).tolist(),
             SamplingParams(max_new_tokens=m, temperature=0.7 if i % 3 == 2 else 0.0,
                            top_k=8, seed=i, ignore_eos=True))
            for i, (n, m) in enumerate([(3, 9), (30, 12), (11, 7), (50, 20),
                                        (1, 5)])]
    paged = KVCachePolicy(paged=True, page_tokens=8, prefill_chunk=16,
                          prefix_cache=True)
    contiguous = KVCachePolicy(prefill_chunk=16, prefix_cache=True)
    outs = {}
    for name, pol in (("paged", paged), ("contiguous", contiguous)):
        eng = DecodeEngine(model, n_slots=3, max_len=128, kv_policy=pol)
        tds.fused_decode_step.launches = tds.paged_decode_attention.launches = 0
        handles = [eng.submit(p, sp) for p, sp in reqs]
        eng.run_until_idle()
        torch.cuda.synchronize()
        st = eng.stats()
        kernel = (tds.paged_decode_attention if name == "paged"
                  else tds.fused_decode_step)
        other = (tds.fused_decode_step if name == "paged"
                 else tds.paged_decode_attention)
        assert kernel.launches == cfg.n_layers * eng.n_ticks > 0
        assert other.launches == 0
        assert st["prefix_store"]["hits"] >= 2      # requests 3 and 4
        outs[name] = [h.output_ids for h in handles]
        assert [len(o) for o in outs[name]] == [9, 12, 7, 20, 5]
        if name == "paged":
            assert st["pane_copies"] == 0
            stored = {p for e in eng.prefix_store._entries.values()
                      for p in e.pages}
            assert st["page_pool"]["used"] == len(stored) > 0
            assert st["page_pool"]["reserved"] == 0
            solo = DecodeEngine(model, n_slots=3, max_len=128, kv_policy=pol)
            h = solo.submit(*reqs[1])
            solo.run_until_idle()
            assert h.output_ids == handles[1].output_ids
    greedy = [i for i, (_, sp) in enumerate(reqs) if sp.temperature == 0]
    assert [outs["paged"][i] for i in greedy] == [outs["contiguous"][i] for i in greedy]


def test_paged_engine_refuses_head_dims_b7_cannot_take(cuda):
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        KVCachePolicy,
    )

    model = build_model(_paged_cfg(emb_dim=64), seed=0, device=cuda)  # hd 16
    with pytest.raises(ValueError, match="CUDA paged decode-attention kernel"):
        DecodeEngine(model, n_slots=2, kv_policy=KVCachePolicy(
            paged=True, page_tokens=8, prefill_chunk=16))


# Flash-attention kernels (B1 forward, B2a dq, B2b dk/dv summed over each kv
# head's query heads) against their twins (B2b's: the per-query-head twin
# followed by group_sum). Errors are measured as max |kernel - ref| /
# max |ref| per tensor (lse: absolute). fp32: the same arithmetic in
# another order (tiled online softmax vs one pass), 1e-5 for out and lse
# and 5e-5 for the gradients (sums over up to 2048 terms). bf16 and fp16:
# the kernel rounds the exp terms with the running max and the twin with
# the final one, and both round P and dS to the 16-bit type before their
# products, so 2e-2, the twin tolerance of the decode kernel; the same
# bound holds against the exact result (the twin in fp32 on the same
# inputs).
FLASH_TOL = {torch.float32: (1e-5, 5e-5), torch.float16: (2e-2, 2e-2),
             torch.bfloat16: (2e-2, 2e-2)}


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def flash_inputs(dev, B, T, Hq, Hkv, hd, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
    return (rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd),
            rnd(B, T, Hq, hd))


def grouped_dkv_plain(q, k, v, do, lse, delta, rate=0.0, seed=0, **kw):
    """B2b's twin: the per-query-head twin, then the group sum (``kw``:
    the twin's ``h0``)."""
    dk, dv = tfa.fused_attention_dkv_plain(q, k, v, do, lse, delta, rate, seed, **kw)
    return tfa.group_sum(dk, k.shape[2]), tfa.group_sum(dv, k.shape[2])


PLAIN = (tfa.fused_attention_fwd_plain, tfa.fused_attention_dq_plain,
         grouped_dkv_plain)


def flash_all(q, k, v, do, fwd, dq, dkv, rate=0.0, seed=0):
    out, lse = fwd(q, k, v, rate, seed)
    delta = tfa.attention_delta(out, do)
    return (out, lse, dq(q, k, v, do, lse, delta, rate, seed)) + tuple(
        dkv(q, k, v, do, lse, delta, rate, seed))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("B,T", [(2, 256), (1, 1024), (1, 2048)])
def test_flash_kernels_match_twin(cuda, B, T, hd, dtype, G, rate):
    """B1, B2a and B2b against their twins and the exact (fp32) result, at
    GQA group sizes 1 and 4, with and without attention dropout; B2b's
    output is (B, T, Hkv, D)."""
    Hq = 4
    Hkv = Hq // G
    seed = 424242 + T
    q, k, v, do = flash_inputs(cuda, B, T, Hq, Hkv, hd, dtype)
    n0 = (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
          tfa.flash_attention_dkv.launches)
    got = flash_all(q, k, v, do, tfa.flash_attention_fwd,
                    tfa.flash_attention_dq, tfa.flash_attention_dkv, rate, seed)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == tuple(n + 1 for n in n0)
    twin = flash_all(q, k, v, do, *PLAIN, rate, seed)
    f32 = [t.float() for t in (q, k, v, do)]
    exact = flash_all(*f32, *PLAIN, rate, seed)
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
    assert got[3].shape == (B, T, Hkv, hd)


def test_flash_autograd_group_sums_gqa(cuda, monkeypatch):
    """The autograd Function's gradients equal the twins' with the G query
    heads of each kv head summed; on the card B2b sums them itself and
    writes (B, T, Hkv, D), so the backward calls no group_sum."""
    q, k, v, do = flash_inputs(cuda, 1, 256, 8, 2, 64, torch.bfloat16, seed=1)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))

    def no_group_sum(*args):
        raise AssertionError("group_sum on the CUDA autograd path")

    monkeypatch.setattr(tfa, "group_sum", no_group_sum)
    n0 = tfa.flash_attention_dkv.launches
    out = tfa.fused_causal_attention(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    assert tfa.flash_attention_dkv.launches == n0 + 1
    monkeypatch.undo()
    ref = flash_all(q.detach(), k.detach(), v.detach(), do, *PLAIN)
    assert _rel(out, ref[0]) <= 2e-2
    assert _rel(q.grad, ref[2]) <= 2e-2
    assert k.grad.shape == k.shape and v.grad.shape == v.shape
    assert _rel(k.grad, ref[3]) <= 2e-2
    assert _rel(v.grad, ref[4]) <= 2e-2


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,hd", [(2, 256, 4, 4, 64), (1, 512, 8, 2, 64),
                                           (1, 256, 4, 2, 128), (1, 1024, 8, 2, 128)])
def test_flash_dropout_kernels_match_twin_and_oracle(cuda, dtype, B, T, Hq, Hkv, hd):
    """With p = 0.1 the kernels draw the twins' mask: out, lse, dq, dk, dv
    within FLASH_TOL of the twin and of the fp32 same-mask oracle (whose
    dk/dv autograd sums over the query heads of each kv head, as B2b does;
    G 4 in two cases); the twin with the next seed fails the bound."""
    rate, seed = 0.1, 987654321987
    q, k, v, do = flash_inputs(cuda, B, T, Hq, Hkv, hd, dtype, seed=2)
    got = flash_all(q, k, v, do, tfa.flash_attention_fwd, tfa.flash_attention_dq,
                    tfa.flash_attention_dkv, rate, seed)
    torch.cuda.synchronize()
    twin = flash_all(q, k, v, do, *PLAIN, rate, seed)
    mask = tfa.keep_mask(seed, B, Hq, T, rate, cuda)
    oracle = _oracle(q, k, v, do, mask, rate)
    tol_out, tol_grad = FLASH_TOL[dtype]
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        a, b = got[i], twin[i]
        assert torch.isfinite(a).all(), name
        assert a.shape == b.shape == oracle[i].shape, name
        tol = tol_out if name in ("out", "lse") else tol_grad
        if name == "lse":
            assert (a - b).abs().max().item() <= tol
            assert (a - oracle[i]).abs().max().item() <= tol
        else:
            assert _rel(a, b) <= tol, (name, _rel(a, b))
            assert _rel(a, oracle[i]) <= tol, (name, _rel(a, oracle[i]))
    control = flash_all(q, k, v, do, *PLAIN, rate, seed + 1)
    for i, name in ((0, "out"), (2, "dq"), (3, "dk"), (4, "dv")):
        assert _rel(control[i], twin[i]) > FLASH_TOL[dtype][i > 0], name


def _device_kernels(fn):
    """The names of the CUDA kernels ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if str(ev.device_type).endswith("CUDA") and ev.device_time_total > 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_flash_routes_by_dtype(cuda, dtype):
    """fp32 launches the 3xTF32 kernels (attn_{fwd,dq,dkv}_f32_sm90.cu) and
    bf16/fp16 the 16-bit Hopper kernels, one kernel per call, as
    ``kernel_source`` names them."""
    from building_llm_from_scratch_tpu_torch.ops._kernels import CSRC

    q, k, v, do = flash_inputs(cuda, 1, 256, 4, 1, 64, dtype)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    delta = tfa.attention_delta(out, do)
    calls = {"fwd": lambda: tfa.flash_attention_fwd(q, k, v),
             "dq": lambda: tfa.flash_attention_dq(q, k, v, do, lse, delta),
             "dkv": lambda: tfa.flash_attention_dkv(q, k, v, do, lse, delta)}
    for kname, fn in calls.items():
        src = tfa.kernel_source(dtype, kname)
        assert src == (f"attn_{kname}_f32_sm90.cu" if dtype == torch.float32
                       else f"attn_{kname}_sm90.cu")
        kernel = src.replace("_sm90.cu", "_kernel") if dtype == torch.float32 \
            else src.replace(".cu", "_kernel")
        assert f"{kernel}(" in (CSRC / src).read_text()
        names = _device_kernels(fn)
        assert len(names) == 1 and kernel in names[0], (kname, names)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fp32_dkv_sums_gqa_in_one_launch_without_workspace(cuda, rate):
    """fp32 B2b with GQA (G 4): one kernel launch, and the call allocates
    dk and dv and nothing else (the per-head workspace and the group-sum
    kernel are gone)."""
    q, k, v, do = flash_inputs(cuda, 2, 1024, 8, 2, 64, torch.float32, seed=6)
    out, lse = tfa.flash_attention_fwd(q, k, v, rate, 11)
    delta = tfa.attention_delta(out, do)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n0 = tfa.flash_attention_dkv.launches
    dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, rate, 11)
    torch.cuda.synchronize()
    assert tfa.flash_attention_dkv.launches == n0 + 1
    assert torch.cuda.max_memory_allocated() - base == dk.numel() * 4 + dv.numel() * 4
    assert dk.shape == k.shape and dv.shape == v.shape
    names = _device_kernels(lambda: tfa.flash_attention_dkv(q, k, v, do, lse, delta, rate, 11))
    assert len(names) == 1 and "attn_dkv_f32_kernel" in names[0], names


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hd,G", [(64, 1), (64, 4), (128, 4)])
def test_fp32_flash_kernels_are_bit_equal_over_two_calls(cuda, rate, hd, G):
    """fp32 B1, B2a and B2b give the same bits on two calls (no atomics;
    B2b sums the G heads in a fixed order), with and without dropout."""
    q, k, v, do = flash_inputs(cuda, 1, 1024, 4, 4 // G, hd, torch.float32, seed=7)
    kern = (tfa.flash_attention_fwd, tfa.flash_attention_dq, tfa.flash_attention_dkv)
    first = flash_all(q, k, v, do, *kern, rate, 99)
    second = flash_all(q, k, v, do, *kern, rate, 99)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4,), (12,), (8 * 1001 + 4,), (4096, 768), (8192, 768)])
def test_dropout_kernel_is_bit_equal_at_every_size(cuda, dtype, shape):
    """B3's three functions equal their twins bit for bit at sizes that end
    in a partial vector (4, 12, 8k + 4 elements: the tail group), a single
    pass, and the training shapes (several passes of the one-wave grid)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    h = torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    seed = 0xD20F0000 + h.numel()
    for a, b in ((tfd.dropout_fwd(None, h, seed, 0.1), tfd.dropout_fwd_plain(None, h, seed, 0.1)),
                 (tfd.dropout_fwd(x, h, seed, 0.1), tfd.dropout_fwd_plain(x, h, seed, 0.1)),
                 (tfd.dropout_bwd(h, seed, 0.1), tfd.dropout_bwd_plain(h, seed, 0.1))):
        torch.cuda.synchronize()
        assert a.dtype == dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_dropout_kernel_refuses_what_it_cannot_take(cuda):
    before = tfd.dropout_fwd.launches
    with pytest.raises(ValueError):                       # not a group of 4
        tfd.dropout_fwd(None, torch.zeros(7, device=cuda), 1, 0.1)
    with pytest.raises(ValueError):                       # not contiguous
        tfd.dropout_fwd(None, torch.zeros(8, 8, device=cuda).t(), 1, 0.1)
    with pytest.raises(TypeError):
        tfd.dropout_fwd(None, torch.zeros(8, dtype=torch.int32, device=cuda), 1, 0.1)
    assert tfd.dropout_fwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("N,D,V", [(8192, 768, 50257), (1024, 768, 50257),
                                   (256, 128, 999), (200, 128, 300)])
def test_xent_kernel_matches_twin(cuda, dtype, N, D, V):
    """B4's (nll, lse) against its twin at the JAX kernel test's bounds (the
    Hopper kernel for bf16/fp16, the fp32 kernel for fp32); the twin over W
    padded with unmasked zero columns fails them."""
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


@pytest.mark.parametrize("N,V", [(8192, 50257), (1024, 50257), (200, 1001)])
def test_fp32_xent_kernel_holds_the_3xtf32_bounds(cuda, N, V):
    """fp32 B4 against its twin (full fp32 products) with W at 0.1 x N(0, 1),
    logits spread as a trained head's: inputs at which one TF32 product
    would fail the bounds (tests/test_torch_b3_b4_sm90.py); 3xTF32 holds
    them."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(N, 768, generator=gen, device=cuda)
    w = 0.1 * torch.randn(768, V, generator=gen, device=cuda)
    t = torch.randint(0, V, (N,), generator=gen, device=cuda)
    nll, lse = txf.xent_fwd(x, w, t)
    torch.cuda.synchronize()
    nll_t, lse_t = txf.xent_fwd_plain(x, w, t)
    torch.testing.assert_close(lse, lse_t, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nll, nll_t, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("N,V", [(8192, 50257), (256, 999)])
def test_fp32_xent_kernel_is_bit_equal_over_two_calls(cuda, N, V):
    """fp32 B4 gives the same bits on two calls (fixed tiles, shares and
    combine order; no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(N, 768, generator=gen, device=cuda)
    w = 0.02 * torch.randn(768, V, generator=gen, device=cuda)
    t = torch.randint(0, V, (N,), generator=gen, device=cuda)
    first, second = txf.xent_fwd(x, w, t), txf.xent_fwd(x, w, t)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_xent_kernel_refuses_what_it_cannot_take(cuda):
    before = txf.xent_fwd.launches
    x = torch.zeros(256, 100, device=cuda)                # D % 32
    with pytest.raises(ValueError):
        txf.xent_fwd(x, torch.zeros(100, 999, device=cuda),
                     torch.zeros(256, dtype=torch.long, device=cuda))
    for dt in (torch.bfloat16, torch.float16):            # 16 bits: D % 64
        with pytest.raises(ValueError):
            txf.xent_fwd(torch.zeros(256, 96, device=cuda, dtype=dt),
                         torch.zeros(96, 999, device=cuda, dtype=dt),
                         torch.zeros(256, dtype=torch.long, device=cuda))
    with pytest.raises(TypeError):
        txf.xent_fwd(torch.zeros(256, 128, device=cuda),
                     torch.zeros(128, 999, device=cuda, dtype=torch.bfloat16),
                     torch.zeros(256, dtype=torch.long, device=cuda))
    assert txf.xent_fwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_xent_routes_by_dtype(cuda, dtype, monkeypatch):
    """bf16 and fp16 launch the Hopper kernel (xent_fwd_sm90.cu) and fp32
    the fp32 Hopper kernel (xent_fwd_f32_sm90.cu), chosen before the launch;
    W's columns reach the 16-bit kernel padded to a multiple of 8, and the
    fp32 one unpadded (it reads W's split transpose)."""
    from building_llm_from_scratch_tpu_torch.ops._kernels import load_library

    lib = load_library()
    calls = []

    def spy(name):
        fn = getattr(lib, name)

        def wrapped(*args):
            calls.append((name, args))
            return fn(*args)
        return wrapped

    for name in ("bllm_xent_fwd_f32_sm90", "bllm_xent_fwd_sm90"):
        monkeypatch.setattr(lib, name, spy(name))
    x = torch.randn(256, 128, device=cuda).to(dtype)
    w = (0.02 * torch.randn(128, 999, device=cuda)).to(dtype)
    txf.xent_fwd(x, w, torch.zeros(256, dtype=torch.long, device=cuda))
    torch.cuda.synchronize()
    want = "bllm_xent_fwd_f32_sm90" if dtype == torch.float32 else "bllm_xent_fwd_sm90"
    assert [c[0] for c in calls] == [want]
    assert txf.kernel_source(dtype) == ("xent_fwd_f32_sm90.cu"
                                        if want == "bllm_xent_fwd_f32_sm90"
                                        else "xent_fwd_sm90.cu")
    if want == "bllm_xent_fwd_sm90":
        assert calls[0][1][3:5] == (999, 1000)          # V, padded V
    else:
        assert calls[0][1][:3] == (256, 128, 999)       # N, D, V: W not padded


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


@pytest.mark.parametrize("dtype,loss_rel,grad_rel", [("fp32", 1e-5, 1e-4),
                                                     ("bf16", 1e-3, 3e-2)])
def test_lora_sft_step_on_the_card_matches_the_cpu(cuda, dtype, loss_rel, grad_rel):
    """One LoRA SFT step (T 256, the prompt-masked loss weights, the
    adapter merged in the step) of a small LLaMA-like model on the card
    against the same step on the CPU: each flash kernel once per layer, the
    loss and every adapter gradient within chip_smoke's REF_BOUNDS, the
    base bit-unchanged. The CPU step with all-ones weights must fail the
    loss bound."""
    from building_llm_from_scratch_tpu_torch.models.lora import (
        flatten_lora,
        init_lora_params,
        unflatten_lora,
    )
    from building_llm_from_scratch_tpu_torch.models.transformer import Transformer
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    cfg = get_config("llama3_2", "1B", dtype=dtype).replace(
        emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=3, hidden_dim=512,
        vocab_size=512, context_length=256)
    model = build_model(cfg, seed=0, device=cuda)
    base = {k: v.clone() for k, v in model.flat_params().items()}
    gen = torch.Generator().manual_seed(1)
    lora = init_lora_params(cfg, gen, 8)
    for path, leaf in flatten_lora(lora).items():
        if path[-1] == "B":                   # B = 0 would leave A no gradient
            leaf.normal_(0.0, 0.02, generator=gen)
    # an instruction batch's layout: a masked prompt, a supervised response
    # and pad targets (id 0) masked past the first
    x = torch.randint(1, 512, (2, 257), generator=gen)
    x[0, 141:] = x[1, 61:] = 0
    weights = torch.zeros(2, 256)
    weights[0, 100:141] = weights[1, 30:61] = 1.0

    def step(m, w):
        tree = unflatten_lora({p: t.to(m.device).clone()
                               for p, t in flatten_lora(lora).items()})
        opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10),
                         grad_clip_norm=float("inf"))
        state = tts.init_train_state(tree, opt, frozen=m)
        batch = {"inputs": x[:, :-1].to(m.device), "targets": x[:, 1:].to(m.device),
                 "weights": w.to(m.device)}
        _, met = tts.make_train_step(cfg, opt, lora_alpha=16.0, lora_rank=8)(state, batch)
        return met["loss"].item(), {k: g.cpu().float() for k, g in state.grads.items()}

    cpu = Transformer(cfg, {k: v.cpu() for k, v in model.flat_params().items()})
    for f in (tfa.flash_attention_fwd, tfa.flash_attention_dq, tfa.flash_attention_dkv):
        f.launches = 0
    card_loss, card_grads = step(model, weights)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == (3, 3, 3)
    cpu_loss, cpu_grads = step(cpu, weights)
    ones_loss, _ = step(cpu, torch.ones(2, 256))
    assert abs(card_loss - cpu_loss) <= loss_rel * abs(cpu_loss)
    assert abs(ones_loss - cpu_loss) > loss_rel * abs(cpu_loss)
    for k, g in cpu_grads.items():
        assert ((card_grads[k] - g).norm() / g.norm()).item() <= grad_rel, k
    for k, v in model.flat_params().items():
        assert torch.equal(v, base[k]), k


# ---------------------------------------------------------------------------
# B6: the BGMV kernel and multi-LoRA serving on the card
# ---------------------------------------------------------------------------

# Bounds of B6, per output element, relative to M = scale * (|x @ A| @ |B|)
# (fp64, the magnitude of the second product's terms): the kernel rounds the
# rank-r intermediate to the pool dtype (half a unit, 2^-9 in bf16) and sums
# in fp32 (sqrt(D) 2^-24, about 5e-6 at D 8192). Against the exact result
# 2^-8 M in bf16, against the twin (which rounds the same intermediate from
# its own fp32 sum, so one unit may differ) 2^-7 M; 1e-4 M in fp32. A row
# with id -1 has M = 0: its output must be exactly 0. The same bounds as
# chip_smoke.py.
BGMV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 2.0 ** -8),
            torch.float16: (2.0 ** -9, 2.0 ** -10)}


def bgmv_inputs(dev, S, N, L, D, r, O, dtype, ids, seed=0):
    """x and a stacked (N, L, D, r) / (N, L, r, O) pool (the registry's
    layout); the layer-1 slices are what decode_slots hands the kernel."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
    x = rnd(S, D)
    A = (rnd(N, L, D, r).float() / D ** 0.5).to(dtype)
    B = rnd(N, L, r, O)
    scales = torch.rand(N, generator=gen, device=dev) + 0.5
    return (x, A[:, 1], B[:, 1], torch.tensor(ids, dtype=torch.int32, device=dev),
            scales)


def bgmv_exact(x, A, B, ids, scales):
    """(fp64 exact result, the magnitude M of the bounds)."""
    idx = ids.long().clamp(0, A.shape[0] - 1)
    xa = torch.bmm(x.double()[:, None], A.double()[idx])
    keep = (ids >= 0).double()[:, None] * scales.double()[idx][:, None]
    return (torch.bmm(xa, B.double()[idx])[:, 0] * keep,
            torch.bmm(xa.abs(), B.double()[idx].abs())[:, 0] * keep)


def within(out, ref, mag, tol) -> bool:
    return bool(((out.double() - ref.double()).abs() <= tol * mag).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,r,O", [(2048, 16, 512), (8192, 16, 2048),
                                   (768, 16, 768), (768, 16, 3072), (3072, 16, 768),
                                   (768, 2, 3072), (96, 256, 200), (64, 7, 33)])
def test_bgmv_kernel_matches_twin(cuda, dtype, D, r, O):
    """B6 against its twin and the exact result, with id -1 rows, repeated
    ids and an id past the pool (clamped); ids permuted must fail."""
    ids = [0, 1, 2, -1, 0, 2, 1, 7]
    x, A, B, ids, sc = bgmv_inputs(cuda, 8, 4, 2, D, r, O, dtype, ids)
    before = tds.lora_bgmv.launches
    out = tds.lora_bgmv(x, A, B, ids, sc)
    torch.cuda.synchronize()
    assert tds.lora_bgmv.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, O)
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    twin = tds.lora_bgmv_plain(x, A, B, ids, sc)
    exact, mag = bgmv_exact(x, A, B, ids, sc)
    t_twin, t_exact = BGMV_TOL[dtype]
    assert within(out, twin, mag, t_twin)
    assert within(out, exact, mag, t_exact)
    perm = ids[[1, 2, 3, 4, 5, 6, 7, 0]]
    assert not within(tds.lora_bgmv_plain(x, A, B, perm, sc), out, mag, t_twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one adapter", "all base", "pool of one"])
def test_bgmv_kernel_groups_at_the_edges(cuda, dtype, case):
    """B6 with every row in one group (one leader computes them all), with
    every row at -1 (exact zeros, no group) and over a pool of one row (ids
    past it clamp to it), against the twin and the exact result."""
    S, D, r, O = 8, 2048, 16, 512
    N, ids = {"one adapter": (4, [2] * S), "all base": (4, [-1] * S),
              "pool of one": (1, [0, -1, 3, 0, 1, -1, 0, 7])}[case]
    x, A, B, ids, sc = bgmv_inputs(cuda, S, N, 2, D, r, O, dtype, ids, seed=2)
    before = tds.lora_bgmv.launches
    out = tds.lora_bgmv(x, A, B, ids, sc)
    torch.cuda.synchronize()
    assert tds.lora_bgmv.launches == before + 1
    twin = tds.lora_bgmv_plain(x, A, B, ids, sc)
    exact, mag = bgmv_exact(x, A, B, ids, sc)
    t_twin, t_exact = BGMV_TOL[dtype]
    assert within(out, twin, mag, t_twin) and within(out, exact, mag, t_exact)
    assert torch.equal(out[ids < 0], torch.zeros_like(out[ids < 0]))
    if case == "all base":
        assert not out.any()


@pytest.mark.parametrize("dtype,D,O", [(torch.bfloat16, 8192, 2048),
                                       (torch.bfloat16, 2048, 8192),
                                       (torch.float32, 3072, 768)])
def test_bgmv_row_is_bit_equal_alone_and_cobatched(cuda, dtype, D, O):
    """B6's plan takes no batch and each row's sums run in one order
    whatever its group: a row's output alone has the bits it has among rows
    that share its adapter, and the same call twice gives the same bits."""
    ids = [0, 1, 2, -1, 0, 2, 1, -1]
    x, A, B, ids, sc = bgmv_inputs(cuda, 8, 4, 2, D, 16, O, dtype, ids, seed=4)
    out = tds.lora_bgmv(x, A, B, ids, sc)
    assert torch.equal(out, tds.lora_bgmv(x, A, B, ids, sc))
    for s in (0, 4, 5):
        alone = tds.lora_bgmv(x[s:s + 1].contiguous(), A, B, ids[s:s + 1].contiguous(), sc)
        assert torch.equal(alone[0], out[s])


def test_bgmv_kernel_rejects_what_it_cannot_take(cuda):
    x, A, B, ids, sc = bgmv_inputs(cuda, 2, 2, 2, 64, 8, 64, torch.float32, [0, 1])
    with pytest.raises(ValueError, match="BGMV kernel"):
        tds.check_lora_kernel_shape(257, torch.bfloat16)
    with pytest.raises(ValueError, match="BGMV kernel"):
        tds.check_lora_kernel_shape(8, torch.float64)
    big = torch.zeros(2, 64, 257, device=cuda)
    before = tds.lora_bgmv.launches
    for args in ((x, big, torch.zeros(2, 257, 64, device=cuda), ids, sc),
                 (x, A, B, ids.long(), sc),                         # id dtype
                 (x.bfloat16(), A, B, ids, sc),                     # dtypes
                 (x, A.transpose(1, 2).contiguous().transpose(1, 2), B, ids, sc),
                 (x, A, B, ids.cpu(), sc)):                         # devices
        with pytest.raises((ValueError, TypeError)):
            tds.lora_bgmv(*args)
    assert tds.lora_bgmv.launches == before
    from building_llm_from_scratch_tpu_torch.serving.adapters import AdapterRegistry

    with pytest.raises(ValueError, match="BGMV kernel"):
        AdapterRegistry(_paged_cfg(), capacity=2, max_rank=300, device=cuda)


def _adapter_files(tmp_path, cfg, ranks):
    """Adapter artifacts of the port's save_adapter: seeded A, and B made
    nonzero (B = 0 at init would make every delta zero)."""
    from building_llm_from_scratch_tpu_torch.models.lora import (
        init_lora_params,
        save_adapter,
    )

    specs = {}
    for i, (name, r) in enumerate(ranks.items()):
        gen = torch.Generator().manual_seed(30 + i)
        lora = init_lora_params(cfg, gen, r)
        for node in (lora["head"]["weight"], *(
                n for g in lora["blocks"].values() for n in g.values())):
            node["B"] = (0.05 * torch.randn(node["B"].shape, generator=gen)
                         ).to(node["B"].dtype)
        specs[name] = str(tmp_path / f"{name}.npz")
        save_adapter(specs[name], lora, rank=r, alpha=2.0 * r, cfg=cfg)
    return specs


def test_decode_slots_launches_b6_per_projection(cuda, tmp_path):
    """A decode tick with an adapter pool on the card launches B6 once per
    adapted projection and layer (7 a layer for a LLaMA-like model) and B5
    once per layer; its fp32 logits agree with the CPU twin's on the same
    state (1e-3, phase 4's fp32 bound), and another adapter's ids fail it."""
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        Transformer,
        decode_slots,
        init_slot_cache,
    )
    from building_llm_from_scratch_tpu_torch.serving.adapters import AdapterRegistry

    cfg = _paged_cfg(n_layers=3)
    specs = _adapter_files(tmp_path, cfg, {"a": 8, "b": 4})
    model = build_model(cfg, seed=0, device=cuda)
    cpu = Transformer(cfg, {k: v.cpu() for k, v in model.flat_params().items()})
    regs = [AdapterRegistry.from_artifacts(cfg, specs, device=d) for d in (cuda, "cpu")]
    cache = init_slot_cache(cfg, 3, 64, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for bufs in cache.values():
        for b in bufs:
            b.normal_(generator=gen)
    cpu_cache = {k: [b.cpu() for b in v] for k, v in cache.items()}
    toks = torch.tensor([[7], [9], [3]])
    lens = torch.tensor([12, 20, 0], dtype=torch.int32)
    ids = torch.tensor([0, -1, 1], dtype=torch.int32)

    def adapter(reg, ids):
        pool, scaling = reg.pool_args()
        return {"pool": pool, "scaling": scaling, "ids": ids.to(reg.device)}

    b5, b6 = tds.fused_decode_step.launches, tds.lora_bgmv.launches
    got = decode_slots(model, toks.to(cuda), lens.to(cuda), cache,
                       adapter=adapter(regs[0], ids))
    torch.cuda.synchronize()
    assert tds.lora_bgmv.launches == b6 + 7 * cfg.n_layers
    assert tds.fused_decode_step.launches == b5 + cfg.n_layers
    ref = decode_slots(cpu, toks, lens, {k: [b.clone() for b in v]
                                         for k, v in cpu_cache.items()},
                       adapter=adapter(regs[1], ids))
    torch.testing.assert_close(got.cpu(), ref, atol=1e-3, rtol=0)
    other = decode_slots(cpu, toks, lens, cpu_cache,
                         adapter=adapter(regs[1], ids[[2, 1, 0]]))
    assert (got.cpu() - other)[[0, 2]].abs().max() > 1e-3


def test_adapter_engine_on_the_card(cuda, tmp_path):
    """Multi-LoRA serving on the card (bf16): B6 launches = 7 x layers x
    ticks, B5 = layers x ticks, the per-adapter counts match the traffic,
    and a greedy adapted request gives the same tokens alone."""
    from building_llm_from_scratch_tpu_torch.serving.adapters import AdapterRegistry

    cfg = _paged_cfg(dtype="bf16")
    specs = _adapter_files(tmp_path, cfg, {"a": 8, "b": 16})
    model = build_model(cfg, seed=0, device=cuda)
    reg = AdapterRegistry.from_artifacts(cfg, specs, device=cuda)
    rng = np.random.default_rng(2)
    names = ["a", None, "b", "a", "b"]
    reqs = [(rng.integers(0, 512, 5 + 7 * i).tolist(),
             SamplingParams(max_new_tokens=6 + i, seed=i, ignore_eos=True,
                            adapter=nm)) for i, nm in enumerate(names)]
    eng = DecodeEngine(model, n_slots=3, max_len=128, adapters=reg)
    tds.fused_decode_step.launches = tds.lora_bgmv.launches = 0
    handles = [eng.submit(p, sp) for p, sp in reqs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    assert tds.lora_bgmv.launches == 7 * cfg.n_layers * eng.n_ticks > 0
    assert tds.fused_decode_step.launches == cfg.n_layers * eng.n_ticks
    st = eng.stats()
    assert {k: v["finished"] for k, v in st["per_adapter"].items()} == \
        {"a": 2, "b": 2, "base": 1}
    assert [len(h.output_ids) for h in handles] == [6, 7, 8, 9, 10]
    solo = DecodeEngine(model, n_slots=3, max_len=128, adapters=reg)
    h = solo.submit(*reqs[2])
    solo.run_until_idle()
    assert h.output_ids == handles[2].output_ids


# ---------------------------------------------------------------------------
# pretrained weights and train-state checkpoints on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name,naming", [("GPT2", "gpt2"),
                                               ("llama3_2", "hf"),
                                               ("llama2", "meta")])
def test_loaded_leaves_land_on_the_card_bit_equal(cuda, tmp_path, model_name,
                                                  naming):
    """A checkpoint file of each naming (written by chip_smoke's writer from
    a CPU model) read by ``load_hf_weights(device="cuda")``: every leaf on
    the card, in the model dtype, bit-equal to the CPU model's."""
    import chip_smoke
    from building_llm_from_scratch_tpu_torch.weights import load_hf_weights

    size = {"GPT2": "124M", "llama3_2": "1B", "llama2": "7B"}[model_name]
    cfg = get_config(model_name, size, dtype="bf16" if naming != "gpt2" else "fp32",
                     qkv_bias=True if naming == "gpt2" else None, debug=True)
    model = build_model(cfg, 3, "cpu")
    if naming != "meta":                   # the head ships tied to the embedding
        model.stacked["head/weight"].copy_(model.stacked["tok_emb/weight"].t())
    chip_smoke.write_checkpoint(torch, model, naming, str(tmp_path))
    flat = load_hf_weights(model_name, size, cfg, weights_dir=str(tmp_path),
                           device="cuda")
    assert set(flat) == set(model.stacked)
    for k, v in model.stacked.items():
        assert flat[k].device.type == "cuda" and flat[k].dtype == v.dtype, k
        ints = {2: torch.int16, 4: torch.int32}[v.element_size()]
        assert torch.equal(flat[k].cpu().view(ints), v.view(ints)), k


def test_checkpoint_round_trip_on_the_card_refills_the_views(cuda, tmp_path):
    """A train state on the card after one step, saved and restored into a
    state of other weights: every stacked leaf, moment and count comes back
    bit-equal, in place (the same storage), so each layer's parameter view
    and attached gradient slice sees the restored values."""
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )

    cfg = get_config("llama3_2", "1B", dtype="bf16", debug=True)

    def state_of(seed):
        opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
        model = build_model(cfg, seed, "cuda")
        return tts.init_train_state(model, opt, seed=5), opt

    src, opt = state_of(0)
    x = torch.randint(0, cfg.vocab_size, (2, cfg.context_length + 1), device="cuda")
    src, _ = tts.make_train_step(cfg, opt)(src, {"inputs": x[:, :-1],
                                                 "targets": x[:, 1:]})
    save_checkpoint(str(tmp_path / "ck"), tts.checkpoint_tree(src))
    dst, _ = state_of(1)
    ptrs = {k: v.data_ptr() for k, v in dst.params.items()}
    tts.restore_train_state(dst, str(tmp_path / "ck"))
    assert dst.step == 1 and dst.opt_state.count == 1
    for k, v in src.params.items():
        assert dst.params[k].data_ptr() == ptrs[k], k
        for a, b in ((dst.params[k], v), (dst.opt_state.mu[k], src.opt_state.mu[k]),
                     (dst.opt_state.nu[k], src.opt_state.nu[k])):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k
    for name, l, p in dst.model.leaves():
        if l is not None:
            assert p.data_ptr() == dst.params[name][l].data_ptr(), name
            assert torch.equal(p.detach(), src.params[name][l].detach()), name
            assert p.grad.data_ptr() == dst.grads[name][l].data_ptr(), name


# ---------------------------------------------------------------------------
# fp16 on the training path, the copy stream, remat and the pinned snapshot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fp16_flash_kernels_at_gpt2_training_shape(cuda, rate):
    """B1, B2a and B2b in fp16 at GPT-2-124M's training shape (B 8, H 12,
    T 1024, hd 64), the shape the fp16 policy trains at, against their
    twins and the exact result at FLASH_TOL."""
    B, T, H, hd = 8, 1024, 12, 64
    q, k, v, do = flash_inputs(cuda, B, T, H, H, hd, torch.float16, seed=7)
    got = flash_all(q, k, v, do, tfa.flash_attention_fwd, tfa.flash_attention_dq,
                    tfa.flash_attention_dkv, rate, 99)
    torch.cuda.synchronize()
    twin = flash_all(q, k, v, do, *PLAIN, rate, 99)
    tol_out, tol_grad = FLASH_TOL[torch.float16]
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, twin):
        assert torch.isfinite(a).all(), name
        if name == "lse":
            assert (a - b).abs().max().item() <= tol_out, name
        else:
            tol = tol_out if name == "out" else tol_grad
            assert _rel(a, b) <= tol, (name, _rel(a, b))


def test_staged_batch_waits_for_its_copy(cuda):
    """``DeviceStager`` copies on its own stream and ``Staged.ready()``
    orders the consumer's stream after the copy. With the copy stream held
    back by a long sleep, a sum launched right after ``ready()`` sees the
    whole batch (without the wait it would read memory the copy has not
    written); the same read without the wait sees something else."""
    from building_llm_from_scratch_tpu_torch.data.prefetch import DeviceStager

    stager = DeviceStager(cuda)
    rng = np.random.default_rng(0)
    for wait in (True, False):
        host = rng.integers(1, 1000, (64, 16384))
        with torch.cuda.stream(stager.stream):
            torch.cuda._sleep(300_000_000)
        staged = stager.stage({"inputs": host}, {"inputs": np.int64})
        t = staged.ready()["inputs"] if wait else staged.tensors["inputs"]
        got = t.sum().item()
        torch.cuda.synchronize()
        assert (got == int(host.sum())) == wait, (wait, got, int(host.sum()))


def test_fp16_policy_remat_and_accumulation_on_the_card(cuda):
    """GPT-2 cut to 2 layers at T 256 (the flash and dropout kernels) under
    the fp16 policy with remat and two microbatches: B1 runs twice per
    layer and microbatch (the recompute), B2 once; the masters stay fp32.
    The accumulating step scales the microbatches' nll sums, not a mean
    (as the JAX step does), so at 2^15 its fp16 gradients overflow: each
    such step is skipped and halves the scale, the parameters unmoved,
    until a scale fits and the update lands with a finite loss."""
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts
    from building_llm_from_scratch_tpu_torch.training.precision import get_policy

    cfg = get_config("GPT2", "124M").replace(n_layers=2, context_length=256,
                                             use_actv_ckpt=True)
    policy = get_policy("fp16")
    model = build_model(cfg, 0, "cuda")
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(model, opt, seed=1, policy=policy)
    step = tts.make_train_step(cfg, opt, policy=policy, grad_accum=2)
    x = torch.randint(0, cfg.vocab_size, (2, 257), device=cuda)
    batch = {"inputs": x[:, :-1], "targets": x[:, 1:]}
    scale, before = 2.0 ** 15, model.stacked["blocks/attn/wq"].clone()
    for i in range(20):
        n0 = (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches)
        state, m = step(state, batch)
        torch.cuda.synchronize()
        assert (tfa.flash_attention_fwd.launches - n0[0],
                tfa.flash_attention_dq.launches - n0[1]) == (2 * 2 * 2, 2 * 2)
        if not m["skipped"]:
            break
        scale /= 2
        assert m["loss_scale"] == scale and state.opt_state.count == 0
        assert torch.equal(model.stacked["blocks/attn/wq"], before)
    assert not m["skipped"] and m["loss_scale"] == scale
    assert np.isfinite(m["loss"].item()) and state.opt_state.count == 1
    assert state.step == i + 1
    assert {v.dtype for v in state.params.values()} == {torch.float32}


def test_async_snapshot_is_ordered_before_the_next_update(cuda, tmp_path):
    """A train state on the card saved asynchronously, then updated in
    place at once (the next step's optimizer): the checkpoint holds the
    state of the save, byte for byte the synchronous save's files."""
    import os

    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts
    from building_llm_from_scratch_tpu_torch.training.async_checkpoint import (
        AsyncCheckpointer,
    )
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )

    cfg = get_config("GPT2", "124M").replace(n_layers=2)
    model = build_model(cfg, 0, "cuda")
    state = tts.init_train_state(model, topt.AdamW(lambda c: 1e-4), seed=1)
    save_checkpoint(str(tmp_path / "sync"), tts.checkpoint_tree(state))
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "async"), tts.checkpoint_tree(state))
    with torch.no_grad():
        for v in state.params.values():
            v.add_(1.0)
    ck.wait()
    for f in sorted(os.listdir(tmp_path / "sync")):
        assert (tmp_path / "sync" / f).read_bytes() == (
            tmp_path / "async" / f).read_bytes(), f


# ---------------------------------------------------------------------------
# sharded training (parallel/): one rank over NCCL, two ranks over gloo
# ---------------------------------------------------------------------------

def _sharded_small(tmp_path, dtype="bf16"):
    """A LLaMA-like model whose attention takes the flash kernels (T 256,
    head dim 64), its export and four global batches of 4 rows."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.training.checkpoint import export_params

    cfg = dataclasses.replace(get_config("llama3_2", "1B", dtype=dtype),
                              emb_dim=256, n_heads=4, n_kv_groups=2,
                              n_layers=2, hidden_dim=512, vocab_size=512,
                              context_length=256)
    export = str(tmp_path / "init.npz")
    export_params(export, build_model(cfg, 0, "cpu"))
    rng = np.random.default_rng(1)
    x = rng.integers(0, cfg.vocab_size, (4, 4, cfg.context_length + 1))
    bpath = str(tmp_path / "batches.npz")
    np.savez(bpath, inputs=x[..., :-1], targets=x[..., 1:])
    return cfg, export, bpath


def test_world_one_nccl_step_is_the_single_device_step(cuda, tmp_path):
    """dp, fsdp and zero1 over a one-rank NCCL group on the card: the
    single-device step's losses and parameters bit for bit, the flash
    kernels launched as many times, the gradient all-reduces counted."""
    from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
    from building_llm_from_scratch_tpu_torch.parallel import mesh
    from building_llm_from_scratch_tpu_torch.parallel.sharding import build_mesh_plan
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_exported_params,
    )

    cfg, export, bpath = _sharded_small(tmp_path)
    data = np.load(bpath)

    def run(mode):
        model = load_exported_params(export, cfg, cuda)
        opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
        plan = None if mode is None else build_mesh_plan(mode)
        state = tts.init_train_state(model, opt, plan=plan)
        step = (tts.make_train_step(cfg, opt) if plan is None
                else tts.make_sharded_train_step(cfg, opt, plan))
        before = tfa.flash_attention_fwd.launches
        losses = []
        for i in range(3):
            batch = {"inputs": torch.from_numpy(data["inputs"][i]).to(cuda),
                     "targets": torch.from_numpy(data["targets"][i]).to(cuda)}
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        tts.gather_params(state)
        return (losses, {k: v.detach().clone() for k, v in state.full.items()},
                tfa.flash_attention_fwd.launches - before)

    ref = run(None)
    mesh.initialize_distributed(init_method=f"file://{tmp_path}/rendezvous",
                                rank=0, world_size=1, device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        for mode in ("dp", "fsdp", "zero1"):
            coll.reset_counters()
            losses, params, launches = run(mode)
            assert losses == ref[0] and launches == ref[2] == 3 * cfg.n_layers
            for k, v in ref[1].items():
                assert torch.equal(params[k], v), (mode, k)
            assert coll.counters()["all_reduce/bf16"]["calls"] == 3 * len(ref[1])
    finally:
        mesh.shutdown_distributed()


def test_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on the one card over gloo (staged through the host):
    zero1 bit-equal to dp, fsdp within 1e-5 of dp (each leaf's relative
    L2), the moments halved per rank, fsdp's sharded working copy freed
    between steps."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_dist_worker import launch

    cfg, export, bpath = _sharded_small(tmp_path, dtype="fp32")
    import dataclasses

    spec = dict(scenario="steps", cfg=dataclasses.asdict(cfg), params=export,
                batches=bpath, sched=[5e-4, 1e-5, 1e-6, 2, 10], seed=0, steps=2,
                device="cuda:0",
                runs=[[m, m, None] for m in ("dp", "zero1", "fsdp")])
    out = tmp_path / "out"
    out.mkdir()
    res = launch(spec, 2, str(out), timeout=300)
    for r in res:
        for k, v in r["dp"]["whole"].items():
            np.testing.assert_array_equal(r["zero1"]["whole"][k], v, err_msg=k)
            rel = np.linalg.norm(r["fsdp"]["whole"][k] - v) / max(np.linalg.norm(v), 1e-30)
            assert rel <= 1e-5, (k, rel)
        for mode in ("zero1", "fsdp"):
            assert r[mode]["moment_bytes"] * 2 == pytest.approx(
                r["dp"]["moment_bytes"], rel=0.01)
        # fsdp's working copy and gradients of its sharded leaves are freed
        assert r["fsdp"]["sharded"] and r["fsdp"]["freed"] == r["fsdp"]["sharded"]


# ---------------------------------------------------------------------------
# tensor and sequence parallelism's kernels, selective remat on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Hq,Hkv,dtype,h0", [(1, 16, 4, torch.bfloat16, 16),
                                               (2, 6, 6, torch.float32, 6)])
def test_flash_kernels_at_a_tp_ranks_heads(cuda, rate, B, Hq, Hkv, dtype, h0):
    """B1/B2 at a tensor-parallel rank's heads (LLaMA-3.2-1B at tp 2: Hq
    16, Hkv 4; GPT-2-124M: H 6) with rank 1's head offset: within
    FLASH_TOL of the twins at that offset, whose mask is heads h0.. of the
    whole model's; with dropout the twin at offset 0 fails the bound."""
    import functools

    seed, T, hd = 424242, 1024, 64
    q, k, v, do = flash_inputs(cuda, B, T, Hq, Hkv, hd, dtype, seed=5)
    at = lambda fn: functools.partial(fn, h0=h0)  # noqa: E731
    got = flash_all(q, k, v, do, at(tfa.flash_attention_fwd), at(tfa.flash_attention_dq),
                    at(tfa.flash_attention_dkv), rate, seed)
    torch.cuda.synchronize()
    twin = flash_all(q, k, v, do, *(at(f) for f in PLAIN), rate, seed)
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        tol = FLASH_TOL[dtype][0 if name in ("out", "lse") else 1]
        err = ((got[i] - twin[i]).abs().max().item() if name == "lse"
               else _rel(got[i], twin[i]))
        assert err <= tol, (name, err)
    whole = tfa.keep_mask(seed, B, h0 + Hq, T, 0.1, cuda)
    assert torch.equal(tfa.keep_mask(seed, B, Hq, T, 0.1, cuda, h0), whole[:, h0:])
    if rate:
        control = flash_all(q, k, v, do, *PLAIN, rate, seed)
        assert _rel(control[0], twin[0]) > FLASH_TOL[dtype][0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_on_a_sequence_block(cuda, dtype):
    """B3 on a sequence-parallel rank's (B, T / 2, D) block with its
    layout: forward (with the add) and backward bit-equal to the twins,
    and the forward the whole tensor's, sliced."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, T, D, seed = 3, 512, 768, 77
    x = torch.randn(B, T, D, generator=gen, device=cuda).to(dtype)
    h = torch.randn(B, T, D, generator=gen, device=cuda).to(dtype)
    whole = tfd.dropout_fwd_plain(x, h, seed, 0.1)
    row = T // 2 * D
    for s in range(2):
        blk = slice(s * T // 2, (s + 1) * T // 2)
        xs, hs = x[:, blk].contiguous(), h[:, blk].contiguous()
        layout = (row // 4, 2 * row // 4, s * row // 4)
        fwd = tfd.dropout_fwd(xs, hs, seed, 0.1, layout)
        bwd = tfd.dropout_bwd(hs, seed, 0.1, layout)
        torch.cuda.synchronize()
        assert torch.equal(fwd, tfd.dropout_fwd_plain(xs, hs, seed, 0.1, layout))
        assert torch.equal(bwd, tfd.dropout_bwd_plain(hs, seed, 0.1, layout))
        assert torch.equal(fwd, whole[:, blk])


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ring_hop_math_on_the_card(cuda, rate):
    """The ring's forward and backward on one seq rank (one hop: the causal
    diagonal) on CUDA tensors equal the port's one-rank attention (fp32
    scores, the same dropout mask) and its autograd gradients."""
    from building_llm_from_scratch_tpu_torch.ops.attention import xla_attention
    from building_llm_from_scratch_tpu_torch.ops.ring_attention import (
        ring_attention_bwd,
        ring_attention_fwd,
    )

    q, k, v, do = flash_inputs(cuda, 2, 256, 8, 2, 64, torch.float32, seed=6)
    kw = dict(n=1, rank=0, rate=rate, seed=99)
    out, lse = ring_attention_fwd(q, k, v, **kw)
    dq, dk, dv = ring_attention_bwd(q, k, v, out, lse, do, **kw)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = xla_attention(qr, kr, vr, dropout_rate=rate, seed=99, deterministic=False)
    ref.backward(do)
    assert _rel(out, ref) <= 1e-5
    for a, b in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        assert _rel(a, b) <= 1e-4


def test_selective_remat_is_bit_equal_on_the_card(cuda, monkeypatch):
    """A 2-layer LLaMA bf16 and a 2-layer GPT-2 fp32 with dropout 0.1 at
    T 1024 (the kernels): the loss and every gradient of selective remat
    equal those of save-all and of full remat bit for bit, and B1 runs
    once a layer without full remat, twice with it."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.models import transformer as tfm
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    for model, size, dtype, drop in (("llama3_2", "1B", "bf16", 0.0),
                                     ("GPT2", "124M", "fp32", 0.1)):
        cfg = dataclasses.replace(get_config(model, size, dtype=dtype), n_layers=2,
                                  drop_rate=drop)
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, cfg.context_length + 1))).to(cuda)
        out = {}
        for mode in ("none", "selective", "full"):
            monkeypatch.setattr(tfm, "_SAVE_ALL", mode == "none")
            c = dataclasses.replace(cfg, use_actv_ckpt=mode == "full")
            m = tfm.build_model(c, 1, cuda)
            opt = topt.AdamW(lambda count: 0.0)
            state = tts.init_train_state(m, opt, seed=3)
            n0 = tfa.flash_attention_fwd.launches
            _, met = tts.make_train_step(c, opt)(state, {"inputs": x[:, :-1],
                                                         "targets": x[:, 1:]})
            out[mode] = (met["loss"].item(), {k: g.clone() for k, g in state.grads.items()},
                         tfa.flash_attention_fwd.launches - n0)
        for mode in ("none", "full"):
            assert out[mode][0] == out["selective"][0], (model, mode)
            for k, g in out["selective"][1].items():
                assert torch.equal(out[mode][1][k], g), (model, mode, k)
        assert out["none"][2] == out["selective"][2] == 2
        assert out["full"][2] == 4


# ---------------------------------------------------------------------------
# pipeline parallelism: the kernels at a microbatch's shapes and seeds
# ---------------------------------------------------------------------------

def _pp_seed(site: str, layer: int) -> int:
    """The seed of one dropout site of GPT-2-124M's pipelined step at pp 2
    (6 layers a stage), microbatch 3 of 4, stage 1 (``dropout_sites``)."""
    from building_llm_from_scratch_tpu_torch.parallel.pipeline import dropout_sites
    from building_llm_from_scratch_tpu_torch.utils.seeding import step_seed

    return dropout_sites(step_seed(123, 1), 0, 3, 6, 6)(layer, site)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_kernels_at_a_pp_microbatch(cuda, rate):
    """B1/B2 at GPT-2-124M's pipeline microbatch (a batch of 8 in 4
    microbatches: Bm 2, H 12, T 1024, hd 64, fp32) with a seed folded per
    (step, data, stage, micro, layer): within FLASH_TOL of the twins; the
    kernels launched once each."""
    seed = _pp_seed("attention", 1)
    q, k, v, do = flash_inputs(cuda, 2, 1024, 12, 12, 64, torch.float32, seed=9)
    n0 = (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
          tfa.flash_attention_dkv.launches)
    got = flash_all(q, k, v, do, tfa.flash_attention_fwd, tfa.flash_attention_dq,
                    tfa.flash_attention_dkv, rate, seed)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == tuple(n + 1 for n in n0)
    twin = flash_all(q, k, v, do, *PLAIN, rate, seed)
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        tol = FLASH_TOL[torch.float32][0 if name in ("out", "lse") else 1]
        err = ((got[i] - twin[i]).abs().max().item() if name == "lse"
               else _rel(got[i], twin[i]))
        assert err <= tol, (name, err)


@pytest.mark.parametrize("site,layer", [("embedding", -1), ("residual1", 0),
                                        ("residual2", 5)])
def test_dropout_kernel_at_a_pp_microbatch(cuda, site, layer):
    """B3 at GPT-2-124M's pipeline microbatch (2 x 1024 rows of 768, fp32,
    p 0.1) with the microbatch's folded seeds (the embedding's on stage 0,
    the residuals' on stage 1): forward (alone and with the residual add)
    and backward bit-equal to the twins."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(2, 1024, 768, generator=gen, device=cuda)
    h = torch.randn(2, 1024, 768, generator=gen, device=cuda)
    seed = _pp_seed(site, layer)
    for a in (None, x):
        fwd = tfd.dropout_fwd(a, h, seed, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(fwd, tfd.dropout_fwd_plain(a, h, seed, 0.1))
    bwd = tfd.dropout_bwd(h, seed, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(bwd, tfd.dropout_bwd_plain(h, seed, 0.1))


def test_pp_step_at_one_stage_launches_per_microbatch(cuda):
    """A one-rank pp step (no process group: one stage) of GPT-2-124M cut
    to 2 layers, p 0.1, B 8 in 4 microbatches of T 1024: B1 / B2a / B2b
    once per layer and microbatch, B3 forward and backward (1 + 2 x 2) per
    microbatch; finite loss."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.parallel.pipeline import (
        PipelinePlan,
        make_pp_mesh,
    )
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    cfg = dataclasses.replace(get_config("GPT2", "124M"), n_layers=2, drop_rate=0.1)
    plan = PipelinePlan(mesh=make_pp_mesh(1, world_size=1), n_micro=4)
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(build_model(cfg, 1, cuda), opt, plan=plan)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, cfg.context_length + 1))).to(cuda)
    kernels = (tfa.flash_attention_fwd, tfa.flash_attention_dq, tfa.flash_attention_dkv,
               tfd.dropout_fwd, tfd.dropout_bwd)
    n0 = [f.launches for f in kernels]
    _, m = tts.make_pp_train_step(cfg, opt, plan)(state, {"inputs": x[:, :-1],
                                                          "targets": x[:, 1:]})
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(kernels, n0)] == [8, 8, 8, 20, 20]
    assert np.isfinite(m["loss"].item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_health_bundle_on_the_card_matches_the_cpu(cuda, dtype):
    """The per-layer-group health bundle of the same trees on the card and
    on the CPU (fp32 sums, another reduction order): within 1e-5 relative,
    the same group holding an injected NaN, no host sync needed to form it
    (the bundle's tensors stay on the card)."""
    from building_llm_from_scratch_tpu_torch.obs.health import group_health

    gen = torch.Generator().manual_seed(0)

    def tree():
        return {"blocks/attn/wq": torch.randn(3, 64, 64, generator=gen).to(dtype),
                "blocks/norm1/scale": torch.randn(3, 64, generator=gen).to(dtype),
                "head/weight": torch.randn(64, 300, generator=gen).to(dtype),
                "tok_emb/weight": torch.randn(300, 64, generator=gen).to(dtype)}
    g, p, u = tree(), tree(), tree()
    g["blocks/attn/wq"][2, 5, 7] = float("nan")
    on = lambda d: {k: v.to(cuda) for k, v in d.items()}  # noqa: E731
    card = group_health(on(g), on(p), on(u))
    cpu = group_health(g, p, u)
    assert all(v.device.type == "cuda" for v in card.values())
    assert int(card["first_nonfinite"]) == int(cpu["first_nonfinite"]) == 2
    for k in ("grad_norm", "param_norm", "update_norm", "update_ratio"):
        a, b = card[k].cpu().double(), cpu[k].double()
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin), k
        assert ((a[fin] - b[fin]).abs() / b[fin].abs()).max() <= 1e-5, k


def test_profile_trace_holds_kernel_events(cuda, tmp_path):
    """``--profile`` on the card: the exported Chrome trace holds CUDA
    kernel events beside the step's named regions (a trace without kernel
    events raises)."""
    import json

    from building_llm_from_scratch_tpu_torch import main as tmain

    data = tmp_path / "data"
    data.mkdir()
    (data / "c.txt").write_text("Every effort moves you closer to mastery. " * 40)
    t = tmain.run(["--mode", "train", "--model", "GPT2", "--num_params", "124M",
                   "--debug", "--byte_tokenizer", "--data_dir", str(data),
                   "--output_dir", str(tmp_path / "out"), "--batch_size", "4",
                   "--eval_freq", "1000", "--print_sample_iter", "1000",
                   "--profile", "--profile_steps", "2"])
    events = json.loads(open(t.profile_trace).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"forward", "backward", "optimizer", "health", "dispatch"} <= names
    assert sum(e.get("cat") == "kernel" for e in events) > 0
