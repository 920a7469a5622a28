"""Paged KV in the port (``PagePool``, page tables, ``paged_*`` serving
functions, kernel B7's twin) against the JAX package on the same weights:

  - B7's twin against the JAX ``paged_decode_attention`` in interpret mode
    and against ``_paged_view`` + ``decode_attention``, fp32 atol/rtol 2e-5
    (the bound of ``tests/test_paged_kv.py:430``), over shared pages, trash
    entries, a length-0 row and a row with ``length + 1 == k P``;
  - the paged engine's greedy tokens and its integer state (page table,
    pool and prefix-store counters, pane copies) equal the JAX engine's
    after every tick, with and without the prefix cache, for GPT-2-like
    and LLaMA-like models;
  - the port's paged engine against its contiguous one: logits bit-equal,
    sampled requests included;
  - admission: the FCFS bounce of an oversubscribed pool, and the request
    that can never fit (``page_pool_too_small``); the zero scrub of a
    non-finite slot's private pages.

The CUDA kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.models.transformer import (
    _paged_view as jax_paged_view,
)
from building_llm_from_scratch_tpu.ops.attention import (
    decode_attention as jax_decode_attention,
)
from building_llm_from_scratch_tpu.ops.decode_step import (
    paged_decode_attention as jax_paged_attention,
)
from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy
from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    params_from_jax,
)
from torch_port_helpers import (
    assert_engines_agree,
    jax_params,
    small_configs,
    to_np32,
    traffic,
)

PAGED = dict(paged=True, page_tokens=8, prefill_chunk=16)


# ---------------------------------------------------------------------------
# B7's twin against JAX
# ---------------------------------------------------------------------------

def paged_case(S, Hq, Hkv, hd, P, M, seed=0):
    """q, pools and a table over shuffled page ids: every row shares page
    ids[0] (a prefix hit), columns past a row's frontier point at the trash
    page 0 (which holds garbage), row 0 has length 0 and row 1 ends one
    short of a page boundary (length + 1 == 3 P)."""
    r = np.random.default_rng(seed)
    N = S * M + 1
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    q, K, V = f(S, 1, Hq, hd), f(N, Hkv, P, hd), f(N, Hkv, P, hd)
    ids = r.permutation(np.arange(1, N)).astype(np.int32)
    table = ids[:S * M].reshape(S, M).copy()
    table[:, 0] = ids[0]
    lens = np.concatenate([[0, 3 * P - 1], r.integers(1, M * P, S - 2)])
    lens = lens.astype(np.int32)
    for s in range(S):
        table[s, lens[s] // P + 1:] = 0
    return q, K, V, table, lens


@pytest.mark.parametrize("Hq,Hkv,hd,P,M", [(8, 2, 64, 5, 4), (4, 4, 128, 8, 3)])
def test_b7_twin_matches_jax(Hq, Hkv, hd, P, M):
    S = 3
    q, K, V, table, lens = paged_case(S, Hq, Hkv, hd, P, M)
    t = torch.from_numpy
    before = tds.paged_decode_attention.launches
    out = tds.paged_decode_attention(t(q), t(K), t(V), t(table), t(lens))
    assert tds.paged_decode_attention.launches == before   # CPU: the twin
    assert tuple(out.shape) == (S, 1, Hq, hd)
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(K), jnp.asarray(V),
                              jnp.asarray(table), jnp.asarray(lens),
                              interpret=True)
    np.testing.assert_allclose(to_np32(out), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    view = jax_decode_attention(
        jnp.asarray(q), jax_paged_view(jnp.asarray(K), jnp.asarray(table), M * P),
        jax_paged_view(jnp.asarray(V), jnp.asarray(table), M * P),
        q_positions=jnp.asarray(lens)[:, None], kv_length=jnp.asarray(lens) + 1)
    np.testing.assert_allclose(to_np32(out), np.asarray(view), atol=2e-5,
                               rtol=2e-5)
    # the port's row view is the JAX one, trimmed or not
    for n in (M * P, M * P - 3):
        np.testing.assert_array_equal(
            tds.paged_view(t(K), t(table), n).numpy(),
            np.asarray(jax_paged_view(jnp.asarray(K), jnp.asarray(table), n)))


def test_b7_wrapper_rejects():
    q = torch.zeros(2, 1, 4, 64)
    K = torch.zeros(5, 2, 8, 64)
    table = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    for args in ((torch.zeros(2, 2, 4, 64), K, K, table, lens),     # Tq 2
                 (torch.zeros(2, 1, 3, 64), K, K, table, lens),     # heads
                 (q, K, K[:, :, :4], table, lens),                  # pools
                 (q, K, K, table[:1], lens),                        # table rows
                 (q, K.double(), K.double(), table, lens)):         # dtype
        with pytest.raises((ValueError, TypeError)):
            tds.paged_decode_attention(*args)
    tds.check_paged_kernel_shape(128, torch.bfloat16)
    for hd, dt in ((256, torch.float32), (16, torch.bfloat16),
                   (64, torch.float64)):
        with pytest.raises(ValueError, match="paged decode-attention kernel"):
            tds.check_paged_kernel_shape(hd, dt)


# ---------------------------------------------------------------------------
# the paged engine against the JAX engine, tick by tick
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["gpt2", "llama"])
def models(request):
    jcfg, tcfg = small_configs(request.param)
    params, np_params = jax_params(jcfg, seed=3)
    return jcfg, params, params_from_jax(np_params, tcfg, device="cpu")


@pytest.mark.parametrize("prefix", [False, True], ids=["paged", "paged-prefix"])
def test_paged_engine_matches_jax(models, prefix):
    jcfg, params, model = models
    eng = assert_engines_agree(jcfg, params, model,
                               dict(PAGED, prefix_cache=prefix),
                               traffic(jcfg.vocab_size))
    st = eng.stats()
    assert st["pane_copies"] == 0
    assert st["page_pool"]["reserved"] == 0 and st["page_pool"]["frees"] > 0
    if prefix:
        assert st["prefix_store"]["hits"] >= 3
        stored = {p for e in eng.prefix_store._entries.values() for p in e.pages}
        assert st["page_pool"]["used"] == len(stored) > 0
    else:
        assert st["page_pool"]["used"] == 0


def test_oversubscribed_pool_bounces_fcfs_like_jax(models):
    """A pool of 4 pages holds one request's worst case (3 pages) at a
    time: admission bounces the queue head and everything behind it, in
    order, until a retirement frees pages; the state matches JAX's at
    every tick and the pool is never oversubscribed."""
    jcfg, params, model = models
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, jcfg.vocab_size, 16).astype(np.int32),
             SamplingParams(max_new_tokens=4, ignore_eos=True, seed=51))
            for _ in range(3)]
    order = []
    eng = assert_engines_agree(jcfg, params, model,
                               dict(PAGED, pool_pages=4), reqs, n_slots=2,
                               max_len=32)
    st = eng.stats()["page_pool"]
    assert st["peak_used"] <= 4 and st["used"] == 0 and st["reserved"] == 0
    # first tokens come in submission order through the bounces
    eng2 = DecodeEngine(model, n_slots=2, max_len=32, warmup_prompt_cap=32,
                        kv_policy=KVCachePolicy(**PAGED, pool_pages=4))

    def on_tok(req, _tok, _piece):
        if len(req.output_ids) == 1:
            order.append(req.id)

    hs = [eng2.submit(p, sp, on_token=on_tok) for p, sp in reqs]
    eng2.run_until_idle()
    assert order == [h.id for h in hs]


def test_request_that_can_never_fit_fails_fast(models):
    _, _, model = models
    eng = DecodeEngine(model, n_slots=2, max_len=32, warmup_prompt_cap=16,
                       kv_policy=KVCachePolicy(**PAGED, pool_pages=2))
    big = eng.submit(np.arange(2, 18), SamplingParams(max_new_tokens=4,
                                                      ignore_eos=True))
    small = eng.submit(np.arange(2, 10), SamplingParams(max_new_tokens=2,
                                                        ignore_eos=True))
    eng.run_until_idle()
    assert big.finish_reason == "error" and "page_pool_too_small" in big.error
    assert small.finish_reason == "length" and len(small.output_ids) == 2
    assert eng.stats()["page_pool"]["used"] == 0


# ---------------------------------------------------------------------------
# the port's paged engine against its contiguous engine
# ---------------------------------------------------------------------------

def record_logits(eng) -> list:
    """Wrap the engine's decode step and chunks to record the logits of the
    rows that decode (free and mid-prefill rows compute garbage)."""
    seen = []
    decode, chunk = eng._decode, eng._run_chunk

    def rec_decode(cache):
        out = decode(cache)
        rows = [s for s, _ in eng.scheduler.active()
                if s not in eng._prefill_state]
        seen.append(("decode", rows, out[rows].clone()))
        return out

    def rec_chunk(slot, req, lo, hi, Tp, cache):
        out = chunk(slot, req, lo, hi, Tp, cache)
        seen.append(("chunk", slot, lo, out.clone()))
        return out

    eng._decode, eng._run_chunk = rec_decode, rec_chunk
    return seen


@pytest.mark.parametrize("page_tokens", [8, 5])
def test_paged_logits_bit_equal_contiguous(models, page_tokens):
    """The same requests (sampled ones with fixed seeds included) through
    the paged and the contiguous chunked engines: every decoding row's
    logits and every chunk's logits are bit-equal, and so are the tokens.
    Page size 5 leaves the last page of a 64-token row half used."""
    _, _, model = models
    reqs = traffic(model.cfg.vocab_size, seed=4)
    reqs = [(p, SamplingParams(max_new_tokens=sp.max_new_tokens,
                               temperature=0.9 if i % 2 else 0.0, top_k=6,
                               seed=100 + i, ignore_eos=True))
            for i, (p, sp) in enumerate(reqs)]
    runs = []
    for paged in (True, False):
        pol = KVCachePolicy(prefill_chunk=2 * page_tokens,
                            prefix_cache=True, paged=paged,
                            page_tokens=page_tokens)
        eng = DecodeEngine(model, n_slots=3, max_len=64, warmup_prompt_cap=32,
                           kv_policy=pol)
        seen = record_logits(eng)
        hs = [eng.submit(p, sp) for p, sp in reqs]
        eng.run_until_idle()
        runs.append((seen, [h.output_ids for h in hs], eng.stats()))
    (a, ta, sa), (b, tb, sb) = runs
    assert ta == tb
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[:-1] == y[:-1]
        assert torch.equal(x[-1], y[-1])
    assert sa["prefix_store"]["hits"] == sb["prefix_store"]["hits"] >= 3
    assert sa["pane_copies"] == 0 and sb["pane_copies"] > 0


def test_non_finite_failure_scrubs_private_pages(models):
    """A slot whose private pages turn NaN fails alone with a non-finite
    error; its pages are zeroed before they return to the pool, so the
    next request that draws them decodes as a fresh engine does."""
    _, _, model = models
    pol = KVCachePolicy(**PAGED)
    eng = DecodeEngine(model, n_slots=2, max_len=64, kv_policy=pol)
    sp = SamplingParams(max_new_tokens=6, ignore_eos=True)
    prompt = np.arange(3, 23)
    bad = eng.submit(prompt, sp)
    while bad.slot is None or bad.slot in eng._prefill_state:
        eng.step()
    pages = [int(p) for p in eng._page_table[bad.slot, :eng._slot_cols[bad.slot]]]
    eng._rewrite_slot_pages(bad.slot, float("nan"), eng.cache)
    eng.run_until_idle()
    assert bad.finish_reason == "error" and "non-finite" in bad.error
    for bufs in eng.cache.values():
        for buf in bufs:
            assert torch.isfinite(buf).all()
            assert not buf[pages].any()
    good = eng.submit(prompt, sp)
    eng.run_until_idle()
    fresh = DecodeEngine(model, n_slots=2, max_len=64, kv_policy=pol)
    ref = fresh.submit(prompt, sp)
    fresh.run_until_idle()
    assert good.output_ids == ref.output_ids and len(good.output_ids) == 6
