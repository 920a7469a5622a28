"""Speculative decoding in the port (``serving/spec.py``,
``generate.accept_draft_tokens``, ``verify_slots`` / ``paged_verify_slots``,
the engine's verify tick and ``--serve_spec_k``) against the JAX package on
the same weights:

  - ``NgramDrafter.propose`` equals the JAX drafter's on random and
    repetitive histories and on the edge cases of ``tests/test_spec.py``;
  - the accept rule on fixed logits gives the JAX rule's tokens,
    ``n_accepted`` and ``ok``: greedy rows, sampled rows whose logits make
    the draw certain (the packages' random streams differ), a non-finite
    position;
  - ``verify_slots`` / ``paged_verify_slots`` logits and appended caches
    within fp32 atol 1e-5 of JAX's on the same cache (model dtype, int8
    codes with scales, and gathered adapters);
  - the port engine spec on against spec off, greedy and seeded-sampled
    rows, under an oracle, a never-right and the n-gram drafter: tokens
    and finish reasons bit-equal; and its greedy tokens and acceptance
    counts equal the JAX engine's at spec_k 4;
  - compositions: per-request opt-out, chunked prefill, paged with a prefix
    hit, adapters, the near-capacity position clamp;
  - the CLI (``--serve_spec_k`` alone, and with int8, paged, the prefix
    cache and adapters together, and the ``"spec": false`` field) against
    the JAX JSONL frontend.

Tolerances: logits fp32 atol 1e-5 (the same operations in another
framework); tokens, counts and finish reasons exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.configs import ModelConfig as JConfig
from building_llm_from_scratch_tpu.generate import (
    accept_draft_tokens as jax_accept,
)
from building_llm_from_scratch_tpu.generate import token_rng
from building_llm_from_scratch_tpu.models import lora as jlora
from building_llm_from_scratch_tpu.models import transformer as jtf
from building_llm_from_scratch_tpu.serving import DecodeEngine as JEngine
from building_llm_from_scratch_tpu.serving import SamplingParams as JParams
from building_llm_from_scratch_tpu.serving.adapters import (
    AdapterRegistry as JReg,
)
from building_llm_from_scratch_tpu.serving.kvcache import (
    KVCachePolicy as JPolicy,
)
from building_llm_from_scratch_tpu.serving.spec import NgramDrafter as JNgram
from building_llm_from_scratch_tpu_torch.generate import (
    accept_draft_tokens,
    sample_tokens_dynamic,
    sample_tokens_multi,
)
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.serving.adapters import AdapterRegistry
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy
from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams
from building_llm_from_scratch_tpu_torch.serving.spec import Drafter, NgramDrafter
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    params_from_jax,
)
from torch_port_helpers import jax_params, to_torch_config

ATOL = 1e-5
#: the JAX functions, compiled once per cache structure (eager dispatch of
#: two layers' ops costs seconds a call)
_VERIFY = jax.jit(jtf.verify_slots, static_argnums=(1,))
_PAGED_VERIFY = jax.jit(jtf.paged_verify_slots, static_argnums=(1,),
                        static_argnames=("cache_len",))
_ACCEPT = jax.jit(jax_accept, static_argnums=(5,))


def tiny_cfg(ctx=64, **kw):
    """The JAX spec tests' model (``tests/test_spec.py:28``): 2 layers,
    width 32."""
    base = dict(name="spec-tiny", vocab_size=96, context_length=ctx,
                emb_dim=32, n_heads=2, n_layers=2, hidden_dim=64,
                n_kv_groups=2, norm="layernorm", positional="learned",
                activation="gelu", drop_rate=0.0, eos_id=1)
    base.update(kw)
    return JConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_cfg()
    params, np_params = jax_params(jcfg, 0)
    return jcfg, params, params_from_jax(np_params, to_torch_config(jcfg), "cpu")


def mixed_requests(vocab, n=6, max_new=16, prompt_len=8, seed=0):
    """Greedy and seeded-sampled rows with assorted budgets
    (``tests/test_spec.py``'s ``_mixed_requests``)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, vocab, (prompt_len,)).astype(np.int32)
               for _ in range(n)]
    params = [SamplingParams(max_new_tokens=max_new - (i % 3), ignore_eos=True,
                             seed=i, temperature=0.7 if i % 2 else 0.0,
                             top_k=8 if i % 2 else None) for i in range(n)]
    return prompts, params


def repetitive_requests(vocab, n=4, max_new=40, seed=1):
    """Greedy rows over templated prompts (a span repeated three times), the
    traffic the n-gram drafter is for."""
    rng = np.random.default_rng(seed)
    prompts = [np.tile(rng.integers(2, vocab, (5,)), 3).astype(np.int32)
               for _ in range(n)]
    return prompts, [SamplingParams(max_new_tokens=max_new, ignore_eos=True,
                                    seed=i) for i in range(n)]


def run_engine(model, prompts, sps, n_slots=2, **kw):
    eng = DecodeEngine(model, n_slots=n_slots, max_queue=len(prompts),
                       warmup_prompt_cap=16, **kw)
    hs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    eng.run_until_idle()
    return eng, [list(h.output_ids) for h in hs], [h.finish_reason for h in hs], hs


class OracleDrafter(Drafter):
    """Drafts the true continuation from recorded spec-off sequences (near
    full acceptance)."""

    def __init__(self, sequences):
        self.sequences = [np.asarray(s, np.int32) for s in sequences]

    def propose(self, history, k):
        L = history.shape[0]
        for seq in self.sequences:
            if L <= seq.shape[0] and np.array_equal(seq[:L], history):
                cont = seq[L:L + k]
                return np.concatenate([cont, np.full((k - cont.shape[0],),
                                                     history[-1], np.int32)])
        return super().propose(history, k)


class WrongDrafter(Drafter):
    """Always drafts token 3 (near zero acceptance)."""

    def propose(self, history, k):
        return np.full((k,), 3, np.int32)


# ---------------------------------------------------------------------------
# the drafter (tests/test_spec.py:75-117)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hist,k,max_n,min_n,want", [
    ([7, 8, 9, 4, 1, 7, 8, 9, 5, 6, 7, 8, 9], 2, 3, 1, [5, 6]),   # most recent
    ([3, 4, 5, 4, 9, 3, 4], 1, 2, 1, [5]),                         # longer wins
    ([10, 11, 12, 13], 3, 3, 1, [13, 13, 13]),                     # no match
    ([5], 2, 3, 1, [5, 5]),                                        # too short
    ([5, 5], 2, 3, 1, [5, 5]),
    ([2, 8, 2], 3, 1, 1, [8, 2, 2]),                               # padded
])
def test_ngram_drafter_edge_cases_match_jax(hist, k, max_n, min_n, want):
    h = np.asarray(hist, np.int32)
    got = NgramDrafter(max_n, min_n).propose(h, k)
    assert got.dtype == np.int32 and got.tolist() == want
    assert JNgram(max_n, min_n).propose(h, k).tolist() == want


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_ngram_drafter_matches_jax_on_histories(kind):
    rng = np.random.default_rng(7)
    for trial in range(40):
        if kind == "random":
            h = rng.integers(0, 6, rng.integers(1, 60)).astype(np.int32)
        else:
            h = np.tile(rng.integers(0, 50, rng.integers(2, 9)),
                        rng.integers(1, 6))[: rng.integers(1, 60)]
            h = np.concatenate([h, rng.integers(0, 50, 3)]).astype(np.int32)
        for max_n, min_n in ((3, 1), (4, 2), (1, 1)):
            for k in (1, 4):
                got = NgramDrafter(max_n, min_n).propose(h, k)
                want = JNgram(max_n, min_n).propose(h, k)
                assert got.tolist() == want.tolist(), (trial, h, max_n, min_n, k)
    with pytest.raises(ValueError):
        NgramDrafter(1, 2)
    assert NgramDrafter().describe() == JNgram().describe()


# ---------------------------------------------------------------------------
# the accept rule
# ---------------------------------------------------------------------------

def test_sample_tokens_multi_rowwise_equals_single_position():
    """Position j of row s is the one-token sampler's draw for token index
    n_gen[s] + j from the same logits (the property the accept rule's
    exactness stands on)."""
    S, Tq, V = 3, 4, 32
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(S, Tq, V)).astype(np.float32))
    seeds, n_gen = np.array([4, 5, 6]), np.array([0, 3, 7])
    temps = np.array([0.0, 0.8, 1.3], np.float32)
    topks = np.array([0, 5, 0], np.int32)
    gen = torch.Generator()
    multi = sample_tokens_multi(logits, seeds, n_gen, temps, topks, 8, gen)
    for s in range(S):
        for j in range(Tq):
            one = sample_tokens_dynamic(logits[s, j][None], seeds[s:s + 1],
                                        n_gen[s:s + 1] + j, temps[s:s + 1],
                                        topks[s:s + 1], 8, gen)
            assert int(one[0]) == int(multi[s, j]), (s, j)


def test_accept_rule_matches_jax_on_fixed_logits():
    """Rows 0-1 greedy, rows 2-3 sampled (temperature 0.7, top-k 5 on row 3)
    with one logit 100 above the rest at every position, so both packages'
    draws are that token whatever their random streams. Drafts: row 0 all
    right, row 1 wrong at position 2, row 2 right then a NaN at position 3
    (the chain stops before it), row 3 wrong at once; row 4 greedy with a
    non-finite position 0 (``ok`` False)."""
    S, k, V = 5, 4, 24
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(S, k + 1, V)).astype(np.float32)
    top = rng.integers(0, V, (S, k + 1))
    for s in (2, 3):
        logits[s, np.arange(k + 1), top[s]] += 100.0
    argmax = logits.argmax(-1)
    want = np.where(np.isin(np.arange(S), (2, 3))[:, None], top, argmax)
    drafts = want[:, :k].copy()
    drafts[1, 2] = (drafts[1, 2] + 1) % V
    drafts[3, 0] = (drafts[3, 0] + 1) % V
    logits[2, 3, 5] = np.nan
    logits[4, 0, :] = -np.inf
    temps = np.array([0, 0, 0.7, 0.7, 0], np.float32)
    topks = np.array([0, 0, 0, 5, 0], np.int32)
    seeds, n_gen = np.arange(S) + 10, np.array([0, 2, 5, 1, 0])

    toks, n_acc, ok = accept_draft_tokens(
        torch.from_numpy(logits), torch.from_numpy(drafts), seeds, n_gen,
        temps, topks, 8, torch.Generator())
    offs = jnp.asarray(n_gen)[:, None] + jnp.arange(k + 1)[None, :]
    base = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    keys = jax.vmap(jax.vmap(token_rng, in_axes=(None, 0)))(base, offs)
    jt, jn, jok = _ACCEPT(jnp.asarray(logits), jnp.asarray(drafts), keys,
                             jnp.asarray(temps), jnp.asarray(topks), 8)
    finite = np.isfinite(logits).all(-1)
    np.testing.assert_array_equal(toks.numpy()[finite], np.asarray(jt)[finite])
    np.testing.assert_array_equal(toks.numpy()[finite], want[finite])
    assert n_acc.tolist() == np.asarray(jn).tolist() == [4, 2, 2, 0, 0]
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 4 + [False]


# ---------------------------------------------------------------------------
# verify_slots / paged_verify_slots against JAX
# ---------------------------------------------------------------------------

def random_state(jcfg, policy: dict, n_rows, length, seed=0):
    """The same random cache in both packages: floats for a model-dtype
    cache, int8 codes and positive scales for an int8 one."""
    jc = jtf.init_slot_cache(jcfg, n_rows, length, policy=JPolicy(**policy))
    rng = np.random.default_rng(seed)
    out = {}
    for name, bufs in jc.items():
        if name.endswith("_scale"):
            arrs = [rng.uniform(0.005, 0.05, b.shape).astype(np.float32) for b in bufs]
        elif bufs[0].dtype == jnp.int8:
            arrs = [rng.integers(-127, 128, b.shape).astype(np.int8) for b in bufs]
        else:
            arrs = [rng.standard_normal(b.shape).astype(np.float32) for b in bufs]
        out[name] = arrs
    return ({k: [jnp.asarray(a) for a in v] for k, v in out.items()},
            {k: [torch.from_numpy(a.copy()) for a in v] for k, v in out.items()})


def assert_caches_close(tc, jc):
    for name in tc:
        for a, b in zip(tc[name], jc[name]):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       atol=ATOL, rtol=0, err_msg=name)


def write_adapter(path, jcfg, params, seed, rank) -> str:
    """A JAX adapter artifact with B drawn nonzero (B = 0 at init would make
    every delta vanish), the noise from numpy."""
    rng = np.random.default_rng(seed)
    lora = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jlora.init_lora_params(jcfg, params, jax.random.PRNGKey(seed), rank=rank))
    jlora.save_adapter(str(path), lora, rank=rank, alpha=2.0 * rank, cfg=jcfg)
    return str(path)


@pytest.fixture(scope="module")
def registries(tiny, tmp_path_factory):
    jcfg, params, model = tiny
    d = tmp_path_factory.mktemp("spec-adapters")
    return {name: write_adapter(d / f"{name}.npz", jcfg, params, 30 + i, rank)
            for i, (name, rank) in enumerate([("a", 4), ("b", 2)])}


def adapter_args(jcfg, params, model, specs, ids):
    jreg = JReg.from_artifacts(jcfg, params, specs, capacity=3)
    treg = AdapterRegistry.from_artifacts(model.cfg, specs, capacity=3, device="cpu")
    pool, scaling = jreg.pool_args()
    tpool, tscaling = treg.pool_args()
    ids = np.asarray(ids, np.int32)
    return ({"pool": pool, "scaling": scaling, "ids": jnp.asarray(ids)},
            {"pool": tpool, "scaling": tscaling, "ids": torch.from_numpy(ids)})


@pytest.mark.parametrize("quant", ["model", "int8"])
@pytest.mark.parametrize("with_adapters", [False, True])
def test_verify_slots_matches_jax(tiny, registries, quant, with_adapters):
    """Rows at lengths 0, 20 and 59 of a 64 + 4 row: the last one's tail
    candidates pass the context and clamp (``tests/test_spec.py``'s
    near-capacity case); the adapters' rows mix a, b and the base."""
    jcfg, params, model = tiny
    jc, tc = random_state(jcfg, dict(kv_quant=quant), 3, 68)
    toks = np.random.default_rng(1).integers(0, 96, (3, 5))
    lens = np.array([0, 20, 59], np.int32)
    ja, ta = (adapter_args(jcfg, params, model, registries, [0, -1, 1])
              if with_adapters else (None, None))
    jl, jnew = _VERIFY(params, jcfg, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(lens), jc, adapter=ja)
    tl = ttf.verify_slots(model, torch.from_numpy(toks), torch.from_numpy(lens),
                          tc, adapter=ta)
    assert tl.shape == (3, 5, 96) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert_caches_close(tc, jnew)


@pytest.mark.parametrize("quant", ["model", "int8"])
def test_paged_verify_slots_matches_jax(tiny, quant):
    """A pool of 4-token pages; row 1 shares row 0's first page (a prefix
    hit); a row's columns past its frontier point at the trash page."""
    jcfg, params, model = tiny
    pol = dict(kv_quant=quant, paged=True, page_tokens=4, prefill_chunk=8)
    jc, tc = random_state(jcfg, pol, 3, 68, seed=2)
    table = np.zeros((3, 17), np.int32)
    table[0, :4] = [3, 4, 5, 6]
    table[1, :6] = [3, 7, 8, 9, 10, 11]
    table[2, :2] = [1, 2]
    toks = np.random.default_rng(4).integers(0, 96, (3, 5))
    lens = np.array([9, 17, 2], np.int32)
    jl, jnew = _PAGED_VERIFY(
        params, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(lens),
        jnp.asarray(table), jc, cache_len=68)
    tl = ttf.paged_verify_slots(model, torch.from_numpy(toks),
                                torch.from_numpy(lens), torch.from_numpy(table),
                                tc, 68)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert_caches_close(tc, jnew)


# ---------------------------------------------------------------------------
# the engine: spec on against spec off, and against the JAX engine
# ---------------------------------------------------------------------------

def test_spec_on_equals_spec_off_under_three_drafters(tiny):
    """Greedy and seeded-sampled rows (tests/test_spec.py:150-210): the
    oracle drafter accepts more than half its drafts, the never-right one
    fewer than a fifth, and every drafter commits the spec-off tokens."""
    _, _, model = tiny
    prompts, sps = mixed_requests(96)
    _, ref, ref_r, _ = run_engine(model, prompts, sps)
    full = [np.concatenate([p, np.asarray(o, np.int32)]) for p, o in zip(prompts, ref)]
    for drafter, check in ((OracleDrafter(full), lambda a, d: a > 0.5 * d),
                           (WrongDrafter(), lambda a, d: a < 0.2 * d),
                           (None, lambda a, d: True)):
        eng, out, out_r, hs = run_engine(model, prompts, sps, spec_k=4,
                                         drafter=drafter)
        st = eng.stats()
        assert out == ref and out_r == ref_r, eng.drafter.describe()
        assert check(st["spec_tokens_accepted"], st["spec_tokens_drafted"]), st
        assert st["spec_tokens_drafted"] == sum(h.spec_drafted for h in hs) > 0
        assert st["decode_tokens"] == st["tokens_generated"] - len(prompts)
        assert st["kv_bytes"]["spec_headroom"] * 64 == st["kv_bytes"]["slot_kv"] * 4


@pytest.mark.parametrize("drafter", ["ngram", "oracle"])
def test_greedy_tokens_and_acceptance_equal_the_jax_engine(tiny, drafter):
    """Greedy templated traffic at spec_k 4: the tokens, every request's
    drafted and accepted counts, and the engine totals equal the JAX
    engine's on the same weights and prompts."""
    jcfg, params, model = tiny
    prompts, sps = repetitive_requests(96)
    draft = None
    if drafter == "oracle":
        _, ref, _, _ = run_engine(model, prompts, sps)
        draft = OracleDrafter([np.concatenate([p, np.asarray(o, np.int32)])
                               for p, o in zip(prompts, ref)])
    eng, out, _, hs = run_engine(model, prompts, sps, spec_k=4, drafter=draft)
    jeng = JEngine(jcfg, params, n_slots=2, max_queue=len(prompts),
                   warmup_prompt_cap=16, spec_k=4, drafter=draft,
                   watch_compiles=False)
    jh = [jeng.submit(p, JParams(max_new_tokens=sp.max_new_tokens,
                                 ignore_eos=True, seed=sp.seed))
          for p, sp in zip(prompts, sps)]
    jeng.run_until_idle()
    assert out == [list(h.output_ids) for h in jh]
    assert [(h.spec_drafted, h.spec_accepted) for h in hs] == \
        [(h.spec_drafted, h.spec_accepted) for h in jh]
    st, jst = eng.stats(), jeng.stats()
    for key in ("spec_tokens_drafted", "spec_tokens_accepted",
                "spec_acceptance_ratio", "n_ticks", "tokens_generated"):
        assert st[key] == jst[key], key
    assert st["spec_tokens_accepted"] > 0


def test_per_request_opt_out(tiny):
    _, _, model = tiny
    prompts, sps = mixed_requests(96, n=4)
    sps = [sp if i % 2 else SamplingParams(**dict(sp.__dict__, spec=False))
           for i, sp in enumerate(sps)]
    _, ref, _, _ = run_engine(model, prompts, sps)
    _, out, _, hs = run_engine(model, prompts, sps, spec_k=3)
    assert out == ref
    for i, h in enumerate(hs):
        if i % 2 == 0:
            assert (h.spec_drafted, h.spec_accepted) == (0, 0)
            assert "spec_drafted" not in h.summary()
        else:
            assert h.summary()["spec_drafted"] == h.spec_drafted > 0


@pytest.mark.parametrize("policy", [
    dict(prefill_chunk=8),
    dict(paged=True, prefill_chunk=8, page_tokens=4, prefix_cache=True),
], ids=["chunked", "paged-prefix"])
def test_spec_composes_with_chunked_and_paged_prefix(tiny, policy):
    """Mid-prefill rows ride the verify as ignored rows; with pages and the
    prefix cache, sharers hit a stored prefix and the candidates land in the
    headroom pages: tokens equal the same policy's spec-off engine."""
    _, _, model = tiny
    prompts, sps = mixed_requests(96, prompt_len=20)
    shared = prompts[0][:16]
    prompts = [np.concatenate([shared, p[16:]]) if i % 2 == 0 else p
               for i, p in enumerate(prompts)]
    _, ref, ref_r, _ = run_engine(model, prompts, sps,
                                  kv_policy=KVCachePolicy(**policy))
    eng, out, out_r, _ = run_engine(model, prompts, sps, spec_k=4,
                                    kv_policy=KVCachePolicy(**policy))
    assert out == ref and out_r == ref_r
    if policy.get("paged"):
        st = eng.stats()
        assert st["prefix_store"]["hits"] >= 1
        assert st["page_pool"]["reserved"] == 0
        # pages: max_len + spec_k positions a row, 4 a page
        assert eng._pages_per_slot == (64 + 4) // 4


def test_spec_composes_with_adapters(tiny, registries):
    jcfg, params, model = tiny
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 96, (8,)).astype(np.int32) for _ in range(4)]
    sps = [SamplingParams(max_new_tokens=12, ignore_eos=True, seed=i,
                          temperature=0.6 if i >= 2 else 0.0,
                          top_k=8 if i >= 2 else None,
                          adapter="a" if i % 2 else None) for i in range(4)]

    def run(spec_k):
        reg = AdapterRegistry.from_artifacts(model.cfg, registries, device="cpu")
        return run_engine(model, prompts, sps, adapters=reg, spec_k=spec_k)[1]

    assert run(4) == run(0)


def test_near_capacity_rows_complete(tiny):
    """Rows decoding to the slot's last position: the verify's tail
    positions pass the context and clamp; every row finishes its budget
    with the spec-off tokens."""
    _, _, model = tiny
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 96, (8,)).astype(np.int32) for _ in range(3)]
    sps = [SamplingParams(max_new_tokens=24, ignore_eos=True, seed=i,
                          temperature=0.5 if i == 2 else 0.0,
                          top_k=8 if i == 2 else None) for i in range(3)]
    _, ref, ref_r, _ = run_engine(model, prompts, sps, max_len=32)
    _, out, out_r, _ = run_engine(model, prompts, sps, max_len=32, spec_k=4)
    assert out_r == ref_r == ["length"] * 3 and out == ref


def test_spec_k_bounds(tiny):
    _, _, model = tiny
    with pytest.raises(ValueError, match="spec_k"):
        DecodeEngine(model, n_slots=1, spec_k=-1)
    with pytest.raises(ValueError, match="spec_k"):
        DecodeEngine(model, n_slots=1, max_len=8, spec_k=8)
    eng = DecodeEngine(model, n_slots=1, max_len=8, spec_k=7)
    assert eng.cache["k"][0].shape[2] == 15
    assert isinstance(eng.drafter, NgramDrafter)


# ---------------------------------------------------------------------------
# the CLI against the JAX JSONL frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,policy", [
    (["--serve_spec_k", "4"], {}),
    (["--serve_spec_k", "3", "--serve_kv_quant", "int8", "--serve_kv_paged",
      "on", "--serve_kv_page_tokens", "4", "--serve_prefill_chunk", "4",
      "--serve_prefix_cache", "on", "--adapters"],
     dict(kv_quant="int8", paged=True, page_tokens=4, prefill_chunk=4,
          prefix_cache=True)),
], ids=["spec", "spec-int8-paged-prefix-adapters"])
def test_serve_cli_matches_jax_frontend(tmp_path, flags, policy):
    """``main.run --mode serve`` with the flags, on a JSONL file whose
    records include ``"spec": false`` and (with adapters) ``"adapter"``,
    gives the tokens of the JAX ``serve_jsonl`` over a JAX engine with the
    same policy and spec_k on the same exported weights; the opted-out
    record drafts nothing."""
    from building_llm_from_scratch_tpu.configs import get_config as jget_config
    from building_llm_from_scratch_tpu.models import init_params as jinit
    from building_llm_from_scratch_tpu.serving.frontend import (
        serve_jsonl as jax_serve_jsonl,
    )
    from building_llm_from_scratch_tpu.training import checkpoint as jckpt
    from building_llm_from_scratch_tpu_torch import main as tmain

    jcfg = jget_config("llama3_2", "1B", dtype="fp32", debug=True)
    params = jinit(jcfg, jax.random.PRNGKey(5))
    export = str(tmp_path / "init.npz")
    jckpt.export_params(export, params)
    adapters = "--adapters" in flags
    flags = [f for f in flags if f != "--adapters"]
    jreg = None
    if adapters:
        art = write_adapter(tmp_path / "a.npz", jcfg, params, 40, 4)
        flags += ["--serve_adapters", f"a={art}"]
        jreg = JReg.from_artifacts(jcfg, params, {"a": art})
    rng = np.random.default_rng(0)
    span = rng.integers(0, 200, 3).tolist()
    recs = [{"prompt_ids": span * 2 + rng.integers(0, 200, 1 + i % 2).tolist(),
             "max_new_tokens": 6 + i % 2, "ignore_eos": True,
             **({"spec": False} if i == 1 else {}),
             **({"adapter": "a"} if adapters and i != 2 else {})}
            for i in range(4)]
    src = tmp_path / "req.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs))
    eng = tmain.run([
        "--mode", "serve", "--model", "llama3_2", "--num_params", "1B",
        "--debug", "--data_type", "fp32", "--init_params_from", export,
        "--serve_prompts", str(src), "--serve_slots", "2",
        "--device", "cpu", "--serve_out", str(tmp_path / "t.jsonl"), *flags])
    spec_k = int(flags[flags.index("--serve_spec_k") + 1])
    jeng = JEngine(jcfg, params, n_slots=2, watch_compiles=False,
                   kv_policy=JPolicy(**policy), spec_k=spec_k, adapters=jreg)
    jeng.start()
    try:
        jout = jax_serve_jsonl(jeng, str(src), None, default_max_new=4)
    finally:
        jeng.shutdown()
    out = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["token_ids"] for r in out] == [r["token_ids"] for r in jout]
    assert [r.get("spec_drafted", 0) for r in out] == \
        [r.get("spec_drafted", 0) for r in jout]
    assert "spec_drafted" not in out[1] and out[0]["spec_drafted"] > 0
    st = eng.stats()
    assert st["spec_k"] == spec_k and st["kv_policy"] == jeng.kv_policy.describe()


def test_spec_and_int8_flags_need_serve_mode(tmp_path):
    from building_llm_from_scratch_tpu_torch.args import get_args

    train = ["--mode", "train", "--byte_tokenizer", "--data_dir", str(tmp_path)]
    for flag in (["--serve_spec_k", "4"], ["--serve_kv_quant", "int8"]):
        with pytest.raises(ValueError, match=f"{flag[0]} require --mode serve"):
            get_args(train + flag)
