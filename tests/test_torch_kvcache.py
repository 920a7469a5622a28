"""Chunked prefill and the prefix cache in the port (``serving/kvcache.py``,
``prefill_chunk_into_slot``) against the JAX package on the same weights:
the page-pool and prefix-store units (mirroring ``tests/test_paged_kv.py``
and ``tests/test_kvcache.py``), zero-clamped prefix panes through the
chunked path, the contiguous chunked engine's greedy tokens and integer
state tick by tick, and the serving flags.

Tolerances: chunk logits and panes fp32 atol 1e-5 (the same operations in
another framework); integer state and greedy tokens exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.models import transformer as jtf
from building_llm_from_scratch_tpu.models.lora import (
    adapter_fingerprint as jax_fingerprint,
)
from building_llm_from_scratch_tpu.serving.kvcache import (
    KVCachePolicy as JPolicy,
)
from building_llm_from_scratch_tpu.serving.kvcache import (
    extract_prefix_panes as jax_extract,
)
from building_llm_from_scratch_tpu_torch.args import get_args
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.serving.frontend import (
    kv_policy_from_args,
)
from building_llm_from_scratch_tpu_torch.serving.kvcache import (
    DEFAULT_POLICY,
    KVCachePolicy,
    PagePool,
    PrefixStore,
    adapter_fingerprint,
    extract_prefix_panes,
)
from building_llm_from_scratch_tpu_torch.serving.queue import RequestQueue
from building_llm_from_scratch_tpu_torch.serving.request import (
    Request,
    SamplingParams,
)
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    params_from_jax,
)
from torch_port_helpers import (
    assert_engines_agree,
    jax_params,
    small_configs,
    traffic,
)


# ---------------------------------------------------------------------------
# PagePool units (tests/test_paged_kv.py:78-137)
# ---------------------------------------------------------------------------

def test_page_pool_alloc_free_refcount():
    pool = PagePool(6, 128)                    # trash + 5 usable
    assert pool.n_free == 5 and pool.available() == 5
    assert pool.refcount(0) == 1               # trash page: pinned
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (1, 2)                    # lowest-id-first
    pool.incref(a)
    assert pool.refcount(a) == 2
    assert pool.decref(a) is False
    assert pool.decref(a) is True
    assert pool.n_free == 4
    with pytest.raises(RuntimeError, match="double free"):
        pool.decref(a)
    with pytest.raises(RuntimeError, match="use-after-free"):
        pool.incref(a)
    assert pool.decref(0) is False
    with pytest.raises(RuntimeError):
        pool.incref(0)
    assert pool.alloc() == 1                   # freed ids reused lowest-first
    pool.decref(b)
    st = pool.stats()
    assert st["n_pages"] == 5 and st["page_bytes"] == 128
    assert (st["allocs"], st["frees"], st["used"], st["free"],
            st["peak_used"]) == (3, 2, 1, 4, 2)


def test_page_pool_reservations_and_exhaustion():
    pool = PagePool(4, 64)                     # 3 usable
    pool.reserve(2)
    assert pool.available() == 1
    p = pool.alloc(from_reserved=True)
    assert pool.stats()["reserved"] == 1 and pool.available() == 1
    pool.unreserve(1)
    assert pool.available() == 2
    q, r = pool.alloc(), pool.alloc()
    assert pool.n_free == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc()
    for page in (p, q, r):
        pool.decref(page)
    assert pool.n_free == 3


def test_policy_validation():
    with pytest.raises(ValueError, match="chunked prefill"):
        KVCachePolicy(paged=True)
    with pytest.raises(ValueError, match="chunked prefill"):
        KVCachePolicy(prefix_cache=True)
    with pytest.raises(ValueError, match="multiple"):
        KVCachePolicy(paged=True, prefill_chunk=12, page_tokens=8)
    with pytest.raises(ValueError):
        KVCachePolicy(paged=True, prefill_chunk=16, page_tokens=0)
    with pytest.raises(ValueError, match="item 5"):
        KVCachePolicy(kv_quant="int8")
    assert DEFAULT_POLICY.paged is False and KVCachePolicy().prefill_chunk == 0


def test_policy_sizes_match_jax():
    jcfg, tcfg = small_configs("llama", dtype="bf16")
    for kw in (dict(), dict(paged=True, prefill_chunk=16, page_tokens=8),
               dict(paged=True, prefill_chunk=15, page_tokens=5, pool_pages=7)):
        jp, tp = JPolicy(**kw), KVCachePolicy(**kw)
        assert tp.page_bytes(tcfg) == jp.page_bytes(jcfg)
        assert tp.bytes_per_slot(tcfg, 64) == jp.bytes_per_slot(jcfg, 64)
        assert tp.pages_per_slot(61) == jp.pages_per_slot(61)
        assert tp.total_pool_pages(3, 61) == jp.total_pool_pages(3, 61)
        assert tp.describe() == jp.describe()
        cache = tp.alloc(tcfg, 3, 61, "cpu")
        ref = jp.alloc(jcfg, 3, 61)
        assert [tuple(t.shape) for t in cache["k"]] == [r.shape for r in ref["k"]]
        assert cache["v"][0].dtype == torch.bfloat16
    assert adapter_fingerprint(tcfg) == jax_fingerprint(jcfg)


def test_queue_put_front_bypasses_capacity():
    q = RequestQueue(2)
    reqs = [Request(i, np.zeros(1, np.int32), SamplingParams()) for i in range(3)]
    q.put(reqs[1])
    q.put(reqs[2])
    q.put_front(reqs[0])                       # full queue: still accepted
    assert len(q) == 3
    assert [q.get_nowait().id for _ in range(3)] == [0, 1, 2]


# ---------------------------------------------------------------------------
# PrefixStore units (tests/test_kvcache.py:222-290)
# ---------------------------------------------------------------------------

def _panes(nbytes_target=1024):
    return {"k": torch.zeros(max(nbytes_target // 4, 1))}


def test_prefix_store_lru_eviction_under_budget():
    store = PrefixStore("fp", chunk_tokens=4, budget_bytes=3 * 1024,
                        pane_tokens=64)
    ids = [np.arange(i, i + 8, dtype=np.int32) for i in range(4)]
    for i in range(3):
        assert store.insert(ids[i], "base", _panes(1024))
    span, e0 = store.match(np.concatenate([ids[0], [99]]), "base")
    assert e0 is not None and span == 8
    store.release(e0)
    assert store.insert(ids[3], "base", _panes(1024))
    assert store.n_entries == 3 and store.n_evictions == 1
    assert store.contains(ids[0], "base")          # refreshed: survived
    assert not store.contains(ids[1], "base")      # LRU victim
    assert not store.insert(np.arange(50, 58, dtype=np.int32), "base",
                            _panes(64 * 1024))
    assert store.n_insert_skips == 1


def test_prefix_store_pinned_entries_never_evict():
    store = PrefixStore("fp", chunk_tokens=4, budget_bytes=2 * 1024,
                        pane_tokens=64)
    a, b = np.arange(0, 8, dtype=np.int32), np.arange(10, 18, dtype=np.int32)
    assert store.insert(a, "base", _panes(1024))
    assert store.insert(b, "base", _panes(1024))
    _span, ea = store.match(np.concatenate([a, [99]]), "base")
    assert ea is not None
    assert store.insert(np.arange(20, 28, dtype=np.int32), "base", _panes(1024))
    assert store.contains(a, "base") and not store.contains(b, "base")
    _sp, ec = store.match(np.arange(20, 29, dtype=np.int32), "base")
    assert ec is not None
    assert not store.insert(np.arange(30, 38, dtype=np.int32), "base",
                            _panes(2048))
    store.release(ea)
    store.release(ec)


def test_prefix_store_namespacing_and_span_semantics():
    store = PrefixStore("fp", chunk_tokens=4, budget_bytes=1 << 20,
                        pane_tokens=12)
    ids = np.arange(0, 8, dtype=np.int32)
    store.insert(ids, "tenant-a#1", _panes())
    assert store.match(np.concatenate([ids, [1]]), "base")[1] is None
    assert store.match(np.concatenate([ids, [1]]), "tenant-a#2")[1] is None
    span, e = store.match(np.concatenate([ids, [1]]), "tenant-a#1")
    assert span == 8
    store.release(e)
    assert (store.storable_span(8), store.storable_span(9),
            store.storable_span(17)) == (4, 8, 12)
    assert store.match(np.concatenate([ids, [1]]), "tenant-a#1",
                       min_span=8, count_miss=False)[1] is None
    st = store.stats()
    assert (st["hits"], st["misses"]) == (1, 2)


def test_prefix_store_pages_release_on_eviction():
    pool = PagePool(10, 100)
    store = PrefixStore("fp", chunk_tokens=4, budget_bytes=300,
                        pane_tokens=64, page_pool=pool)
    pages = [pool.alloc() for _ in range(3)]
    assert store.insert_pages(np.arange(8, dtype=np.int32), "base", pages) == 300
    assert [pool.refcount(p) for p in pages] == [2, 2, 2]
    for p in pages:                            # the donor slot retires
        pool.decref(p)
    other = [pool.alloc()]
    assert store.insert_pages(np.arange(1, 9, dtype=np.int32), "base", other)
    assert store.n_evictions == 1 and pool.stats()["used"] == 1
    assert pool.refcount(other[0]) == 2 and store.n_entries == 1


# ---------------------------------------------------------------------------
# chunked prefill and the zero-clamped panes, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["gpt2", "llama"])
def models(request):
    jcfg, tcfg = small_configs(request.param)
    params, np_params = jax_params(jcfg, seed=3)
    return jcfg, params, params_from_jax(np_params, tcfg, device="cpu")


_jax_chunk = jax.jit(jtf.prefill_chunk_into_slot, static_argnums=(1,))


def _chunked_prefill_jax(jcfg, params, prompt, C, Tmax):
    cache = jtf.init_slot_cache(jcfg, 2, Tmax)
    for lo in range(0, len(prompt), C):
        chunk = np.zeros((1, C), np.int32)
        part = prompt[lo:lo + C]
        chunk[0, :len(part)] = part
        logits, cache = _jax_chunk(
            params, jcfg, jnp.asarray(chunk), jnp.int32(lo),
            jnp.int32(len(prompt)), jnp.int32(1), cache)
    return np.asarray(logits), cache


def _chunked_prefill_port(model, prompt, C, Tmax):
    cache = ttf.init_slot_cache(model.cfg, 2, Tmax, "cpu")
    # garbage past the prompt: a previous occupant's state
    for bufs in cache.values():
        for b in bufs:
            b.normal_(generator=torch.Generator().manual_seed(len(prompt)))
    for lo in range(0, len(prompt), C):
        chunk = torch.zeros((1, C), dtype=torch.long)
        part = torch.from_numpy(prompt[lo:lo + C].astype(np.int64))
        chunk[0, :len(part)] = part
        logits = ttf.prefill_chunk_into_slot(model, chunk, lo, len(prompt), 1,
                                             cache)
    return logits, cache


def test_chunked_prefill_and_zero_clamped_panes_match_jax(models):
    """Two donors sharing a 24-token prefix with other suffixes prefill
    through 8-token chunks: their 16-token panes are byte-identical (the
    pad/suffix state past the span is zeroed), and the chunk logits and
    panes agree with the JAX chunked path."""
    jcfg, params, model = models
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, jcfg.vocab_size, 24).astype(np.int32)
    panes = []
    for suffix in ([33, 34, 35], [44]):
        prompt = np.concatenate([prefix, np.asarray(suffix, np.int32)])
        logits, cache = _chunked_prefill_port(model, prompt, 8, 48)
        jlogits, jcache = _chunked_prefill_jax(jcfg, params, prompt, 8, 48)
        np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5, rtol=0)
        pane = extract_prefix_panes(cache, 1, 16, pane_len=32)
        jpane = jax_extract(jcache, 1, 16, pane_len=32)
        for name in ("k", "v"):
            assert tuple(pane[name].shape) == jpane[name].shape
            assert not pane[name][:, :, 16:].any()
            np.testing.assert_allclose(pane[name].numpy(),
                                       np.asarray(jpane[name]), atol=1e-5)
        panes.append(pane)
    for name in ("k", "v"):
        assert torch.equal(panes[0][name], panes[1][name])


# ---------------------------------------------------------------------------
# the contiguous chunked engine against the JAX engine, tick by tick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", [False, True], ids=["chunked", "prefix"])
def test_contiguous_chunked_engine_matches_jax(models, prefix):
    jcfg, params, model = models
    reqs = traffic(jcfg.vocab_size)
    eng = assert_engines_agree(jcfg, params, model,
                               dict(prefill_chunk=16, prefix_cache=prefix),
                               reqs)
    st = eng.stats()
    assert st["prefill_chunks"] > len(reqs)
    if prefix:
        assert st["prefix_store"]["hits"] >= 3
        assert st["pane_copies"] == st["prefix_store"]["hits"]
    else:
        assert "prefix_store" not in st and st["pane_copies"] == 0


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

def _req_file(tmp_path):
    path = tmp_path / "req.jsonl"
    path.write_text('{"prompt_ids": [1, 2, 3]}\n')
    return str(path)


def test_serve_flags_build_the_jax_policy(tmp_path):
    req = _req_file(tmp_path)
    base = ["--mode", "serve", "--serve_prompts", req]
    args = get_args(base + ["--serve_kv_paged", "on", "--serve_prefix_cache",
                            "on", "--serve_kv_page_tokens", "8",
                            "--serve_prefix_budget_mb", "1.5"])
    assert kv_policy_from_args(args) == KVCachePolicy(
        prefix_cache=True, prefill_chunk=64, paged=True, page_tokens=8,
        prefix_budget_bytes=int(1.5 * 1024 ** 2))
    args = get_args(base + ["--serve_prefix_cache", "on",
                            "--serve_prefill_chunk", "32"])
    assert kv_policy_from_args(args).prefill_chunk == 32
    assert kv_policy_from_args(get_args(base)) == KVCachePolicy()
    for bad in (["--serve_kv_paged", "on", "--serve_kv_page_tokens", "48"],
                ["--serve_prefill_chunk", "-1"],
                ["--serve_kv_page_tokens", "0"],
                ["--serve_prefix_budget_mb", "0"]):
        with pytest.raises(ValueError):
            get_args(base + bad)


def test_serve_flags_outside_serve_mode_are_refused(tmp_path):
    flags = ["--mode", "train", "--byte_tokenizer", "--data_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="--serve_kv_paged require --mode serve"):
        get_args(flags + ["--serve_kv_paged", "on"])
    get_args(flags)


@pytest.mark.parametrize("flag", ["--serve_kv_quant=int8", "--serve_spec_k=2"])
def test_int8_kv_and_speculation_stay_refused_by_name(tmp_path, capsys, flag):
    with pytest.raises(SystemExit):
        get_args(["--mode", "serve", "--serve_prompts", _req_file(tmp_path),
                  "--serve_kv_paged", "on", flag])
    err = capsys.readouterr().err
    assert flag.split("=")[0] in err and "ROADMAP" in err
