"""int8 KV in the port (``ops/decode_step.quantize_kv``, the scaled
``decode_attention``, ``KVCachePolicy(kv_quant="int8")``, quantize-on-write
in every slot function, ``--serve_kv_quant int8``) against the JAX package
on the same weights:

  - ``quantize_kv`` codes and scales bit-equal to JAX's on the same input
    (fp32 and bf16), and the dequantization bound;
  - scaled ``decode_attention`` within fp32 atol 1e-5 of JAX's, and of
    attention over the dequantized cache;
  - the policy's ``bytes_per_slot`` / ``page_bytes`` / ``describe()`` and
    allocation equal the JAX policy's exactly;
  - the slot functions on int8 caches (contiguous and paged, with
    adapters) against JAX: logits within 1e-5, codes within one step (see
    ``assert_int8_caches_close``) and scales within 1e-5 relative;
  - logits over an int8 cache within the JAX package's
    ``INT8_LOGITS_ATOL`` 0.15 of the model-dtype cache
    (``tests/test_kvcache.py:160-189``), the live cache at most 0.6x the
    fp32 cache's bytes;
  - the int8 engine's greedy tokens and integer state equal the JAX int8
    engine's tick by tick (contiguous, and paged with the prefix cache);
    int8 with prefix + chunked prefill (``tests/test_kvcache.py:590``),
    with speculation, and through the CLI with adapters.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.models import lora as jlora
from building_llm_from_scratch_tpu.models import transformer as jtf
from building_llm_from_scratch_tpu.ops.attention import (
    decode_attention as jax_decode_attention,
)
from building_llm_from_scratch_tpu.ops.decode_step import (
    quantize_kv as jax_quantize_kv,
)
from building_llm_from_scratch_tpu.serving import DecodeEngine as JEngine
from building_llm_from_scratch_tpu.serving.adapters import (
    AdapterRegistry as JReg,
)
from building_llm_from_scratch_tpu.serving.kvcache import (
    KVCachePolicy as JPolicy,
)
from building_llm_from_scratch_tpu_torch.configs import get_config
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.ops.attention import decode_attention
from building_llm_from_scratch_tpu_torch.ops.decode_step import (
    dequantize_kv,
    quantize_kv,
)
from building_llm_from_scratch_tpu_torch.serving.adapters import AdapterRegistry
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.kvcache import (
    KVCachePolicy,
    cache_is_quantized,
    cache_nbytes,
)
from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    params_from_jax,
)
from torch_port_helpers import (
    assert_engines_agree,
    bits,
    jax_params,
    small_configs,
    traffic,
)

ATOL = 1e-5
#: the JAX slot functions, compiled once per cache structure (eager
#: dispatch of two layers' ops costs seconds a call)
_JIT = {name: jax.jit(getattr(jtf, name), static_argnums=(1,),
                      static_argnames=("cache_len",) if "paged" in name else ())
        for name in ("prefill_into_slot", "prefill_chunk_into_slot",
                     "decode_slots", "paged_prefill_chunk_into_slot",
                     "paged_decode_slots")}
#: the JAX package's pinned int8-vs-model-dtype logits bound
#: (tests/test_kvcache.py:164)
INT8_LOGITS_ATOL = 0.15
INT8 = dict(kv_quant="int8")
PAGED_INT8 = dict(kv_quant="int8", paged=True, page_tokens=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def small():
    """A LLaMA-like small model (GQA 4 / 2, head dim 32) in both packages."""
    jcfg, tcfg = small_configs("llama")
    params, np_params = jax_params(jcfg, seed=2)
    return jcfg, params, params_from_jax(np_params, tcfg, "cpu")


# ---------------------------------------------------------------------------
# quantize_kv and the scaled attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """Rows of assorted magnitudes, an all-zero row (scale EPS, codes 0)
    and rows built so x / scale lands on .5 ties (round-half-even in both):
    codes and scales bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 9, 32)).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 6, (3, 4, 9, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3] = np.arange(32, dtype=np.float32) - 15.5     # ties
    x[2, 1, 4, :4] = [127.0, 0.5, -1.5, 2.5]
    x[2, 1, 4, 4:] = 0.0
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    codes, scale = quantize_kv(tx)
    jcodes, jscale = jax_quantize_kv(jx)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == (3, 4, 9, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(bits(scale), bits(np.asarray(jscale)))
    assert (codes[0, 0, 0] == 0).all() and float(scale[0, 0, 0]) == np.float32(1e-8)
    # half a scale step, plus the fp32 rounding of codes * scale
    err = (dequantize_kv(codes, scale) - tx.float()).abs()
    amax = tx.float().abs().amax(-1, keepdim=True)
    assert (err <= amax * (1 / 254.0 + 2.0 ** -23) + 1e-7).all()


@pytest.mark.parametrize("per_row", [True, False])
def test_scaled_decode_attention_matches_jax(per_row):
    """GQA 8 / 2 over an int8 cache with scales, per-row (B, Tq) positions
    and lengths or shared (Tq,) ones: within 1e-5 of JAX, and of plain
    attention over the dequantized cache."""
    rng = np.random.default_rng(1)
    B, Tq, Hq, Hkv, T, D = 3, 4, 8, 2, 40, 16
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, Hkv, T, D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, (B, Hkv, T, 1)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (B, Hkv, T, 1)).astype(np.float32)
    if per_row:
        lens = np.array([5, 17, 36], np.int32)
        qpos = lens[:, None] + np.arange(Tq)[None, :]
        kv_len = lens + Tq
    else:
        qpos, kv_len = np.arange(20, 20 + Tq), np.int32(20 + Tq)
    t = torch.from_numpy
    out = decode_attention(t(q), t(k8), t(v8), q_positions=t(np.asarray(qpos)),
                           kv_length=t(np.asarray(kv_len)), k_scale=t(ks),
                           v_scale=t(vs))
    ref = jax_decode_attention(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                               q_positions=jnp.asarray(qpos),
                               kv_length=jnp.asarray(kv_len),
                               k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    deq = decode_attention(t(q), dequantize_kv(t(k8), t(ks)),
                           dequantize_kv(t(v8), t(vs)),
                           q_positions=t(np.asarray(qpos)),
                           kv_length=t(np.asarray(kv_len)))
    np.testing.assert_allclose(out.numpy(), deq.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [INT8, dict(INT8, prefix_cache=True, prefill_chunk=16),
                                PAGED_INT8, dict(PAGED_INT8, pool_pages=7)])
def test_policy_sizes_and_alloc_match_jax(kw):
    jcfg, tcfg = small_configs("llama", dtype="bf16")
    jp, tp = JPolicy(**kw), KVCachePolicy(**kw)
    assert tp.quantized and tp.describe() == jp.describe()
    assert tp.page_bytes(tcfg) == jp.page_bytes(jcfg)
    for length in (64, 61):
        assert tp.bytes_per_slot(tcfg, length) == jp.bytes_per_slot(jcfg, length)
    cache, ref = tp.alloc(tcfg, 3, 61, "cpu"), jp.alloc(jcfg, 3, 61)
    assert sorted(cache) == sorted(ref) == ["k", "k_scale", "v", "v_scale"]
    for name in cache:
        assert [tuple(a.shape) for a in cache[name]] == [b.shape for b in ref[name]]
        want = torch.float32 if name.endswith("_scale") else torch.int8
        assert all(a.dtype == want for a in cache[name])
    assert cache_is_quantized(cache) and not cache_is_quantized(
        KVCachePolicy().alloc(tcfg, 1, 8, "cpu"))
    if tp.paged:
        assert cache_nbytes(cache) == tp.total_pool_pages(3, 61) * tp.page_bytes(tcfg)
    else:
        assert cache_nbytes(cache) == 3 * tp.bytes_per_slot(tcfg, 61)["total_bytes"]


def test_int8_halves_bf16_kv_bytes_at_published_widths():
    """KV data bytes are exactly half of bf16's (a quarter of fp32's); with
    the scale sidecars the total is (hd + 4) / (2 hd) of bf16's."""
    int8, model = KVCachePolicy(kv_quant="int8"), KVCachePolicy()
    for name, size, dt in (("GPT2", "124M", "fp32"), ("llama3_2", "1B", "bf16")):
        cfg = get_config(name, size, dtype=dt)
        b8 = int8.bytes_per_slot(cfg, 1024)
        bm = model.bytes_per_slot(cfg, 1024)
        width = 4 if dt == "fp32" else 2
        assert b8["kv_bytes"] * width == bm["kv_bytes"]
        hd = cfg.head_dim
        assert b8["total_bytes"] * width * hd == bm["total_bytes"] * (hd + 4)
    with pytest.raises(ValueError, match="kv_quant"):
        KVCachePolicy(kv_quant="fp8")


# ---------------------------------------------------------------------------
# the slot functions on int8 caches against JAX
# ---------------------------------------------------------------------------

def int8_state(jcfg, policy: dict, n_rows, length, seed=0):
    """The same random int8 cache (codes and positive scales) in both
    packages."""
    jc = jtf.init_slot_cache(jcfg, n_rows, length, policy=JPolicy(**policy))
    rng = np.random.default_rng(seed)
    out = {name: [rng.uniform(0.005, 0.05, b.shape).astype(np.float32)
                  if name.endswith("_scale")
                  else rng.integers(-127, 128, b.shape).astype(np.int8)
                  for b in bufs] for name, bufs in jc.items()}
    return ({k: [jnp.asarray(a) for a in v] for k, v in out.items()},
            {k: [torch.from_numpy(a.copy()) for a in v] for k, v in out.items()})


def assert_int8_caches_close(tc, jc):
    """Scales within 1e-5 relative; codes equal except where the two
    packages' fp32 k / v (within ~1e-6 of each other: the same products
    summed in another order) put x / scale within that distance of a .5
    rounding tie, where a code may move by one. A code off by one is a
    change of one scale step in one element, which the logits bound
    absorbs; more than one step, or more than 0.5% of the codes, is a
    fault. (On this model no code differed when the bound was set.)"""
    for name in ("k_scale", "v_scale"):
        for a, b in zip(tc[name], jc[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ATOL, atol=0)
    for name in ("k", "v"):
        for a, b in zip(tc[name], jc[name]):
            d = np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 5e-3, (name, d.max(),
                                                               (d > 0).mean())


def test_contiguous_slot_functions_on_int8_match_jax(small):
    """prefill_into_slot, three chunks of prefill_chunk_into_slot and a
    decode_slots tick on one int8 cache, then verify_slots: logits within
    1e-5 of JAX at each step, and the caches as ``assert_int8_caches_close``
    says."""
    jcfg, params, model = small
    jc, tc = int8_state(jcfg, INT8, 3, 64)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (1, 32))
    jl, jc = _JIT["prefill_into_slot"](params, jcfg, jnp.asarray(tokens, jnp.int32),
                                   jnp.int32(27), jnp.int32(2), jc)
    tl = ttf.prefill_into_slot(model, torch.from_numpy(tokens), 27, 2, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    prompt = rng.integers(0, 512, 21)
    for lo in range(0, 21, 8):
        chunk = np.zeros((1, 8), np.int64)
        chunk[0, :len(prompt[lo:lo + 8])] = prompt[lo:lo + 8]
        jl, jc = _JIT["prefill_chunk_into_slot"](
            params, jcfg, jnp.asarray(chunk, jnp.int32), jnp.int32(lo),
            jnp.int32(21), jnp.int32(0), jc)
        tl = ttf.prefill_chunk_into_slot(model, torch.from_numpy(chunk), lo, 21,
                                         0, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    toks = np.array([[5], [17], [300]], np.int64)
    lens = np.array([21, 40, 27], np.int32)
    jl, jc = _JIT["decode_slots"](params, jcfg, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(lens), jc)
    tl = ttf.decode_slots(model, torch.from_numpy(toks), torch.from_numpy(lens), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert_int8_caches_close(tc, jc)


def test_paged_slot_functions_on_int8_match_jax(small):
    """paged_prefill_chunk_into_slot and paged_decode_slots on an int8
    pool whose rows share a page: codes and scale pages land at the same
    pool rows as JAX's."""
    jcfg, params, model = small
    jc, tc = int8_state(jcfg, PAGED_INT8, 3, 64, seed=2)
    table = np.array([[3, 4, 0, 0, 0, 0, 0, 0], [3, 6, 7, 0, 0, 0, 0, 0],
                      [1, 2, 0, 0, 0, 0, 0, 0]], np.int32)
    prompt = np.random.default_rng(3).integers(0, 512, (1, 16))
    jl, jc = _JIT["paged_prefill_chunk_into_slot"](
        params, jcfg, jnp.asarray(prompt, jnp.int32), jnp.int32(8),
        jnp.int32(21), jnp.int32(1), jnp.asarray(table), jc, cache_len=64)
    tl = ttf.paged_prefill_chunk_into_slot(
        model, torch.from_numpy(prompt), 8, 21, torch.from_numpy(table[1:2]),
        tc, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    toks = np.array([[7], [9], [11]], np.int64)
    lens = np.array([12, 21, 5], np.int32)
    jl, jc = _JIT["paged_decode_slots"](
        params, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(lens),
        jnp.asarray(table), jc, cache_len=64)
    tl = ttf.paged_decode_slots(model, torch.from_numpy(toks),
                                torch.from_numpy(lens), torch.from_numpy(table),
                                tc, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert_int8_caches_close(tc, jc)


def test_int8_decode_logits_within_the_pinned_tolerance(small):
    """The same prompt prefilled into a model-dtype cache and an int8 one
    (through the real prefill path), then one decode tick on each: logits
    within INT8_LOGITS_ATOL, and different (the quantization ran)."""
    _, _, model = small
    prompt = torch.arange(2, 42)[None]
    out = {}
    for name, kw in (("model", {}), ("int8", INT8)):
        cache = ttf.init_slot_cache(model.cfg, 2, 64, "cpu",
                                    policy=KVCachePolicy(**kw))
        padded = torch.zeros((1, 64), dtype=torch.long)
        padded[:, :40] = prompt
        ttf.prefill_into_slot(model, padded, 40, 0, cache)
        out[name] = ttf.decode_slots(model, torch.tensor([[5], [0]]),
                                     torch.tensor([40, 0], dtype=torch.int32),
                                     cache)[0]
    delta = (out["int8"] - out["model"]).abs().max().item()
    assert torch.isfinite(out["int8"]).all() and 0 < delta <= INT8_LOGITS_ATOL


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [
    INT8, dict(PAGED_INT8, prefix_cache=True)], ids=["contiguous", "paged-prefix"])
def test_int8_engine_equals_the_jax_int8_engine(small, policy):
    """Seven requests over three slots (five behind a shared prefix): greedy
    tokens and the integer state (lengths, page table, pool and prefix-store
    counters) equal the JAX int8 engine's after every tick; the live cache
    is at most 0.6x an fp32 cache's bytes."""
    jcfg, params, model = small
    eng = assert_engines_agree(jcfg, params, model, policy, traffic(512))
    fp32 = KVCachePolicy(**{k: v for k, v in policy.items() if k != "kv_quant"})
    fp32_bytes = cache_nbytes(fp32.alloc(model.cfg, 3, 64, "cpu"))
    assert cache_nbytes(eng.cache) <= 0.6 * fp32_bytes
    parts = eng.stats()["kv_bytes"]
    assert sum(parts.values()) == cache_nbytes(eng.cache)
    if not policy.get("paged"):
        assert parts["kv_scales"] * model.cfg.head_dim == parts["slot_kv"] * 4


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_plus_int8_compose(small, paged):
    """int8 + prefix cache + chunked prefill (``tests/test_kvcache.py:590``):
    a stored prefix holds int8 codes and fp32 scales (a pane copy, or with
    pages the shared code and scale pages), sharers hit it, and a hit
    reproduces the miss path's tokens exactly."""
    _, _, model = small
    policy = KVCachePolicy(kv_quant="int8", prefill_chunk=16, prefix_cache=True,
                           paged=paged, page_tokens=8,
                           prefix_budget_bytes=8 << 20)
    eng = DecodeEngine(model, n_slots=2, max_len=128, warmup_prompt_cap=64,
                       kv_policy=policy)
    rng = np.random.default_rng(0)
    prefix = rng.integers(2, 512, 40)
    prompts = [np.concatenate([prefix, rng.integers(2, 512, 2 + i)]).astype(np.int32)
               for i in range(3)]
    sp = SamplingParams(max_new_tokens=4, ignore_eos=True, seed=1)
    h0 = eng.submit(prompts[0], sp)
    eng.run_until_idle()
    hs = [eng.submit(p, sp) for p in prompts[1:]]
    eng.run_until_idle()
    assert all(h.finish_reason == "length" and len(h.output_ids) == 4
               for h in [h0] + hs)
    assert eng.prefix_store.stats()["hits"] >= 2
    entry = next(iter(eng.prefix_store._entries.values()))
    if paged:
        assert entry.panes is None and entry.pages
        scales = eng.cache["k_scale"][0][torch.tensor(entry.pages)]
        assert (scales > 0).all()           # the stored span's scale pages
    else:
        assert entry.panes["k"].dtype == torch.int8
        assert entry.panes["k_scale"].dtype == torch.float32
    again = eng.submit(prompts[0], sp)
    eng.run_until_idle()
    assert again.output_ids == h0.output_ids


def test_int8_composes_with_speculation(small):
    """spec x int8 (``tests/test_spec.py:278``): quantize-on-write covers the
    k+1 candidates; tokens equal the int8 spec-off engine's, greedy and
    sampled rows."""
    _, _, model = small
    reqs = traffic(512)

    def run(spec_k):
        eng = DecodeEngine(model, n_slots=3, max_len=64, spec_k=spec_k,
                           kv_policy=KVCachePolicy(kv_quant="int8"))
        hs = [eng.submit(p, sp) for p, sp in reqs]
        eng.run_until_idle()
        return [h.output_ids for h in hs], eng.stats()

    off, _ = run(0)
    on, st = run(4)
    assert on == off and st["spec_tokens_drafted"] > 0


def test_serve_cli_int8_with_adapters_matches_jax_frontend(tmp_path):
    """``--serve_kv_quant int8 --serve_adapters`` through the port's CLI (the
    contiguous tick: the plain int8 attention with B6's twin on the
    projections) gives the JAX JSONL frontend's tokens over a JAX int8
    engine with the same registry."""
    from building_llm_from_scratch_tpu.configs import get_config as jget_config
    from building_llm_from_scratch_tpu.models import init_params as jinit
    from building_llm_from_scratch_tpu.serving.frontend import (
        serve_jsonl as jax_serve_jsonl,
    )
    from building_llm_from_scratch_tpu.training import checkpoint as jckpt
    from building_llm_from_scratch_tpu_torch import main as tmain

    jcfg = jget_config("llama3_2", "1B", dtype="fp32", debug=True)
    params = jinit(jcfg, jax.random.PRNGKey(6))
    export = str(tmp_path / "init.npz")
    jckpt.export_params(export, params)
    rng = np.random.default_rng(1)
    lora = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jlora.init_lora_params(jcfg, params, jax.random.PRNGKey(2), rank=4))
    art = str(tmp_path / "a.npz")
    jlora.save_adapter(art, lora, rank=4, alpha=8.0, cfg=jcfg)
    recs = [{"prompt_ids": rng.integers(0, 200, 4 + i).tolist(),
             "max_new_tokens": 6, "ignore_eos": True,
             **({"adapter": "a"} if i % 2 else {})} for i in range(4)]
    src = tmp_path / "req.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs))
    eng = tmain.run([
        "--mode", "serve", "--model", "llama3_2", "--num_params", "1B",
        "--debug", "--data_type", "fp32", "--init_params_from", export,
        "--serve_prompts", str(src), "--serve_slots", "2", "--device", "cpu",
        "--serve_out", str(tmp_path / "t.jsonl"), "--serve_kv_quant", "int8",
        "--serve_adapters", f"a={art}"])
    jeng = JEngine(jcfg, params, n_slots=2, watch_compiles=False,
                   kv_policy=JPolicy(kv_quant="int8"),
                   adapters=JReg.from_artifacts(jcfg, params, {"a": art}))
    jeng.start()
    try:
        jout = jax_serve_jsonl(jeng, str(src), None, default_max_new=4)
    finally:
        jeng.shutdown()
    out = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["token_ids"] for r in out] == [r["token_ids"] for r in jout]
    assert eng.stats()["kv_policy"]["kv_quant"] == "int8"
    assert eng.cache["k"][0].dtype == torch.int8
    assert isinstance(eng.adapters, AdapterRegistry)
