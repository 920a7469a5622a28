"""Multi-tenant LoRA serving in the port (``serving/adapters.py``, the
engine's adapter path, ``--serve_adapters``) against the JAX package on
the same weights and the same adapter artifacts:

  - the registry's refusals (fingerprint, capacity, rank, duplicate name,
    the reserved ``base``, bad names), rank zero-padding and the pool bit
    for bit against the JAX registry's, fresh load tags on reload;
  - the engine with three adapters (ranks 4, 8, 2) and base traffic
    co-batched, greedy and seeded-sampled, on the default policy and on
    paged KV with the prefix cache: greedy tokens and the integer state
    (lengths, page table, store and pool counters) equal the JAX engine's
    after every tick, fp32; per-adapter counts equal; an adapted request
    equals the port's base engine serving ``merge_lora`` weights;
  - isolation and hot paths: co-batched equals alone, hot-load and evict
    under the running engine fail nothing in flight, a request evicted
    while queued fails alone, a row in use is not reused;
  - prefix namespacing: an adapter never hits panes stored by base or by
    another adapter, ``replace`` makes the old panes miss;
  - the ``--serve_adapters`` CLI against the JAX JSONL frontend's tokens.

Sampled requests draw from the port's own random stream, so their tokens
differ from JAX's; they are held by their lengths and by alone =
co-batched.
"""

import json

import jax
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.models import lora as jlora
from building_llm_from_scratch_tpu.serving import AdapterRegistry as JReg
from building_llm_from_scratch_tpu.serving import DecodeEngine as JEngine
from building_llm_from_scratch_tpu.serving import SamplingParams as JParams
from building_llm_from_scratch_tpu.serving.kvcache import (
    KVCachePolicy as JPolicy,
)
from building_llm_from_scratch_tpu_torch.models import lora as tlora
from building_llm_from_scratch_tpu_torch.models.transformer import Transformer
from building_llm_from_scratch_tpu_torch.serving.adapters import (
    AdapterMismatchError,
    AdapterRegistry,
    AdapterRegistryFullError,
)
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.frontend import (
    parse_adapter_specs,
    serve_jsonl,
)
from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy
from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    params_from_jax,
)
from torch_port_helpers import (
    bits,
    engine_state,
    jax_params,
    make_jax_lora,
    small_configs,
)

RANKS = [("a", 4, 8.0), ("b", 8, 16.0), ("c", 2, 3.0)]
PAGED_PREFIX = dict(paged=True, page_tokens=8, prefill_chunk=16,
                    prefix_cache=True)


def write_adapter(path, jcfg, params, seed, rank, alpha=None):
    jlora.save_adapter(str(path), make_jax_lora(jcfg, params, seed, rank),
                       rank=rank, alpha=alpha or 2.0 * rank, cfg=jcfg)
    return str(path)


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def base(request, tmp_path_factory):
    """Both packages' models on the same weights and artifacts a, b, c."""
    jcfg, tcfg = small_configs(request.param)
    params, np_params = jax_params(jcfg, seed=7)
    d = tmp_path_factory.mktemp(f"adapters-{request.param}")
    specs = {name: write_adapter(d / f"{name}.npz", jcfg, params, 10 + i,
                                 rank, alpha)
             for i, (name, rank, alpha) in enumerate(RANKS)}
    return dict(jcfg=jcfg, params=params, tcfg=tcfg, specs=specs, dir=d,
                model=params_from_jax(np_params, tcfg, "cpu"))


def registries(b, capacity=5):
    return (JReg.from_artifacts(b["jcfg"], b["params"], b["specs"],
                                capacity=capacity),
            AdapterRegistry.from_artifacts(b["tcfg"], b["specs"],
                                           capacity=capacity, device="cpu"))


def traffic(vocab, seed=0, names=(None, "a", "b", "c", "a", None, "b", "c")):
    """Co-batched requests over the adapters and base, every odd one
    sampled; five share a 20-token prefix (for the prefix store)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 20)
    out = []
    for i, nm in enumerate(names):
        tail = rng.integers(0, vocab, 4 + i % 5)
        p = np.concatenate([prefix, tail]) if i % 3 else tail
        out.append((p.astype(np.int32), SamplingParams(
            max_new_tokens=6 + i % 4, ignore_eos=True, seed=i,
            temperature=0.8 if i % 2 else 0.0, top_k=8 if i % 2 else None,
            adapter=nm)))
    return out


def jax_submit(eng, p, sp):
    return eng.submit(p, JParams(max_new_tokens=sp.max_new_tokens,
                                 temperature=sp.temperature, top_k=sp.top_k,
                                 seed=sp.seed, ignore_eos=sp.ignore_eos,
                                 adapter=sp.adapter))


def state(eng):
    out = engine_state(eng)
    out["adapter_ids"] = np.asarray(eng._adapter_ids).tolist()
    return out


def run_both(b, policy, reqs, n_slots=4):
    """Both engines with registries from the same artifacts, stepped to
    idle; the integer state equal after every tick, greedy tokens equal.
    Returns (port engine, its handles, JAX engine, its handles)."""
    jreg, treg = registries(b)
    jeng = JEngine(b["jcfg"], b["params"], n_slots=n_slots, max_len=64,
                   watch_compiles=False, warmup_prompt_cap=32,
                   kv_policy=JPolicy(**policy), adapters=jreg)
    eng = DecodeEngine(b["model"], n_slots=n_slots, max_len=64,
                       warmup_prompt_cap=32, kv_policy=KVCachePolicy(**policy),
                       adapters=treg)
    jh = [jax_submit(jeng, p, sp) for p, sp in reqs]
    th = [eng.submit(p, sp) for p, sp in reqs]
    ticks = 0
    while True:
        more = eng.step()
        assert jeng.step() == more
        assert state(eng) == state(jeng), f"tick {ticks}"
        ticks += 1
        if not more:
            break
    for (_, sp), h, j in zip(reqs, th, jh):
        assert h.finish_reason == j.finish_reason == "length"
        assert len(h.output_ids) == sp.max_new_tokens
        if sp.temperature == 0:
            assert h.output_ids == j.output_ids, sp
    return eng, th, jeng, jh


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_refusals(base, tmp_path):
    b = base
    jcfg, tcfg, params = b["jcfg"], b["tcfg"], b["params"]
    paths = {name: write_adapter(tmp_path / f"{name}.npz", jcfg, params, 40 + i,
                                 rank, 4.0)
             for i, (name, rank) in enumerate([("r1", 2), ("r2", 2), ("big", 16)])}
    reg = AdapterRegistry(tcfg, capacity=2, max_rank=8, device="cpu")
    assert reg.load("r1", paths["r1"]) == 0
    with pytest.raises(ValueError, match="already loaded"):
        reg.load("r1", paths["r1"])
    with pytest.raises(ValueError, match="max_rank"):
        reg.load("big", paths["big"])
    assert reg.load("r2", paths["r2"]) == 1
    with pytest.raises(AdapterRegistryFullError):
        reg.load("r3", paths["r1"])
    for bad in ('ten"ant', "a b", "x{y}", "", "-lead"):
        with pytest.raises(ValueError, match="invalid"):
            reg.load(bad, paths["r1"])
    with pytest.raises(ValueError, match="reserved"):
        AdapterRegistry(tcfg, capacity=2, max_rank=8, device="cpu").load(
            "base", paths["r1"])
    with pytest.raises(KeyError):
        reg.evict("nope")
    assert reg.evict("r1") == 0
    assert reg.lookup("r1") is None and reg.lookup("r2") == 1
    assert reg.load("r1b", paths["r1"]) == 0          # nothing in use
    # an adapter of another base architecture
    ojcfg, otcfg = small_configs("llama" if jcfg.n_kv_groups == jcfg.n_heads
                                 else "gpt2")
    oparams, _ = jax_params(ojcfg)
    other = write_adapter(tmp_path / "other.npz", ojcfg, oparams, 3, 4)
    with pytest.raises(AdapterMismatchError):
        reg.load("other", other)
    np.savez(str(tmp_path / "plain.npz"), foo=np.zeros(3))
    with pytest.raises(ValueError, match="not an adapter artifact"):
        reg.load("plain", str(tmp_path / "plain.npz"))
    assert reg.stats()["n_loaded"] == 2
    with pytest.raises(ValueError):
        AdapterRegistry(tcfg, capacity=0, device="cpu")


def test_registry_pool_matches_jax_with_rank_padding_and_tags(base):
    b = base
    jreg, treg = registries(b, capacity=4)
    assert (treg.capacity, treg.max_rank) == (jreg.capacity, jreg.max_rank) == (4, 8)
    pool, scaling = treg.pool_args()
    jpool, jscaling = jreg.pool_args()
    jflat = {tuple(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jax.device_get(jpool))[0]}
    flat = tlora.flatten_lora(pool)
    assert list(flat) == list(jflat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(bits(leaf), bits(jflat[path]))
    np.testing.assert_array_equal(scaling.numpy(), np.asarray(jscaling))
    # rank 2 'c' in the rank-8 pool: its A/B beyond rank 2 are zero
    c = treg.lookup("c")
    lora, meta = tlora.load_adapter(b["specs"]["c"])
    a = flat[("blocks", "attn", "wq", "A")][c]
    assert torch.equal(a[..., :2], lora["blocks"]["attn"]["wq"]["A"])
    assert not a[..., 2:].any()
    assert not flat[("head", "weight", "B")][c][2:].any()
    assert scaling[c].item() == meta["alpha"] / meta["rank"]
    assert treg.stats() == jreg.stats()
    assert treg.pool_nbytes() == jreg.pool_nbytes()
    # a reload gets a new tag; evict frees the name, never the weights
    tag = treg.load_tag("a")
    row = treg.evict("a")
    assert treg.load_tag("a") is None
    assert torch.equal(flat[("blocks", "attn", "wq", "A")][row],
                       tlora.flatten_lora(pool)[("blocks", "attn", "wq", "A")][row])
    treg.replace("a", b["specs"]["a"])
    assert treg.load_tag("a") not in (None, tag)
    with pytest.raises(KeyError, match="not loaded"):
        treg.resolve("zzz")


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [{}, PAGED_PREFIX], ids=["default", "paged-prefix"])
def test_engine_matches_jax_engine(base, policy):
    eng, th, jeng, _ = run_both(base, policy, traffic(base["tcfg"].vocab_size))
    st, jst = eng.stats(), jeng.stats()
    assert st["per_adapter"] == jst["per_adapter"]
    assert st["adapters_loaded"] == jst["adapters_loaded"] == 3
    assert {k: v["finished"] for k, v in st["per_adapter"].items()} == \
        {"a": 2, "b": 2, "c": 2, "base": 2}
    if policy:
        assert st["prefix_store"]["hits"] >= 1
        assert st["page_pool"]["reserved"] == 0


def test_adapted_request_equals_merged_weights(base):
    """Greedy, fp32: a request of adapter 'b' through the pool equals the
    port's base engine serving merge_lora(params, b) weights."""
    b = base
    _, treg = registries(b)
    reqs = [r for r in traffic(b["tcfg"].vocab_size) if r[1].temperature == 0]
    eng = DecodeEngine(b["model"], n_slots=4, max_len=64, adapters=treg)
    handles = [eng.submit(p, sp) for p, sp in reqs]
    eng.run_until_idle()
    lora, meta = tlora.load_adapter(b["specs"]["b"])
    merged = Transformer(b["tcfg"], tlora.merge_lora(
        b["model"].flat_params(), lora, meta["alpha"], meta["rank"]))
    plain = DecodeEngine(merged, n_slots=4, max_len=64)
    n = 0
    for (p, sp), h in zip(reqs, handles):
        if sp.adapter != "b":
            continue
        m = plain.submit(p, SamplingParams(max_new_tokens=sp.max_new_tokens,
                                           ignore_eos=True))
        plain.run_until_idle()
        assert m.output_ids == h.output_ids
        n += 1
    assert n == 2


def test_cobatched_equals_alone(base):
    """Isolation: a request's tokens (greedy and sampled) are the same
    alone as co-batched with other adapters' traffic."""
    b = base
    _, treg = registries(b)
    reqs = traffic(b["tcfg"].vocab_size, seed=3)
    eng = DecodeEngine(b["model"], n_slots=4, max_len=64, adapters=treg)
    handles = [eng.submit(p, sp) for p, sp in reqs]
    eng.run_until_idle()
    for i in (1, 2, 3):               # a sampled, b greedy, c sampled
        solo = DecodeEngine(b["model"], n_slots=4, max_len=64, adapters=treg)
        h = solo.submit(*reqs[i])
        solo.run_until_idle()
        assert h.output_ids == handles[i].output_ids


def test_hot_load_and_evict_under_a_running_engine(base, tmp_path):
    b = base
    _, treg = registries(b)
    eng = DecodeEngine(b["model"], n_slots=2, max_len=64, max_queue=64,
                       adapters=treg)
    eng.start()
    try:
        rng = np.random.default_rng(1)
        handles = [eng.submit(rng.integers(0, 500, 5).astype(np.int32),
                              SamplingParams(max_new_tokens=12, ignore_eos=True,
                                             seed=i, adapter="a" if i % 2 else None))
                   for i in range(10)]
        hot = write_adapter(tmp_path / "hot.npz", b["jcfg"], b["params"], 77, 4)
        treg.load("hot", hot)
        prompt = rng.integers(0, 500, 5).astype(np.int32)
        sp = SamplingParams(max_new_tokens=8, ignore_eos=True, seed=99,
                            adapter="hot")
        h_hot = eng.submit(prompt, sp)
        treg.evict("b")
        for h in handles:
            h.result(timeout=60)
            assert h.finish_reason == "length", h.error
        h_hot.result(timeout=60)
        with pytest.raises(ValueError, match="not loaded"):
            eng.submit(prompt, SamplingParams(adapter="b"))
    finally:
        eng.shutdown()
    lora, meta = tlora.load_adapter(hot)
    merged = Transformer(b["tcfg"], tlora.merge_lora(
        b["model"].flat_params(), lora, meta["alpha"], meta["rank"]))
    plain = DecodeEngine(merged, n_slots=2, max_len=64)
    m = plain.submit(prompt, SamplingParams(max_new_tokens=8, ignore_eos=True,
                                            seed=99))
    plain.run_until_idle()
    assert m.output_ids == h_hot.output_ids


def test_registry_churn_beside_a_running_engine(base, tmp_path):
    """Stress: one thread evicts and reloads another adapter 20 times, with
    a 10-microsecond switch interval, while the engine thread serves 'a';
    every 'a' request still gives its solo tokens (a load never writes a
    row an active slot reads) and the registry ends consistent."""
    import sys
    import threading

    b = base
    _, treg = registries(b)
    prompts = [np.arange(5, dtype=np.int32) + 3 * i for i in range(6)]
    sp = SamplingParams(max_new_tokens=6, ignore_eos=True, adapter="a")
    solo = DecodeEngine(b["model"], n_slots=2, max_len=64, adapters=treg)
    want = []
    for p in prompts:
        h = solo.submit(p, sp)
        solo.run_until_idle()
        want.append(h.output_ids)
    other = write_adapter(tmp_path / "x.npz", b["jcfg"], b["params"], 55, 8)
    eng = DecodeEngine(b["model"], n_slots=2, max_len=64, adapters=treg)

    def churn():
        for _ in range(20):
            treg.replace("x", other)
            treg.evict("x")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        t = threading.Thread(target=churn)
        t.start()
        handles = [eng.submit(p, sp) for p in prompts]
        t.join(timeout=120)
        assert not t.is_alive()
        got = [h.result(timeout=120).output_ids for h in handles]
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()
    assert got == want
    st = treg.stats()
    assert (st["n_loaded"], st["n_evicts"]) == (3, 20)
    assert sorted(st["adapters"]) == ["a", "b", "c"]


def test_evicted_while_queued_fails_alone(base):
    b = base
    _, treg = registries(b)
    eng = DecodeEngine(b["model"], n_slots=1, max_len=64, max_queue=8,
                       kv_policy=KVCachePolicy(**PAGED_PREFIX), adapters=treg)
    prompt = np.arange(4, dtype=np.int32) + 2
    doomed = eng.submit(prompt, SamplingParams(max_new_tokens=4,
                                               ignore_eos=True, adapter="a"))
    survivor = eng.submit(prompt, SamplingParams(max_new_tokens=4,
                                                 ignore_eos=True))
    treg.evict("a")
    eng.run_until_idle()
    with pytest.raises(RuntimeError, match="adapter_not_loaded"):
        doomed.result(timeout=10)
    assert survivor.result(timeout=10).finish_reason == "length"
    st = eng.stats()
    assert st["per_adapter"]["a"] == {"finished": 0, "failed": 1, "tokens": 0}
    assert st["page_pool"]["reserved"] == 0 and st["page_pool"]["used"] == 0


def test_row_in_use_is_not_reused(base, tmp_path):
    b = base
    _, treg = registries(b)       # capacity 5: rows 0-2 loaded, 3-4 free
    eng = DecodeEngine(b["model"], n_slots=1, max_len=64, adapters=treg)
    h = eng.submit(np.arange(4, dtype=np.int32) + 2,
                   SamplingParams(max_new_tokens=50, ignore_eos=True, adapter="a"))
    assert eng.step()             # admitted: slot 0 references row 0
    treg.evict("a")
    for i, name in enumerate(["x1", "x2"]):
        p = write_adapter(tmp_path / f"{name}.npz", b["jcfg"], b["params"],
                          200 + i, 2)
        assert treg.load(name, p) != 0
    with pytest.raises(AdapterRegistryFullError, match="referenced"):
        treg.load("x3", p)
    eng.run_until_idle()
    h.result(timeout=30)
    assert treg.load("x3", p) == 0


def test_engine_without_registry(base):
    eng = DecodeEngine(base["model"], n_slots=2, max_len=64)
    with pytest.raises(ValueError, match="no adapter registry"):
        eng.submit([1, 2, 3], SamplingParams(adapter="a"))
    h = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=3, ignore_eos=True))
    eng.run_until_idle()
    assert len(h.output_ids) == 3 and "adapters_loaded" not in eng.stats()


# ---------------------------------------------------------------------------
# prefix namespacing
# ---------------------------------------------------------------------------

def test_prefix_store_is_namespaced_per_install(base):
    """One 32-token prompt under base, 'a', 'b', then 'a' again: only the
    second 'a' hits; after ``replace('a')`` the old panes miss. The store's
    counters equal the JAX engine's throughout."""
    b = base
    jreg, treg = registries(b)
    pol = dict(prefill_chunk=16, prefix_cache=True)
    jeng = JEngine(b["jcfg"], b["params"], n_slots=2, max_len=64,
                   watch_compiles=False, warmup_prompt_cap=32,
                   kv_policy=JPolicy(**pol), adapters=jreg)
    eng = DecodeEngine(b["model"], n_slots=2, max_len=64, warmup_prompt_cap=32,
                       kv_policy=KVCachePolicy(**pol), adapters=treg)
    prompt = np.random.default_rng(5).integers(0, 500, 36).astype(np.int32)
    hits = []
    for name in (None, "a", "b", "a", "replace", "a"):
        if name == "replace":
            jreg.replace("a", b["specs"]["a"])
            treg.replace("a", b["specs"]["a"])
            continue
        sp = SamplingParams(max_new_tokens=3, ignore_eos=True, adapter=name)
        h, jh = eng.submit(prompt, sp), jax_submit(jeng, prompt, sp)
        eng.run_until_idle()
        jeng.run_until_idle()
        assert h.output_ids == jh.output_ids
        st, jst = state(eng)["prefix_store"], state(jeng)["prefix_store"]
        assert st == jst
        hits.append(st["hits"])
    assert hits == [0, 0, 0, 1, 1]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_adapters_cli_matches_jax_frontend(tmp_path):
    """The port's ``main.run --mode serve --serve_adapters a=...,b=...`` on a
    JSONL file with ``adapter`` fields gives the tokens of the JAX JSONL
    frontend (``serve_jsonl`` over a JAX engine with a registry from the
    same artifacts) on the same exported weights. The JAX CLI itself is not
    run: its serve mode loads a tokenizer the repository does not hold."""
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
    specs = {n: write_adapter(tmp_path / f"{n}.npz", jcfg, params, 20 + i, r)
             for i, (n, r) in enumerate([("a", 4), ("b", 2)])}
    rng = np.random.default_rng(0)
    recs = [{"prompt_ids": rng.integers(0, 200, 5 + i).tolist(),
             "max_new_tokens": 4 + i, "ignore_eos": True, "adapter": nm}
            for i, nm in enumerate(["a", None, "b", "a"])]
    src = tmp_path / "req.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs))
    eng = tmain.run([
        "--mode", "serve", "--model", "llama3_2", "--num_params", "1B",
        "--debug", "--data_type", "fp32", "--init_params_from", export,
        "--serve_prompts", str(src), "--serve_slots", "2",
        "--serve_max_len", "64", "--device", "cpu",
        "--serve_out", str(tmp_path / "t.jsonl"),
        "--serve_adapters", ",".join(f"{n}={p}" for n, p in specs.items())])
    jeng = JEngine(jcfg, params, n_slots=2, max_len=64, watch_compiles=False,
                   adapters=JReg.from_artifacts(jcfg, params, specs))
    jeng.start()
    try:
        jout = jax_serve_jsonl(jeng, str(src), None, default_max_new=4)
    finally:
        jeng.shutdown()
    out = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["token_ids"] for r in out] == [r["token_ids"] for r in jout]
    assert [r.get("adapter") for r in out] == ["a", None, "b", "a"]
    assert eng.stats()["adapters_loaded"] == 2
    assert eng.adapters.capacity == 3 and eng.adapters.max_rank == 4
    # an unknown adapter is refused at submit
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"prompt_ids": [1, 2], "adapter": "zzz"}) + "\n")
    with pytest.raises(ValueError, match="not loaded"):
        serve_jsonl(eng, str(bad), None, default_max_new=2)


def test_serve_adapters_flag_rules(tmp_path):
    from building_llm_from_scratch_tpu_torch.args import get_args

    req = tmp_path / "req.jsonl"
    req.write_text('{"prompt_ids": [1, 2, 3]}\n')
    art = tmp_path / "a.npz"
    art.write_bytes(b"")
    serve = ["--mode", "serve", "--serve_prompts", str(req)]
    args = get_args(serve + ["--serve_adapters", f"a={art}",
                             "--serve_adapter_slots", "3"])
    assert (args.serve_adapters, args.serve_adapter_slots) == (f"a={art}", 3)
    with pytest.raises(ValueError, match="require --mode serve"):
        get_args(["--mode", "train", "--data_dir", str(tmp_path),
                  "--byte_tokenizer", "--serve_adapters", f"a={art}"])
    with pytest.raises(FileNotFoundError):
        get_args(serve + ["--serve_adapters", f"a={tmp_path / 'no.npz'}"])
    with pytest.raises(ValueError, match="cannot hold"):
        get_args(serve + ["--serve_adapters", f"a={art},b={art}",
                          "--serve_adapter_slots", "1"])
    with pytest.raises(ValueError, match="twice"):
        parse_adapter_specs(f"a={art},a={art}")
    with pytest.raises(ValueError, match="name=path"):
        parse_adapter_specs("nopath")
    with pytest.raises(SystemExit):
        get_args(serve + ["--use_lora", "--lora_rank", "8"])
