"""Shared helpers of the ``test_torch_*`` files: small configs built from
both packages' registries, JAX-initialised weights, and numpy bridges.

Both packages run on the same weights (made by the JAX ``init_params``,
carried into the port by ``params_from_jax``) and the same numpy inputs."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from building_llm_from_scratch_tpu import configs as jcfgs
from building_llm_from_scratch_tpu.models import init_params as jax_init_params
from building_llm_from_scratch_tpu.models.lora import (
    init_lora_params as jax_init_lora,
)
from building_llm_from_scratch_tpu.serving import DecodeEngine as JEngine
from building_llm_from_scratch_tpu.serving import SamplingParams as JParams
from building_llm_from_scratch_tpu.serving.kvcache import (
    KVCachePolicy as JPolicy,
)
from building_llm_from_scratch_tpu_torch import configs as tcfgs
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy
from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams

# The tier-1 suite runs these files in several worker processes beside the
# JAX tests, some of which time their own ticks; torch's default of one
# intra-op thread per core in every worker oversubscribes the CPU.
torch.set_num_threads(min(2, torch.get_num_threads()))

SMALL = dict(emb_dim=128, n_heads=4, n_kv_groups=2, vocab_size=512,
             context_length=64, n_layers=2, hidden_dim=256, drop_rate=0.0)


def small_configs(kind: str, dtype: str = "fp32", **kw):
    """(jax_cfg, torch_cfg) for a GPT-2-like or LLaMA-like small model cut
    from the registries with ``replace``."""
    if kind == "gpt2":
        base = jcfgs.get_config("GPT2", "124M", dtype=dtype)
        small = dict(SMALL, n_kv_groups=SMALL["n_heads"])
    else:
        base = jcfgs.get_config("llama3_2", "1B", dtype=dtype)
        small = dict(SMALL)
    jcfg = base.replace(**{**small, **kw})
    return jcfg, to_torch_config(jcfg)


def to_torch_config(jcfg) -> tcfgs.ModelConfig:
    d = dataclasses.asdict(jcfg)
    if d["rope_scaling"] is not None:
        d["rope_scaling"] = tcfgs.RopeScaling(**d["rope_scaling"])
    return tcfgs.ModelConfig(**d)


def jax_params(jcfg, seed: int = 0):
    """The JAX params tree and its numpy copy."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return params, jax.device_get(params)


def make_jax_lora(jcfg, params, seed, rank):
    """A JAX adapter with NONZERO B (B = 0 at init would make every delta
    zero and every check vacuous), as the JAX tests' ``make_lora``."""
    lora = jax_init_lora(jcfg, params, jax.random.PRNGKey(seed), rank=rank)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 1000), a.shape, a.dtype), lora)


def bits(a) -> np.ndarray:
    """Raw bits of a numpy or torch array (bf16 included), for exact
    comparisons."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().view(np.dtype(f"u{t.element_size()}"))
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def to_np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def engine_state(eng) -> dict:
    """The integer state of a serving engine (either package's) after a
    tick: lengths, prefill frontiers, outputs so far, the paged bookkeeping
    and the prefix-store and page-pool counters."""
    out = {"lengths": np.asarray(eng._lengths).tolist(),
           "prefill": {s: st["pos"] for s, st in eng._prefill_state.items()},
           "slots": [None if r is None else len(r.output_ids)
                     for r in eng.scheduler.slots],
           "pane_copies": eng.pane_copies}
    if eng.page_pool is not None:
        out["page_table"] = np.asarray(eng._page_table).tolist()
        out["slot_cols"] = np.asarray(eng._slot_cols).tolist()
        out["pages_reserved"] = np.asarray(eng._pages_reserved).tolist()
        out["page_pool"] = eng.page_pool.stats()
    if eng.prefix_store is not None:
        st = eng.prefix_store.stats()
        out["prefix_store"] = {k: st[k] for k in (
            "entries", "bytes", "hits", "misses", "inserts", "evictions",
            "insert_skips", "pane_tokens")}
    return out


def run_stepwise(eng, requests, submit) -> tuple:
    """Submit ``requests`` ((prompt, params) pairs, ``submit(eng, p, sp)``
    makes the call) and step ``eng`` to idle; returns (handles, the
    engine state after every tick)."""
    handles = [submit(eng, p, sp) for p, sp in requests]
    states = []
    while eng.step():
        states.append(engine_state(eng))
    states.append(engine_state(eng))
    return handles, states


def traffic(vocab, seed=0):
    """Seven requests over three slots: five share a 24-token prefix, one
    shares none, one is sampled (its tokens differ between the packages'
    random streams; its lengths do not)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 24)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, n)])
               for n in (3, 9, 1, 17, 12)]
    prompts.insert(3, rng.integers(0, vocab, 21))
    prompts.append(np.concatenate([prefix[:20], rng.integers(0, vocab, 5)]))
    budgets = [6, 4, 8, 5, 7, 4, 6]
    return [(p.astype(np.int32), SamplingParams(
        max_new_tokens=m, ignore_eos=True, seed=i,
        temperature=0.8 if i == 4 else 0.0, top_k=8 if i == 4 else None))
        for i, (p, m) in enumerate(zip(prompts, budgets))]


def jax_submit(eng, p, sp):
    return eng.submit(p, JParams(max_new_tokens=sp.max_new_tokens,
                                 temperature=sp.temperature, top_k=sp.top_k,
                                 seed=sp.seed, ignore_eos=sp.ignore_eos))


def port_submit(eng, p, sp):
    return eng.submit(p, sp)


def assert_engines_agree(jcfg, params, model, policy: dict, reqs, n_slots=3,
                         max_len=64):
    """Both engines get the same requests; greedy tokens equal, and the
    integer state equal after every tick. Returns the port engine."""
    jeng = JEngine(jcfg, params, n_slots=n_slots, max_len=max_len,
                   watch_compiles=False, warmup_prompt_cap=32,
                   kv_policy=JPolicy(**policy))
    jh, jstates = run_stepwise(jeng, reqs, jax_submit)
    eng = DecodeEngine(model, n_slots=n_slots, max_len=max_len,
                       warmup_prompt_cap=32, kv_policy=KVCachePolicy(**policy))
    th, tstates = run_stepwise(eng, reqs, port_submit)
    assert len(tstates) == len(jstates)
    for i, (a, b) in enumerate(zip(tstates, jstates)):
        assert a == b, f"tick {i}"
    for (_, sp), h, j in zip(reqs, th, jh):
        assert len(h.output_ids) == sp.max_new_tokens
        assert h.finish_reason == j.finish_reason == "length"
        if sp.temperature == 0:
            assert h.output_ids == j.output_ids
    return eng
