"""The port's ``DecodeEngine`` vs the JAX package's on the same weights
(greedy tokens identical, eos included, more requests than slots), the
port's sampling properties (top-k membership, one seed gives one stream
whether alone or co-batched), queue-full rejection, and the JSONL
frontend."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from building_llm_from_scratch_tpu.models import transformer as jtf
from building_llm_from_scratch_tpu.serving import DecodeEngine as JEngine
from building_llm_from_scratch_tpu.serving import SamplingParams as JParams
from building_llm_from_scratch_tpu_torch.ops.decode_step import fused_decode_step
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.frontend import serve_jsonl
from building_llm_from_scratch_tpu_torch.serving.queue import QueueFullError
from building_llm_from_scratch_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_LENGTH,
    SamplingParams,
)
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    params_from_jax,
)
from torch_port_helpers import jax_params, small_configs

PROMPT_LENS = [3, 17, 40, 5, 9, 31, 12]
MAX_NEW = [12, 8, 10, 15, 6, 9, 11]


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def models(request):
    jcfg, tcfg = small_configs(request.param)
    params, np_params = jax_params(jcfg, seed=2)
    return jcfg, params, params_from_jax(np_params, tcfg, device="cpu")


def prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def run_port(model, reqs, n_slots=3):
    eng = DecodeEngine(model, n_slots=n_slots, max_len=64, max_queue=16)
    handles = [eng.submit(p, sp) for p, sp in reqs]
    eng.run_until_idle()
    return eng, handles


def test_greedy_tokens_match_jax_engine(models):
    jcfg, params, model = models
    ps = prompts(jcfg.vocab_size)
    plain = [SamplingParams(max_new_tokens=n) for n in MAX_NEW]
    _, first = run_port(model, list(zip(ps, plain)))
    # give request 3 an eos it reaches mid-stream (both engines must stop there)
    eos = first[3].output_ids[4]
    params_list = [SamplingParams(max_new_tokens=n, eos_id=eos if i == 3 else None)
                   for i, n in enumerate(MAX_NEW)]
    launches = fused_decode_step.launches
    eng, handles = run_port(model, list(zip(ps, params_list)))
    assert fused_decode_step.launches == launches      # CPU: no kernel launch

    jeng = JEngine(jcfg, params, n_slots=3, max_len=64, max_queue=16,
                   watch_compiles=False)
    jh = [jeng.submit(p, JParams(max_new_tokens=sp.max_new_tokens,
                                 eos_id=sp.eos_id))
          for p, sp in zip(ps, params_list)]
    jeng.run_until_idle()

    for h, j in zip(handles, jh):
        assert h.output_ids == j.output_ids
        assert h.finish_reason == j.finish_reason
    assert handles[3].finish_reason == FINISH_EOS
    assert handles[3].output_ids == first[3].output_ids[
        :first[3].output_ids.index(eos)]
    assert all(h.finish_reason == FINISH_LENGTH for i, h in enumerate(handles) if i != 3)
    assert eng.stats()["requests_finished"] == len(ps)


def test_sampling_in_top_k_and_seeded(models):
    jcfg, params, model = models
    ps = prompts(jcfg.vocab_size, seed=1)
    target = SamplingParams(max_new_tokens=10, temperature=1.0, top_k=5,
                            seed=7, ignore_eos=True)
    _, alone = run_port(model, [(ps[0], target)])
    others = [(p, SamplingParams(max_new_tokens=6, temperature=0.7, top_k=3,
                                 seed=i, ignore_eos=True))
              for i, p in enumerate(ps[1:4])]
    _, mixed = run_port(model, others[:2] + [(ps[0], target)] + others[2:])
    assert alone[0].output_ids == mixed[2].output_ids
    assert len(alone[0].output_ids) == 10

    # every sampled token lies in the top-5 of the reference logits at its
    # position (1e-4 slack for the two frameworks' fp32 rounding)
    seq = np.concatenate([ps[0], np.asarray(alone[0].output_ids, np.int32)])
    logits = np.asarray(jtf.forward(params, jcfg, jnp.asarray(seq)[None]))[0]
    Tp = len(ps[0])
    for i, tok in enumerate(alone[0].output_ids):
        row = logits[Tp - 1 + i]
        kth = np.sort(row)[-5]
        assert row[tok] >= kth - 1e-4

    # top_k=1 leaves one candidate: a sampled request equals greedy
    greedy = SamplingParams(max_new_tokens=8, ignore_eos=True)
    top1 = SamplingParams(max_new_tokens=8, temperature=0.9, top_k=1, seed=3,
                          ignore_eos=True)
    _, pair = run_port(model, [(ps[5], greedy), (ps[5], top1)])
    assert pair[0].output_ids == pair[1].output_ids

    # another seed gives another stream
    _, other = run_port(model, [(ps[0], SamplingParams(
        max_new_tokens=10, temperature=1.0, top_k=5, seed=8, ignore_eos=True))])
    assert other[0].output_ids != alone[0].output_ids


def test_queue_full_rejection(models):
    _, _, model = models
    eng = DecodeEngine(model, n_slots=1, max_len=64, max_queue=2)
    sp = SamplingParams(max_new_tokens=2)
    a, b = eng.submit([1, 2, 3], sp), eng.submit([4, 5], sp)
    with pytest.raises(QueueFullError):
        eng.submit([6], sp)
    assert eng.stats()["requests_rejected"] == 1
    eng.run_until_idle()
    assert a.done and b.done and len(a.output_ids) == len(b.output_ids) == 2
    # the queue drained: admission accepts again
    c = eng.submit([6], sp)
    eng.run_until_idle()
    assert c.done and eng.stats()["requests_finished"] == 3


def test_submit_validation(models):
    _, _, model = models
    eng = DecodeEngine(model, n_slots=1, max_len=64, max_top_k=8)
    with pytest.raises(ValueError):
        eng.submit("text prompt")
    with pytest.raises(ValueError):
        eng.submit([10**6])
    with pytest.raises(ValueError):
        eng.submit([1, 2], SamplingParams(top_k=9))
    with pytest.raises(ValueError):
        eng.submit(list(range(60)), SamplingParams(max_new_tokens=8))


def test_serve_jsonl_round_trip(models, tmp_path):
    jcfg, _, model = models
    ps = prompts(jcfg.vocab_size, seed=4)[:4]
    recs = [{"prompt_ids": p.tolist(), "max_new_tokens": 5 + i,
             "temperature": 0.8 if i % 2 else 0.0, "top_k": 4 if i % 2 else None,
             "seed": i, "ignore_eos": True} for i, p in enumerate(ps)]
    src, out = tmp_path / "req.jsonl", tmp_path / "out.jsonl"
    src.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    eng = DecodeEngine(model, n_slots=2, max_len=64)
    eng.start()
    try:
        results = serve_jsonl(eng, str(src), str(out), default_max_new=4)
    finally:
        eng.shutdown()
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == results and len(lines) == 4
    _, direct = run_port(model, [
        (p, SamplingParams(max_new_tokens=r["max_new_tokens"],
                           temperature=r["temperature"], top_k=r["top_k"],
                           seed=r["seed"], ignore_eos=True))
        for p, r in zip(ps, recs)])
    for line, h in zip(lines, direct):
        assert line["token_ids"] == h.output_ids
        assert line["finish_reason"] == FINISH_LENGTH
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"prompt": "hello"}) + "\n")
    with pytest.raises(ValueError, match="text prompt needs a tokenizer"):
        serve_jsonl(eng, str(bad), None, default_max_new=4)

