"""Text in and out of the port against the JAX package: the serving engine
on text prompts beside the JAX engine (``token_ids``, ``text``, the
``stream()`` pieces and the ``on_token(req, tok, piece)`` pieces), the JSONL
frontend with ``"prompt"`` lines beside the JAX ``serve_jsonl``, the hold
rule on a split multi-byte character, and the CLI end to end with
``--tokenizer_path`` (training against the JAX CLI, serving against the JAX
frontend). Tokenizers: the byte tokenizer of each package, and LLaMA-3 BPE
on a small synthetic ``tokenizer.model`` (``scripts/build_local_bpe.py``;
the JAX ``Llama3Tokenizer`` runs on tiktoken). Greedy decoding on the same
weights, so every comparison is exact.
"""

import json
import os
import runpy

import jax
import numpy as np
import pytest

from building_llm_from_scratch_tpu.data import tokenizers as jtok
from building_llm_from_scratch_tpu.serving.frontend import (
    serve_jsonl as jax_serve_jsonl,
)
from building_llm_from_scratch_tpu.serving.request import Request as JRequest
from building_llm_from_scratch_tpu_torch.data import tokenizers as ttok
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.frontend import serve_jsonl
from building_llm_from_scratch_tpu_torch.serving.request import (
    Request,
    SamplingParams,
)
from building_llm_from_scratch_tpu_torch.training.checkpoint import params_from_jax
from torch_port_helpers import JEngine, JParams, jax_params, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = runpy.run_path(os.path.join(ROOT, "scripts", "build_local_bpe.py"))


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """A small synthetic LLaMA-3 ``tokenizer.model`` (256 bytes + 300
    merges, not padded: its ids, specials included, fit a small model)."""
    return BPE["write_assets"](str(tmp_path_factory.mktemp("bpe")), 300,
                               full=False, text_chars=60_000)["tokenizer_model"]


@pytest.fixture(scope="module")
def full_model_file(tmp_path_factory):
    """The same merges padded to Meta's 128,000 ranks: every id of a
    ``--debug`` LLaMA (vocab 128,256) decodes."""
    return BPE["write_assets"](str(tmp_path_factory.mktemp("bpe-full")), 300,
                               full=True, text_chars=60_000)["tokenizer_model"]


@pytest.fixture(scope="module")
def setups(model_file):
    """kind -> (port tokenizer, JAX tokenizer, jcfg, params, port model)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIKTOKEN_CACHE_DIR", "")      # no tiktoken file cache
        jl = jtok.Llama3Tokenizer(model_file)
    tl = ttok.Llama3Tokenizer(model_file)
    out = {}
    for kind, (port_tok, jax_tok, vocab) in {
            "byte": (ttok.ByteTokenizer(), jtok.ByteTokenizer(), 512),
            "llama3": (tl, jl, tl._enc.n_vocab)}.items():
        jcfg, tcfg = small_configs("llama", vocab_size=vocab)
        params, np_params = jax_params(jcfg, seed=1)
        out[kind] = (port_tok, jax_tok, jcfg, params,
                     params_from_jax(np_params, tcfg, "cpu"))
    return out


def text_requests(tok, n=5, seed=0, max_len=64):
    """n (prompt, budget) pairs: pieces of a seeded ``sample_text`` (accents,
    CJK, emoji, CRLF) of 8-70 characters, cut until prompt + budget fit
    ``max_len`` under ``tok``; budgets 4, 6, 8, ..."""
    rng = np.random.default_rng(seed)
    text = BPE["sample_text"](seed + 9, 4000)
    out = []
    for i in range(n):
        a = int(rng.integers(0, len(text) - 80))
        prompt, budget = text[a:a + int(rng.integers(8, 70))], 4 + 2 * i
        while len(tok.encode(prompt)) + budget > max_len:
            prompt = prompt[:-1]
        out.append((prompt, budget))
    return out


def engines(setup, n_slots=3):
    port_tok, jax_tok, jcfg, params, model = setup
    jeng = JEngine(jcfg, params, jax_tok, n_slots=n_slots, max_len=64,
                   watch_compiles=False, warmup_prompt_cap=32)
    eng = DecodeEngine(model, port_tok, n_slots=n_slots, max_len=64,
                       warmup_prompt_cap=32)
    return eng, jeng


@pytest.mark.parametrize("kind", ["byte", "llama3"])
def test_text_prompts_match_the_jax_engine(setups, kind):
    """The same text prompts through both engines, stepped to idle: greedy
    ids, ``text``, every ``on_token`` (token, piece) and every stream
    piece equal; ``text`` is ``decode(ids)`` unless a held tail split a
    character, and the stream is the non-empty pieces then the tail the
    finish flushed."""
    port_tok, jax_tok = setups[kind][:2]
    eng, jeng = engines(setups[kind])
    calls = {"port": {}, "jax": {}}
    handles = {}
    for name, e, make in (("port", eng, lambda m: SamplingParams(
            max_new_tokens=m, ignore_eos=True)), ("jax", jeng, lambda m: JParams(
            max_new_tokens=m, ignore_eos=True))):
        def on_token(req, tok, piece, log=calls[name]):
            log.setdefault(req.id, []).append((int(tok), piece))

        handles[name] = [e.submit(p, make(m), on_token=on_token)
                         for p, m in text_requests(port_tok)]
        while e.step():
            pass
    held = 0
    for h, j in zip(handles["port"], handles["jax"]):
        assert h.prompt_ids.tolist() == np.asarray(j.prompt_ids).tolist()
        assert h.output_ids == [int(t) for t in j.output_ids]
        assert h.text == j.text
        assert calls["port"][h.id] == calls["jax"][j.id]
        pieces = list(h.stream(timeout=5))
        assert pieces == list(j.stream(timeout=5))
        assert "".join(pieces) == h.text
        said = [p for _, p in calls["port"][h.id] if p]
        assert pieces[:len(said)] == said
        held += sum(p == "" for _, p in calls["port"][h.id])
        if len(pieces) == len(said):
            assert h.text == port_tok.decode(h.output_ids)
    if kind == "byte":
        assert held > 0          # the random outputs split characters


@pytest.mark.parametrize("kind", ["byte", "llama3"])
def test_serve_jsonl_text_lines_match_the_jax_frontend(setups, tmp_path, kind):
    """JSONL lines with ``"prompt"`` (and one with ``"prompt_ids"``) through
    the port's ``serve_jsonl`` and the JAX one: the same ids and text."""
    port_tok = setups[kind][0]
    recs = [{"prompt": p, "max_new_tokens": m, "ignore_eos": True}
            for p, m in text_requests(port_tok, seed=2)]
    recs.append({"prompt_ids": port_tok.encode(recs[0]["prompt"]),
                 "max_new_tokens": recs[0]["max_new_tokens"], "ignore_eos": True})
    src = tmp_path / "req.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs))
    eng, jeng = engines(setups[kind], n_slots=2)
    outs = []
    for e, pump in ((eng, serve_jsonl), (jeng, jax_serve_jsonl)):
        e.start()
        try:
            outs.append(pump(e, str(src), None, default_max_new=4))
        finally:
            e.shutdown()
    ours, theirs = outs
    assert [r["token_ids"] for r in ours] == [r["token_ids"] for r in theirs]
    assert [r["text"] for r in ours] == [r["text"] for r in theirs]
    assert ours[-1]["token_ids"] == ours[0]["token_ids"]
    assert ours[-1]["text"] == ours[0]["text"]


def test_hold_and_flush_on_a_split_character(setups):
    """``_detok_piece`` of both engines on the same outputs: the three
    bytes of a 3-byte character commit together, a tail that keeps ending
    in U+FFFD commits at the 16th token, a held tail flushes at the
    finish."""
    sequences = [list("字".encode()), [0xC3, 0xA9, 0x41],
                 [0xF8] * 17, [0xE2, 0x82]]
    eng, jeng = engines(setups["byte"])
    for seq in sequences:
        got = {}
        for name, e, req in (
                ("port", eng, Request(0, np.array([1]), SamplingParams())),
                ("jax", jeng, JRequest(0, np.array([1]), JParams()))):
            pieces = []
            for tok in seq:
                req.output_ids.append(tok)
                pieces.append(e._detok_piece(req))
            pieces.append(e._detok_piece(req, final=True))
            got[name] = (pieces, req.text)
        assert got["port"] == got["jax"], seq
        assert "".join(got["port"][0]) == got["port"][1]
    assert got["port"][0] == ["", "", "�"]
    eng2 = DecodeEngine(setups["byte"][4], n_slots=1, max_len=64)
    req = Request(0, np.array([1]), SamplingParams())
    req.output_ids.append(65)
    assert eng2._detok_piece(req) == "" and req.text == ""


def _export(tmp_path, jcfg_name="llama3_2"):
    from building_llm_from_scratch_tpu.configs import get_config as jget_config
    from building_llm_from_scratch_tpu.models import init_params as jinit
    from building_llm_from_scratch_tpu.training import checkpoint as jckpt

    jcfg = jget_config(jcfg_name, "1B", dtype="fp32", debug=True)
    params = jinit(jcfg, jax.random.PRNGKey(5))
    export = str(tmp_path / "init.npz")
    jckpt.export_params(export, params)
    return jcfg, params, export


def test_train_cli_with_tokenizer_path_matches_the_jax_cli(full_model_file, tmp_path,
                                                            monkeypatch):
    """``--mode train --tokenizer_path`` on a ``--debug`` LLaMA through both
    CLIs from the same exported weights: the same steps, loss history
    (1e-5 relative), tokens seen and warm-up sample. The JAX loader's
    LLaMA-3 tokenizer raises on the eos suffix ``<|end_of_text|>`` it
    appends to each file; the port allows it as a special, and the JAX
    side gets the same rule here (the test wraps its ``encode``). Then the
    port again with ``--tokenizer_cache_dir``, twice: the relaunch reads the
    cache file and gives the same losses."""
    from building_llm_from_scratch_tpu import main as jmain
    from building_llm_from_scratch_tpu.training.trainer import Trainer as JTrainer
    from building_llm_from_scratch_tpu_torch import main as tmain

    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", "")
    data = tmp_path / "data"
    data.mkdir()
    (data / "corpus.txt").write_text(BPE["sample_text"](5, 6000))
    _, _, export = _export(tmp_path)
    flags = ["--model", "llama3_2", "--num_params", "1B", "--debug",
             "--tokenizer_path", full_model_file, "--data_type", "fp32",
             "--n_epochs", "1", "--batch_size", "4", "--eval_freq", "4",
             "--print_sample_iter", "1000", "--warmup_steps", "2",
             "--init_params_from", export, "--data_dir", str(data)]
    encode = jtok.Llama3Tokenizer.encode

    def encode_with_eos(self, text, bos=False, eos=False, allowed_special=None):
        if allowed_special is not None:
            allowed_special = set(allowed_special) | {"<|end_of_text|>"}
        return encode(self, text, bos, eos, allowed_special)

    monkeypatch.setattr(jtok.Llama3Tokenizer, "encode", encode_with_eos)
    jsamples = []
    sample = JTrainer.generate_and_print_sample

    def record(self, *a, **kw):
        jsamples.append(sample(self, *a, **kw))
        return jsamples[-1]

    monkeypatch.setattr(JTrainer, "generate_and_print_sample", record)
    monkeypatch.setattr(jmain, "plot_losses", lambda *a, **kw: None)
    jt = jmain.run(flags + ["--output_dir", str(tmp_path / "jout"),
                            "--save_ckpt_freq", "1000"])
    runs = [tmain.run(flags + ["--output_dir", str(tmp_path / f"tout{i}"),
                               "--device", "cpu", "--tokenizer_cache_dir",
                               str(tmp_path / "cache")]) for i in range(2)]
    tt = runs[0]
    assert tt.global_step == jt.global_step >= 8
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-5)
    np.testing.assert_allclose(tt.val_losses, jt.val_losses, rtol=1e-5)
    assert tt.track_tokens_seen == jt.track_tokens_seen
    assert tt.samples[0] == jsamples[0]
    assert [r.loader.token_cache.stats["encoded"] for r in runs] == [1, 0]
    assert [r.loader.token_cache.stats["disk"] for r in runs] == [0, 1]
    assert [m["loss"] for m in runs[1].step_metrics] == [
        m["loss"] for m in tt.step_metrics]
    assert len(os.listdir(tmp_path / "cache")) == 1


def test_serve_cli_text_prompts_match_the_jax_frontend(full_model_file, tmp_path,
                                                       monkeypatch):
    """``--mode serve --tokenizer_path`` on a JSONL of text prompts: each
    line's ``text`` is the decode of its ids, the ids equal those of the
    same requests as ``prompt_ids`` without a tokenizer, and both equal the
    JAX ``serve_jsonl`` over a JAX engine with the JAX tokenizer on the
    same exported weights."""
    from building_llm_from_scratch_tpu_torch import main as tmain

    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", "")
    jcfg, params, export = _export(tmp_path)
    tok = ttok.Llama3Tokenizer(full_model_file)
    reqs = [("Every effort moves", 4), ("The quick brown", 6), ("é中 🙂", 3),
            ("a lazy dog\r\n", 5)]
    for name, recs in (("text", [{"prompt": p, "max_new_tokens": m, "ignore_eos": True}
                                 for p, m in reqs]),
                       ("ids", [{"prompt_ids": tok.encode(p), "max_new_tokens": m,
                                 "ignore_eos": True} for p, m in reqs])):
        (tmp_path / f"{name}.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in recs))
    out = {}
    for name, extra in (("text", ["--tokenizer_path", full_model_file]), ("ids", [])):
        tmain.run(["--mode", "serve", "--model", "llama3_2", "--num_params", "1B",
                   "--debug", "--data_type", "fp32", "--init_params_from", export,
                   "--serve_prompts", str(tmp_path / f"{name}.jsonl"),
                   "--serve_slots", "2", "--serve_max_len", "16", "--device", "cpu",
                   "--serve_out", str(tmp_path / f"{name}.out"), *extra])
        out[name] = [json.loads(x) for x in
                     (tmp_path / f"{name}.out").read_text().splitlines()]
    jeng = JEngine(jcfg, params, jtok.Llama3Tokenizer(full_model_file), n_slots=2,
                   max_len=16, watch_compiles=False)
    jeng.start()
    try:
        jout = jax_serve_jsonl(jeng, str(tmp_path / "text.jsonl"), None,
                               default_max_new=4)
    finally:
        jeng.shutdown()
    ids = [r["token_ids"] for r in out["text"]]
    assert ids == [r["token_ids"] for r in out["ids"]] == [r["token_ids"] for r in jout]
    assert [r["text"] for r in out["text"]] == [r["text"] for r in jout]
    assert [r["text"] for r in out["ids"]] == [""] * len(reqs)
    assert all(len(i) == m for i, (_, m) in zip(ids, reqs))
    for r in out["text"]:
        assert r["text"] == tok.decode(r["token_ids"]) or "�" in r["text"]
