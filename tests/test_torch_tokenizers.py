"""The port's BPE tokenizers (plain Python) against the JAX package's
wrappers, which run on tiktoken, on the same synthetic files written from a
seed by ``scripts/build_local_bpe.py`` in the real formats (Meta's
``tokenizer.model`` padded to 128,000 ranks; GPT-2's ``vocab.bpe`` /
``encoder.json`` padded to 50,256). LLaMA-3 goes through the JAX
``Llama3Tokenizer(path)``; GPT-2 through the JAX ``GPT2Tokenizer`` with
``tiktoken.get_encoding`` monkeypatched, in the test only, to an
``Encoding`` over the synthetic ranks and tiktoken's own r50k pattern.

Exact throughout: ids, decoded text and error messages bit for bit, on
text drawn from the code points Unicode 15.0 assigns (Python 3.12's
``unicodedata``), with the whitespace and case-folding cases the
rewritten patterns must get right. Also: ``build_tokenizer``'s contract,
the on-disk token cache read across the two packages, the Alpaca records
under BPE, and ``generate(ref_eos_semantics=True)``.
"""

import hashlib
import inspect
import json
import logging
import os
import runpy

import numpy as np
import pytest
import tiktoken
import tiktoken_ext.openai_public as openai_public
from hypothesis import given, settings
from hypothesis import strategies as st
from tiktoken.load import data_gym_to_mergeable_bpe_ranks as tk_data_gym
from tiktoken.load import load_tiktoken_bpe as tk_load_bpe

from building_llm_from_scratch_tpu.data import tokenizers as jtok
from building_llm_from_scratch_tpu.data.instruct import (
    InstructionDataset as JInstructionDataset,
)
from building_llm_from_scratch_tpu.data.instruct import collate_batch as jcollate
from building_llm_from_scratch_tpu.data.pretrain import PretrainLoader as JLoader
from building_llm_from_scratch_tpu.generate import generate as jgenerate
from building_llm_from_scratch_tpu_torch.data import tokenizers as ttok
from building_llm_from_scratch_tpu_torch.data.instruct import (
    InstructionDataset,
    collate_batch,
)
from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader
from building_llm_from_scratch_tpu_torch.generate import generate
from building_llm_from_scratch_tpu_torch.training.checkpoint import params_from_jax
from torch_port_helpers import jax_params, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = runpy.run_path(os.path.join(ROOT, "scripts", "build_local_bpe.py"))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Synthetic files padded to the real sizes, 600 learned merges."""
    return BPE["write_assets"](str(tmp_path_factory.mktemp("bpe")), 600,
                               full=True, text_chars=120_000)


@pytest.fixture(scope="module")
def pair(assets):
    """{"llama3": (port, jax), "gpt2": (port, jax)} on the same files.
    tiktoken's own file cache is switched off (it would keep a copy of each
    local file under ``$TMPDIR/data-gym-cache``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIKTOKEN_CACHE_DIR", "")
        jl = jtok.Llama3Tokenizer(assets["tokenizer_model"])
        ranks = tk_data_gym(assets["vocab_bpe"], assets["encoder_json"])
        enc = tiktoken.Encoding(name="gpt2", pat_str=openai_public.r50k_pat_str,
                                mergeable_ranks=ranks,
                                special_tokens={"<|endoftext|>": len(ranks)})
        mp.setattr(tiktoken, "get_encoding", lambda name: enc)
        jg = jtok.GPT2Tokenizer()
    return {"llama3": (ttok.Llama3Tokenizer(assets["tokenizer_model"]), jl),
            "gpt2": (ttok.GPT2Tokenizer.from_files(assets["vocab_bpe"],
                                                   assets["encoder_json"]), jg)}


def outcome(fn, *a, **kw):
    """("ids", ids) or ("error", type name, message)."""
    try:
        return ("ids", [int(i) for i in fn(*a, **kw)])
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return ("error", type(e).__name__, str(e))


def assert_same(pair, text, **kw):
    port, jax_tok = pair
    got, want = outcome(port.encode, text, **kw), outcome(jax_tok.encode, text, **kw)
    assert got == want, repr(text)
    if got[0] == "ids":
        assert port.decode(got[1]) == jax_tok.decode(want[1]), repr(text)
    return got


def test_split_patterns_and_rank_files_are_tiktokens(assets, monkeypatch):
    assert ttok.GPT2_SPLIT_PATTERN == openai_public.r50k_pat_str
    assert ttok.LLAMA3_SPLIT_PATTERN == jtok.LLAMA3_SPLIT_PATTERN
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", "")
    assert ttok.load_tiktoken_bpe(assets["tokenizer_model"]) == tk_load_bpe(
        assets["tokenizer_model"])
    with open(assets["vocab_bpe"], "rb") as f:
        bpe = f.read()
    with open(assets["encoder_json"], "rb") as f:
        enc = f.read()
    assert ttok.data_gym_to_mergeable_bpe_ranks(bpe, enc) == tk_data_gym(
        assets["vocab_bpe"], assets["encoder_json"])
    assert (assets["llama3_ranks"], assets["gpt2_ranks"]) == (128_000, 50_256)
    with pytest.raises(ValueError, match="encoder.json"):
        ttok.data_gym_to_mergeable_bpe_ranks(bpe, json.dumps({"a": 0}).encode())


# the cases the rewritten patterns must get right: Python's \s takes
# U+001C-U+001F (tiktoken's does not), U+0085 / U+00A0 / U+2028 / U+3000
# are White_Space, ſ and K fold to s and k, trailing spaces, CRLF, digit
# runs longer than 3, specials allowed and not, a lone surrogate
CASES = [
    "a \x1c\x1cb", "x\x1d\x1e\x1fy z", "\x85a\xa0b c　d ", "ſ 'S K 'ſ",
    "IT'S don't I'LL we'VE you'D", "line\r\nnext\r\n\r\n  end", "trailing   ",
    "   leading", "digits 1234567890 and 12", "tab\there\t\t", "é中文🙂👍🏽 mixed",
    "<|endoftext|> joined", "x<|eot_id|>y", "<|begin_of_text|>hi<|end_of_text|>",
    "", " ", "\n", "lone \ud800 surrogate", "a" * 300, "é́ combining",
]


@pytest.mark.parametrize("kind", ["llama3", "gpt2"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_cases_equal_tiktoken_through_the_jax_wrappers(pair, kind, case):
    assert_same(pair[kind], CASES[case])


PIECES = ["\x1c", "\x1f", "\x85", "\xa0", " ", "　", "ſ", "K", "'S",
          "'s", "'ll", "\r\n", "\n", "\t", "   ", "1234567", "<|endoftext|>",
          "<|eot_id|>", "<|end_of_text|>", " the", "é", "中", "🙂"]
TEXT = st.lists(st.one_of(st.sampled_from(PIECES),
                          st.characters(exclude_categories=("Cn", "Cs"))),
                max_size=40).map("".join)


@settings(max_examples=200, deadline=None)
@given(text=TEXT)
def test_random_unicode_text_equals_tiktoken(pair, text):
    for kind in ("llama3", "gpt2"):
        assert_same(pair[kind], text)
        assert_same(pair[kind], text, allowed_special={"<|endoftext|>"})


def test_bos_eos_vocab_size_and_eos_id(pair):
    (tl, jl), (tg, jg) = pair["llama3"], pair["gpt2"]
    for kw in (dict(bos=True), dict(eos=True), dict(bos=True, eos=True)):
        assert tl.encode("hello there", **kw) == jl.encode("hello there", **kw)
    assert tl.encode("hi", bos=True, eos=True)[::len(tl.encode("hi")) + 1] == [
        128_000, 128_001]
    assert (tl.vocab_size, tl.eos_id) == (jl.vocab_size, jl.eos_id) == (128_256, 128_001)
    assert tl.encode("<|eot_id|>") == [128_009]
    assert (tg.vocab_size, tg.eos_id) == (jg.vocab_size, jg.eos_id) == (50_257, 50_256)
    assert tg.encode("<|endoftext|>") == [50_256]
    assert tl.decode(tl.encode("é中文🙂", bos=True)) == "<|begin_of_text|>é中文🙂"
    with pytest.raises(KeyError, match="Invalid token"):
        tg.decode([50_257])


def test_the_pretrain_specials(pair, tmp_path):
    """``allowed_special={"<|endoftext|>"}`` (the pretrain encode): GPT-2
    takes it as its eos id, LLaMA-3 as plain text; LLaMA-3's ``<|eot_id|>``
    then raises the same ValueError in both packages. The port's loader
    also allows the config's eos suffix (LLaMA-3: ``<|end_of_text|>``,
    its eos id), where the JAX tokenizer raises on it."""
    allowed = {"<|endoftext|>"}
    got = assert_same(pair["llama3"], "a <|endoftext|> b", allowed_special=allowed)
    assert max(got[1]) < 128_000
    assert 50_256 in assert_same(pair["gpt2"], "a <|endoftext|> b",
                                 allowed_special=allowed)[1]
    err = assert_same(pair["llama3"], "a <|eot_id|> b", allowed_special=allowed)
    assert err[:2] == ("error", "ValueError") and "<|eot_id|>" in err[2]
    err = assert_same(pair["llama3"], "a <|end_of_text|> ", allowed_special=allowed)
    assert err[:2] == ("error", "ValueError")
    tl = pair["llama3"][0]
    (tmp_path / "c.txt").write_text("Every effort moves you. " * 80)
    loader = PretrainLoader(tl, 2, 16)
    tr, va = loader._file_token_ids(str(tmp_path / "c.txt"), "<|end_of_text|>")
    text = "Every effort moves you. " * 80 + " <|end_of_text|> "
    cut = int(0.9 * len(text))
    assert tr.tolist() == tl.encode(text[:cut]) and va.tolist() == tl.encode(text[cut:])
    assert va[-2] == 128_001
    (tmp_path / "d.txt").write_text("x <|eot_id|> y " * 40)
    with pytest.raises(ValueError, match="eot_id"):
        PretrainLoader(tl, 2, 16)._file_token_ids(str(tmp_path / "d.txt"),
                                                  "<|end_of_text|>")


def test_piece_cache_and_merge_order(pair):
    tl = pair["llama3"][0]
    text = BPE["sample_text"](3, 20_000)
    tl._enc._pieces.clear()
    cold = tl.encode(text)
    assert len(tl._enc._pieces) > 100
    assert tl.encode(text) == cold
    # the merge loop: lowest rank first, the leftmost on ties
    ranks = {b"a": 0, b"b": 1, b"ab": 2, b"bb": 3, b"abb": 4}
    assert ttok.byte_pair_encode(b"abb", ranks) == [4]
    assert ttok.byte_pair_encode(b"bbb", ranks) == [3, 1]
    assert ttok.byte_pair_encode(b"abab", {**ranks, b"abab": 5}) == [5]


def test_build_tokenizer_matches_the_jax_contract(assets, tmp_path, monkeypatch):
    model_file = assets["tokenizer_model"]
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(tmp_path / "empty-cache"))

    def offline(*a, **kw):
        raise OSError("offline")

    # the JAX hub fetch and tiktoken's download fail as offline ones do
    monkeypatch.setattr(jtok, "fetch_tokenizer_asset", offline)
    monkeypatch.setattr(tiktoken, "get_encoding", offline)
    for model in ("llama3", "llama3_1", "llama3_2"):
        with pytest.raises(FileNotFoundError) as port_err:
            ttok.build_tokenizer(model)
        with pytest.raises(FileNotFoundError) as jax_err:
            jtok.build_tokenizer(model)
        for e in (port_err, jax_err):
            assert str(e.value).startswith(f"{model} tokenizer assets unavailable:")
            assert str(e.value).endswith("pass --tokenizer_path to a local "
                                         "tokenizer.model for offline runs")
        assert type(ttok.build_tokenizer(model, model_file)).__name__ == type(
            jtok.build_tokenizer(model, model_file)).__name__ == "Llama3Tokenizer"
    missing = str(tmp_path / "none.model")
    for model, path in (("llama3_2", None), ("llama3_2", missing), ("GPT2", None),
                        ("llama2", None), ("llama2", missing)):
        assert type(ttok.build_tokenizer(model, path, fallback_byte=True)).__name__ \
            == type(jtok.build_tokenizer(model, path, fallback_byte=True)).__name__ \
            == "ByteTokenizer", (model, path)
    with pytest.raises(FileNotFoundError) as port_err:
        ttok.build_tokenizer("llama3_2", missing)
    with pytest.raises(FileNotFoundError) as jax_err:
        jtok.build_tokenizer("llama3_2", missing)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError, match="llama2.*--byte_tokenizer"):
        ttok.build_tokenizer("llama2", model_file)
    with pytest.raises(FileNotFoundError, match="tiktoken's cache"):
        ttok.build_tokenizer("GPT2")
    with pytest.raises(ValueError, match="Unknown model"):
        ttok.build_tokenizer("gpt5")


def test_gpt2_reads_the_files_tiktoken_caches(assets, tmp_path, monkeypatch):
    """GPT-2's files are looked up where tiktoken keeps them (the sha1 of
    the URL, under TIKTOKEN_CACHE_DIR, DATA_GYM_CACHE_DIR or
    $TMPDIR/data-gym-cache) and checked against tiktoken's sha256."""
    source = inspect.getsource(openai_public.gpt2)
    for url, sha256 in ttok.GPT2_FILES.values():
        assert url in source and sha256 in source
    cache = tmp_path / "cache"
    cache.mkdir()
    for name, src in (("vocab.bpe", assets["vocab_bpe"]),
                      ("encoder.json", assets["encoder_json"])):
        url, _ = ttok.GPT2_FILES[name]
        with open(src, "rb") as f:
            (cache / hashlib.sha1(url.encode()).hexdigest()).write_bytes(f.read())
    for var in ("TIKTOKEN_CACHE_DIR", "DATA_GYM_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr("tempfile.tempdir", None)
    url = ttok.GPT2_FILES["vocab.bpe"][0]
    assert ttok.tiktoken_cache_path(url) == str(
        tmp_path / "tmp" / "data-gym-cache" / hashlib.sha1(url.encode()).hexdigest())
    monkeypatch.setenv("DATA_GYM_CACHE_DIR", str(cache))
    with pytest.raises(FileNotFoundError, match="sha256"):
        ttok.GPT2Tokenizer()            # the synthetic files are not GPT-2's
    sums = {}
    for name, (u, _) in ttok.GPT2_FILES.items():
        with open(cache / hashlib.sha1(u.encode()).hexdigest(), "rb") as f:
            sums[name] = (u, hashlib.sha256(f.read()).hexdigest())
    monkeypatch.setattr(ttok, "GPT2_FILES", sums)
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(cache))
    tok = ttok.GPT2Tokenizer()
    want = ttok.GPT2Tokenizer.from_files(assets["vocab_bpe"], assets["encoder_json"])
    text = BPE["sample_text"](4, 4000)
    assert tok.encode(text) == want.encode(text) and tok.eos_id == 50_256
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", "")
    with pytest.raises(FileNotFoundError):
        ttok.GPT2Tokenizer()


# ---------------------------------------------------------------------------
# the on-disk token cache
# ---------------------------------------------------------------------------

def _corpus(tmp_path, name="corpus.txt"):
    path = tmp_path / name
    path.write_text(BPE["sample_text"](7, 6000))
    return str(path)


def _boom(*a, **kw):
    raise AssertionError("tokenized again: the cache file was not read")


@pytest.mark.parametrize("kind", ["byte", "llama3"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_token_cache_files_are_read_across_packages(pair, tmp_path, kind, writer):
    """A ``--tokenizer_cache_dir`` file written by either package is read
    by the other: the same key, name and ``.npz`` layout."""
    if kind == "byte":
        toks = (ttok.ByteTokenizer(), jtok.ByteTokenizer())
    else:
        toks = pair["llama3"]
    path = _corpus(tmp_path)
    cache = str(tmp_path / "cache")
    port = PretrainLoader(toks[0], 2, 32, token_cache_dir=cache)
    jax_loader = JLoader(toks[1], 2, 32, token_cache_dir=cache)
    first, second = (jax_loader, port) if writer == "jax" else (port, jax_loader)
    want = first._file_token_ids(path, "<|endoftext|>")
    assert len(os.listdir(cache)) == 1
    reader_tok = second.tokenizer
    second.token_cache._tokenizer_id(reader_tok)     # the fingerprint probe
    reader_tok.encode = _boom
    try:
        got = second._file_token_ids(path, "<|endoftext|>")
    finally:
        del reader_tok.encode
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if second is port:
        assert port.token_cache.stats["disk"] == 1
        assert port.token_cache.stats["encoded"] == 0


def test_token_cache_rebuilds_a_corrupt_file_and_survives_a_failed_write(
        tmp_path, caplog):
    tok = ttok.ByteTokenizer()
    path = _corpus(tmp_path)
    cache = tmp_path / "cache"
    want = PretrainLoader(tok, 2, 32, token_cache_dir=str(cache))._file_token_ids(
        path, "<|endoftext|>")
    (f,) = cache.iterdir()
    f.write_bytes(b"not an npz")
    fresh = PretrainLoader(tok, 2, 32, token_cache_dir=str(cache))
    with caplog.at_level(logging.WARNING):
        got = fresh._file_token_ids(path, "<|endoftext|>")
    assert "unreadable" in caplog.text
    assert fresh.token_cache.stats["encoded"] == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    (blocked := tmp_path / "blocked").write_text("a file, not a directory")
    other = PretrainLoader(tok, 2, 32, token_cache_dir=str(blocked / "sub"))
    with caplog.at_level(logging.WARNING):
        got = other._file_token_ids(path, "<|endoftext|>")
    assert "write" in caplog.text and "failed" in caplog.text
    np.testing.assert_array_equal(got[0], want[0])
    # another vocabulary of the same class and size is another entry
    ids = PretrainLoader(ttok.ByteTokenizer(("<|endoftext|>", "<|x|>")), 2, 32,
                         token_cache_dir=str(cache)).token_cache
    assert ids._tokenizer_id(tok) != ids._tokenizer_id(
        ttok.ByteTokenizer(("<|x|>", "<|endoftext|>")))


# ---------------------------------------------------------------------------
# Alpaca records under BPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["llama3", "gpt2"])
def test_alpaca_records_and_prompt_mask_under_bpe(pair, tmp_path, kind):
    """The records' ids, the prompt lengths and the collated mask equal the
    JAX package's under each BPE: a merge across the prompt/response
    boundary would show here."""
    port_tok, jax_tok = pair[kind]
    path = tmp_path / "a.json"
    runpy.run_path(os.path.join(ROOT, "scripts", "build_local_alpaca.py"))["main"](
        ["", str(path), "24"])
    records = json.loads(path.read_text())
    records[0]["instruction"] += " é中文 "       # a boundary after spaces
    records[1]["input"] = "IT'S\r\n"
    ds, jds = InstructionDataset(records, port_tok), JInstructionDataset(records, jax_tok)
    assert ds.encoded_texts == [list(map(int, x)) for x in jds.encoded_texts]
    assert ds.instruction_lengths == jds.instruction_lengths
    eos = port_tok.eos_id
    for got, want in zip(collate_batch([ds[i] for i in range(8)], pad_token_id=eos,
                                       allowed_max_length=128),
                         jcollate([jds[i] for i in range(8)], pad_token_id=eos,
                                  allowed_max_length=128)):
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# generate(ref_eos_semantics=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch,prompt_len,max_new", [("cached", 5, 12),
                                                       ("window", 30, 40)])
@pytest.mark.parametrize("rows", ["one", "all"])
def test_ref_eos_semantics_matches_jax(branch, prompt_len, max_new, rows):
    """The reference's batch-global eos: a row's eos neither stops it nor is
    dropped ("one": row 0 samples it at its third token, row 1 does not),
    and the step at which every row samples eos ends generation with that
    column dropped ("all": one row). Tokens and counts equal JAX's."""
    jcfg, tcfg = small_configs("llama", context_length=64)
    params, np_params = jax_params(jcfg, seed=2)
    model = params_from_jax(np_params, tcfg, "cpu")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                            (2 if rows == "one" else 1, prompt_len))
    eos_id = int(jgenerate(params, jcfg, ids, 3)[0, prompt_len + 2])
    out_j, n_j = jgenerate(params, jcfg, ids, max_new, eos_id=eos_id,
                           ref_eos_semantics=True, return_n_generated=True)
    out_t, n_t = generate(model, ids, max_new, eos_id=eos_id,
                          ref_eos_semantics=True, return_n_generated=True)
    np.testing.assert_array_equal(np.asarray(n_t), np.asarray(n_j))
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    if rows == "one":
        assert out_t.shape[1] == prompt_len + max_new and out_t[0, prompt_len + 2] == eos_id
    else:
        assert n_t.tolist() == [2] and out_t.shape[1] == prompt_len + 2
