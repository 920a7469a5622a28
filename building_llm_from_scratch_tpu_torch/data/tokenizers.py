"""Host-side tokenizers (the port's copy of the JAX package's
``data/tokenizers.py``), on Python's standard library alone.

  - ``GPT2Tokenizer``: GPT-2's byte-level BPE over the two files tiktoken
    reads for its ``gpt2`` encoding (``vocab.bpe``, ``encoder.json``),
    found where tiktoken caches them (``tiktoken_cache_path``), or from
    two given files (``GPT2Tokenizer.from_files``);
  - ``Llama3Tokenizer``: BPE over Meta's ``tokenizer.model`` (base64 rank
    lines) with Meta's 256 reserved specials;
  - ``ByteTokenizer``: UTF-8 bytes plus specials, for offline smoke runs.

The BPE is tiktoken's, written out (``BytePairEncoding``): the text is
split on the allowed specials, each stretch between them is cut into
pieces by the encoding's split pattern, and each piece is merged pair by
pair, lowest rank first. Neither ``tiktoken`` nor ``regex`` is imported.
The split patterns are rewritten for Python's ``re`` (``translate_pattern``):
``\\p{L}`` and ``\\p{N}`` become classes of code-point ranges built from
``unicodedata`` once per process, and ``\\s`` / ``\\S`` become the
Unicode ``White_Space`` set and its complement (Python's ``\\s`` also
takes U+001C-U+001F, which tiktoken's does not). ``unicodedata`` is
Unicode 15.0 on Python 3.12: text with code points assigned later may
split otherwise than in tiktoken. Possessive quantifiers need Python 3.11.

LLaMA-2's SentencePiece model is not ported (``sentencepiece`` is not
installed); ``--byte_tokenizer`` stands in for it.
"""

from __future__ import annotations

import base64
import functools
import hashlib
import json
import os
import re
import tempfile
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

#: GPT-2's split pattern (tiktoken's ``r50k_pat_str``)
GPT2_SPLIT_PATTERN = (
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}++| ?\p{N}++| ?[^\s\p{L}\p{N}]++|\s++$"""
    r"""|\s+(?!\S)|\s"""
)

LLAMA3_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

#: the Unicode White_Space property: what ``\s`` means in tiktoken
_WHITE_SPACE = [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000)]

_NO_RANK = 1 << 62


def _escape(cp: int) -> str:
    if cp < 0x100:
        return f"\\x{cp:02x}"
    if cp < 0x10000:
        return f"\\u{cp:04x}"
    return f"\\U{cp:08x}"


def _class_body(ranges) -> str:
    return "".join(_escape(a) if a == b else f"{_escape(a)}-{_escape(b)}"
                   for a, b in ranges)


@functools.lru_cache(maxsize=None)
def unicode_classes() -> Dict[str, str]:
    """Character-class bodies (no brackets) of ``\\p{L}``, ``\\p{N}`` and
    ``\\s``, built once per process from ``unicodedata``."""
    spans: Dict[str, list] = {"L": [], "N": []}
    for cp in range(0x110000):
        major = unicodedata.category(chr(cp))[0]
        if major in spans:
            runs = spans[major]
            if runs and runs[-1][1] == cp - 1:
                runs[-1][1] = cp
            else:
                runs.append([cp, cp])
    out = {k: _class_body(v) for k, v in spans.items()}
    out["s"] = _class_body(_WHITE_SPACE)
    return out


def translate_pattern(pattern: str) -> str:
    """A tiktoken split pattern as Python ``re`` syntax: ``\\p{L}``,
    ``\\p{N}``, ``\\s`` and ``\\S`` written out as code-point classes (in
    an existing class, their ranges are inserted into it), and ``$`` (end of
    the text in Rust's regex) as ``\\Z``."""
    classes = unicode_classes()
    out: List[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            esc = pattern[i + 1]
            if esc == "p":
                end = pattern.index("}", i)
                body = classes[pattern[i + 3:end]]
                out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if esc in "sS":
                if in_class and esc == "S":
                    raise ValueError(f"\\S inside a class: {pattern!r}")
                neg = "^" if esc == "S" else ""
                out.append(classes["s"] if in_class else f"[{neg}{classes['s']}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if in_class:
            in_class = c != "]"
        elif c == "[":
            in_class = True
            if pattern[i + 1] == "^":
                out.append("[^")
                i += 2
                continue
        elif c == "$":
            c = r"\Z"
        out.append(c)
        i += 1
    return "".join(out)


def _disallowed_special_message(token: str) -> str:
    """tiktoken's message for a disallowed special in the text."""
    return (
        f"Encountered text corresponding to disallowed special token {token!r}.\n"
        "If you want this text to be encoded as a special token, "
        f"pass it to `allowed_special`, e.g. `allowed_special={{{token!r}, ...}}`.\n"
        f"If you want this text to be encoded as normal text, disable the check for this token "
        f"by passing `disallowed_special=(enc.special_tokens_set - {{{token!r}}})`.\n"
        "To disable this check for all special tokens, pass `disallowed_special=()`.\n"
    )


def byte_pair_encode(piece: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """tiktoken's ``_byte_pair_merge``: merge the adjacent pair whose bytes
    have the lowest rank (the leftmost on ties) until no pair is a token;
    the parts' ranks are the ids."""
    starts = list(range(len(piece) + 1))
    pair = [ranks.get(piece[i:i + 2], _NO_RANK) for i in range(len(piece) - 1)]
    pair += [_NO_RANK, _NO_RANK]
    while True:
        best = min(pair[:-1])
        if best == _NO_RANK:
            break
        i = pair.index(best)
        # the merged part's pairs with its neighbours, read before the
        # boundary at i + 1 goes
        if i > 0:
            pair[i - 1] = (ranks.get(piece[starts[i - 1]:starts[i + 2]], _NO_RANK)
                           if i + 2 < len(starts) else _NO_RANK)
        pair[i] = (ranks.get(piece[starts[i]:starts[i + 3]], _NO_RANK)
                   if i + 3 < len(starts) else _NO_RANK)
        del starts[i + 1], pair[i + 1]
    return [ranks[piece[a:b]] for a, b in zip(starts, starts[1:])]


class BytePairEncoding:
    """A tiktoken ``Encoding`` on the standard library: ``encode`` with
    tiktoken's ``allowed_special`` / disallowed-special rules, ``decode``
    (bytes joined, UTF-8 with ``errors="replace"``), ``n_vocab``. Keeps the
    ids of every piece it has merged (the corpus pre-pass encodes whole
    files)."""

    #: pieces remembered before the cache starts over
    CACHE_PIECES = 1 << 20

    def __init__(self, pat_str: str, mergeable_ranks: Dict[bytes, int],
                 special_tokens: Dict[str, int]):
        self._pat = re.compile(translate_pattern(pat_str))
        self._ranks = mergeable_ranks
        self._decoder = {v: k for k, v in mergeable_ranks.items()}
        self._special_tokens = dict(special_tokens)
        self._special_decoder = {v: k.encode("utf-8")
                                 for k, v in special_tokens.items()}
        self.special_tokens_set = frozenset(special_tokens)
        self.n_vocab = max(list(self._decoder) + list(self._special_decoder)) + 1
        self._pieces: Dict[str, tuple] = {}
        self._special_res: Dict[frozenset, "re.Pattern"] = {}

    def _special_regex(self, tokens: frozenset) -> "re.Pattern":
        rx = self._special_res.get(tokens)
        if rx is None:
            rx = self._special_res[tokens] = re.compile(
                "|".join(re.escape(t) for t in sorted(tokens)))
        return rx

    def encode_single_token(self, text: str) -> int:
        if text in self._special_tokens:
            return self._special_tokens[text]
        return self._ranks[text.encode("utf-8")]

    def _encode_ordinary(self, text: str, out: List[int]) -> None:
        cache, ranks = self._pieces, self._ranks
        for m in self._pat.finditer(text):
            s = m.group()
            ids = cache.get(s)
            if ids is None:
                piece = s.encode("utf-8")
                tok = ranks.get(piece)
                ids = (tok,) if tok is not None else tuple(
                    byte_pair_encode(piece, ranks))
                if len(cache) >= self.CACHE_PIECES:
                    cache.clear()
                cache[s] = ids
            out.extend(ids)

    def _encode(self, text: str, allowed: set) -> List[int]:
        out: List[int] = []
        specials = self.special_tokens_set & allowed
        if not specials:
            self._encode_ordinary(text, out)
            return out
        start = 0
        for m in self._special_regex(specials).finditer(text):
            self._encode_ordinary(text[start:m.start()], out)
            out.append(self._special_tokens[m.group()])
            start = m.end()
        self._encode_ordinary(text[start:], out)
        return out

    def encode(self, text: str, allowed_special: Iterable[str] = ()) -> List[int]:
        """Ids of ``text``; a special it holds that ``allowed_special`` does
        not name raises ``ValueError``, as in tiktoken."""
        allowed = set(allowed_special)
        disallowed = self.special_tokens_set - allowed
        if disallowed:
            m = self._special_regex(frozenset(disallowed)).search(text)
            if m:
                raise ValueError(_disallowed_special_message(m.group()))
        try:
            return self._encode(text, allowed)
        except UnicodeEncodeError:
            # lone surrogates: tiktoken's own fix-up, then again
            text = text.encode("utf-16", "surrogatepass").decode("utf-16", "replace")
            return self._encode(text, allowed)

    def decode(self, ids: Sequence[int]) -> str:
        parts = []
        for t in ids:
            b = self._decoder.get(t)
            if b is None:
                b = self._special_decoder.get(t)
                if b is None:
                    raise KeyError(f"Invalid token for decoding: {t}")
            parts.append(b)
        return b"".join(parts).decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# rank files
# ---------------------------------------------------------------------------

def load_tiktoken_bpe(path: str) -> Dict[bytes, int]:
    """A ``base64-token rank`` file (Meta's ``tokenizer.model``), as
    tiktoken's ``load_tiktoken_bpe`` reads it."""
    with open(path, "rb") as f:
        contents = f.read()
    ranks: Dict[bytes, int] = {}
    for line in contents.splitlines():
        if not line:
            continue
        try:
            token, rank = line.split()
            ranks[base64.b64decode(token)] = int(rank)
        except Exception as e:
            raise ValueError(f"Error parsing line {line!r} in {path}") from e
    return ranks


def data_gym_byte_order() -> List[int]:
    """GPT-2's byte order: the printable bytes other than space first, the
    rest after them; data-gym files spell byte ``order[i]`` (i >= 188) as
    ``chr(256 + i - 188)``."""
    order = [b for b in range(256) if chr(b).isprintable() and chr(b) != " "]
    return order + [b for b in range(256) if b not in order]


def data_gym_to_mergeable_bpe_ranks(vocab_bpe: bytes, encoder_json: bytes
                                    ) -> Dict[bytes, int]:
    """tiktoken's ``data_gym_to_mergeable_bpe_ranks`` on the two files'
    contents: the 256 bytes in ``data_gym_byte_order``, then one token a
    merge line of ``vocab.bpe``; ``encoder.json`` must hold the same
    ranks (its ``<|endoftext|>`` / ``<|startoftext|>`` aside)."""
    order = data_gym_byte_order()
    n_printable = sum(1 for b in range(256)
                      if chr(b).isprintable() and chr(b) != " ")
    to_byte = {chr(b): b for b in order[:n_printable]}
    to_byte.update({chr(256 + i): b for i, b in enumerate(order[n_printable:])})

    def decode_data_gym(value: str) -> bytes:
        return bytes(to_byte[c] for c in value)

    ranks = {bytes([b]): i for i, b in enumerate(order)}
    n = len(ranks)
    for line in vocab_bpe.decode().split("\n")[1:-1]:
        first, second = line.split()
        ranks[decode_data_gym(first) + decode_data_gym(second)] = n
        n += 1
    loaded = {decode_data_gym(k): v for k, v in json.loads(encoder_json).items()}
    loaded.pop(b"<|endoftext|>", None)
    loaded.pop(b"<|startoftext|>", None)
    if ranks != loaded:
        raise ValueError("encoder.json does not hold the ranks of vocab.bpe")
    return ranks


#: the files tiktoken's ``gpt2`` encoding reads (URL, sha256); tiktoken
#: caches each under the sha1 of its URL
GPT2_FILES = {
    "vocab.bpe": (
        "https://openaipublic.blob.core.windows.net/gpt-2/encodings/main/vocab.bpe",
        "1ce1664773c50f3e0cc8842619a93edc4624525b728b188a9e0be33b7726adc5"),
    "encoder.json": (
        "https://openaipublic.blob.core.windows.net/gpt-2/encodings/main/encoder.json",
        "196139668be63f3b5d6574427317ae82f612a97c5d1cdaf36ed2256dbf636783"),
}


def tiktoken_cache_path(url: str) -> Optional[str]:
    """Where tiktoken keeps the file of ``url``: ``TIKTOKEN_CACHE_DIR``,
    else ``DATA_GYM_CACHE_DIR``, else ``$TMPDIR/data-gym-cache``, under the
    sha1 of the URL; None when the directory is set empty (tiktoken's
    switch for no cache)."""
    cache_dir = os.environ.get("TIKTOKEN_CACHE_DIR")
    if cache_dir is None:
        cache_dir = os.environ.get("DATA_GYM_CACHE_DIR")
    if cache_dir is None:
        cache_dir = os.path.join(tempfile.gettempdir(), "data-gym-cache")
    if cache_dir == "":
        return None
    return os.path.join(cache_dir, hashlib.sha1(url.encode()).hexdigest())


def read_gpt2_file(name: str) -> bytes:
    """The contents of GPT-2's ``name`` from tiktoken's cache, checked
    against tiktoken's sha256. The port reads local files only: a missing
    or altered file raises ``FileNotFoundError``."""
    url, sha256 = GPT2_FILES[name]
    path = tiktoken_cache_path(url)
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(
            f"GPT2 tokenizer file {name} is not in tiktoken's cache ({path}, "
            f"the file tiktoken stores for {url}); the port reads it from "
            "there and never downloads it")
    with open(path, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != sha256:
        raise FileNotFoundError(
            f"GPT2 tokenizer file {name} at {path} does not match tiktoken's "
            f"sha256 {sha256}")
    return data


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """Deterministic offline tokenizer: raw UTF-8 bytes + special tokens.
    Ids 0-255 are bytes; specials get ids >= 256."""

    def __init__(self, specials: Sequence[str] = ("<|endoftext|>",)):
        self.specials = {s: 256 + i for i, s in enumerate(specials)}
        self._specials_by_id = {v: k for k, v in self.specials.items()}
        self.vocab_size = 256 + len(self.specials)
        self.eos_id = self.specials.get("<|endoftext|>", 256)

    def encode(self, text: str, allowed_special: Optional[Iterable[str]] = None
               ) -> List[int]:
        """UTF-8 bytes, with the allowed specials spliced in as their ids."""
        allowed = set(allowed_special or self.specials)
        pattern = "|".join(re.escape(s) for s in self.specials
                           if s in allowed)
        if not pattern:
            return list(text.encode("utf-8"))
        out: List[int] = []
        pos = 0
        for m in re.finditer(pattern, text):
            out.extend(text[pos:m.start()].encode("utf-8"))
            out.append(self.specials[m.group(0)])
            pos = m.end()
        out.extend(text[pos:].encode("utf-8"))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        parts: List[bytes] = []
        for t in ids:
            t = int(t)
            if t in self._specials_by_id:
                parts.append(self._specials_by_id[t].encode("utf-8"))
            elif 0 <= t < 256:
                parts.append(bytes([t]))
            # ids outside the byte+special range (e.g. sampled from an
            # untrained model with a larger vocab) decode to nothing
        return b"".join(parts).decode("utf-8", errors="replace")


class GPT2Tokenizer:
    """GPT-2's BPE: the files of tiktoken's ``gpt2`` encoding from its
    cache (no argument), or ``mergeable_ranks`` as
    ``data_gym_to_mergeable_bpe_ranks`` reads them."""

    def __init__(self, mergeable_ranks: Optional[Dict[bytes, int]] = None,
                 eot_id: int = 50256):
        if mergeable_ranks is None:
            mergeable_ranks = data_gym_to_mergeable_bpe_ranks(
                read_gpt2_file("vocab.bpe"), read_gpt2_file("encoder.json"))
        self._enc = BytePairEncoding(GPT2_SPLIT_PATTERN, mergeable_ranks,
                                     {"<|endoftext|>": eot_id})
        self.vocab_size = self._enc.n_vocab
        self.eos_id = eot_id

    @classmethod
    def from_files(cls, vocab_bpe: str, encoder_json: str) -> "GPT2Tokenizer":
        """From a ``vocab.bpe`` / ``encoder.json`` pair on disk, unchecked;
        ``<|endoftext|>`` takes its id in ``encoder.json`` (50256 in
        GPT-2's), or the first id after the ranks."""
        with open(vocab_bpe, "rb") as f:
            bpe = f.read()
        with open(encoder_json, "rb") as f:
            enc = f.read()
        ranks = data_gym_to_mergeable_bpe_ranks(bpe, enc)
        return cls(ranks, json.loads(enc).get("<|endoftext|>", len(ranks)))

    def encode(self, text: str, allowed_special: Optional[Iterable[str]] = None
               ) -> List[int]:
        allowed = set(allowed_special or {"<|endoftext|>"})
        return self._enc.encode(text, allowed_special=allowed)

    def decode(self, ids: Sequence[int]) -> str:
        return self._enc.decode([int(i) for i in ids])


#: Meta's special-token layout: 256 specials from the first id after the
#: ranks, the named ones among the reserved slots
LLAMA3_SPECIALS = [
    "<|begin_of_text|>",                # 128000
    "<|end_of_text|>",                  # 128001
    "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>",
    "<|reserved_special_token_2|>",
    "<|reserved_special_token_3|>",
    "<|start_header_id|>",              # 128006
    "<|end_header_id|>",                # 128007
    "<|reserved_special_token_4|>",
    "<|eot_id|>",                       # 128009
] + [f"<|reserved_special_token_{i}|>" for i in range(5, 251)]


class Llama3Tokenizer:
    """BPE over Meta's ``tokenizer.model`` + 256 reserved specials."""

    def __init__(self, model_path: str):
        if not os.path.exists(model_path):
            raise FileNotFoundError(
                f"LLaMA-3 tokenizer.model not found at {model_path}")
        mergeable = load_tiktoken_bpe(model_path)
        num_base = len(mergeable)               # 128000 for Meta's model
        specials = {tok: num_base + i for i, tok in enumerate(LLAMA3_SPECIALS)}
        self._enc = BytePairEncoding(LLAMA3_SPLIT_PATTERN, mergeable, specials)
        self.vocab_size = 128_256
        self.eos_id = specials["<|end_of_text|>"]    # 128001

    def encode(self, text: str, bos: bool = False, eos: bool = False,
               allowed_special: Optional[Iterable[str]] = None) -> List[int]:
        """Every special is allowed unless ``allowed_special`` names some."""
        ids = self._enc.encode(
            text, allowed_special=set(allowed_special or
                                      self._enc.special_tokens_set))
        if bos:
            ids = [self._enc.encode_single_token("<|begin_of_text|>")] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._enc.decode([int(i) for i in ids])


def build_tokenizer(model: str, tokenizer_path: Optional[str] = None,
                    fallback_byte: bool = False):
    """The tokenizer of a run, as the JAX ``build_tokenizer`` picks it, from
    local files only: GPT-2 from tiktoken's cache, LLaMA-3 from
    ``tokenizer_path``. ``fallback_byte`` (``--byte_tokenizer``) takes the
    ``ByteTokenizer`` for a LLaMA model without a path, and wherever the
    chosen tokenizer cannot be built. LLaMA-2's SentencePiece model is
    refused by name."""
    if fallback_byte and model != "GPT2" and tokenizer_path is None:
        return ByteTokenizer()

    def _asset_path() -> str:
        if tokenizer_path is not None:
            return tokenizer_path
        raise FileNotFoundError(
            f"{model} tokenizer assets unavailable: the hub download is not "
            "ported; pass --tokenizer_path to a local tokenizer.model for "
            "offline runs")

    try:
        if model == "GPT2":
            return GPT2Tokenizer()
        if model == "llama2":
            raise NotImplementedError(
                "the llama2 tokenizer is a SentencePiece model, which the "
                "port does not read (ROADMAP queue 1, tokenizers: LLaMA-2); "
                "pass --byte_tokenizer")
        if model in ("llama3", "llama3_1", "llama3_2"):
            return Llama3Tokenizer(_asset_path())
    except Exception:
        if fallback_byte:
            return ByteTokenizer()
        raise
    raise ValueError(f"Unknown model '{model}'")
