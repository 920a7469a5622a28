"""Host-side tokenizers (the port's copy of the byte tokenizer of the JAX
package's ``data/tokenizers.py``).

Only the offline ``ByteTokenizer`` is ported: GPT-2's tiktoken file and
Meta's ``tokenizer.model`` are downloads the repository does not hold, so
``build_tokenizer`` raises unless ``--byte_tokenizer`` is given.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence


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


def build_tokenizer(model: str, byte_tokenizer: bool = False):
    """The tokenizer of a run: the ``ByteTokenizer`` when asked for. The
    BPE tokenizers (tiktoken GPT-2, LLaMA's sentencepiece/tiktoken models)
    need asset files the repository does not hold and are not ported."""
    if byte_tokenizer:
        return ByteTokenizer()
    raise NotImplementedError(
        f"the {model} tokenizer needs asset files the repository does not "
        "hold and is not ported yet (ROADMAP queue 1, tokenizers); pass "
        "--byte_tokenizer")
