"""Write synthetic BPE tokenizer files, from a seed, in the real formats.

GPT-2's ``vocab.bpe`` / ``encoder.json`` and Meta's LLaMA-3
``tokenizer.model`` are downloads the repository does not hold. This
script learns merges from a seeded text (sentences of a small vocabulary
mixed with accents, CJK, emoji, digit runs, contractions in either case,
CRLF line ends, tabs and runs of spaces) and writes them as

  - ``tokenizer.model``: ``base64-token rank`` lines (tiktoken's
    ``load_tiktoken_bpe`` format, Meta's file's);
  - ``gpt2/vocab.bpe`` + ``gpt2/encoder.json``: the data-gym pair that
    tiktoken's ``data_gym_to_mergeable_bpe_ranks`` reads, with
    ``<|endoftext|>`` right after the ranks.

With ``--full`` the tables are padded to the real sizes with tokens that
UTF-8 text never produces (strings of the bytes 0xF8-0xFF): 128,000 ranks
put LLaMA-3's ``<|begin_of_text|>`` at 128,000, ``<|end_of_text|>`` at
128,001 and ``<|eot_id|>`` at 128,009; 50,256 ranks put GPT-2's
``<|endoftext|>`` at 50,256. The single bytes come first, in GPT-2's byte
order (printable bytes first), as in both real files.

  python scripts/build_local_bpe.py OUT_DIR [n_merges] [--full]

The functions are imported by the tests and ``chip_smoke.py`` (through
``runpy``); the script uses the standard library only.
"""

import base64
import heapq
import itertools
import json
import os
import random
import re
import sys

WORDS = ("the a quick brown fox jumps over lazy dog every effort moves you "
         "closer to mastery of small steps and long roads bring light "
         "water stone river tree wind sings").split()
ACCENTED = ["café", "naïve", "über", "señor", "smørrebrød", "straße",
            "déjà", "Ångström", "façade", "crème", "Øresund", "ŝtono"]
CJK = ["中文", "日本語", "한국어", "東京", "北京", "漢字", "ひらがな", "カタカナ"]
EMOJI = ["🙂", "👍🏽", "🚀", "🌍", "🎉", "❤️", "👩‍💻"]
CONTRACTIONS = ["don't", "I'll", "we've", "it's", "THEY'RE", "You'D",
                "she's", "can't", "I'M", "we're"]
SYLLABLES = ("ka ri to mu sen la vor en dal mi qua zet po lin rha bel "
             "sto ne ur gri fa tek nol is ba").split()


def sample_text(seed: int, n_chars: int) -> str:
    """A seeded text of ``n_chars`` characters: sentences of 4-12 words,
    most from ``WORDS`` and a few thousand pseudo-words, the rest accented
    words, CJK, emoji, numbers (runs longer than three digits too) and
    contractions; line ends CRLF or LF, now and then a tab or a run of
    spaces."""
    rng = random.Random(seed)
    pseudo = ["".join(rng.choice(SYLLABLES) for _ in range(rng.randint(1, 4)))
              for _ in range(3000)]
    weights = [1.0 / (i + 1) for i in range(len(pseudo))]
    parts, n = [], 0
    while n < n_chars:
        words = []
        for _ in range(rng.randint(4, 12)):
            r = rng.random()
            if r < 0.45:
                w = rng.choice(WORDS)
            elif r < 0.75:
                w = rng.choices(pseudo, weights)[0]
            elif r < 0.82:
                w = rng.choice(ACCENTED)
            elif r < 0.87:
                w = rng.choice(CJK)
            elif r < 0.90:
                w = rng.choice(EMOJI)
            elif r < 0.95:
                w = str(rng.randint(0, 10 ** rng.randint(1, 7)))
            else:
                w = rng.choice(CONTRACTIONS)
            words.append(w)
        sent = " ".join(words)
        sent = sent[0].upper() + sent[1:] + rng.choice([".", "!", "?", ","])
        r = rng.random()
        end = ("\r\n" if r < 0.1 else "\n" if r < 0.2 else "\t" if r < 0.25
               else " " * rng.randint(2, 5) if r < 0.3 else " ")
        parts.append(sent + end)
        n += len(sent) + len(end)
    return "".join(parts)[:n_chars]


def learn_merges(text: str, n_merges: int) -> list:
    """Up to ``n_merges`` BPE merges (pairs of byte strings) learned on the
    words of ``text`` (a leading space kept with its word): the most
    frequent adjacent pair first, ties to the smaller pair."""
    freqs: dict = {}
    for w in re.findall(r" ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+", text):
        freqs[w] = freqs.get(w, 0) + 1
    words = [[bytes([b]) for b in w.encode("utf-8")] for w in freqs]
    counts = list(freqs.values())
    pairs: dict = {}
    where: dict = {}
    for i, (w, c) in enumerate(zip(words, counts)):
        for p in zip(w, w[1:]):
            pairs[p] = pairs.get(p, 0) + c
            where.setdefault(p, set()).add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < n_merges:
        c, p = heapq.heappop(heap)
        if pairs.get(p, 0) != -c or c == 0:
            continue                    # a stale entry
        merges.append(p)
        joined = p[0] + p[1]
        touched = set()
        for i in sorted(where.pop(p, ())):
            w, n = words[i], counts[i]
            for q in zip(w, w[1:]):
                pairs[q] -= n
                touched.add(q)
            out, j = [], 0
            while j < len(w):
                if j + 1 < len(w) and (w[j], w[j + 1]) == p:
                    out.append(joined)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            words[i] = out
            for q in zip(out, out[1:]):
                pairs[q] = pairs.get(q, 0) + n
                where.setdefault(q, set()).add(i)
                touched.add(q)
        pairs.pop(p, None)
        for q in touched:
            if pairs.get(q, 0) > 0:
                heapq.heappush(heap, (-pairs[q], q))
    return merges


def data_gym_byte_order() -> list:
    order = [b for b in range(256) if chr(b).isprintable() and chr(b) != " "]
    return order + [b for b in range(256) if b not in order]


def rank_table(merges: list, n_ranks=None) -> list:
    """Tokens by rank as (bytes, (first, second) or None): the 256 bytes,
    the merges (a merge that makes a token already there adds none), then,
    up to ``n_ranks``, strings of the bytes 0xF8-0xFF, shortest first, each
    the merge of its prefix and its last byte."""
    table = [(bytes([b]), None) for b in data_gym_byte_order()]
    seen = {t for t, _ in table}
    for a, b in merges:
        if a + b not in seen:
            seen.add(a + b)
            table.append((a + b, (a, b)))
    if n_ranks is not None:
        if len(table) > n_ranks:
            raise ValueError(f"{len(table)} tokens do not fit {n_ranks} ranks")
        alphabet = [bytes([b]) for b in range(0xF8, 0x100)]
        for length in itertools.count(2):
            for combo in itertools.product(alphabet, repeat=length):
                if len(table) == n_ranks:
                    return table
                s = b"".join(combo)
                table.append((s, (s[:-1], s[-1:])))
    return table


def write_tiktoken_model(path: str, table: list) -> None:
    """Meta's ``tokenizer.model`` format: ``base64 rank`` a line."""
    with open(path, "wb") as f:
        for rank, (tok, _) in enumerate(table):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")


def write_gpt2_files(out_dir: str, table: list) -> tuple:
    """``vocab.bpe`` (a version line, then one ``first second`` merge a
    line in data-gym spelling) and ``encoder.json`` (every token's rank,
    ``<|endoftext|>`` next); returns the two paths."""
    order = data_gym_byte_order()
    n_printable = sum(1 for b in range(256)
                      if chr(b).isprintable() and chr(b) != " ")
    spell = {b: chr(b) for b in order[:n_printable]}
    spell.update({b: chr(256 + i) for i, b in enumerate(order[n_printable:])})

    def gym(tok: bytes) -> str:
        return "".join(spell[b] for b in tok)

    os.makedirs(out_dir, exist_ok=True)
    bpe = os.path.join(out_dir, "vocab.bpe")
    enc = os.path.join(out_dir, "encoder.json")
    with open(bpe, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for _, parts in table[256:]:
            f.write(f"{gym(parts[0])} {gym(parts[1])}\n")
    encoder = {gym(tok): rank for rank, (tok, _) in enumerate(table)}
    encoder["<|endoftext|>"] = len(table)
    with open(enc, "w", encoding="utf-8") as f:
        json.dump(encoder, f, ensure_ascii=False)
    return bpe, enc


def write_assets(out_dir: str, n_merges: int = 3000, full: bool = True,
                 seed: int = 0, text_chars: int = 400_000) -> dict:
    """Learn ``n_merges`` merges on ``sample_text(seed, text_chars)`` and
    write both formats under ``out_dir``; returns their paths and sizes."""
    merges = learn_merges(sample_text(seed, text_chars), n_merges)
    os.makedirs(out_dir, exist_ok=True)
    llama = rank_table(merges, 128_000 if full else None)
    gpt2 = rank_table(merges, 50_256 if full else None)
    model = os.path.join(out_dir, "tokenizer.model")
    write_tiktoken_model(model, llama)
    bpe, enc = write_gpt2_files(os.path.join(out_dir, "gpt2"), gpt2)
    return dict(tokenizer_model=model, vocab_bpe=bpe, encoder_json=enc,
                merges=len(merges), llama3_ranks=len(llama),
                gpt2_ranks=len(gpt2))


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 2
    args = [a for a in argv[1:] if a != "--full"]
    out = write_assets(args[0], int(args[1]) if len(args) > 1 else 3000,
                       full="--full" in argv)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
