"""Speculative-decoding drafters for the serving engine (port of the JAX
package's ``serving/spec.py``; host numpy, no device work).

A drafter proposes k candidate tokens per slot per tick; one verify forward
(``models/transformer.verify_slots``, the Tq = k+1 sibling of the decode
step) scores all k+1 positions, and the engine commits the longest prefix
the accept rule (``generate.accept_draft_tokens``) takes. Drafts are point
masses and the rule is exact-match against the engine's own token at each
position, so committed tokens are the spec-off engine's at any acceptance
rate; k is fixed per engine, drafts and accepted counts are data.

``NgramDrafter`` is prompt-lookup drafting over the slot's own history
(prompt + generated): match the last n committed tokens against an earlier
occurrence and propose what followed it. It needs no second model and no
device memory, and it pays off where output repeats its context (templated
prompts, extraction, code).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Drafter", "NgramDrafter"]


class Drafter:
    """Drafter interface: ``propose(history, k)`` returns exactly k int32
    candidate next tokens for one slot. ``history`` is the slot's committed
    ids (prompt + generated, most recent last), a 1-D int32 numpy array the
    engine keeps on the host; proposing is host compute only, since it runs
    inside the engine tick.

    There is no "no draft": the verify width is fixed, so a poor guess costs
    nothing extra and is simply rejected. The base class repeats the last
    token (a fixed point of greedy decode loops)."""

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        return np.full((k,), history[-1], np.int32)

    def describe(self) -> str:
        return type(self).__name__


class NgramDrafter(Drafter):
    """Prompt-lookup / n-gram drafting against the slot's own history.

    For n from ``max_n`` down to ``min_n``: take the last n tokens as the
    query, find its most recent earlier occurrence, and propose the k tokens
    that followed it (padded with the last of them when the history ends
    first). Longer matches are tried first; the first hit wins. No
    occurrence at any n falls back to ``Drafter.propose``. Each n is one
    vectorized sliding-window comparison."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if min_n < 1 or max_n < min_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got min_n={min_n} "
                f"max_n={max_n}")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        L = history.shape[0]
        for n in range(self.max_n, self.min_n - 1, -1):
            if L < n + 1:
                continue            # too short to match and continue
            suffix = history[L - n:]
            # windows[s] = history[s : s + n]; candidates start before L - n
            # (the window at L - n is the query itself), so each has at
            # least one continuation token at s + n
            windows = np.lib.stride_tricks.sliding_window_view(history, n)
            hits = np.flatnonzero((windows[: L - n] == suffix).all(axis=1))
            if hits.size == 0:
                continue
            s = hits[-1]            # the most recent occurrence
            cont = history[s + n: s + n + k]
            if cont.shape[0] < k:
                cont = np.concatenate(
                    [cont, np.full((k - cont.shape[0],), cont[-1],
                                   history.dtype)])
            return cont.astype(np.int32, copy=False)
        return super().propose(history, k)

    def describe(self) -> str:
        return f"ngram(max_n={self.max_n},min_n={self.min_n})"
