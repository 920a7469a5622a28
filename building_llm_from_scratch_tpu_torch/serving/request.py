"""Request lifecycle for the serving engine (port of the JAX package's
``serving/request.py``, with the fields this engine uses).

A ``Request`` is one generation job: prompt tokens and ``SamplingParams``
in, generated token ids out, and with a tokenizer on the engine their text
(``text``). It doubles as the caller's handle: ``result()`` blocks until
the request finishes, ``stream()`` yields the text as it is decoded.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue as _stdqueue
import threading
import time
from typing import Callable, Iterator, List, Optional

#: request states
QUEUED = "queued"
RUNNING = "running"      # admitted to a slot
FINISHED = "finished"
REJECTED = "rejected"

#: finish reasons
FINISH_EOS = "eos"          # sampled the request's eos (the token is dropped)
FINISH_LENGTH = "length"    # hit max_new_tokens
FINISH_ERROR = "error"      # engine-side failure (req.error holds the message)
FINISH_REJECTED = "rejected"  # bounded queue at capacity at submit


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls, co-batchable in one decode tick.

    ``seed`` pins the request's random stream: token i is drawn with a
    generator seeded from (seed, i), whatever slot the request lands in and
    whatever runs beside it. ``temperature`` 0 is greedy argmax; ``top_k``
    None disables the filter. ``eos_id`` None means the model's eos;
    ``ignore_eos`` decodes to the token budget. ``adapter`` names a LoRA
    adapter of the engine's ``AdapterRegistry`` (None: the base model).
    ``spec`` False opts the request out of speculative decoding on a
    ``spec_k`` engine: its row commits one token a tick (the tokens are the
    same either way; the opt-out saves drafting where acceptance is low).
    It does nothing on a spec-off engine."""

    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    eos_id: Optional[int] = None
    ignore_eos: bool = False
    adapter: Optional[str] = None
    spec: bool = True


class Request:
    """One generation request and its result handle."""

    def __init__(self, req_id: int, prompt_ids, params: SamplingParams,
                 on_token: Optional[Callable[["Request", int, str], None]]
                 = None):
        self.id = req_id
        self.prompt_ids = prompt_ids            # np.int32 (Tp,)
        self.params = params
        self.on_token = on_token
        self.state = QUEUED
        self.finish_reason: Optional[str] = None
        self.output_ids: List[int] = []
        self.text = ""
        self._detok_start = 0    # first output_ids index not yet in text
        self.slot: Optional[int] = None
        self.error: Optional[str] = None
        # speculative decoding (spec engines only): k drafted a decode tick,
        # and the drafts the accept rule took
        self.spec_drafted = 0
        self.spec_accepted = 0
        # time.monotonic: submit -> admit -> first token -> finish
        self.t_submit = time.monotonic()
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self._done = threading.Event()
        self._stream: "_stdqueue.Queue[Optional[str]]" = _stdqueue.Queue()

    def result(self, timeout: Optional[float] = None) -> "Request":
        """Block until the request finishes; returns self. Raises
        ``RuntimeError`` when the engine failed it."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished "
                               f"within {timeout}s")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return self

    def stream(self, timeout: Optional[float] = None) -> Iterator[str]:
        """Yield detokenized text pieces as they are generated (ends when
        the request finishes). Raises ``TimeoutError``, as ``result()``
        does, when no piece arrives within ``timeout``."""
        while True:
            try:
                piece = self._stream.get(timeout=timeout)
            except _stdqueue.Empty:
                raise TimeoutError(
                    f"request {self.id}: no stream piece within "
                    f"{timeout}s") from None
            if piece is None:
                return
            yield piece

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (None with < 2)."""
        if (self.t_first_token is None or self.t_finish is None
                or len(self.output_ids) < 2):
            return None
        return ((self.t_finish - self.t_first_token)
                / (len(self.output_ids) - 1))

    def e2e_s(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_submit

    def summary(self) -> dict:
        out: dict = {
            "request_id": self.id,
            "n_prompt_tokens": int(len(self.prompt_ids)),
            "n_tokens": len(self.output_ids),
            "finish_reason": self.finish_reason,
            "slot": self.slot,
        }
        if self.params.adapter is not None:
            out["adapter"] = self.params.adapter
        if self.spec_drafted:
            out["spec_drafted"] = self.spec_drafted
            out["spec_accepted"] = self.spec_accepted
        for name, fn in (("ttft_s", self.ttft_s), ("tpot_s", self.tpot_s),
                         ("e2e_s", self.e2e_s)):
            v = fn()
            if v is not None:
                out[name] = round(v, 6)
        return out

    def _push_piece(self, piece: str) -> None:
        self._stream.put(piece)

    def _mark_done(self) -> None:
        self._stream.put(None)
        self._done.set()


def resolve_eos(params: SamplingParams, default_eos: Optional[int]
                ) -> Optional[int]:
    """The eos id this request stops on (None = never)."""
    if params.ignore_eos:
        return None
    return params.eos_id if params.eos_id is not None else default_eos


_ids = itertools.count(1)
_ids_lock = threading.Lock()


def next_request_id() -> int:
    with _ids_lock:
        return next(_ids)
