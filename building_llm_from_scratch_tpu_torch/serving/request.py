"""Request lifecycle for the serving engine (port of the JAX package's
``serving/request.py``, with the fields this engine uses).

A ``Request`` is one generation job: prompt tokens and ``SamplingParams``
in, generated token ids out. It doubles as the caller's handle:
``result()`` blocks until the request finishes.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, List, Optional

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
    ``ignore_eos`` decodes to the token budget."""

    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    eos_id: Optional[int] = None
    ignore_eos: bool = False


class Request:
    """One generation request and its result handle."""

    def __init__(self, req_id: int, prompt_ids, params: SamplingParams,
                 on_token: Optional[Callable[["Request", int], None]] = None):
        self.id = req_id
        self.prompt_ids = prompt_ids            # np.int32 (Tp,)
        self.params = params
        self.on_token = on_token
        self.state = QUEUED
        self.finish_reason: Optional[str] = None
        self.output_ids: List[int] = []
        self.slot: Optional[int] = None
        self.error: Optional[str] = None
        # time.monotonic: submit -> admit -> first token -> finish
        self.t_submit = time.monotonic()
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self._done = threading.Event()

    def result(self, timeout: Optional[float] = None) -> "Request":
        """Block until the request finishes; returns self. Raises
        ``RuntimeError`` when the engine failed it."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished "
                               f"within {timeout}s")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return self

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
        for name, fn in (("ttft_s", self.ttft_s), ("tpot_s", self.tpot_s),
                         ("e2e_s", self.e2e_s)):
            v = fn()
            if v is not None:
                out[name] = round(v, 6)
        return out

    def _mark_done(self) -> None:
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
