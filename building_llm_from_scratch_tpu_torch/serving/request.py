"""Request lifecycle for the serving engine (port of the JAX package's
``serving/request.py``; the router fields are not ported).

A ``Request`` is one generation job: prompt tokens and ``SamplingParams``
in, generated token ids out, and with a tokenizer on the engine their text
(``text``). It doubles as the caller's handle: ``result()`` blocks until
the request finishes, ``stream()`` yields the text as it is decoded. It
carries the timestamps the serving telemetry is built from (queue wait,
TTFT, TPOT, end to end) and its deadline.
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
FINISH_EXPIRED = "expired"      # deadline passed while queued (shed)
FINISH_PREEMPTED = "preempted"  # the drain's timeout came before it finished
FINISH_CANCELLED = "cancelled"  # the client gave up (timeout, disconnect)
FINISH_SHED = "shed"            # refused at submit: predicted deadline miss
FINISH_REJECTED = "rejected"    # bounded queue at capacity at submit


class RequestExpiredError(RuntimeError):
    """The request's deadline passed before it reached a slot: the engine
    shed it at an admission boundary (``result()`` raises this; the HTTP
    frontend answers 504)."""


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
    It does nothing on a spec-off engine. ``deadline_s`` is the client's
    patience in seconds from submission: past it the engine sheds the
    request from the queue, and ``submit`` refuses it up front when the
    backlog already predicts a miss (None: no deadline, or the engine's
    default)."""

    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    eos_id: Optional[int] = None
    ignore_eos: bool = False
    deadline_s: Optional[float] = None
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
        self._cancelled = False  # the client gave up; retired at a boundary
        # speculative decoding (spec engines only): k drafted a decode tick,
        # and the drafts the accept rule took
        self.spec_drafted = 0
        self.spec_accepted = 0
        # the slot KV bytes held at retirement, and those prefix hits spared
        self.kv_bytes_peak = 0
        self.prefix_bytes_saved = 0
        # time.monotonic: submit -> admit -> first token -> finish;
        # wall_submit anchors the request's spans to unix time
        self.t_submit = time.monotonic()
        self.wall_submit = time.time()
        self.t_deadline: Optional[float] = (
            self.t_submit + params.deadline_s
            if params.deadline_s is not None else None)
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self._done = threading.Event()
        self._stream: "_stdqueue.Queue[Optional[str]]" = _stdqueue.Queue()

    def result(self, timeout: Optional[float] = None) -> "Request":
        """Block until the request finishes; returns self. Raises
        ``RequestExpiredError`` when its deadline shed it in the queue and
        ``RuntimeError`` for any other failure (isolation, restart,
        preemption, cancellation)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished "
                               f"within {timeout}s")
        if self.finish_reason == FINISH_EXPIRED:
            raise RequestExpiredError(f"request {self.id} expired: {self.error}")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return self

    def expired(self, now: Optional[float] = None) -> bool:
        """True once the deadline has passed (never without one)."""
        if self.t_deadline is None:
            return False
        return (time.monotonic() if now is None else now) > self.t_deadline

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

    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

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
        """The ``request_done`` payload (the JAX summary's keys)."""
        out: dict = {
            "request_id": self.id,
            "n_prompt_tokens": int(len(self.prompt_ids)),
            "n_tokens": len(self.output_ids),
            "finish_reason": self.finish_reason,
            "slot": self.slot,
        }
        if self.params.deadline_s is not None:
            out["deadline_s"] = self.params.deadline_s
        if self.params.adapter is not None:
            out["adapter"] = self.params.adapter
        if self.spec_drafted:
            out["spec_drafted"] = self.spec_drafted
            out["spec_accepted"] = self.spec_accepted
        if self.kv_bytes_peak:
            out["kv_bytes_peak"] = self.kv_bytes_peak
        if self.prefix_bytes_saved:
            out["prefix_bytes_saved"] = self.prefix_bytes_saved
        for name, fn in (("queue_wait_s", self.queue_wait_s),
                         ("ttft_s", self.ttft_s), ("tpot_s", self.tpot_s),
                         ("e2e_s", self.e2e_s)):
            v = fn()
            if v is not None:
                out[name] = round(v, 6)
        return out

    def _wall(self, t_mono: Optional[float]) -> Optional[float]:
        """Monotonic time -> unix time through the submit anchor."""
        if t_mono is None:
            return None
        return self.wall_submit + (t_mono - self.t_submit)

    def outcome(self) -> str:
        """The span row's terminal label: the finish reason, or the state
        of a request that never got one."""
        return self.finish_reason or self.state

    def trace_row(self) -> dict:
        """The request's one ``span`` row: a ``request`` root [submit,
        terminal] with ``queued`` / ``prefill`` / ``decode`` children for
        each phase it reached, written once at its terminal transition."""
        t_end = self.t_finish if self.t_finish is not None else time.monotonic()
        children = [{"name": "queued", "t0": self.wall_submit,
                     "dur_s": (self.t_admit if self.t_admit is not None
                               else t_end) - self.t_submit}]
        if self.t_admit is not None:
            t_ft = (self.t_first_token if self.t_first_token is not None
                    else min(t_end, self.t_admit))
            children.append({"name": "prefill", "t0": self._wall(self.t_admit),
                             "dur_s": max(t_ft - self.t_admit, 0.0)})
            if self.t_first_token is not None:
                children.append({"name": "decode",
                                 "t0": self._wall(self.t_first_token),
                                 "dur_s": max(t_end - self.t_first_token, 0.0)})
        row = {"name": "request", "cat": "request", "t0": self.wall_submit,
               "dur_s": max(t_end - self.t_submit, 0.0), "children": children,
               "request_id": self.id, "outcome": self.outcome(),
               "n_prompt_tokens": int(len(self.prompt_ids)),
               "n_tokens": len(self.output_ids)}
        if self.slot is not None:
            row["slot"] = self.slot
        if self.params.adapter is not None:
            row["adapter"] = self.params.adapter
        if self.error is not None:
            row["error"] = self.error
        return row

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
