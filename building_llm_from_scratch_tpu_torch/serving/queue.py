"""Bounded FIFO request queue with explicit backpressure (port of the JAX
package's ``serving/queue.py``).

``put`` on a full queue either rejects at once (``QueueFullError``, HTTP
429) or blocks until admission drains the queue (the JSONL frontend's
backpressure). ``remove`` takes one queued request out (a client's
cancel); the typed errors carry what the HTTP frontend maps to a status."""

from __future__ import annotations

import collections
import threading
from typing import Optional

from building_llm_from_scratch_tpu_torch.serving.request import Request


class QueueFullError(Exception):
    """The bounded request queue is at capacity."""


class SLOShedError(Exception):
    """Admission predicted the request would miss its deadline (queue
    position x the live service estimate), so ``submit`` refused it: a
    429 now instead of a 504 later. ``retry_after_s`` estimates when the
    backlog will have drained enough to try again."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class EngineDrainingError(Exception):
    """The engine is draining (SIGTERM or shutdown): admission is closed
    while in-flight work finishes. The HTTP frontend answers 503 with
    Retry-After."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class PromptTooLongError(ValueError):
    """The prompt exceeds what this engine can admit (``limit`` prompt
    tokens). A ``ValueError`` so callers that catch the generic rejection
    keep working."""

    def __init__(self, msg: str, *, prompt_tokens: int, limit: int):
        super().__init__(msg)
        self.prompt_tokens = prompt_tokens
        self.limit = limit


class RequestQueue:
    def __init__(self, max_size: int = 64):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max_size = max_size
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._q: "collections.deque[Request]" = collections.deque()  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def put(self, req: Request, block: bool = False,
            timeout: Optional[float] = None) -> None:
        """Enqueue FCFS; raises ``QueueFullError`` when at capacity (or
        after ``timeout`` when ``block=True``)."""
        with self._not_full:
            if len(self._q) >= self.max_size:
                if not block:
                    raise QueueFullError(
                        f"request queue full ({self.max_size})")
                if not self._not_full.wait_for(
                        lambda: len(self._q) < self.max_size,
                        timeout=timeout):
                    raise QueueFullError(
                        f"request queue still full ({self.max_size}) "
                        f"after {timeout}s")
            self._q.append(req)

    def put_front(self, req: Request) -> None:
        """Re-queue a request at the head, past the capacity check: the
        paged engine's admission bounce. Admission popped the request and
        then found the page pool too drained for its worst-case need; it
        goes back ahead of everything behind it (capacity was charged when
        it was first queued, so a full queue must not reject it now)."""
        with self._not_full:
            self._q.appendleft(req)

    def get_nowait(self) -> Optional[Request]:
        """Pop the oldest request, or None when empty."""
        with self._not_full:
            if not self._q:
                return None
            req = self._q.popleft()
            self._not_full.notify()
            return req

    def remove(self, req: Request) -> bool:
        """Drop one queued request (a client's cancel). False when it is not
        queued (already admitted or popped)."""
        with self._not_full:
            try:
                self._q.remove(req)
            except ValueError:
                return False
            self._not_full.notify()
            return True

    def peek(self) -> Optional[Request]:
        with self._lock:
            return self._q[0] if self._q else None
