"""Bounded FIFO request queue with explicit backpressure (port of the JAX
package's ``serving/queue.py``, without the drain and SLO-shed errors).

``put`` on a full queue either rejects at once (``QueueFullError``) or
blocks until admission drains the queue (the JSONL frontend's
backpressure)."""

from __future__ import annotations

import collections
import threading
from typing import Optional

from building_llm_from_scratch_tpu_torch.serving.request import Request


class QueueFullError(Exception):
    """The bounded request queue is at capacity."""


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

    def get_nowait(self) -> Optional[Request]:
        """Pop the oldest request, or None when empty."""
        with self._not_full:
            if not self._q:
                return None
            req = self._q.popleft()
            self._not_full.notify()
            return req
