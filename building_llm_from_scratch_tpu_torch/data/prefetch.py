"""Host/device overlap for the batch stream (the port's copy of the JAX
package's ``data/prefetch.py``, plus the copy to the card).

The synchronous step loop builds the next numpy batch, copies it to the
card, then launches the step: the device waits through the first two.
``Prefetcher`` runs them on a worker thread that keeps up to ``depth``
batches queued; ``DeviceStager`` is the placement it runs there for a
CUDA model.

Prefetcher contracts (the trainer and the resume rely on each):

  - **Exact order.** One worker, one FIFO queue: batches arrive in the
    source's order. Callers apply the resume fast-forward before wrapping
    the source, so the queue only holds batches that will train.
  - **No leaked threads.** ``close()`` (idempotent, also the context exit)
    stops the worker, drains the queue so a blocked ``put`` wakes, and
    joins. The trainer closes in a ``finally``.
  - **Exceptions propagate.** A worker exception is raised again at the
    consumer's next ``__next__``.
  - **Counters.** ``stalls`` counts pops that found the queue empty while
    the worker was still producing (the first pop and the end-of-stream
    pop excluded); ``fill_sum`` / ``pops`` is the mean queue depth at a
    pop. The trainer logs their window deltas as ``prefetch_stall`` and
    ``prefetch_fill_ratio``.

``place_fn`` runs once per batch, on the worker.

DeviceStager: a worker that copied to the card on the default stream would
serialise the copy with the step; one that copied on a side stream with no
ordering would let the step read a batch that has not landed (wrong
losses, no error). So the stager copies from pinned host memory on its own
stream and records an event after the copy; ``Staged.ready()`` makes the
consumer's stream wait for that event and marks the tensors as used there
(``record_stream``), so the allocator does not hand their memory to the
next copy while the step still reads it. On the CPU it only converts.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: queue sentinel: the worker finished the source (or died: then ``_exc``
#: is set)
_DONE = object()


class Prefetcher:
    """Iterate ``source`` through a bounded background-thread queue of
    ``depth`` (>= 1) batches; ``place_fn`` is applied once per batch, on
    the worker; ``name`` names the thread."""

    def __init__(self, source: Iterable[Any], depth: int = 2, *,
                 place_fn: Optional[Callable[[Any], Any]] = None,
                 name: str = "prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self._place_fn = place_fn
        self._src = iter(source)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # _exc is written by the worker and read by the consumer after
        # _DONE; the lock also makes close() safe from a second thread
        self._lock = threading.Lock()
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._finished = False
        self.stalls = 0
        self.pops = 0
        self.fill_sum = 0
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name=f"{name}-worker")
        self._thread.start()

    # -- worker --------------------------------------------------------

    def _put(self, item: Any) -> bool:
        """A bounded put that notices ``close()``; False when cancelled."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        try:
            for item in self._src:
                if self._stop.is_set():
                    return
                if self._place_fn is not None:
                    item = self._place_fn(item)
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — raised again at the pop
            with self._lock:
                self._exc = e
        finally:
            # the consumer's blocking get() must wake whether the source
            # ended, raised or was cancelled
            self._put(_DONE)

    # -- consumer ------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._finished:
            raise StopIteration
        qsize = self._q.qsize()
        # an empty queue while the worker still produces is a stall; not
        # the first pop (the initial fill) nor a wait that turns out to be
        # for the end of the stream
        would_stall = qsize == 0 and self.pops > 0
        item = self._q.get()
        if item is _DONE:
            self._finished = True
            self._thread.join(timeout=5.0)
            with self._lock:
                exc, self._exc = self._exc, None
            if exc is not None:
                raise exc
            raise StopIteration
        if would_stall:
            self.stalls += 1
        self.fill_sum += qsize
        self.pops += 1
        return item

    # -- lifecycle -----------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def counters(self) -> dict:
        """The counters now (the trainer takes window deltas)."""
        return {"stalls": self.stalls, "pops": self.pops,
                "fill_sum": self.fill_sum}

    def close(self) -> None:
        """Stop and join the worker; idempotent, safe mid-iteration."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._finished = True
        self._stop.set()
        # drain so a worker blocked in put() sees the stop flag promptly
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            logger.warning("Prefetch worker did not join within 10 s; "
                           "leaving the daemon thread to the process exit.")

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Staged:
    """A batch placed by ``DeviceStager``: ``ready()`` returns its tensors
    once the consumer's stream is ordered after their copy."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 event: Optional[torch.cuda.Event] = None,
                 device: Optional[torch.device] = None):
        self.tensors = tensors
        self.event = event
        self.device = device

    def ready(self) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


class DeviceStager:
    """Host batches -> ``Staged`` batches on ``device``: each numpy array
    converted to a tensor of its ``dtypes`` entry, pinned and copied on
    the stager's stream (CUDA), or only converted (CPU)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def stage(self, arrays: Dict[str, np.ndarray],
              dtypes: Dict[str, np.dtype]) -> Staged:
        host = {k: torch.from_numpy(np.asarray(a, dtypes[k]))
                for k, a in arrays.items()}
        if self.stream is None:
            return Staged(host)
        with torch.cuda.stream(self.stream):
            tensors = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return Staged(tensors, event, self.device)
