"""Per-step wall-clock breakdown and profiler trace annotation (port of the
JAX package's ``obs/timeline.py``).

Two jobs, one API:

  1. **Accounting**: the trainer's cadence window needs to know where the
     wall-clock went: waiting on the data pipeline (``data_wait``),
     launching the step (``dispatch``: launch time, not execution, since
     CUDA kernels run behind the host), blocking host fetches
     (``host_fetch``: the execution catch-up shows there, at the cadence)
     and the cadence work that is not training (``eval``, ``sample``,
     ``checkpoint``), whose time is left out of tok/s.
  2. **Navigability**: every span is a ``torch.profiler.record_function``
     region and each train step one profiler step (``step_span``), so a
     ``--profile`` trace shows named regions around the kernels.

``record_function`` costs next to nothing when no profiler is active, so
the spans stay on whether or not ``--profile`` is given.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, Optional

#: segments left out of the throughput window: cadence work that is not
#: training (the step loop is paused, not slow)
NON_STEP_SEGMENTS = ("eval", "sample", "checkpoint")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named ``torch.profiler.record_function`` region."""
    import torch

    with torch.profiler.record_function(name):
        yield


class StepTimeline:
    """Accumulates named wall-clock segments between ``drain()`` calls.

    The trainer drains once a logging cadence; the returned dict is the
    window's breakdown in seconds. ``on_step``, when set, is called after
    each ``step_span`` (the trainer's profiler advances one step there)."""

    def __init__(self, on_step: Optional[Callable[[], None]] = None):
        self.seconds: Dict[str, float] = {}
        self.steps_in_window = 0
        self.on_step = on_step

    def add(self, segment: str, dt: float) -> None:
        self.seconds[segment] = self.seconds.get(segment, 0.0) + dt

    @contextlib.contextmanager
    def span(self, segment: str) -> Iterator[None]:
        """Time a block into ``segment`` and annotate it in the trace."""
        t0 = time.perf_counter()
        try:
            with annotate(segment):
                yield
        finally:
            self.add(segment, time.perf_counter() - t0)

    @contextlib.contextmanager
    def step_span(self, step_num: int) -> Iterator[None]:
        """One train step: a ``train step <n>`` region in the trace (and one
        profiler step, through ``on_step``) plus ``dispatch`` accounting.
        The measured time is launch latency: the step returns before the
        device finishes, and the catch-up shows as ``host_fetch`` at the
        cadence."""
        t0 = time.perf_counter()
        try:
            with annotate("dispatch"), annotate(f"train step {step_num}"):
                yield
        finally:
            self.add("dispatch", time.perf_counter() - t0)
            self.steps_in_window += 1
            if self.on_step is not None:
                self.on_step()

    def non_step_seconds(self) -> float:
        return sum(self.seconds.get(k, 0.0) for k in NON_STEP_SEGMENTS)

    def drain(self) -> Dict[str, float]:
        """Return and reset the current window's breakdown; the dict also
        carries ``steps`` (train steps launched in the window)."""
        out = dict(self.seconds)
        out["steps"] = self.steps_in_window
        self.seconds = {}
        self.steps_in_window = 0
        return out


def window_stats(window: Dict[str, float], elapsed: float,
                 tokens: int) -> Dict[str, Optional[float]]:
    """Throughput and step time of one drained cadence window.

    ``elapsed`` is the wall-clock since the window opened; the non-step
    segments (eval, sample, checkpoint) are subtracted, so tok/s and
    step_time measure the training loop only."""
    non_step = sum(window.get(k, 0.0) for k in NON_STEP_SEGMENTS)
    step_seconds = max(elapsed - non_step, 0.0)
    steps = int(window.get("steps", 0))
    return {
        "tok_s": tokens / step_seconds if step_seconds > 0 else 0.0,
        "step_time_s": step_seconds / steps if steps else None,
        "step_seconds": step_seconds,
        "non_step_seconds": non_step,
    }
