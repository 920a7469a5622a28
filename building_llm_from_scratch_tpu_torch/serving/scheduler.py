"""Slot scheduler: FCFS admission into a fixed slot batch (copy of the JAX
package's ``serving/scheduler.py``).

The decode batch has ``n_slots`` rows with STATIC shapes; the scheduler
owns which request occupies which row. Admission happens only at step
boundaries (the engine calls ``admit`` before each decode tick), retirement
frees the slot immediately so the next queued request fills it on the same
tick — the continuous-batching invariant that keeps the fixed batch full
under load.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from building_llm_from_scratch_tpu_torch.serving.queue import RequestQueue
from building_llm_from_scratch_tpu_torch.serving.request import Request


class Scheduler:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.slots: List[Optional[Request]] = [None] * n_slots
        # ordered free list: lowest slot first (deterministic placement,
        # which the placement-invariance test then proves irrelevant)
        self._free: List[int] = list(range(n_slots))

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def active(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def admit_from(self, queue: RequestQueue) -> List[Tuple[int, Request]]:
        """FCFS: fill free slots from the queue head; returns the
        (slot, request) pairs admitted this boundary."""
        admitted: List[Tuple[int, Request]] = []
        while self._free:
            req = queue.get_nowait()
            if req is None:
                break
            slot = self._free.pop(0)
            self.slots[slot] = req
            admitted.append((slot, req))
        return admitted

    def retire(self, slot: int) -> None:
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        self.slots[slot] = None
        self._free.append(slot)
        self._free.sort()
