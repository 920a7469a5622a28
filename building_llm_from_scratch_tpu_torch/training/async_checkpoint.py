"""Checkpoint writes off the step loop (the port's copy of the JAX
package's ``training/async_checkpoint.py``, one process).

A synchronous save holds the step loop for the whole write: the shard
files, their sha256 and the two-rename commit. ``AsyncCheckpointer``
splits the save where it must be split:

  1. **Snapshot (main thread).** ``checkpoint.snapshot_for_save`` copies
     every leaf into pinned host memory on the current stream and returns
     without waiting: the stream orders the copies before the next step's
     in-place updates, so training may go on at once.
  2. **Write (worker thread).** ``checkpoint.write_snapshot`` waits for
     the copies, then stages, hashes and commits exactly as the
     synchronous save does, so every reader (``load_checkpoint``,
     ``validate_checkpoint``, ``--resume auto``) takes its output as is.

Contracts:

  - **One save in flight.** ``save()`` first ``wait()``s for the previous
    commit, so two saves never interleave their staging dirs.
  - **Durability on demand.** ``wait()`` blocks until the last queued
    checkpoint is committed; the trainer calls it for ``final`` and
    ``interrupted``.
  - **Failures surface.** A worker error is raised again on the main
    thread at the next ``save()``/``wait()``.
  - ``on_commit(info)`` runs on the worker after a commit succeeds (never
    on failure): retention pruning, which must count only durable
    checkpoints.

``snapshot_s`` (what the step loop paid), ``write_s`` (the write that ran
beside training) and ``overlap_s`` (from the snapshot's return to the
commit) of the last committed save are kept as attributes and logged; the
port has no event sink yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from building_llm_from_scratch_tpu_torch.training import checkpoint as ckpt

logger = logging.getLogger(__name__)


class AsyncCheckpointer:
    """Background checkpoint writer; see the module docstring."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self.saves_committed = 0
        self.snapshot_s: Optional[float] = None
        self.write_s: Optional[float] = None
        self.overlap_s: Optional[float] = None

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def save(self, ckpt_dir: str, tree: Dict[str, Any],
             extra_metadata: Optional[dict] = None,
             on_commit: Optional[Callable[[dict], None]] = None) -> float:
        """Queue one checkpoint write of ``tree`` (``checkpoint_tree``'s
        layout). Blocks only for the previous save's commit and for the
        snapshot; returns the snapshot's seconds. ``on_commit`` gets the
        write's info (``path``, ``bytes``, ``leaves``, ``seconds``, and
        ``snapshot_s``, ``write_s``, ``overlap_s``)."""
        self.wait()
        t0 = time.perf_counter()
        snapshot = ckpt.snapshot_for_save(tree, extra_metadata)
        snapshot_s = time.perf_counter() - t0
        t_resume = time.perf_counter()

        def write() -> None:
            try:
                t_w = time.perf_counter()
                info = ckpt.write_snapshot(ckpt_dir, snapshot)
                now = time.perf_counter()
                info.update(snapshot_s=snapshot_s, write_s=now - t_w,
                            overlap_s=now - t_resume)
                self.snapshot_s, self.write_s, self.overlap_s = (
                    snapshot_s, info["write_s"], info["overlap_s"])
                self.saves_committed += 1
                logger.info("Async checkpoint %s committed: snapshot %.3f s, "
                            "write %.3f s, overlap %.3f s", ckpt_dir,
                            snapshot_s, info["write_s"], info["overlap_s"])
                if on_commit is not None:
                    on_commit(info)
            except BaseException as e:  # noqa: BLE001 — raised again at wait
                self._exc = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="async-ckpt-writer")
        self._thread.start()
        return snapshot_s

    def wait(self, reraise: bool = True) -> None:
        """Block until the write in flight (if any) has committed. With
        ``reraise`` a worker failure is raised here, on the main thread;
        ``reraise=False`` logs it instead (for ``finally`` blocks that must
        not mask an exception already on its way)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            if reraise:
                raise RuntimeError("Async checkpoint write failed") from exc
            logger.error("Async checkpoint write failed: %r", exc)

    def close(self) -> None:
        """The trainer's exit hook: drain the writer, logging a failure
        (it runs in a ``finally``)."""
        self.wait(reraise=False)
