"""Fault tolerance (the port's copy of the JAX package's
``training/resilience.py``): a preemption-safe stop, checkpoint integrity,
resume discovery, retention and a loss watchdog.

  - ``GracefulStopper``: SIGTERM/SIGINT set a flag; the trainer polls it at
    step boundaries, writes an ``interrupted`` checkpoint and returns
    cleanly (the CLI exits 0). A second SIGINT raises ``KeyboardInterrupt``.
    With several ranks the stop is agreed: every ``STOP_SYNC_EVERY`` polls
    the flags are all-reduced (MAX), so a signal to one rank stops every
    rank at the same step, at most ``STOP_SYNC_EVERY - 1`` steps late.
  - ``validate_checkpoint`` / ``find_latest_valid_checkpoint``: the
    manifest's per-shard ``bytes``/``sha256`` records are checked (manifests
    without them validate on the files' existence); auto-resume walks the
    checkpoints newest first and falls back, loudly, past corrupt ones.
  - ``resolve_resume``: the ``--resume auto|off|<dir>`` policy;
    ``resolve_resume_agreed`` lets rank 0 choose and broadcasts its
    choice, so every rank restores the same checkpoint.
  - ``prune_checkpoints``: ``--keep_ckpts N`` retention; only step-tagged
    ``model_pg_<step>`` dirs are pruned, ``interrupted``/``final`` never.
  - ``LossWatchdog``: halts on a non-finite train loss or a spike above a
    multiple of the running median, with the step, the loss and the recent
    losses in the message; ``context_fn`` (the trainer's health digest)
    names the layer group.

Events (``obs/metrics``, the JAX field sets): ``preemption_signal``,
``checkpoint_fallback``, ``checkpoint_gc`` and ``watchdog_halt``.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import signal
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from building_llm_from_scratch_tpu_torch.obs.metrics import emit_event

logger = logging.getLogger(__name__)

#: prefix of every Trainer-written checkpoint dir (model_pg_<tag>)
CKPT_PREFIX = "model_pg_"

_STEP_TAGGED = re.compile(r"^" + re.escape(CKPT_PREFIX) + r"(\d+)$")


class PreemptionStop(Exception):
    """Raised by the trainer at a step boundary after a graceful-stop
    request; callers treat it as a clean early return, not a failure."""


class TrainingDivergedError(RuntimeError):
    """Raised by ``LossWatchdog`` on a non-finite or spiking train loss."""


# ---------------------------------------------------------------------------
# graceful stop (SIGTERM/SIGINT -> stop at the next step boundary)
# ---------------------------------------------------------------------------

#: with several ranks, the stop flags are agreed every this many polls
STOP_SYNC_EVERY = 8


class GracefulStopper:
    """Context manager that turns SIGTERM/SIGINT into a polled flag. The
    first signal only records the request: the training loop finishes its
    step, writes a checkpoint and returns. A second SIGINT raises
    ``KeyboardInterrupt``. Handlers are restored on exit; outside the main
    thread (where ``signal.signal`` is refused) the flag is never set."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous = {}
        self._sigint_seen = False
        self.requested = False
        self._calls = 0

    def _handle(self, signum, frame):
        # only a second Ctrl-C aborts: a SIGINT after a SIGTERM must not
        # turn the graceful stop into the abort path
        if signum == signal.SIGINT:
            if self._sigint_seen:
                raise KeyboardInterrupt
            self._sigint_seen = True
        self.requested = True
        emit_event("preemption_signal", signal=signal.Signals(signum).name)
        logger.warning(
            "Received %s: will checkpoint and stop at the next step "
            "boundary (send SIGINT again to abort immediately).",
            signal.Signals(signum).name)

    def __enter__(self) -> "GracefulStopper":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:          # not the main thread
                logger.warning(
                    "Cannot install %s handler outside the main thread; "
                    "graceful stop disabled for it.", signal.Signals(s).name)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return False

    def should_stop(self) -> bool:
        """The stop decision. One rank: the local flag. Several: every rank
        calls this once per step; every ``STOP_SYNC_EVERY``-th call
        all-reduces the flags (any rank's request stops all), the others
        return False, so no rank ever stops without its peers."""
        from building_llm_from_scratch_tpu_torch.parallel import collectives

        if collectives.world() == 1:
            return self.requested
        self._calls += 1
        if self._calls % STOP_SYNC_EVERY:
            return False
        return collectives.agree(self.requested, "max")


# ---------------------------------------------------------------------------
# checkpoint integrity and discovery
# ---------------------------------------------------------------------------

def validate_checkpoint(ckpt_dir: str) -> Optional[str]:
    """None when the checkpoint is valid, else a reason. Never raises: it
    exists so that ``--resume auto`` can fall back past corrupt
    checkpoints. Valid = the manifest parses and every shard file it names
    exists with the recorded size and sha256 (manifests without those
    records: existence alone)."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        _read_manifest,
        _resolve_ckpt_dir,
        sha256_file,
    )

    resolved = _resolve_ckpt_dir(ckpt_dir)
    try:
        manifest = _read_manifest(resolved)
        for meta in manifest["leaves"]:
            for sh in meta["shards"]:
                path = os.path.join(resolved, sh["file"])
                if not os.path.isfile(path):
                    return f"shard file {sh['file']} is missing"
                if "bytes" in sh:
                    size = os.path.getsize(path)
                    if size != int(sh["bytes"]):
                        return (f"shard file {sh['file']} is {size} bytes, "
                                f"manifest records {sh['bytes']} "
                                "(truncated?)")
                if "sha256" in sh and sha256_file(path) != sh["sha256"]:
                    return f"shard file {sh['file']} fails its sha256 checksum"
    except (ValueError, KeyError, TypeError, AttributeError, OSError) as e:
        return f"manifest is unusable ({type(e).__name__}: {e})"
    return None


def list_checkpoints(output_dir: str) -> List[Tuple[int, str]]:
    """Every Trainer checkpoint under ``output_dir`` as (global_step,
    path), the path being the commit tag (a save cut mid-commit that left
    only ``.tmp``/``.old`` resolves through it). Unreadable entries are
    skipped with a log line."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        checkpoint_metadata,
    )

    if not os.path.isdir(output_dir):
        return []
    tags = set()
    for name in sorted(os.listdir(output_dir)):
        if not name.startswith(CKPT_PREFIX):
            continue
        if not os.path.isdir(os.path.join(output_dir, name)):
            continue                     # e.g. the model_pg_final.npz export
        for suffix in (".tmp", ".old"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
                break
        tags.add(name)
    out = []
    for name in sorted(tags):
        path = os.path.join(output_dir, name)
        try:
            meta = checkpoint_metadata(path)
            out.append((int(meta.get("global_step", 0)), path))
        except (ValueError, OSError) as e:
            logger.warning("Skipping unreadable checkpoint %s: %s", path, e)
    return sorted(out)


def find_latest_valid_checkpoint(output_dir: str,
                                 predicate=None) -> Optional[str]:
    """The newest checkpoint (by recorded global_step) that passes
    ``validate_checkpoint``; corrupt ones are logged loudly and skipped.
    ``predicate(metadata) -> bool`` quietly skips checkpoints of another
    run mode (fleet checkpoints share the prefix and the output dir)."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        checkpoint_metadata,
    )

    for step, path in reversed(list_checkpoints(output_dir)):
        if predicate is not None:
            try:
                keep = predicate(checkpoint_metadata(path))
            except (ValueError, OSError) as e:
                logger.error("Checkpoint %s became unreadable during resume "
                             "discovery (%s) — skipping it.", path, e)
                continue
            if not keep:
                logger.info("Resume discovery: skipping %s (another run "
                            "mode's checkpoint).", path)
                continue
        reason = validate_checkpoint(path)
        if reason is None:
            return path
        emit_event("checkpoint_fallback", step=step, path=path, reason=reason)
        logger.error(
            "Checkpoint %s (step %d) is INVALID: %s — falling back to the "
            "previous checkpoint.", path, step, reason)
    return None


def resolve_resume(resume: Optional[str], resume_from: Optional[str],
                   output_dir: str, predicate=None) -> Optional[str]:
    """The (--resume, --resume_from) pair -> a checkpoint dir, or None for
    a fresh start. ``--resume_from <dir>`` wins outright; ``--resume auto``
    (the default) finds the latest valid checkpoint under ``output_dir``;
    ``off`` starts fresh; any other value is a checkpoint dir.
    ``predicate`` filters auto-discovery only."""
    if resume_from is not None:
        return resume_from
    if resume is None or resume == "off":
        return None
    if resume != "auto":
        return resume
    found = find_latest_valid_checkpoint(output_dir, predicate=predicate)
    if found is not None:
        logger.info("--resume auto: found checkpoint %s", found)
    return found


def resolve_resume_agreed(resume: Optional[str], resume_from: Optional[str],
                          output_dir: str, predicate=None) -> Optional[str]:
    """``resolve_resume`` for several ranks: rank 0 alone runs discovery
    and validation (one hash pass, not one per rank) and broadcasts its
    choice, so every rank restores the same checkpoint even while another
    is still landing. One rank: ``resolve_resume``."""
    from building_llm_from_scratch_tpu_torch.parallel import collectives

    if collectives.world() == 1:
        return resolve_resume(resume, resume_from, output_dir,
                              predicate=predicate)
    choice = None
    if collectives.is_coordinator():
        choice = resolve_resume(resume, resume_from, output_dir,
                                predicate=predicate)
    return collectives.broadcast_object(choice)


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------

def prune_checkpoints(output_dir: str, keep: int) -> List[str]:
    """Delete the oldest step-tagged checkpoints, keeping the newest
    ``keep``; ``interrupted`` and ``final`` are never touched. Returns the
    removed paths."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    if not os.path.isdir(output_dir):
        return []
    tagged = []
    for name in os.listdir(output_dir):
        m = _STEP_TAGGED.match(name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            tagged.append((int(m.group(1)), name))
    removed = []
    for _step, name in sorted(tagged)[:-keep]:
        for suffix in ("", ".tmp", ".old"):
            path = os.path.join(output_dir, name + suffix)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
                if not suffix:
                    removed.append(path)
    if removed:
        emit_event("checkpoint_gc", removed=[os.path.basename(p) for p in removed],
                   keep=keep)
        logger.info("Retention: removed %d old checkpoint(s): %s",
                    len(removed), ", ".join(os.path.basename(p)
                                            for p in removed))
    return removed


# ---------------------------------------------------------------------------
# loss watchdog
# ---------------------------------------------------------------------------

class LossWatchdog:
    """Halt on silent divergence: a non-finite train loss, or a spike above
    ``spike_factor`` x the running median of the last ``window`` steps.
    The spike check arms after ``min_history`` observations (capped at the
    window, so it can always arm). ``context_fn()`` (the trainer's health
    digest, ``obs/health.describe_health``) adds fields to the
    ``watchdog_halt`` event and the first non-finite or largest-gradient
    layer group to the message."""

    def __init__(self, spike_factor: float = 10.0, window: int = 50,
                 min_history: int = 20, context_fn=None):
        if spike_factor <= 1.0:
            raise ValueError(f"spike_factor must be > 1, got {spike_factor}")
        self.spike_factor = spike_factor
        self.min_history = min(min_history, window)
        self._history: deque = deque(maxlen=window)
        self.context_fn = context_fn

    def _context(self) -> dict:
        if self.context_fn is None:
            return {}
        try:
            return dict(self.context_fn() or {})
        except Exception as e:      # best effort: never mask the halt
            logger.warning("Watchdog context provider failed: %s", e)
            return {}

    @staticmethod
    def _context_note(ctx: dict) -> str:
        group = ctx.get("first_nonfinite_group")
        if group:
            return f" First non-finite layer group: {group}."
        top = ctx.get("top_grad_norm_groups")
        if top:
            return (f" Largest gradient norm: {top[0].get('group')} "
                    f"({top[0].get('grad_norm')}).")
        return ""

    @staticmethod
    def _merge_fields(fields: dict, ctx: dict) -> dict:
        """Context fields never shadow the event's own."""
        fields.update({k: v for k, v in ctx.items()
                       if k not in fields and k not in ("step", "event", "type",
                                                        "time")})
        return fields

    def observe(self, step: int, loss: float) -> None:
        if not np.isfinite(loss):
            ctx = self._context()
            emit_event("watchdog_halt", step=step, **self._merge_fields(
                dict(loss=float(loss), reason="non_finite", recent=self._tail()),
                ctx))
            raise TrainingDivergedError(
                f"Train loss became non-finite ({loss}) by step {step}. "
                f"Recent losses: {self._tail()}.{self._context_note(ctx)} "
                "The model has diverged — lower the learning rate, raise "
                "warmup, or resume from an earlier checkpoint.")
        if len(self._history) >= self.min_history:
            median = float(np.median(self._history))
            if np.isfinite(loss) and loss > self.spike_factor * max(median, 1e-8):
                ctx = self._context()
                emit_event("watchdog_halt", step=step, **self._merge_fields(
                    dict(loss=float(loss), reason="spike", median=median,
                         spike_factor=self.spike_factor, recent=self._tail()),
                    ctx))
                raise TrainingDivergedError(
                    f"Train loss {loss:.4f} at step {step} spiked above "
                    f"{self.spike_factor:g}x the running median "
                    f"{median:.4f} (window={self._history.maxlen}). Recent "
                    f"losses: {self._tail()}.{self._context_note(ctx)} Halting "
                    "instead of training on a diverged model; resume from an "
                    "earlier checkpoint with a lower LR.")
        self._history.append(float(loss))

    def _tail(self, n: int = 8) -> List[float]:
        return [round(x, 4) for x in list(self._history)[-n:]]
