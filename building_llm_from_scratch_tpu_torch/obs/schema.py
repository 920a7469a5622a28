"""The telemetry schema: every event kind, span shape, tick phase and
trainer segment the port's JSONL sink may emit, declared once (copy of the
serving and training parts of the JAX package's ``obs/schema.py``; the
fleet and fused-finetuning kinds are not registered).

The field sets are the JAX registry's, so a row the port emits is valid
under either package's ``validate_event``. Standard library only."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List

#: the JAX schema version these rows follow (the header carries it)
SCHEMA_VERSION = 13

#: JSONL row discriminators (the ``type`` field)
ROW_TYPES = ("header", "metrics", "health", "event", "span")

#: engine tick phases, in within-tick order: the engine sums wall-clock per
#: phase, logs the sums as ``tick_<phase>_s`` in its cadence rows and
#: exports ``tick_<phase>_seconds`` on ``/metrics``. ``prefill_shard`` (a
#: sequence-sharded prefill) is identically 0 in the port, as in a JAX
#: engine without ``--serve_sp``; ``draft`` is 0 with speculation off.
TICK_PHASES = ("admit", "prefix_copy", "prefill", "prefill_shard", "draft",
               "decode_dispatch", "host_fetch", "sample_commit",
               "callback_detok")

#: the trainer's ``StepTimeline`` segments (``<segment>_s`` fields of the
#: training cadence rows; ``obs/timeline.py`` measures them)
TRAIN_SEGMENTS = ("data_wait", "dispatch", "host_fetch", "eval", "sample",
                  "checkpoint")

#: event kinds rendered as instants on a trace's incidents track
INCIDENT_EVENTS = ("engine_restart", "drain", "serve_error", "stall",
                   "watchdog_halt", "preemption_signal", "preemption_stop",
                   "checkpoint_fallback", "serve_warmup", "memory_pressure",
                   "memory_drift")

#: request-lifecycle event kinds, pinned to the request's own track
REQUEST_EVENTS = ("request_done", "request_rejected", "request_shed",
                  "request_expired", "request_failed")

#: lifecycle kinds that open a serving report even when no request finished
SERVING_LIFECYCLE_EVENTS = ("engine_restart", "drain", "serve_error")

#: root span names of ``span`` rows (one tree a row)
SPAN_NAMES = ("request",)

#: child spans under a ``request`` root, in lifecycle order
REQUEST_SPAN_PHASES = ("queued", "prefill", "decode")


@dataclass(frozen=True)
class EventSpec:
    """Declared shape of one ``event`` row kind: ``required`` fields every
    emission carries, ``optional`` ones it may carry; ``open_fields``
    admits dynamic keys (a stats snapshot)."""

    name: str
    required: FrozenSet[str] = frozenset()
    optional: FrozenSet[str] = frozenset()
    open_fields: bool = False
    doc: str = ""

    def known_fields(self) -> FrozenSet[str]:
        return self.required | self.optional | ALWAYS_ALLOWED_FIELDS


#: fields any event row may carry (the row envelope and ``step``)
ALWAYS_ALLOWED_FIELDS = frozenset({"step", "type", "time", "event"})


def _spec(name: str, required=(), optional=(), open_fields=False,
          doc: str = "") -> EventSpec:
    return EventSpec(name, frozenset(required), frozenset(optional),
                     open_fields, doc)


_EVENT_LIST: List[EventSpec] = [
    # -- run lifecycle ----------------------------------------------------
    _spec("run_complete", optional=("tokens_seen", "final_train_loss"),
          doc="training main() reached its normal end"),
    # -- checkpoints ------------------------------------------------------
    _spec("checkpoint_save", required=("path",),
          optional=("seconds", "bytes", "leaves", "writer"),
          doc="one durable checkpoint commit (sync or async writer)"),
    _spec("checkpoint_restore", required=("path",),
          optional=("seconds", "leaves"),
          doc="checkpoint loaded into the train state"),
    _spec("checkpoint_fallback", required=("path", "reason"),
          doc="--resume auto skipped an invalid checkpoint"),
    _spec("checkpoint_gc", optional=("removed", "keep"),
          doc="--keep_ckpts retention removed old checkpoints"),
    _spec("ckpt_async_save", required=("path",),
          optional=("snapshot_s", "write_s", "overlap_s"),
          doc="async checkpoint: snapshot/write/overlap seconds"),
    # -- resilience -------------------------------------------------------
    _spec("preemption_signal", required=("signal",),
          doc="SIGTERM/SIGINT observed; stop at the next step boundary"),
    _spec("preemption_stop", optional=("tokens_seen",),
          doc="graceful stop checkpoint written at the step boundary"),
    _spec("watchdog_halt", required=("reason",),
          optional=("loss", "recent", "median", "spike_factor"),
          open_fields=True,
          doc="loss watchdog halt (+ the per-layer-group health context)"),
    _spec("stall", optional=("elapsed_s", "threshold_s", "memory"),
          doc="flight recorder fired: stacks and device memory dumped"),
    _spec("request_done", required=("request_id",),
          optional=("n_prompt_tokens", "n_tokens", "finish_reason", "slot",
                    "deadline_s", "queue_wait_s", "ttft_s", "tpot_s",
                    "e2e_s", "adapter", "spec_drafted", "spec_accepted",
                    "kv_bytes_peak", "prefix_bytes_saved", "long_prompt",
                    "replica"),
          doc="one request completed normally (latency summary)"),
    _spec("request_rejected", required=("request_id", "reason"),
          optional=("queue_depth", "replica"),
          doc="bounded queue at capacity at submit (HTTP 429)"),
    _spec("request_shed", required=("request_id", "reason"),
          optional=("queue_depth", "deadline_s", "estimated_e2e_s",
                    "retry_after_s", "replica"),
          doc="SLO-predicted deadline miss rejected at submit"),
    _spec("request_expired", required=("request_id", "reason"),
          optional=("deadline_s", "queue_wait_s", "queue_depth", "replica"),
          doc="deadline passed while queued (TTL shed, HTTP 504)"),
    _spec("request_failed", required=("request_id", "reason"),
          optional=("error", "slot", "n_tokens", "adapter", "replica"),
          doc="one request failed in isolation (or engine death/restart)"),
    # -- serving: multi-tenant LoRA adapters ------------------------------
    _spec("adapter_load", required=("name",),
          optional=("path", "row", "rank", "alpha", "seconds",
                    "n_loaded", "capacity"),
          doc="registry loaded an adapter into a pool row (same shapes)"),
    _spec("adapter_evict", required=("name",),
          optional=("row", "n_loaded"),
          doc="registry unloaded an adapter (row reused once no active "
              "slot references it)"),
    # -- serving: KV-cache policy -----------------------------------------
    _spec("prefix_evict", required=("key",),
          optional=("bytes", "span_tokens", "hits", "age_s",
                    "entries_left", "bytes_left"),
          doc="LRU eviction under the prefix store's byte budget "
              "(pinned entries are never evicted)"),
    _spec("serve_warmup",
          optional=("n_prefill_buckets", "buckets", "seconds", "n_slots",
                    "max_len", "kv_quant", "prefix_cache", "prefill_chunk",
                    "kv_bytes_per_slot", "prefix_pane_tokens", "spec_k",
                    "drafter", "replica", "kv_paged", "page_tokens",
                    "pool_pages", "sp", "prompt_pane_tokens", "max_prompt"),
          doc="the engine is ready to serve (the port: kernels built)"),
    _spec("serve_summary", open_fields=True,
          doc="shutdown stats snapshot (histogram percentiles, counters)"),
    _spec("serve_error", required=("error",),
          optional=("n_failed", "failed_request_ids", "replica"),
          doc="engine died; every in-flight and queued request failed"),
    _spec("engine_restart", required=("reason",),
          optional=("detail", "n_restart", "max_restarts", "backoff_s",
                    "n_inflight_failed", "failed_request_ids",
                    "queue_depth", "replica"),
          doc="supervisor abandoned a wedged loop and restarted it"),
    _spec("drain", required=("phase",),
          optional=("timeout_s", "n_active", "queue_depth", "n_preempted",
                    "seconds", "requests_finished", "replica"),
          doc="graceful drain bracketing events (phase: start|end)"),
    _spec("memory_snapshot", required=("source", "components"),
          optional=("total_bytes", "device_bytes", "host_bytes",
                    "capacity_bytes", "headroom_bytes", "labeled",
                    "replica"),
          doc="one memory-ledger cadence snapshot: component -> bytes"),
    _spec("memory_drift", required=("component", "reason"),
          optional=("expected_bytes", "measured_bytes", "delta_bytes",
                    "streak", "pinned_bytes", "pinned_entries",
                    "device_bytes", "ledger_bytes", "source", "replica"),
          doc="a ledger component diverged from its exact expectation"),
    _spec("memory_pressure", required=("headroom_bytes", "capacity_bytes"),
          optional=("used_frac", "threshold_frac", "device_bytes",
                    "total_bytes", "components", "labeled", "source",
                    "replica"),
          doc="device components crossed the pressure fraction"),
]

#: kind -> EventSpec
EVENTS: Dict[str, EventSpec] = {s.name: s for s in _EVENT_LIST}


def validate_event(kind: str, fields: Dict[str, Any]) -> List[str]:
    """Schema-check one event emission; returns the problems (empty =
    conforming). Emission itself stays unvalidated: a telemetry row must
    never fail the run it observes."""
    spec = EVENTS.get(kind)
    if spec is None:
        return [f"unregistered event kind '{kind}'"]
    problems = []
    missing = spec.required - set(fields) - ALWAYS_ALLOWED_FIELDS
    if missing:
        problems.append(f"event '{kind}' missing required field(s) "
                        f"{sorted(missing)}")
    if not spec.open_fields:
        unknown = set(fields) - spec.known_fields()
        if unknown:
            problems.append(f"event '{kind}' carries undeclared field(s) "
                            f"{sorted(unknown)}")
    return problems


for _group in (INCIDENT_EVENTS, REQUEST_EVENTS, SERVING_LIFECYCLE_EVENTS):
    for _name in _group:
        assert _name in EVENTS, f"{_name} not in the event registry"
