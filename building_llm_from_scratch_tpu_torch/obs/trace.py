"""Run-trace export: metrics JSONL -> Chrome trace-event JSON (Perfetto)
(port of the JAX package's ``obs/trace.py``).

The metrics JSONL (obs/metrics.py) already records everything that
happened in a run — request ``span`` rows from the serving engine, the
trainer's ``StepTimeline`` cadence windows, the engine's per-tick phase
breakdown, compile/recompile events, and every incident (restart, drain,
stall, watchdog halt, preemption). This module renders that one artifact
as ONE timeline: a Chrome trace-event JSON file loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``, so a whole run —
training and serving tiers alike — is scrubbable instead of greppable.

Track layout (Chrome trace ``pid``/``tid`` become Perfetto process/thread
tracks):

  - ``requests``  — one track per request id: the root ``request`` span
    with its ``queued``/``prefill``/``decode`` children, plus instant
    markers for that request's lifecycle events (rejected, shed, expired,
    failed). Span rows are emitted once, at the request's terminal state.
  - ``engine``    — the tick-phase breakdown at the engine's metrics
    cadence: each window is a ``ticks xN`` slice whose children are the
    window's per-phase AGGREGATES (admit, prefill, decode_dispatch,
    host_fetch, sample_commit, callback_detok) laid end-to-end. Phases
    interleave tick-by-tick in reality; the aggregate layout preserves
    the budget split, which is what head-of-line diagnosis needs.
    Counter tracks carry slot occupancy and queue depth.
  - ``train``     — the ``StepTimeline`` cadence windows (data_wait,
    dispatch, host_fetch, eval, sample, checkpoint), same aggregate
    layout, plus loss/throughput counters.
  - ``incidents`` — instants for restarts, drains, stalls, watchdog
    halts, preemption signals, engine death; ``compile``/``recompile``
    events as slices (their measured compile seconds).

Timestamps are unix-epoch microseconds rebased to the first event, so
every row type lands on one consistent clock (span rows carry wall-clock
``t0`` precisely for this join).

CLI:  python -m building_llm_from_scratch_tpu_torch.obs.trace \
          out/metrics.jsonl [-o out/trace.json]
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

# the phase/segment/event tables live in the schema registry
from building_llm_from_scratch_tpu_torch.obs.schema import (
    INCIDENT_EVENTS,
    REQUEST_EVENTS,
    TICK_PHASES,
    TRAIN_SEGMENTS,
)

_PID_REQUESTS, _PID_ENGINE, _PID_TRAIN, _PID_INCIDENTS = 1, 2, 3, 4


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    return out


def _x(name: str, pid: int, tid: int, ts_us: float, dur_us: float,
       cat: str, args: Optional[dict] = None) -> dict:
    ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
          "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
          "cat": cat}
    if args:
        ev["args"] = args
    return ev


def _instant(name: str, pid: int, tid: int, ts_us: float, cat: str,
             args: Optional[dict] = None) -> dict:
    ev = {"ph": "i", "s": "t", "name": name, "pid": pid, "tid": tid,
          "ts": round(ts_us, 3), "cat": cat}
    if args:
        ev["args"] = args
    return ev


def _counter(name: str, pid: int, ts_us: float, values: dict) -> dict:
    return {"ph": "C", "name": name, "pid": pid, "tid": 0,
            "ts": round(ts_us, 3), "args": values}


def _num(row: dict, key: str) -> Optional[float]:
    v = row.get(key)
    return float(v) if isinstance(v, (int, float)) else None


def _memory_counters(row: dict, pid: int, ts_us: float) -> List[dict]:
    """One ``memory_snapshot`` event -> Perfetto counter samples: the
    component composition as ONE stacked counter track (Perfetto stacks
    the args keys), plus a headroom track when capacity is known. The
    values are the ledger's deterministic ``nbytes`` sums — identical
    runs produce byte-identical tracks (keys sorted so the rendering
    never depends on emission order). ``host_rss`` is the one POLLED
    component (OS-dependent, run-to-run noise) and is host memory
    besides — it stays off the device-composition track."""
    events: List[dict] = []
    comps = row.get("components")
    if isinstance(comps, dict):
        values = {k: comps[k] for k in sorted(comps)
                  if k != "host_rss"
                  and isinstance(comps[k], (int, float))}
        if values:
            events.append(_counter("memory (bytes)", pid, ts_us, values))
    headroom = row.get("headroom_bytes")
    if isinstance(headroom, (int, float)):
        events.append(_counter("memory headroom (bytes)", pid, ts_us,
                               {"headroom": headroom}))
    return events


def load_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue                      # a torn row must not kill export
    return rows


def _span_events(row: dict, base_s: float) -> List[dict]:
    """One request span row -> root X + child X events on its own track."""
    rid = row.get("request_id")
    tid = int(rid) if isinstance(rid, int) else 0
    args = {k: v for k, v in row.items()
            if k not in ("type", "time", "children", "t0", "dur_s", "cat",
                         "name")}
    t0 = _num(row, "t0")
    dur = _num(row, "dur_s")
    if t0 is None or dur is None:
        return []
    out = [_x(str(row.get("name", "span")), _PID_REQUESTS, tid,
              (t0 - base_s) * 1e6, dur * 1e6, str(row.get("cat", "span")),
              args)]
    for c in row.get("children") or []:
        ct0, cdur = _num(c, "t0"), _num(c, "dur_s")
        if ct0 is None or cdur is None:
            continue
        out.append(_x(str(c.get("name", "phase")), _PID_REQUESTS, tid,
                      (ct0 - base_s) * 1e6, cdur * 1e6, "request_phase"))
    return out


def _window_events(row: dict, pid: int, label: str, phases,
                   prefix: str, base_s: float, t_prev: Optional[float],
                   n_key: str) -> List[dict]:
    """One cadence metrics row -> a window slice + sequential per-phase
    aggregate children. ``prefix`` maps phase -> row field (e.g.
    ``tick_admit_s``); the window ends at the row's wall time."""
    t_end = _num(row, "time")
    if t_end is None:
        return []
    sums = {ph: (_num(row, f"{prefix}{ph}_s") or 0.0) for ph in phases}
    total = sum(sums.values())
    if total <= 0:
        return []
    win_t0 = _num(row, "win_t0")
    if win_t0 is None:
        # trainer rows carry no window anchor: reconstruct from the
        # previous cadence row, floored at the phase-sum (clock skew)
        win_t0 = t_prev if t_prev is not None else t_end - total
        win_t0 = min(win_t0, t_end - total)
    n = row.get(n_key)
    name = f"{label} x{int(n)}" if isinstance(n, (int, float)) else label
    out = [_x(name, pid, 1, (win_t0 - base_s) * 1e6,
              (t_end - win_t0) * 1e6, label,
              {k: v for k, v in row.items()
               if isinstance(v, (int, float)) and k != "time"})]
    cursor = win_t0
    for ph in phases:
        if sums[ph] <= 0:
            continue
        out.append(_x(ph, pid, 2, (cursor - base_s) * 1e6,
                      sums[ph] * 1e6, f"{label}_phase"))
        cursor += sums[ph]
    return out


def chrome_trace(rows: List[dict],
                 base_s: Optional[float] = None) -> Dict[str, Any]:
    """Convert parsed metrics-JSONL rows to a Chrome trace-event dict
    (``json.dump`` it to get a Perfetto-loadable file). ``base_s`` pins
    the epoch the timeline rebases onto (a caller merging several files
    passes their minimum, so every process shares one clock); single-file
    export derives it from this file's rows."""
    if base_s is None:
        times = [r["time"] for r in rows
                 if isinstance(r.get("time"), (int, float))]
        times += [r["t0"] for r in rows if r.get("type") == "span"
                  and isinstance(r.get("t0"), (int, float))]
        base_s = min(times) if times else 0.0
    events: List[dict] = []
    events += _meta(_PID_REQUESTS, "requests")
    events += _meta(_PID_ENGINE, "engine", 1, "tick windows")
    events += _meta(_PID_ENGINE, "engine", 2, "tick phases")
    events += _meta(_PID_TRAIN, "train", 1, "step windows")
    events += _meta(_PID_TRAIN, "train", 2, "step phases")
    events += _meta(_PID_INCIDENTS, "incidents", 1, "incidents")
    events += _meta(_PID_INCIDENTS, "incidents", 2, "compiles")

    n_request_spans = n_tick_windows = n_train_windows = 0
    t_prev_tick: Optional[float] = None
    t_prev_train: Optional[float] = None
    named_req_tracks = set()
    for row in rows:
        kind = row.get("type")
        t = _num(row, "time")
        if kind == "span":
            evs = _span_events(row, base_s)
            if evs:
                n_request_spans += 1
                rid = row.get("request_id")
                if isinstance(rid, int) and rid not in named_req_tracks:
                    named_req_tracks.add(rid)
                    events.append(
                        {"ph": "M", "pid": _PID_REQUESTS, "tid": rid,
                         "name": "thread_name",
                         "args": {"name": f"request {rid}"}})
            events += evs
        elif kind == "metrics" and t is not None:
            if _num(row, "tick_total_s"):
                evs = _window_events(row, _PID_ENGINE, "ticks",
                                     TICK_PHASES, "tick_", base_s,
                                     t_prev_tick, "ticks_in_window")
                if evs:
                    n_tick_windows += 1
                events += evs
                t_prev_tick = t
                gauges = {k: row[k] for k in ("slot_occupancy",
                                              "queue_depth")
                          if isinstance(row.get(k), (int, float))}
                if gauges:
                    events.append(_counter("engine load", _PID_ENGINE,
                                           (t - base_s) * 1e6, gauges))
            elif any(_num(row, f"{s}_s") for s in TRAIN_SEGMENTS):
                evs = _window_events(row, _PID_TRAIN, "steps",
                                     TRAIN_SEGMENTS, "", base_s,
                                     t_prev_train, "steps_in_window")
                if evs:
                    n_train_windows += 1
                events += evs
                t_prev_train = t
        elif kind == "event" and t is not None:
            name = row.get("event")
            args = {k: v for k, v in row.items()
                    if k not in ("type", "time")}
            ts_us = (t - base_s) * 1e6
            if name in ("compile", "recompile"):
                dur = _num(row, "compile_seconds") or 0.0
                events.append(_x(f"{name}:{row.get('label', '?')}",
                                 _PID_INCIDENTS, 2,
                                 ts_us - dur * 1e6, dur * 1e6,
                                 "compile", args))
            elif name == "memory_snapshot":
                # memory composition over time, next to the tick/step
                # phases of whichever tier emitted it
                events += _memory_counters(
                    row, _PID_TRAIN if row.get("source") == "trainer"
                    else _PID_ENGINE, ts_us)
            elif name in REQUEST_EVENTS and isinstance(
                    row.get("request_id"), int):
                events.append(_instant(name, _PID_REQUESTS,
                                       int(row["request_id"]), ts_us,
                                       "request_event", args))
            elif name in INCIDENT_EVENTS:
                events.append(_instant(str(name), _PID_INCIDENTS, 1,
                                       ts_us, "incident", args))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "source": "building_llm_from_scratch_tpu_torch obs/trace.py",
            "n_request_spans": n_request_spans,
            "n_tick_windows": n_tick_windows,
            "n_train_windows": n_train_windows,
            "trace_base_unix_s": base_s,
        },
    }


def export_chrome_trace(jsonl_path: str, out_path: str) -> Dict[str, Any]:
    """Render ``jsonl_path`` as Chrome trace JSON at ``out_path``; returns
    the trace's ``metadata`` summary (span/window counts)."""
    trace = chrome_trace(load_jsonl(jsonl_path))
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return trace["metadata"]


def main(argv=None) -> int:
    import argparse
    import os

    p = argparse.ArgumentParser(
        description="Export a --metrics_jsonl file as Chrome trace-event "
                    "JSON (load it at https://ui.perfetto.dev).")
    p.add_argument("jsonl", help="metrics JSONL written by --metrics_jsonl")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: <jsonl>.trace.json)")
    args = p.parse_args(argv)
    out = args.out or (os.path.splitext(args.jsonl)[0] + ".trace.json")
    meta = export_chrome_trace(args.jsonl, out)
    print(f"wrote {out}: {meta['n_request_spans']} request spans, "
          f"{meta['n_tick_windows']} tick windows, "
          f"{meta['n_train_windows']} train windows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
