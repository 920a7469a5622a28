"""Serving operations in the port (``serving/supervisor.py``, the engine's
deadlines, shed, cancel, drain and restart, ``serving/frontend.py``'s HTTP
endpoint and signal drain, ``obs/``) against the JAX package on the same
weights (``params_from_jax``).

Every scenario of ``tests/test_serving_resilience.py`` runs on both
engines with the same hooks (a duck-typed ``FaultHooks``, marking poison
requests by their first prompt token): each request's outcome must be the
same, and every surviving greedy request's tokens bit-equal to JAX's and
to a fault-free run of the same engine. Nothing sleeps to make an event
happen: hooks block on ``threading.Event`` objects at fixed points of the
tick, and a deadline expires while ``before_tick`` holds the loop. The
HTTP servers bind port 0 on loopback.

Tolerances: none. Estimates and the Prometheus text are compared exactly,
tokens bit for bit (fp32 greedy decoding on the same weights)."""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from building_llm_from_scratch_tpu.obs import metrics as jmetrics
from building_llm_from_scratch_tpu.obs import schema as jschema
from building_llm_from_scratch_tpu.serving import DecodeEngine as JEngine
from building_llm_from_scratch_tpu.serving import SamplingParams as JParams
from building_llm_from_scratch_tpu.serving import engine as jengine_mod
from building_llm_from_scratch_tpu.serving import frontend as jfrontend
from building_llm_from_scratch_tpu.serving.kvcache import (
    KVCachePolicy as JPolicy,
)
from building_llm_from_scratch_tpu.serving.queue import (
    EngineDrainingError as JDraining,
)
from building_llm_from_scratch_tpu.serving.queue import SLOShedError as JShed
from building_llm_from_scratch_tpu.serving.request import (
    RequestExpiredError as JExpired,
)
from building_llm_from_scratch_tpu_torch.args import get_args
from building_llm_from_scratch_tpu_torch.obs import metrics as tmetrics
from building_llm_from_scratch_tpu_torch.obs import schema as tschema
from building_llm_from_scratch_tpu_torch.obs.memory import MemoryLedger
from building_llm_from_scratch_tpu_torch.obs.stall import StallDetector
from building_llm_from_scratch_tpu_torch.serving import engine as tengine_mod
from building_llm_from_scratch_tpu_torch.serving import frontend as tfrontend
from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy
from building_llm_from_scratch_tpu_torch.serving.queue import (
    EngineDrainingError,
    SLOShedError,
)
from building_llm_from_scratch_tpu_torch.serving.request import (
    RequestExpiredError,
    SamplingParams,
)
from building_llm_from_scratch_tpu_torch.serving.supervisor import (
    make_serve_stall_detector,
)
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    params_from_jax,
)
from torch_port_helpers import jax_params, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POISON = 9          # first prompt token of a poison request
PAGED = dict(prefill_chunk=16, paged=True, page_tokens=16)


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, kw in (("llama", {}), ("gpt2", {}),
                     ("gpt2-ctx256", dict(context_length=256))):
        jcfg, tcfg = small_configs(kind.split("-")[0], **kw)
        params, np_params = jax_params(jcfg, seed=0)
        out[kind] = (jcfg, params, params_from_jax(np_params, tcfg, device="cpu"))
    return out


def make(models, kind, pkg, **kw):
    """A fresh engine of package ``pkg`` ("jax" or "port") on the shared
    weights; ``kv_policy`` is given as a dict."""
    jcfg, params, model = models[kind]
    kw.setdefault("max_len", 64)
    policy = kw.pop("kv_policy", None)
    if pkg == "jax":
        return JEngine(jcfg, params, watch_compiles=False,
                       kv_policy=JPolicy(**policy) if policy else None, **kw)
    return DecodeEngine(model, kv_policy=KVCachePolicy(**policy) if policy
                        else None, **kw)


def sp(pkg, **kw):
    return (JParams if pkg == "jax" else SamplingParams)(**kw)


class Hooks:
    """Fault hooks both packages' engines call. ``poison_prefill`` /
    ``poison_nan``: marks (first prompt token) of poison requests;
    ``expire``: requests ``before_tick`` waits out (their deadlines pass
    while it holds the loop); ``hang``: when set, the next tick blocks on
    ``release``; ``first_token``: set at the first accepted token, after
    which that token's thread waits for ``go``."""

    def __init__(self, poison_prefill=(), poison_nan=(), gate_first=False):
        self.poison_prefill = set(poison_prefill)
        self.poison_nan_marks = set(poison_nan)
        self.expire = []
        self.hang = threading.Event()
        self.release = threading.Event()
        self.first_token = threading.Event()
        self.go = threading.Event()
        self.gate_first = gate_first
        self._idle = threading.Event()          # never set: a bounded wait

    def before_tick(self, engine):
        for r in self.expire:
            while not r.expired():
                self._idle.wait(0.002)
        self.expire = []
        if self.hang.is_set():
            self.hang.clear()
            self.release.wait(30)

    def before_prefill(self, req):
        if int(req.prompt_ids[0]) in self.poison_prefill:
            raise RuntimeError("injected prefill fault")

    def poison_nan(self, req):
        return int(req.prompt_ids[0]) in self.poison_nan_marks

    def after_token(self, req, tok):
        if self.gate_first and not self.first_token.is_set():
            self.first_token.set()
            self.go.wait(30)


def outcomes(handles):
    return [h.finish_reason for h in handles]


def greedy_tokens(handles, params):
    return [h.output_ids for h, p in zip(handles, params) if p["temperature"] == 0]


# ---------------------------------------------------------------------------
# pure parts: estimates, histograms, the Prometheus text, the schema
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(depth=st.integers(0, 64), active=st.integers(0, 16),
       slots=st.integers(0, 16), new=st.integers(1, 512),
       tpot=st.one_of(st.none(), st.floats(1e-4, 1.0)),
       toks=st.one_of(st.none(), st.floats(1.0, 512.0)))
def test_service_estimates_equal_jax(depth, active, slots, new, tpot, toks):
    assert tengine_mod.service_estimate(depth, active, slots, tpot, toks, new) == \
        jengine_mod.service_estimate(depth, active, slots, tpot, toks, new)
    assert tengine_mod.queue_clear_estimate(depth, active, slots, tpot, toks) == \
        jengine_mod.queue_clear_estimate(depth, active, slots, tpot, toks)


def _histograms(mod, values):
    hists = {"ttft_seconds": mod.Histogram(),
             "tick_prefill_seconds": mod.Histogram(bounds=(0.001, 0.01, 0.1)),
             'ttft_seconds_r{replica="1"}': mod.Histogram()}
    for i, v in enumerate(values):
        for h in hists.values():
            h.observe(v * (1 + i % 3))
    return hists


def test_render_prometheus_byte_equal_to_jax():
    values = list(np.random.default_rng(3).exponential(0.2, 57))
    counters = {"requests_finished": 12, "tick_admit_seconds": 0.123456,
                'adapter_requests_finished{adapter="a"}': 3,
                'adapter_requests_finished{adapter="b"}': 4,
                "already_total": 5, "skipped": "text"}
    gauges = {"slot_occupancy": 0.75, "queue_depth": 3,
              'mem_component_bytes{component="slot_kv"}': 123456789,
              "engine_up": 1.0}
    port = tmetrics.render_prometheus(counters, gauges,
                                      _histograms(tmetrics, values),
                                      prefix="bllm_serve_")
    ref = jmetrics.render_prometheus(counters, gauges,
                                     _histograms(jmetrics, values),
                                     prefix="bllm_serve_")
    assert port == ref
    assert "bllm_serve_ttft_seconds_bucket{le=\"+Inf\"} 57" in port


def test_histogram_and_rolling_ratio_equal_jax():
    values = list(np.random.default_rng(5).exponential(0.5, 200))
    th, jh = tmetrics.Histogram(), jmetrics.Histogram()
    for v in values:
        th.observe(v)
        jh.observe(v)
    assert th.snapshot() == jh.snapshot()
    for p in (1, 50, 90, 95, 99, 100):
        assert th.percentile(p) == jh.percentile(p)
    assert tmetrics.Histogram().percentile(50) is None
    tr, jr = tmetrics.RollingRatio(10.0, 5), jmetrics.RollingRatio(10.0, 5)
    for i, miss in enumerate([True, False, False, True, False] * 4):
        tr.observe(miss, now=100.0 + i)
        jr.observe(miss, now=100.0 + i)
    for now in (110.0, 115.0, 125.0, 200.0):
        assert tr.counts(now) == jr.counts(now)
        assert tr.ratio(now) == jr.ratio(now)


def test_schema_tables_are_jax_subsets():
    assert tschema.TICK_PHASES == jschema.TICK_PHASES
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert tschema.ROW_TYPES == jschema.ROW_TYPES
    for name, spec in tschema.EVENTS.items():
        ref = jschema.EVENTS[name]
        assert (spec.required, spec.optional, spec.open_fields) == \
            (ref.required, ref.optional, ref.open_fields), name
    for group in ("INCIDENT_EVENTS", "REQUEST_EVENTS",
                  "SERVING_LIFECYCLE_EVENTS"):
        assert set(getattr(tschema, group)) <= set(getattr(jschema, group))
    assert tschema.validate_event("nope", {}) == jschema.validate_event("nope", {})
    assert tschema.validate_event("drain", {"x": 1}) == \
        jschema.validate_event("drain", {"x": 1})


def test_metric_logger_header_first_and_rotation(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = tmetrics.MetricLogger(path)
    sink.event("stall", elapsed_s=1.0)          # before the header: buffered
    sink.write_header(test=True)
    sink.log_metrics(4, tick_admit_s=0.5)
    sink.log_span("request", t0=1.0, dur_s=2.0, request_id=7,
                  children=[{"name": "queued", "t0": 0.5, "dur_s": 9.0}])
    sink.close()
    rows = [json.loads(line) for line in open(path)]
    assert [r["type"] for r in rows] == ["header", "event", "metrics", "span"]
    assert rows[0]["schema_version"] == jschema.SCHEMA_VERSION
    assert rows[2]["event:stall"] == 1          # counters ride metrics rows
    # children clamped inside the root, as the JAX sink does
    assert rows[3]["children"] == [{"name": "queued", "t0": 1.0, "dur_s": 2.0}]
    sink2 = tmetrics.MetricLogger(path)
    sink2.write_header(second=True)
    sink2.close()
    assert os.path.exists(path + ".1")
    assert json.loads(open(path).readline())["second"] is True


def test_stall_detector_fires_once_per_gap_and_rearms():
    fired = []
    gate = threading.Event()

    def on_stall(elapsed, thr):
        fired.append(thr)
        gate.set()

    det = StallDetector(timeout=0.2, first_grace=1.0, median_floor=0.2,
                        poll_interval=0.02, on_stall=on_stall)
    with det:
        assert gate.wait(10)
        gate.clear()
        det.notify_step()                       # re-arms
        assert gate.wait(10)
    assert det.stall_count == len(fired) == 2
    assert fired[0] == pytest.approx(0.2)
    serve = make_serve_stall_detector(3.0)
    assert (serve.timeout, serve.median_floor, serve.first_grace) == (3.0, 3.0, 2.0)


def test_memory_ledger_reconciles_and_flags_drift():
    events = []
    sizes = {"a": 100}
    led = MemoryLedger(emit=lambda kind, **f: events.append((kind, f)),
                       capacity_bytes=1000, pressure_frac=0.5)
    led.register("a", lambda: sizes["a"], expected=lambda: 100)
    led.register("b", lambda: 50, device=False)
    led.register_labeled("kv_live_bytes", "tenant", lambda: {"base": 7})
    led.observe(1)
    assert [k for k, _ in events] == ["memory_snapshot"]
    assert events[0][1]["components"] == {"a": 100, "b": 50}
    sizes["a"] = 600                            # drift and pressure
    led.observe(2)
    kinds = [k for k, _ in events]
    assert kinds.count("memory_drift") == 1 and kinds.count("memory_pressure") == 1
    for kind, fields in events:
        assert jschema.validate_event(kind, fields) == []
    g = led.gauges()
    assert g['mem_component_peak_bytes{component="a"}'] == 600
    assert g["mem_device_bytes"] == 600 and g["mem_headroom_bytes"] == 400
    assert g['kv_live_bytes{tenant="base"}'] == 7


# ---------------------------------------------------------------------------
# deadline-aware admission
# ---------------------------------------------------------------------------

def test_queue_ttl_expiry_sheds_at_admission(models):
    for pkg in ("jax", "port"):
        hooks = Hooks()
        eng = make(models, "llama", pkg, n_slots=1, hooks=hooks)
        p = np.array([5, 6, 7], np.int32)
        h = eng.submit(p, sp(pkg, max_new_tokens=4, ignore_eos=True,
                             deadline_s=0.05))
        hooks.expire = [h]                      # the tick holds until it expired
        ticks = eng.n_ticks
        eng.run_until_idle()
        assert h.done and h.finish_reason == "expired"
        with pytest.raises(JExpired if pkg == "jax" else RequestExpiredError,
                           match="expired"):
            h.result(timeout=1)
        assert eng.requests_expired == 1 and eng.n_ticks == ticks
        h2 = eng.submit(p, sp(pkg, max_new_tokens=3, ignore_eos=True,
                              deadline_s=60.0))
        eng.run_until_idle()
        assert h2.result().finish_reason == "length"


def test_slo_shed_decision_matches_jax(models):
    seen = {}
    for pkg in ("jax", "port"):
        eng = make(models, "llama", pkg, n_slots=2)
        assert eng.estimate_completion_s(4, 5) is None
        eng._tpot_ewma, eng._tokens_ewma = 0.1, 10.0
        p = np.array([2, 3], np.int32)
        for _ in range(3):
            eng.submit(p, sp(pkg, max_new_tokens=2, ignore_eos=True))
        est = eng.estimate_completion_s(3, 2)
        with pytest.raises(JShed if pkg == "jax" else SLOShedError) as ei:
            eng.submit(p, sp(pkg, max_new_tokens=2, ignore_eos=True,
                             deadline_s=1.0))
        h = eng.submit(p, sp(pkg, max_new_tokens=2, ignore_eos=True,
                             deadline_s=60.0))
        eng.run_until_idle()
        eng._tpot_ewma, eng._tokens_ewma = 0.1, 10.0
        for _ in range(2):
            eng.submit(p, sp(pkg, max_new_tokens=10, ignore_eos=True))
        eng.step()
        seen[pkg] = (est, ei.value.retry_after_s, eng.requests_shed,
                     h.result().finish_reason, eng.scheduler.n_active,
                     eng.estimate_completion_s(0, 5))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == pytest.approx(1.7)
    assert seen["port"][-1] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# per-request fault isolation
# ---------------------------------------------------------------------------

def _traffic(vocab, n=3):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(10, vocab, (4 + i,)).astype(np.int32)
               for i in range(n)]
    params = [dict(max_new_tokens=6 + i, seed=i, ignore_eos=True,
                   temperature=0.8 * (i % 2), top_k=9 if i % 2 else None)
              for i in range(n)]
    return prompts, params


def _bad_callback(req, tok, piece):
    raise RuntimeError("boom from user callback")


def _isolation_run(models, kind, pkg, hooks, poison_prompt, policy=None,
                   on_token_bad=False):
    """Traffic of three requests with a poison one admitted mid-stream
    (after request 0's first tick); returns (handles, poison handle)."""
    vocab = models[kind][0].vocab_size
    prompts, params = _traffic(vocab)
    eng = make(models, kind, pkg, n_slots=3, hooks=hooks, kv_policy=policy)
    h0 = eng.submit(prompts[0], sp(pkg, **params[0]))
    assert eng.step()
    hp = eng.submit(poison_prompt, sp(pkg, max_new_tokens=8, ignore_eos=True),
                    on_token=_bad_callback if on_token_bad else None)
    rest = [eng.submit(p, sp(pkg, **pr)) for p, pr in zip(prompts[1:], params[1:])]
    eng.run_until_idle()
    assert eng._dead is None and eng.scheduler.n_active == 0
    assert len(eng.queue) == 0 and eng.requests_failed == 1
    return [h0] + rest, hp, eng


def _reference_tokens(models, kind, policy=None):
    """The port's tokens of the same traffic without a fault (sampled rows
    included; the packages' random streams differ, so JAX is compared on
    the greedy rows)."""
    vocab = models[kind][0].vocab_size
    prompts, params = _traffic(vocab)
    eng = make(models, kind, "port", n_slots=3, kv_policy=policy)
    hs = [eng.submit(p, SamplingParams(**pr)) for p, pr in zip(prompts, params)]
    eng.run_until_idle()
    return [h.output_ids for h in hs]


@pytest.mark.parametrize("kind", ["llama", "gpt2"])
def test_poison_prefill_fails_alone_coresidents_bit_equal(models, kind):
    _, params = _traffic(models[kind][0].vocab_size)
    runs = {}
    for pkg in ("jax", "port"):
        hooks = Hooks(poison_prefill={POISON})
        hs, hp, _ = _isolation_run(models, kind, pkg, hooks,
                                   np.array([POISON, 9, 9], np.int32))
        assert hp.finish_reason == "error" and "prefill" in hp.error
        assert outcomes(hs) == ["length"] * 3
        if pkg == "port":
            assert [h.output_ids for h in hs] == _reference_tokens(models, kind)
        runs[pkg] = greedy_tokens(hs, params)
    assert runs["port"] == runs["jax"]


def test_raising_on_token_callback_fails_request_alone(models):
    runs = {}
    _, params = _traffic(models["llama"][0].vocab_size)
    for pkg in ("jax", "port"):
        hs, hp, _ = _isolation_run(models, "llama", pkg, Hooks(),
                                   np.array([2, 3, 4], np.int32),
                                   on_token_bad=True)
        assert hp.finish_reason == "error" and "callback" in hp.error
        if pkg == "port":
            assert [h.output_ids for h in hs] == _reference_tokens(models, "llama")
        runs[pkg] = (outcomes(hs), greedy_tokens(hs, params))
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("policy", [None, PAGED], ids=["contiguous", "paged"])
def test_non_finite_logits_retire_slot_not_batch(models, policy):
    runs = {}
    _, params = _traffic(models["gpt2"][0].vocab_size)
    for pkg in ("jax", "port"):
        hooks = Hooks(poison_nan={POISON})
        hs, hp, eng = _isolation_run(models, "gpt2", pkg, hooks,
                                     np.array([POISON, 4, 4], np.int32),
                                     policy=policy)
        assert hp.finish_reason == "error" and "non-finite" in hp.error
        assert len(hp.output_ids) <= 1
        if pkg == "port":
            assert [h.output_ids for h in hs] == _reference_tokens(
                models, "gpt2", policy)
        runs[pkg] = (outcomes(hs), greedy_tokens(hs, params), len(hp.output_ids))
        if policy is not None:                  # the scrubbed pages returned
            assert eng.page_pool.stats()["used"] == 0
    assert runs["port"] == runs["jax"]


def test_reused_poisoned_slot_serves_next_occupant(models):
    """A NaN-poisoned contiguous slot, failed and reused by a request whose
    prompt bucket (64) is shorter than the row (256): the port scrubs the
    failed row, so the next occupant's tokens are those of a clean slot.
    The JAX engine weighs the masked positions by an exact 0 over the whole
    row and keeps the stale NaN tail, so it fails that occupant: a
    reference caveat (ROADMAP queue 3), pinned here."""
    p = np.array([5, 6, 7, 8], np.int32)
    got = {}
    for pkg in ("jax", "port"):
        hooks = Hooks(poison_nan={POISON})
        eng = make(models, "gpt2-ctx256", pkg, n_slots=1, max_len=256,
                   hooks=hooks)
        hp = eng.submit(np.array([POISON, 4], np.int32),
                        sp(pkg, max_new_tokens=4, ignore_eos=True))
        eng.run_until_idle()
        assert hp.finish_reason == "error"
        h = eng.submit(p, sp(pkg, max_new_tokens=6, ignore_eos=True))
        eng.run_until_idle()
        got[pkg] = h
    clean = make(models, "gpt2-ctx256", "port", n_slots=1, max_len=256)
    ref = clean.submit(p, SamplingParams(max_new_tokens=6, ignore_eos=True))
    clean.run_until_idle()
    assert got["port"].finish_reason == "length"
    assert got["port"].output_ids == ref.output_ids
    assert got["jax"].finish_reason == "error"      # the caveat, pinned
    assert "non-finite" in got["jax"].error


def test_out_of_vocab_prompt_rejected_at_submit(models):
    eng = make(models, "llama", "port", n_slots=1)
    vocab = models["llama"][0].vocab_size
    for bad in ([5, vocab], [-1, 5]):
        with pytest.raises(ValueError, match="token ids"):
            eng.submit(np.array(bad), SamplingParams(max_new_tokens=2))
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(np.array([5]), SamplingParams(max_new_tokens=2, deadline_s=0))


# ---------------------------------------------------------------------------
# the tick watchdog and restart
# ---------------------------------------------------------------------------

def _events(path):
    return [json.loads(line) for line in open(path)]


def test_hung_tick_flight_record_restart_then_serve(models, tmp_path):
    """A wedged tick trips the watchdog: the flight record, the in-flight
    request failed, the queue kept, the loop restarted, and new traffic
    served with the tokens of a fresh engine; the abandoned thread, once
    released, commits nothing. Both packages, the same events. (A paged
    engine's restart: ``test_paged_restart_rebuilds_pool_and_store``.)"""
    rows = {}
    for pkg, mod in (("jax", jmetrics), ("port", tmetrics)):
        path = str(tmp_path / f"{pkg}.jsonl")
        sink = mod.configure_metrics(path)
        sink.write_header(test="restart")
        hooks = Hooks(gate_first=True)
        try:
            eng = make(models, "llama", pkg, n_slots=2, hooks=hooks,
                       tick_timeout_s=0.6, max_restarts=2,
                       restart_backoff_s=0.05)
            eng.warmup()        # JAX compiles here, not under the watchdog
            eng.start()
            p = np.array([5, 6, 7], np.int32)
            h1 = eng.submit(p, sp(pkg, max_new_tokens=40, ignore_eos=True))
            assert hooks.first_token.wait(30)   # h1 is decoding
            hooks.hang.set()                    # the next tick wedges
            hooks.go.set()
            with pytest.raises(RuntimeError, match="restarted"):
                h1.result(timeout=30)
            new = sp(pkg, max_new_tokens=5, seed=2, ignore_eos=True)
            h2 = eng.submit(p, new)
            h2.result(timeout=30)
            hooks.release.set()                 # un-wedge the old thread
            h3 = eng.submit(p, new)
            h3.result(timeout=30)
            assert h3.output_ids == h2.output_ids
            assert eng.n_restarts == 1 and eng.n_recompiles == 0
            if pkg == "port":
                fresh = make(models, "llama", pkg, n_slots=2)
                ref = fresh.submit(p, new)
                fresh.run_until_idle()
                assert h2.output_ids == ref.output_ids
            eng.shutdown()
        finally:
            hooks.release.set()
            hooks.go.set()
            sink.close()
            mod.configure_metrics(None)
        rows[pkg] = _events(path)
        rows[pkg + "_tokens"] = h2.output_ids
    assert rows["port_tokens"] == rows["jax_tokens"]
    for pkg in ("jax", "port"):
        events = [r.get("event") for r in rows[pkg] if r["type"] == "event"]
        assert "stall" in events
        restarts = [r for r in rows[pkg] if r.get("event") == "engine_restart"]
        assert len(restarts) == 1 and restarts[0]["reason"] == "hung_tick"
        assert restarts[0]["n_inflight_failed"] == 1
        assert any(r.get("reason") == "engine_restart" for r in rows[pkg]
                   if r.get("event") == "request_failed")
    # every port row is valid under both registries
    for r in rows["port"]:
        if r["type"] == "event":
            fields = {k: v for k, v in r.items()
                      if k not in ("type", "time", "event")}
            assert tschema.validate_event(r["event"], fields) == [], r
            assert jschema.validate_event(r["event"], fields) == [], r


def test_restart_budget_exhaustion_kills_engine(models):
    for pkg in ("jax", "port"):
        eng = make(models, "llama", pkg, n_slots=1, tick_timeout_s=5.0,
                   max_restarts=1, restart_backoff_s=0.01)
        eng.n_restarts = 1
        assert eng._restart(reason="hung_tick") is False
        h = eng.submit(np.array([5, 6], np.int32),
                       sp(pkg, max_new_tokens=2, ignore_eos=True))
        eng.supervisor._on_stall(9.0, 5.0)     # the watchdog's escalation
        assert h.done and h.finish_reason == "error"
        assert eng.healthz_payload()["status"] == "dead"
        with pytest.raises(RuntimeError, match="dead"):
            eng.submit(np.array([5], np.int32), sp(pkg, max_new_tokens=1))


# ---------------------------------------------------------------------------
# cancel and graceful drain
# ---------------------------------------------------------------------------

def test_drain_completes_in_flight_and_closes_admission(models):
    got = {}
    for pkg in ("jax", "port"):
        hooks = Hooks(gate_first=True)
        eng = make(models, "llama", pkg, n_slots=1, hooks=hooks)
        eng.start()
        p = np.array([5, 6, 7], np.int32)
        h1 = eng.submit(p, sp(pkg, max_new_tokens=20, ignore_eos=True))
        h2 = eng.submit(p, sp(pkg, max_new_tokens=5, ignore_eos=True))
        assert hooks.first_token.wait(30)
        hooks.go.set()
        summary = eng.drain(timeout=60.0)
        assert eng.draining and eng.healthz_payload()["status"] == "draining"
        with pytest.raises(JDraining if pkg == "jax" else EngineDrainingError):
            eng.submit(p, sp(pkg, max_new_tokens=2))
        got[pkg] = (summary["n_preempted"], outcomes([h1, h2]),
                    len(h1.output_ids), h1.output_ids)
        eng.shutdown()
    assert got["port"] == got["jax"] == (0, ["length", "length"], 20,
                                         got["jax"][3])


def test_drain_timeout_preempts_remainder(models):
    got = {}
    for pkg in ("jax", "port"):
        eng = make(models, "llama", pkg, n_slots=1)
        p = np.array([5, 6, 7], np.int32)
        hs = [eng.submit(p, sp(pkg, max_new_tokens=50, ignore_eos=True))
              for _ in range(2)]
        for _ in range(3):
            assert eng.step()
        summary = eng.drain(timeout=0.0)       # no time at all
        for h in hs:
            with pytest.raises(RuntimeError, match="preempted"):
                h.result(timeout=1)
        got[pkg] = (summary["n_preempted"], outcomes(hs),
                    eng.scheduler.n_active, len(eng.queue))
    assert got["port"] == got["jax"] == (2, ["preempted"] * 2, 0, 0)


def test_serve_jsonl_writes_every_line_across_a_drain(models, tmp_path):
    reqs = tmp_path / "reqs.jsonl"
    with open(reqs, "w") as f:
        for i in range(4):
            f.write(json.dumps({"prompt_ids": [5, 6, 7], "ignore_eos": True,
                                "max_new_tokens": 8 + i, "seed": i,
                                "deadline_s": 600}) + "\n")
    got = {}
    for pkg, front in (("jax", jfrontend), ("port", tfrontend)):
        hooks = Hooks(gate_first=True)
        eng = make(models, "llama", pkg, n_slots=1, max_queue=8, hooks=hooks)
        eng.start()
        out = tmp_path / f"{pkg}.jsonl"
        worker = threading.Thread(target=front.serve_jsonl,
                                  args=(eng, str(reqs), str(out), 8), daemon=True)
        worker.start()
        assert hooks.first_token.wait(30)      # mid-batch
        hooks.go.set()
        eng.drain(timeout=60.0)
        worker.join(timeout=30)
        assert not worker.is_alive()
        lines = [json.loads(line) for line in open(out)]
        got[pkg] = lines
        eng.shutdown()
    assert len(got["port"]) == 4
    for a, b in zip(got["port"], got["jax"]):
        assert "error" not in a and a["finish_reason"] == "length"
        assert set(a) == set(b)                 # result_record's keys
        assert (a["token_ids"], a["n_tokens"], a["deadline_s"]) == \
            (b["token_ids"], b["n_tokens"], b["deadline_s"])


def test_cancel_queued_request_immediate(models):
    for pkg in ("jax", "port"):
        eng = make(models, "llama", pkg, n_slots=1)
        p = np.array([5, 6], np.int32)
        h1 = eng.submit(p, sp(pkg, max_new_tokens=3, ignore_eos=True))
        h2 = eng.submit(p, sp(pkg, max_new_tokens=3, ignore_eos=True))
        assert eng.cancel(h2)
        assert h2.done and h2.finish_reason == "cancelled"
        eng.run_until_idle()
        assert h1.result().finish_reason == "length"
        assert eng.cancel(h1) is False


# ---------------------------------------------------------------------------
# the HTTP frontend
# ---------------------------------------------------------------------------

def _post(port, body: bytes, path="/generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = json.loads(resp.read() or b"{}")
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, payload, headers


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def _serve(front, eng, **kw):
    server = front.make_http_server(eng, 0, host="127.0.0.1", **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_http_status_map_and_drain_503_match_jax(models):
    got = {}
    vocab = models["llama"][0].vocab_size
    for pkg, front in (("jax", jfrontend), ("port", tfrontend)):
        eng = make(models, "llama", pkg, n_slots=1, max_queue=1)
        eng.start()
        server, port = _serve(front, eng, max_body_bytes=512)
        seq = []
        try:
            for body in (b"x" * 600, b"{not json", b"[1, 2, 3]",
                         json.dumps({"prompt_ids": [5], "top_k": [1],
                                     "max_new_tokens": 2}).encode(),
                         json.dumps({"prompt_ids": [5, vocab]}).encode(),
                         json.dumps({"max_new_tokens": 2}).encode(),
                         json.dumps({"prompt_ids": [5] * 70}).encode(),
                         json.dumps({"prompt_ids": [5, 6], "deadline_s": 0}).encode(),
                         json.dumps({"prompt_ids": [5, 6], "max_new_tokens": 2,
                                     "ignore_eos": True}).encode()):
                status, out, _ = _post(port, body)
                seq.append((status, sorted(out)))
            seq.append(_post(port, b"{}", path="/nowhere")[0])
            health = json.loads(_get(port, "/healthz")[1])
            status, text = _get(port, "/metrics")
            assert status == 200 and b"bllm_serve_requests_finished_total 1" in text
            eng.drain(timeout=5.0)
            drained = json.loads(_get(port, "/healthz")[1])
            status, out, headers = _post(port, json.dumps(
                {"prompt_ids": [5, 6], "max_new_tokens": 2}).encode())
            seq.append((status, "Retry-After" in headers, drained["status"]))
        finally:
            server.shutdown()
            server.server_close()
            eng.shutdown()
        got[pkg] = (seq, sorted(health), health["status"],
                    sorted(health["counters"]))
    assert got["port"] == got["jax"]
    codes = [s[0] if isinstance(s, tuple) else s for s in got["port"][0]]
    assert codes == [413, 400, 400, 400, 400, 400, 413, 400, 200, 404, 503]


def test_http_timeout_cancels_request_and_frees_slot(models):
    got = {}
    for pkg, front in (("jax", jfrontend), ("port", tfrontend)):
        hooks = Hooks(gate_first=True)
        eng = make(models, "llama", pkg, n_slots=1, hooks=hooks)
        eng.start()
        server, port = _serve(front, eng, request_timeout_s=0.2)
        try:
            # the first token blocks the tick until the handler timed out
            status, _, _ = _post(port, json.dumps(
                {"prompt_ids": [5, 6], "max_new_tokens": 50,
                 "ignore_eos": True}).encode())
            hooks.go.set()
            eng.drain(timeout=30.0)             # returns once the slot frees
            got[pkg] = (status, eng.scheduler.n_active, eng.requests_failed)
        finally:
            hooks.go.set()
            server.shutdown()
            server.server_close()
            eng.shutdown()
    assert got["port"] == got["jax"] == (504, 0, 1)


def test_healthz_and_result_record_keys_match_jax(models):
    got = {}
    for pkg, front in (("jax", jfrontend), ("port", tfrontend)):
        eng = make(models, "llama", pkg, n_slots=2,
                   kv_policy=dict(PAGED, prefix_cache=True))
        h = eng.submit(np.arange(10, 30, dtype=np.int32),
                       sp(pkg, max_new_tokens=3, ignore_eos=True, deadline_s=30))
        eng.run_until_idle()
        counters, gauges, hists = eng.metrics_snapshot()
        got[pkg] = (sorted(front.result_record(h)), sorted(eng.healthz_payload()),
                    sorted(counters), sorted(hists))
        # the memory ledger's series differ by design (no host RSS, no
        # compile temps); every other gauge is the JAX engine's
        got[pkg + "_gauges"] = {k for k in gauges if "{" not in k
                                and not k.startswith(("mem_", "hbm_", "host_"))}
    assert got["port"] == got["jax"]
    assert got["port_gauges"] == got["jax_gauges"]


# ---------------------------------------------------------------------------
# the port's own: telemetry rows, the paged restart, the CLI
# ---------------------------------------------------------------------------

def test_cadence_rows_phases_and_memory_snapshots(models, tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = tmetrics.configure_metrics(path, run_metadata={"test": 1})
    try:
        eng = make(models, "llama", "port", n_slots=2, metrics_every=4,
                   kv_policy=dict(PAGED, prefix_cache=True))
        hs = [eng.submit(np.arange(10, 30, dtype=np.int32),
                         SamplingParams(max_new_tokens=9, ignore_eos=True))
              for _ in range(3)]
        eng.run_until_idle()
        eng.shutdown()
    finally:
        sink.close()
        tmetrics.configure_metrics(None)
    rows = _events(path)
    metrics = [r for r in rows if r["type"] == "metrics"]
    assert metrics and [r["step"] for r in metrics] == \
        list(range(4, eng.n_ticks + 1, 4))
    for r in metrics:
        phases = sum(r[f"tick_{ph}_s"] for ph in tschema.TICK_PHASES)
        assert phases <= r["tick_total_s"] + 1e-6
    snaps = [r for r in rows if r.get("event") == "memory_snapshot"]
    assert len(snaps) == len(metrics)
    assert not [r for r in rows if r.get("event") == "memory_drift"]
    spans = [r for r in rows if r["type"] == "span"]
    assert sorted(r["request_id"] for r in spans) == sorted(h.id for h in hs)
    assert all(r["outcome"] == "length" for r in spans)


def test_paged_restart_rebuilds_pool_and_store(models):
    """A restart of a paged, prefix-cached engine in manual mode: the pool
    and the store are new and empty, the queue is kept, and the next
    requests' tokens equal a fresh engine's."""
    policy = dict(PAGED, prefix_cache=True)
    eng = make(models, "gpt2", "port", n_slots=2, kv_policy=policy,
               tick_timeout_s=30.0, max_restarts=1, restart_backoff_s=0.0)
    prompt = np.arange(10, 40, dtype=np.int32)
    params = SamplingParams(max_new_tokens=6, ignore_eos=True)
    first = [eng.submit(prompt, params) for _ in range(3)]
    eng.step()
    pool0 = eng.page_pool
    assert eng._restart(reason="hung_tick", detail="test")
    assert eng.page_pool is not pool0 and eng.prefix_store.n_entries == 0
    assert [h.finish_reason for h in first[:2]] == ["error", "error"]
    eng.run_until_idle()                        # the kept request is served
    fresh = make(models, "gpt2", "port", n_slots=2, kv_policy=policy)
    ref = fresh.submit(prompt, params)
    fresh.run_until_idle()
    assert first[2].result().output_ids == ref.output_ids
    assert eng.page_pool.stats()["reserved"] == 0
    assert eng._restart(reason="hung_tick") is False    # budget spent


VICTIM = 11         # first prompt token of the request whose tick wedges


class Wedge(Hooks):
    """Holds the victim's tick at one point past its last generation check
    (``block``) until the restarted loop hands a kept request its first
    token; that token's ``after_token`` then lets the abandoned thread run
    on and waits for it to end, so whatever it writes lands before the kept
    request's next tick reads its slot."""

    def __init__(self, where):
        super().__init__()
        self.where = where
        self.wedged = threading.Event()
        self.thread = None

    def block(self):
        self.thread = threading.current_thread()
        self.wedged.set()
        self.release.wait(30)

    def before_prefill(self, req):
        if self.where == "before_prefill" and int(req.prompt_ids[0]) == VICTIM:
            self.block()

    def after_token(self, req, tok):
        if (int(req.prompt_ids[0]) != VICTIM and self.thread is not None
                and not self.release.is_set()):
            self.release.set()
            self.thread.join(10)


#: the launch whose host-to-device copy wedges -> the method that makes it
_COPY_CALLERS = {"prefill": "_admit", "chunk": "_run_chunk",
                 "decode": "_decode", "verify": "_verify_tick"}


@pytest.mark.parametrize("where,kw", [
    ("before_prefill", dict(kv_policy=dict(prefill_chunk=16))),
    ("prefill", {}),
    ("chunk", dict(kv_policy=dict(prefill_chunk=16))),
    ("decode", {}),
    ("verify", dict(spec_k=2)),
    ("chunk", dict(kv_policy=PAGED)),
    ("decode", dict(kv_policy=PAGED)),
], ids=["before_prefill", "prefill", "chunk", "decode", "verify",
        "paged-chunk", "paged-decode"])
def test_abandoned_tick_writes_only_the_old_cache(models, where, kw):
    """A restart (the watchdog's call, made here at once) abandons a tick
    wedged past its last generation check: in ``before_prefill``, or in the
    host-to-device copy of a launch (on the card that copy waits for the
    device). The restarted loop serves the
    kept requests in the new cache; the abandoned thread, released once a
    kept request holds the victim's old slot, launches into the cache it
    took at the top of its tick and commits nothing, so the kept requests'
    tokens are a fault-free engine's."""
    hooks = Wedge(where)
    eng = make(models, "llama", "port", n_slots=2, hooks=hooks,
               tick_timeout_s=30.0, max_restarts=1, restart_backoff_s=0.0, **kw)
    if where in _COPY_CALLERS:
        real = eng._to_device

        def to_device(parts):
            host = real(parts)      # the host arrays as they stand now
            if (hooks.thread is None
                    and sys._getframe(1).f_code.co_name == _COPY_CALLERS[where]):
                hooks.block()
            return host

        eng._to_device = to_device
    # the victim's stale append lands on the first kept prompt's last position
    kept = [np.arange(20, 23, dtype=np.int32), np.arange(30, 36, dtype=np.int32)]
    params = SamplingParams(max_new_tokens=8, ignore_eos=True)
    eng.start()
    try:
        victim = eng.submit(np.array([VICTIM, 12], np.int32), params)
        assert hooks.wedged.wait(30)
        hs = [eng.submit(p, params) for p in kept]      # queued behind it
        assert eng._restart(reason="hung_tick", detail="wedged past its check")
        with pytest.raises(RuntimeError, match="restarted"):
            victim.result(timeout=30)
        for h in hs:
            h.result(timeout=30)
        assert hooks.release.is_set() and not hooks.thread.is_alive()
        assert eng.n_restarts == 1 and eng.n_recompiles == 0
    finally:
        hooks.release.set()
        eng.shutdown()
    fresh = make(models, "llama", "port", n_slots=2, **kw)
    ref = [fresh.submit(p, params) for p in kept]
    fresh.run_until_idle()
    assert [h.output_ids for h in hs] == [h.output_ids for h in ref]
    assert [h.finish_reason for h in hs] == ["length", "length"]


def test_serving_flags_parse_with_jax_defaults_and_checks(tmp_path):
    from building_llm_from_scratch_tpu.args import get_args as jget_args

    req = tmp_path / "r.jsonl"
    req.write_text('{"prompt_ids": [1, 2]}\n')
    flags = ["--mode", "serve", "--serve_prompts", str(req)]
    port, ref = get_args(flags), jget_args(flags)
    for name in ("serve_port", "serve_host", "drain_timeout",
                 "serve_tick_timeout", "serve_max_restarts",
                 "serve_deadline_s", "serve_metrics_every", "metrics_jsonl",
                 "stall_timeout"):
        assert getattr(port, name) == getattr(ref, name), name
    a = get_args(["--mode", "serve", "--serve_port", "8000", "--serve_host",
                  "0.0.0.0", "--serve_deadline_s", "5", "--drain_timeout", "3",
                  "--serve_tick_timeout", "2", "--serve_max_restarts", "1",
                  "--serve_metrics_every", "8", "--metrics_jsonl",
                  str(tmp_path / "m.jsonl"), "--stall_timeout", "9"])
    assert (a.serve_port, a.serve_prompts, a.serve_deadline_s) == (8000, None, 5.0)
    for bad, msg in ((["--drain_timeout", "0"], "drain_timeout"),
                     (["--serve_tick_timeout", "-1"], "serve_tick_timeout"),
                     (["--serve_max_restarts", "-1"], "serve_max_restarts"),
                     (["--serve_deadline_s", "-1"], "serve_deadline_s"),
                     (["--serve_metrics_every", "-1"], "serve_metrics_every"),
                     (["--stall_timeout", "-1"], "stall_timeout")):
        with pytest.raises(ValueError, match=msg):
            get_args(flags + bad)
    with pytest.raises(ValueError, match="workload"):
        get_args(["--mode", "serve"])
    with pytest.raises(ValueError, match="require --mode serve"):
        get_args(["--mode", "train", "--data_dir", str(tmp_path),
                  "--serve_port", "8000"])


def test_cli_sigterm_drains_and_exits_zero(tmp_path):
    """``--mode serve`` in a subprocess: SIGTERM after the first result line
    drains the engine; the process exits 0 with every request's line on
    stdout and the drain in ``--metrics_jsonl``."""
    n = 24
    req = tmp_path / "r.jsonl"
    req.write_text("".join(json.dumps({"prompt_ids": [5 + i % 7, 6],
                                       "max_new_tokens": 13,
                                       "ignore_eos": True}) + "\n"
                           for i in range(n)))
    mj = tmp_path / "m.jsonl"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "building_llm_from_scratch_tpu_torch", "--mode",
         "serve", "--debug", "--device", "cpu", "--serve_slots", "1",
         "--serve_prompts", str(req), "--metrics_jsonl", str(mj),
         "--serve_metrics_every", "16", "--drain_timeout", "120"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        lines = [proc.stdout.readline()]
        proc.send_signal(signal.SIGTERM)
        lines += proc.stdout.readlines()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0
    recs = [json.loads(line) for line in lines if line.strip()]
    assert len(recs) == n and all(r["finish_reason"] == "length" for r in recs)
    rows = _events(mj)
    assert rows[0]["type"] == "header" and rows[0]["flags"]["serve_slots"] == 1
    drains = [r for r in rows if r.get("event") == "drain"]
    assert [d["phase"] for d in drains] == ["start", "end"]
    assert drains[-1]["n_preempted"] == 0
    assert any(r.get("event") == "serve_summary" for r in rows)


def test_cli_refuses_training_telemetry_by_name(tmp_path, capsys):
    """The training telemetry is ported: each of its flags parses in train
    mode; only XLA's compilation cache is still refused, by name."""
    for flag, key, value in ((["--metrics_jsonl", "m.jsonl"], "metrics_jsonl", "m.jsonl"),
                             (["--stall_timeout", "5"], "stall_timeout", 5.0),
                             (["--log_every", "5"], "log_every", 5),
                             (["--profile"], "profile", True),
                             (["--profile_steps", "3"], "profile_steps", 3),
                             (["--warnings"], "warnings", True)):
        args = get_args(["--mode", "train", "--data_dir", str(tmp_path)] + flag)
        assert getattr(args, key) == value, flag
    with pytest.raises(SystemExit):
        get_args(["--mode", "train", "--data_dir", str(tmp_path),
                  "--compile_cache_dir", "c"])
    err = capsys.readouterr().err
    assert "--compile_cache_dir" in err and "XLA" in err


def test_scrape_answers_while_a_tick_holds_the_lock(models):
    """A scrape while a tick holds the engine lock answers (its acquire is
    timed) instead of waiting for the tick."""
    hooks = Hooks(gate_first=True)
    eng = make(models, "llama", "port", n_slots=1, hooks=hooks)
    eng.start()
    try:
        h = eng.submit(np.array([5, 6], np.int32),
                       SamplingParams(max_new_tokens=4, ignore_eos=True))
        assert hooks.first_token.wait(30)       # the loop holds the lock
        t0 = time.monotonic()
        text = eng.prometheus_text()
        assert time.monotonic() - t0 < 5.0 and "bllm_serve_engine_up 1.0" in text
        assert eng.healthz_payload()["active"] == 1
    finally:
        hooks.go.set()
        eng.shutdown()
    assert h.result().finish_reason == "length"


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kind", ["spec", "int8"])
def test_poison_fails_alone_on_plain_torch_ticks(models, kind, paged):
    """The verify and int8 ticks attend with plain torch, which weighs the
    masked positions by an exact 0: a NaN-poisoned request fails there, and
    the slot's next occupant (on one slot: its prompt bucket shorter than
    the 256-position row; paged: its decode drawing the poisoned second
    page, whose positions past the length it never writes) gets the tokens
    of a clean engine, because the failed slot's rows or private pages are
    zeroed first."""
    policy = dict(PAGED) if paged else {}
    if kind == "int8":
        policy["kv_quant"] = "int8"
    extra = dict(spec_k=3) if kind == "spec" else {}
    rng = np.random.default_rng(8)
    poison = np.concatenate([[POISON], rng.integers(10, 512, 19)]).astype(np.int32)
    prompt = rng.integers(10, 512, 5).astype(np.int32)
    params = SamplingParams(max_new_tokens=40, ignore_eos=True)

    def engine(hooks=None):
        return make(models, "gpt2-ctx256", "port", n_slots=1, max_len=256,
                    hooks=hooks, kv_policy=policy or None, **extra)

    eng = engine(Hooks(poison_nan={POISON}))
    bad = eng.submit(poison, SamplingParams(max_new_tokens=4, ignore_eos=True))
    eng.run_until_idle()
    nxt = eng.submit(prompt, params)
    eng.run_until_idle()
    clean = engine()
    ref = clean.submit(prompt, params)
    clean.run_until_idle()
    assert bad.finish_reason == "error" and "non-finite" in bad.error
    assert nxt.finish_reason == "length" and nxt.output_ids == ref.output_ids
