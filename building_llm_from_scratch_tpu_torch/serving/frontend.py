"""Serving frontends of ``--mode serve`` (port of the JAX package's
``serving/frontend.py``, without the fleet): the JSONL batch pump and the
stdlib HTTP endpoint.

  - JSONL (``--serve_prompts``): one request per line, ``{"prompt":
    "text"}`` (with a tokenizer) or ``{"prompt_ids": [...]}``, and
    ``{"max_new_tokens": 32, "temperature": 0.7, "top_k": 40, "seed": 1,
    "eos_id": 7, "ignore_eos": true, "deadline_s": 30, "adapter":
    "tenant-a", "spec": false}``; ``adapter`` names one of the LoRA
    adapters ``--serve_adapters name=path,...`` loaded, ``"spec": false``
    opts a request out of speculative decoding (its tokens are the same
    either way). Results go to ``--serve_out`` (default stdout), one line
    per request in submission order, each flushed as soon as its request
    is done, with its ``token_ids`` and their ``text`` ("" without a
    tokenizer); a failed, expired or preempted request is an ``error``
    line, and lines a drain kept from being submitted are ``shed`` lines.
    Submission blocks while the queue is full (backpressure).
  - HTTP (``--serve_port``, loopback unless ``--serve_host``): ``POST
    /generate`` with the same fields returns the result line; ``GET
    /healthz`` a structured snapshot; ``GET /metrics`` the Prometheus
    text. Status map: 429 + Retry-After for a full queue and an SLO shed,
    503 + Retry-After while draining, 504 for a deadline expired in the
    queue and for a handler timeout (which cancels the request), 413 for a
    body over the limit or a prompt over the ceiling, 400 for malformed
    input, 404 for other paths, 500 for engine-side failures.

``run_serve`` arms ``training/resilience.GracefulStopper``: on SIGTERM or
SIGINT a watcher drains the engine (admission closed, in-flight work
finishes within ``--drain_timeout``, the rest ``preempted``) and stops the
HTTP server, so the process exits 0 with every finished line written.
``run_serve`` attaches the tokenizer of ``--tokenizer_path`` or
``--byte_tokenizer``; with neither, serving takes token ids only.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from typing import List, Optional

from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy
from building_llm_from_scratch_tpu_torch.serving.queue import (
    EngineDrainingError,
    PromptTooLongError,
    QueueFullError,
    SLOShedError,
)
from building_llm_from_scratch_tpu_torch.serving.request import (
    Request,
    RequestExpiredError,
    SamplingParams,
)

logger = logging.getLogger(__name__)


def parse_adapter_specs(spec: str, flag: str = "--serve_adapters") -> dict:
    """``name=path[,name=path...]`` -> {name: path}; names are unique."""
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"{flag} entry '{part}' is not name=path")
        name, path = part.split("=", 1)
        name, path = name.strip(), path.strip()
        if not name or not path:
            raise ValueError(f"{flag} entry '{part}' is not name=path")
        if name in out:
            raise ValueError(f"{flag} names '{name}' twice")
        out[name] = path
    if not out:
        raise ValueError(f"{flag} is empty")
    return out


def params_from_record(rec: dict, default_max_new: int) -> SamplingParams:
    return SamplingParams(
        max_new_tokens=int(rec.get("max_new_tokens", default_max_new)),
        temperature=float(rec.get("temperature", 0.0)),
        top_k=(int(rec["top_k"]) if rec.get("top_k") else None),
        seed=int(rec.get("seed", 0)),
        eos_id=(int(rec["eos_id"]) if rec.get("eos_id") is not None else None),
        ignore_eos=bool(rec.get("ignore_eos", False)),
        # `is not None`: a deadline of 0 reaches submit's check (a 400)
        deadline_s=(float(rec["deadline_s"])
                    if rec.get("deadline_s") is not None else None),
        # by registry name; an unknown name is refused at submit
        adapter=(str(rec["adapter"]) if rec.get("adapter") is not None
                 else None),
        # per-request speculative opt-out; the tokens are the same either way
        spec=bool(rec.get("spec", True)),
    )


def result_record(req: Request) -> dict:
    rec = req.summary()
    rec["token_ids"] = [int(t) for t in req.output_ids]
    rec["text"] = req.text
    return rec


def error_record(req: Request) -> dict:
    rec = req.summary()
    rec["error"] = req.error
    return rec


def serve_jsonl(engine: DecodeEngine, prompts_path: str,
                out_path: Optional[str], default_max_new: int) -> List[dict]:
    """Pump a JSONL request file through a started engine (blocking
    backpressure) and write one line per request, in order, each flushed
    when its request is done. A failed, expired or preempted request is an
    ``error`` line; admission closing mid-file (a drain) records the
    unsubmitted rest as ``shed`` lines."""
    handles: List[Request] = []
    shed: List[dict] = []
    with open(prompts_path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            prompt = rec.get("prompt_ids", rec.get("prompt"))
            if prompt is None:
                raise ValueError(
                    f"{prompts_path}:{lineno}: needs 'prompt' or "
                    "'prompt_ids'")
            try:
                handles.append(engine.submit(
                    prompt, params_from_record(rec, default_max_new),
                    block=True))
            except (EngineDrainingError, SLOShedError, QueueFullError) as e:
                shed.append({"line": lineno, "error": str(e),
                             "finish_reason": "shed"})
    results: List[dict] = []
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        for h in handles:
            try:
                rec = result_record(h.result())
            except RuntimeError:        # RequestExpiredError included
                rec = error_record(h)
            results.append(rec)
            out.write(json.dumps(rec) + "\n")
            out.flush()
        for rec in shed:
            results.append(rec)
            out.write(json.dumps(rec) + "\n")
            out.flush()
    finally:
        if out_path:
            out.close()
    n_ok = sum(1 for r in results if "error" not in r)
    logger.info("Served %d/%d JSONL requests (%d tokens; %d failed/shed).",
                n_ok, len(results), sum(r.get("n_tokens", 0) for r in results),
                len(results) - n_ok)
    return results


# ---------------------------------------------------------------------------
# HTTP endpoint (standard library only)
# ---------------------------------------------------------------------------

def make_http_server(engine: DecodeEngine, port: int, host: str = "127.0.0.1",
                     request_timeout_s: float = 300.0,
                     max_body_bytes: int = 1 << 20):
    """Build (not start) a ``ThreadingHTTPServer`` on ``port`` (0: any free
    port; the real one is ``server.server_address[1]``), loopback by
    default: the endpoint is unauthenticated. A body over
    ``max_body_bytes`` gets 413 without being read, malformed or mistyped
    JSON 400, and a handler timeout cancels its request so the slot stops
    decoding for a client that is gone."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # a client that stalls mid-body is dropped after this many seconds
        timeout = 60
        # TCP_NODELAY: the headers and the body go out in two writes, and
        # Nagle's algorithm would hold the body until the client's delayed
        # ACK of the headers (about 30 ms a response on loopback)
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, payload: dict,
                  retry_after: Optional[float] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                # RFC 7231 delay-seconds: an integer >= 1
                self.send_header("Retry-After",
                                 str(max(1, int(round(retry_after)))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                body = engine.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            self._json(200, engine.healthz_payload())

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                return self._json(400, {"error": "bad Content-Length"})
            if n < 0:
                return self._json(400, {"error": "bad Content-Length"})
            if n > max_body_bytes:
                return self._json(413, {
                    "error": f"body {n} bytes exceeds the "
                             f"{max_body_bytes}-byte limit"})
            try:
                rec = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(rec, dict):
                    return self._json(400, {"error": "body must be a JSON "
                                                     "object"})
                prompt = rec.get("prompt_ids", rec.get("prompt"))
                if prompt is None:
                    return self._json(400, {"error": "missing 'prompt'/"
                                                     "'prompt_ids'"})
                params = params_from_record(rec, engine.default_max_new_tokens)
            except (ValueError, TypeError) as e:
                return self._json(400, {"error": str(e)})
            try:
                handle = engine.submit(prompt, params, block=False)
            except EngineDrainingError as e:
                return self._json(503, {"error": str(e)},
                                  retry_after=e.retry_after_s or 1.0)
            except SLOShedError as e:
                return self._json(429, {"error": str(e), "shed": True},
                                  retry_after=e.retry_after_s or 1.0)
            except QueueFullError:
                return self._json(429, {
                    "error": "request queue full — retry later",
                    "queue_capacity": engine.queue_capacity()},
                    retry_after=engine.estimate_queue_clear_s() or 1.0)
            except PromptTooLongError as e:
                return self._json(413, {"error": str(e), "max_prompt": e.limit,
                                        "prompt_tokens": e.prompt_tokens})
            except (ValueError, TypeError) as e:
                return self._json(400, {"error": str(e)})
            except RuntimeError as e:           # the engine is dead
                return self._json(500, {"error": str(e)})
            try:
                handle.result(timeout=request_timeout_s)
            except RequestExpiredError as e:
                return self._json(504, {"error": str(e), "expired": True},
                                  retry_after=engine.estimate_queue_clear_s())
            except TimeoutError as e:
                # the slot would otherwise decode to max_new_tokens for a
                # client whose handler has given up
                engine.cancel(handle)
                return self._json(504, {"error": str(e)})
            except RuntimeError as e:           # the engine failed it
                return self._json(500, {"error": str(e)})
            self._json(200, result_record(handle))

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(engine: DecodeEngine, port: int, host: str = "127.0.0.1",
               server=None) -> None:
    server = server or make_http_server(engine, port, host=host)
    host, real_port = server.server_address[:2]
    logger.info("Serving on http://%s:%d (POST /generate, GET /healthz, "
                "GET /metrics).", host, real_port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down HTTP server.")
    finally:
        server.server_close()


def kv_policy_from_args(args) -> KVCachePolicy:
    """The engine's KV policy from the flags (the JAX ``run_serve``'s):
    the cache dtype (``--serve_kv_quant``); the prefix cache and paging
    imply chunked prefill, 64 tokens a chunk unless
    ``--serve_prefill_chunk`` says otherwise."""
    prefix_on = args.serve_prefix_cache == "on"
    paged_on = args.serve_kv_paged == "on"
    chunk = args.serve_prefill_chunk
    if (prefix_on or paged_on) and chunk <= 0:
        chunk = 64
        logger.info("--serve_%s on: defaulting --serve_prefill_chunk to 64.",
                    "prefix_cache" if prefix_on else "kv_paged")
    return KVCachePolicy(
        kv_quant=args.serve_kv_quant,
        prefix_cache=prefix_on, prefill_chunk=chunk,
        prefix_budget_bytes=int(args.serve_prefix_budget_mb * 1024 ** 2),
        paged=paged_on, page_tokens=args.serve_kv_page_tokens)


def run_serve(args) -> DecodeEngine:
    """Build the model and engine from the parsed flags, serve
    ``--serve_prompts`` and/or ``--serve_port`` until the file is done or a
    signal drains the engine, and return the shut-down engine.
    ``--metrics_jsonl`` gets the header and the serving telemetry;
    ``--serve_tick_timeout`` arms the supervisor, ``--stall_timeout`` alone
    the flight recorder."""
    from building_llm_from_scratch_tpu_torch.build_components import (
        build_config,
        build_params,
    )
    from building_llm_from_scratch_tpu_torch.device import resolve_device
    from building_llm_from_scratch_tpu_torch.obs.metrics import (
        configure_metrics,
        run_metadata,
    )

    device = resolve_device(args.device)
    cfg = build_config(args)
    sink = configure_metrics(args.metrics_jsonl)
    model = build_params(args, cfg, device)
    sink.write_header(**run_metadata(args, cfg))
    tokenizer = None
    if args.tokenizer_path is not None or args.byte_tokenizer:
        from building_llm_from_scratch_tpu_torch.data.tokenizers import (
            build_tokenizer,
        )

        tokenizer = build_tokenizer(args.model, args.tokenizer_path,
                                    fallback_byte=args.byte_tokenizer)
        logger.info("Tokenizer: %s (vocab %d).", type(tokenizer).__name__,
                    tokenizer.vocab_size)
    adapters = None
    if args.serve_adapters:
        # the multi-tenant LoRA registry, built before the engine: its pool
        # (capacity x max rank) is fixed for the engine's life
        from building_llm_from_scratch_tpu_torch.serving.adapters import (
            AdapterRegistry,
        )

        adapters = AdapterRegistry.from_artifacts(
            cfg, parse_adapter_specs(args.serve_adapters),
            capacity=args.serve_adapter_slots, device=device)
        logger.info("Adapter registry: %d adapter(s) loaded (%s), "
                    "capacity %d.", adapters.n_loaded,
                    ", ".join(adapters.names()), adapters.capacity)
    engine = DecodeEngine(
        model, tokenizer, n_slots=args.serve_slots,
        max_len=(args.serve_max_len or None),
        max_queue=args.serve_max_queue, max_top_k=args.serve_max_top_k,
        default_max_new_tokens=args.serve_max_new_tokens,
        kv_policy=kv_policy_from_args(args), adapters=adapters,
        spec_k=args.serve_spec_k, metrics_every=args.serve_metrics_every,
        default_deadline_s=(args.serve_deadline_s or None),
        tick_timeout_s=args.serve_tick_timeout,
        max_restarts=args.serve_max_restarts)
    stall = None
    if args.stall_timeout > 0 and engine.supervisor is None:
        from building_llm_from_scratch_tpu_torch.serving.supervisor import (
            make_serve_stall_detector,
        )

        stall = make_serve_stall_detector(args.stall_timeout)
        engine.set_heartbeat(stall.notify_step)
    engine.warmup()
    engine.start()
    if stall is not None:
        stall.start()
    return _serve_frontends(args, engine, stall, sink)


def _serve_frontends(args, engine: DecodeEngine, stall, sink) -> DecodeEngine:
    """Drive the JSONL pump and/or the HTTP server over a started engine,
    with the signal drain: a watcher polls the stopper's flag (the handler
    itself stays tiny), drains and stops the server."""
    from building_llm_from_scratch_tpu_torch.training.resilience import (
        GracefulStopper,
    )

    server = (make_http_server(engine, args.serve_port, host=args.serve_host)
              if args.serve_port else None)
    stopper = GracefulStopper()
    done = threading.Event()

    def drain_on_signal():
        while not done.wait(0.1):
            if stopper.requested:
                engine.drain(timeout=args.drain_timeout)
                if server is not None:
                    server.shutdown()
                return

    watcher = threading.Thread(target=drain_on_signal,
                               name="serve-drain-watch", daemon=True)
    try:
        with stopper:
            watcher.start()
            http_thread = None
            if server is not None and args.serve_prompts:
                # both: HTTP serves beside the pump (a scrape must not wait
                # for the batch)
                http_thread = threading.Thread(
                    target=serve_http, name="serve-http", daemon=True,
                    args=(engine, args.serve_port),
                    kwargs=dict(host=args.serve_host, server=server))
                http_thread.start()
            if args.serve_prompts:
                serve_jsonl(engine, args.serve_prompts, args.serve_out,
                            args.serve_max_new_tokens)
            if http_thread is not None:
                http_thread.join()      # until a signal stops the server
            elif server is not None:
                serve_http(engine, args.serve_port, host=args.serve_host,
                           server=server)
    finally:
        done.set()
        watcher.join(timeout=5)
        if stopper.requested and not engine.draining:
            engine.drain(timeout=args.drain_timeout)
        engine.shutdown()
        if stall is not None:
            stall.stop()
        sink.close()
    return engine
