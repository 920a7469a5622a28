"""Continuous-batching decode engine (port of the core of the JAX package's
``serving/engine.py``).

One fixed ``(n_slots, Tmax)`` KV cache; requests are admitted into free
slots at tick boundaries and retired the moment they finish. One tick:

    admit queued requests into free slots (bucketed prefill into the slot)
    -> one decode step over ALL slots (the fused decode-step kernel, one
       launch per layer) -> per-row finite guard -> accept / finish

Free slots ride the fixed-shape decode as ignored rows, as in the JAX
engine. Every row carries its own length, sampling parameters and random
stream, so a request's tokens are the same whether it runs alone, in any
slot, or beside any other traffic.

Host state (``_lengths``, ``_last_tokens`` and the sampling parameters)
lives in numpy. Each decode tick copies tokens and lengths to the device
once and reads back once: the sampled tokens together with the finite
flags.

Not ported yet: chunked prefill and the prefix cache, int8 and paged KV,
adapters, speculative decoding, deadlines, drain, the supervisor and the
telemetry sink.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.generate import (
    _bucket,
    sample_tokens_dynamic,
)
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    decode_slots,
    init_slot_cache,
    prefill_into_slot,
)
from building_llm_from_scratch_tpu_torch.ops.decode_step import (
    check_kernel_shape,
)
from building_llm_from_scratch_tpu_torch.serving.queue import (
    PromptTooLongError,
    QueueFullError,
    RequestQueue,
)
from building_llm_from_scratch_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_REJECTED,
    FINISHED,
    REJECTED,
    RUNNING,
    Request,
    SamplingParams,
    next_request_id,
    resolve_eos,
)
from building_llm_from_scratch_tpu_torch.serving.scheduler import Scheduler


class DecodeEngine:
    """The serving runtime: slot-batched KV cache and request lifecycle.

    Drive it by hand (``step()`` / ``run_until_idle()``) or with the
    background thread (``start()`` / ``shutdown()``). ``submit()`` is
    thread-safe either way. The engine runs on the model's device."""

    def __init__(self, model: Transformer, *, n_slots: int = 4,
                 max_len: Optional[int] = None, max_queue: int = 64,
                 max_top_k: int = 64, default_max_new_tokens: int = 128):
        cfg = model.cfg
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.n_slots = int(n_slots)
        self.max_len = min(int(max_len or cfg.context_length),
                           cfg.context_length)
        self.max_prompt = self.max_len - 1
        if self.device.type == "cuda":
            # every decode tick launches the kernel: refuse a model or a
            # slot length it cannot take now, not at the first tick
            check_kernel_shape(self.max_len, cfg.head_dim, cfg.torch_dtype)
        self.max_top_k = min(int(max_top_k), cfg.vocab_size)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.queue = RequestQueue(max_queue)
        self.scheduler = Scheduler(self.n_slots)
        self.cache = init_slot_cache(cfg, self.n_slots, self.max_len,
                                     self.device)        # guarded-by: _lock

        S = self.n_slots
        # host-owned per-slot state; the device owns only the k/v cache
        self._lengths = np.zeros((S,), np.int32)        # guarded-by: _lock
        self._last_tokens = np.zeros((S,), np.int32)    # guarded-by: _lock
        self._n_gen = np.zeros((S,), np.int64)          # guarded-by: _lock
        self._seeds = np.zeros((S,), np.int64)          # guarded-by: _lock
        self._temps = np.zeros((S,), np.float32)        # guarded-by: _lock
        self._topks = np.zeros((S,), np.int32)          # guarded-by: _lock
        self._generator = torch.Generator(device=self.device)

        self._lock = threading.RLock()
        self._work = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[str] = None

        self.n_ticks = 0                    # decode ticks   guarded-by: _lock
        self.tokens_generated = 0           # guarded-by: _lock
        self.decode_tokens = 0              # tokens sampled by decode ticks
        self.requests_finished = 0          # guarded-by: _lock
        self.requests_rejected = 0          # guarded-by: _lock
        self.requests_failed = 0            # guarded-by: _lock
        self.prefill_seconds = 0.0          # guarded-by: _lock
        self.decode_seconds = 0.0           # guarded-by: _lock

    # -- admission --------------------------------------------------------

    def encode_prompt(self, prompt: Sequence[int] | np.ndarray) -> np.ndarray:
        if isinstance(prompt, str):
            raise ValueError("text prompts need a tokenizer, which this port "
                             "does not have yet: send token ids")
        ids = np.asarray(prompt, np.int64).reshape(-1)
        if ids.size < 1:
            raise ValueError("empty prompt")
        if int(ids.min()) < 0 or int(ids.max()) >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size}); "
                f"got range [{int(ids.min())}, {int(ids.max())}]")
        return ids.astype(np.int32)

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               block: bool = False, timeout: Optional[float] = None,
               on_token=None) -> Request:
        """Enqueue one request of token ids (thread-safe). ``block=False``
        rejects with ``QueueFullError`` when the queue is full;
        ``block=True`` waits for space."""
        if self._error is not None:
            raise RuntimeError(f"engine is dead: {self._error}")
        params = params or SamplingParams(
            max_new_tokens=self.default_max_new_tokens)
        ids = self.encode_prompt(prompt)
        if params.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if params.top_k is not None and not (
                1 <= params.top_k <= self.max_top_k):
            raise ValueError(f"top_k={params.top_k} outside this engine's "
                             f"capacity 1..{self.max_top_k} (raise max_top_k)")
        if params.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if int(ids.size) > self.max_prompt:
            raise PromptTooLongError(
                f"prompt ({ids.size} tokens) exceeds the engine's prompt "
                f"ceiling {self.max_prompt}", prompt_tokens=int(ids.size),
                limit=self.max_prompt)
        total = int(ids.size) + params.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens "
                f"({params.max_new_tokens}) = {total} exceeds the engine's "
                f"slot capacity {self.max_len}")
        req = Request(next_request_id(), ids, params, on_token=on_token)
        try:
            self.queue.put(req, block=block, timeout=timeout)
        except QueueFullError:
            req.state = REJECTED
            req.finish_reason = FINISH_REJECTED
            req.t_finish = time.monotonic()
            with self._lock:
                self.requests_rejected += 1
            req._mark_done()
            raise
        with self._work:
            self._work.notify()
        return req

    # holds: _lock
    def _admit(self, slot: int, req: Request) -> None:
        """Prefill one request into ``slot`` and take its first token."""
        Tp = int(req.prompt_ids.size)
        Tpb = min(_bucket(Tp), self.max_len)
        padded = np.zeros((1, Tpb), np.int64)
        padded[0, :Tp] = req.prompt_ids
        t0 = time.perf_counter()
        tokens = torch.from_numpy(padded).to(self.device)
        logits = prefill_into_slot(self.model, tokens, Tp, slot, self.cache)
        p = req.params
        tok = sample_tokens_dynamic(
            logits[None], np.array([p.seed]), np.array([0]),
            np.array([p.temperature], np.float32),
            np.array([p.top_k or 0], np.int32), self.max_top_k,
            self._generator)
        ok = torch.isfinite(logits).all()
        tok_host, ok_host = torch.stack([tok[0], ok.long()]).tolist()
        self.prefill_seconds += time.perf_counter() - t0
        req.state = RUNNING
        req.slot = slot
        req.t_admit = time.monotonic()
        self._lengths[slot] = Tp
        self._n_gen[slot] = 0
        self._seeds[slot] = p.seed
        self._temps[slot] = p.temperature
        self._topks[slot] = p.top_k or 0
        if not ok_host:
            self._fail_request(slot, req, "non-finite logits in prefill")
            return
        self._accept_token(slot, req, int(tok_host))

    # -- the tick ---------------------------------------------------------

    def step(self) -> bool:
        """One tick: admit into free slots, then one decode step over the
        slot batch. Returns False when idle (no active slot, nothing
        queued)."""
        with self._lock:
            # re-admit until no progress: a request may finish during its
            # own admission (eos first, or max_new_tokens=1) and free a slot
            while True:
                admitted = self.scheduler.admit_from(self.queue)
                for slot, req in admitted:
                    self._admit(slot, req)
                if not admitted:
                    break
            active = self.scheduler.active()
            if not active:
                return len(self.queue) > 0
            t0 = time.perf_counter()
            host_in = torch.from_numpy(
                np.stack([self._last_tokens, self._lengths])).to(self.device)
            logits = decode_slots(self.model, host_in[0].long()[:, None],
                                  host_in[1], self.cache)
            nxt = sample_tokens_dynamic(logits, self._seeds, self._n_gen,
                                        self._temps, self._topks,
                                        self.max_top_k, self._generator)
            ok = torch.isfinite(logits).all(dim=-1)
            # the tick's one device->host read: tokens and finite flags
            nxt_host, ok_host = torch.stack([nxt, ok.long()]).cpu().numpy()
            self.decode_seconds += time.perf_counter() - t0
            self.n_ticks += 1
            for slot, req in active:
                # this tick wrote the slot's previous token at _lengths
                self._lengths[slot] += 1
                if not ok_host[slot]:
                    self._fail_request(
                        slot, req,
                        f"non-finite logits at token {len(req.output_ids)}")
                    continue
                self.decode_tokens += 1
                self._accept_token(slot, req, int(nxt_host[slot]))
            return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # holds: _lock
    def _accept_token(self, slot: int, req: Request, tok: int) -> None:
        eos = resolve_eos(req.params, self.cfg.eos_id)
        if eos is not None and tok == eos:
            # the eos token is dropped and the slot frees at this boundary
            self._finish(slot, req, FINISH_EOS)
            return
        if req.t_first_token is None:
            req.t_first_token = time.monotonic()
        req.output_ids.append(tok)
        self._last_tokens[slot] = tok
        self._n_gen[slot] = len(req.output_ids)
        self.tokens_generated += 1
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception as e:  # noqa: BLE001 — the client's fault, isolate it
                self._fail_request(slot, req, f"token callback failed: {e!r}")
                return
        if len(req.output_ids) >= req.params.max_new_tokens:
            self._finish(slot, req, FINISH_LENGTH)

    # holds: _lock
    def _free_slot(self, slot: int) -> None:
        self.scheduler.retire(slot)
        self._lengths[slot] = 0
        self._last_tokens[slot] = 0
        self._n_gen[slot] = 0
        self._seeds[slot] = 0
        self._temps[slot] = 0.0
        self._topks[slot] = 0

    # holds: _lock
    def _fail_request(self, slot: Optional[int], req: Request,
                      msg: str) -> None:
        """Fail ONE request and free its slot; the engine keeps serving."""
        if slot is not None and self.scheduler.slots[slot] is req:
            self._free_slot(slot)
        req.error = msg
        req.finish_reason = FINISH_ERROR
        req.state = FINISHED
        req.t_finish = time.monotonic()
        self.requests_failed += 1
        req._mark_done()
        with self._work:
            self._work.notify_all()

    # holds: _lock
    def _finish(self, slot: int, req: Request, reason: str) -> None:
        req.state = FINISHED
        req.finish_reason = reason
        req.t_finish = time.monotonic()
        if self.scheduler.slots[slot] is req:
            self._free_slot(slot)
        self.requests_finished += 1
        req._mark_done()
        with self._work:
            self._work.notify_all()

    # -- background loop --------------------------------------------------

    def start(self) -> None:
        """Run ticks on one background thread until ``shutdown()``."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    progressed = self.step()
                except Exception as e:  # noqa: BLE001 — fail loudly, not silently
                    self._fail_all(f"engine loop error: {e!r}")
                    raise
                if not progressed:
                    with self._work:
                        self._work.wait(timeout=0.05)

        self._thread = threading.Thread(target=loop, name="decode-engine",
                                        daemon=True)
        self._thread.start()

    def _fail_all(self, msg: str) -> None:
        with self._lock:
            self._error = msg
            for slot, req in self.scheduler.active():
                self._fail_request(slot, req, msg)
            while (req := self.queue.get_nowait()) is not None:
                self._fail_request(None, req, msg)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the loop; with ``drain`` finish everything queued first."""
        if self._thread is not None:
            if drain:
                while ((self.scheduler.n_active or len(self.queue))
                       and self._thread.is_alive()):
                    time.sleep(0.005)
            self._stop.set()
            with self._work:
                self._work.notify_all()
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("the engine loop did not stop within 30s")
            self._thread = None
        elif drain:
            self.run_until_idle()

    def stats(self) -> dict:
        with self._lock:
            return {
                "requests_finished": self.requests_finished,
                "requests_rejected": self.requests_rejected,
                "requests_failed": self.requests_failed,
                "tokens_generated": self.tokens_generated,
                "decode_tokens": self.decode_tokens,
                "n_ticks": self.n_ticks,
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
            }
