"""Serving frontend: the JSONL batch pump of ``--mode serve`` (port of the
JSONL half of the JAX package's ``serving/frontend.py``).

One request per line: ``{"prompt": "text"}`` (with a tokenizer) or
``{"prompt_ids": [...]}``, and ``{"max_new_tokens": 32,
"temperature": 0.7, "top_k": 40, "seed": 1, "eos_id": 7, "ignore_eos":
true, "adapter": "tenant-a", "spec": false}``; ``adapter`` names one of the
LoRA adapters ``--serve_adapters name=path,...`` loaded (omitted: the base
model); ``"spec": false`` opts a request out of speculative decoding on a
``--serve_spec_k`` engine (its tokens are the same either way).
Results go to ``--serve_out`` (default stdout), one line per request in
submission order, each flushed as soon as its request is done.
Each line carries the request's ``token_ids`` and their ``text`` ("" when
the engine has no tokenizer). Submission blocks while the queue is full
(backpressure). ``run_serve`` attaches the tokenizer of ``--tokenizer_path``
or ``--byte_tokenizer``; with neither, serving takes token ids only.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import List, Optional

from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy
from building_llm_from_scratch_tpu_torch.serving.request import (
    Request,
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
    backpressure) and write one result line per request, in order."""
    handles: List[Request] = []
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
            handles.append(engine.submit(
                prompt, params_from_record(rec, default_max_new),
                block=True))
    results: List[dict] = []
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        for h in handles:
            try:
                rec = result_record(h.result())
            except RuntimeError:
                rec = error_record(h)
            results.append(rec)
            out.write(json.dumps(rec) + "\n")
            out.flush()
    finally:
        if out_path:
            out.close()
    return results


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
    ``--serve_prompts`` and return the shut-down engine."""
    from building_llm_from_scratch_tpu_torch.build_components import (
        build_config,
        build_params,
    )
    from building_llm_from_scratch_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = build_config(args)
    model = build_params(args, cfg, device)
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
        spec_k=args.serve_spec_k)
    engine.start()
    try:
        serve_jsonl(engine, args.serve_prompts, args.serve_out,
                    args.serve_max_new_tokens)
    finally:
        engine.shutdown()
    return engine
