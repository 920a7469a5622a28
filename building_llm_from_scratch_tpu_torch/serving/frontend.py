"""Serving frontend: the JSONL batch pump of ``--mode serve`` (port of the
JSONL half of the JAX package's ``serving/frontend.py``).

One request per line: ``{"prompt_ids": [...], "max_new_tokens": 32,
"temperature": 0.7, "top_k": 40, "seed": 1, "eos_id": 7, "ignore_eos":
true}``. Results go to ``--serve_out`` (default stdout), one line per
request in submission order, each flushed as soon as its request is done.
Submission blocks while the queue is full (backpressure). Text prompts wait
for a tokenizer: a ``"prompt"`` field is rejected.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
from building_llm_from_scratch_tpu_torch.serving.request import (
    Request,
    SamplingParams,
)


def params_from_record(rec: dict, default_max_new: int) -> SamplingParams:
    return SamplingParams(
        max_new_tokens=int(rec.get("max_new_tokens", default_max_new)),
        temperature=float(rec.get("temperature", 0.0)),
        top_k=(int(rec["top_k"]) if rec.get("top_k") else None),
        seed=int(rec.get("seed", 0)),
        eos_id=(int(rec["eos_id"]) if rec.get("eos_id") is not None else None),
        ignore_eos=bool(rec.get("ignore_eos", False)),
    )


def result_record(req: Request) -> dict:
    rec = req.summary()
    rec["token_ids"] = [int(t) for t in req.output_ids]
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
            if "prompt_ids" not in rec:
                raise ValueError(
                    f"{prompts_path}:{lineno}: needs 'prompt_ids' (text "
                    "prompts wait for a tokenizer)")
            handles.append(engine.submit(
                rec["prompt_ids"], params_from_record(rec, default_max_new),
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


def run_serve(args) -> DecodeEngine:
    """Build the model and engine from the parsed flags, serve
    ``--serve_prompts`` and return the shut-down engine."""
    from building_llm_from_scratch_tpu_torch.build_components import (
        build_config,
        build_params,
    )
    from building_llm_from_scratch_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    model = build_params(args, build_config(args), device)
    engine = DecodeEngine(
        model, n_slots=args.serve_slots, max_len=(args.serve_max_len or None),
        max_queue=args.serve_max_queue, max_top_k=args.serve_max_top_k,
        default_max_new_tokens=args.serve_max_new_tokens)
    engine.start()
    try:
        serve_jsonl(engine, args.serve_prompts, args.serve_out,
                    args.serve_max_new_tokens)
    finally:
        engine.shutdown()
    return engine
