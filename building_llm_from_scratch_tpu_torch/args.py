"""Command-line flags of the port: the ``--mode serve`` and ``--mode train``
(pretraining) subsets of the JAX package's CLI, with the same names and
defaults, plus ``--device``.

Flags of the JAX CLI that the port does not carry yet are rejected by name
(not ignored), so a command line written for the JAX package fails loudly
here instead of silently doing something else.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from building_llm_from_scratch_tpu_torch.configs import MODEL_PARAMS_MAPPING

#: flags of the JAX package's CLI that this port does not take yet
UNPORTED_FLAGS = (
    "--serve_replicas", "--serve_workers",
    "--serve_tp", "--serve_sp", "--serve_max_prompt", "--serve_port",
    "--serve_host", "--drain_timeout", "--serve_tick_timeout",
    "--serve_max_restarts", "--serve_deadline_s",
    "--serve_metrics_every", "--serve_kv_quant",
    "--serve_spec_k",
    "--fleet_jobs", "--fleet_rows_per_job", "--fleet_capacity",
    "--fleet_export_dir", "--fleet_style",
    "--prefetch", "--async_ckpt", "--tokenizer_cache_dir",
    "--save_ckpt_freq", "--grad_accum",
    "--metrics_jsonl", "--log_every", "--compile_cache_dir",
    "--stall_timeout", "--load_weights", "--weights_dir", "--run_type",
    "--shard_mode", "--pp", "--pp_micro", "--tp", "--sp", "--use_actv_ckpt",
    "--mixed_precision", "--attn_impl", "--finetune", "--dataset",
    "--use_lora", "--lora_rank", "--lora_alpha", "--save_adapter",
    "--tokenizer_path", "--resume_from", "--resume",
    "--keep_ckpts", "--watchdog", "--loss_spike_factor", "--watchdog_window",
    "--profile", "--profile_steps", "--warnings",
)

#: the ROADMAP queue item that brings an unported training flag
QUEUE_ITEMS = {
    "--use_actv_ckpt": "queue 1, remat",
    "--mixed_precision": "queue 1, precision policies",
    "--save_ckpt_freq": "queue 1, train-state checkpoints",
    "--grad_accum": "queue 1, gradient accumulation",
    "--resume": "queue 1, train-state checkpoints",
    "--resume_from": "queue 1, train-state checkpoints",
    "--finetune": "queue 1 item 2, LLaMA LoRA SFT",
    "--use_lora": "queue 1 item 2, LLaMA LoRA SFT",
    "--lora_rank": "queue 1 item 2, LLaMA LoRA SFT",
    "--lora_alpha": "queue 1 item 2, LLaMA LoRA SFT",
    "--save_adapter": "queue 1 item 2, LLaMA LoRA SFT",
    "--tokenizer_path": "queue 1, tokenizers",
    "--load_weights": "queue 1, HF weight loading",
    "--serve_kv_quant": "queue 1 item 5, int8 KV",
    "--serve_spec_k": "queue 1 item 8, speculative decoding",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m building_llm_from_scratch_tpu_torch",
        description="PyTorch/CUDA port: GPT-2 and LLaMA-family pretraining "
                    "and continuous-batching serving of token-id prompts.")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "serve", "finetune_fleet"],
                   help="'train' (pretraining, --byte_tokenizer) and "
                        "'serve' are ported; 'finetune_fleet' is not.")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="Where the model runs; cuda unless cpu is asked for.")
    p.add_argument("--model", type=str, default="GPT2",
                   choices=list(MODEL_PARAMS_MAPPING))
    p.add_argument("--num_params", type=str, default="124M")
    p.add_argument("--data_type", type=str, default="fp32",
                   choices=["fp32", "fp16", "bf16"])
    p.add_argument("--target_context_length", type=int, default=1024,
                   help="Clamp LLaMA context to this length with RoPE theta "
                        "rescale; 0 keeps the native context.")
    p.add_argument("--debug", action="store_true",
                   help="Use a small model for debugging purposes.")
    p.add_argument("--seed", type=int, default=123,
                   help="Seed of the random weights, the batch shuffle and "
                        "the dropout masks.")
    p.add_argument("--init_params_from", type=str, default=None,
                   help="Load params from a JAX export_params .npz.")
    # training (--mode train)
    p.add_argument("--data_dir", type=str, default="data",
                   help="Path to the dataset directory (.txt files).")
    p.add_argument("--output_dir", type=str, default="model_checkpoints",
                   help="Directory of the final export.")
    p.add_argument("--n_epochs", type=int, default=2,
                   help="Number of training epochs.")
    p.add_argument("--batch_size", type=int, default=4,
                   help="Batch size for training.")
    p.add_argument("--lr", type=float, default=5e-4,
                   help="Base (peak) learning rate.")
    p.add_argument("--warmup_steps", type=int, default=10,
                   help="Number of warmup steps.")
    p.add_argument("--initial_lr", type=float, default=1e-5,
                   help="Initial learning rate before warmup.")
    p.add_argument("--min_lr", type=float, default=1e-6,
                   help="Minimum learning rate.")
    p.add_argument("--print_sample_iter", type=int, default=10,
                   help="Steps between printing sample outputs.")
    p.add_argument("--eval_freq", type=int, default=10,
                   help="Evaluation frequency (in steps).")
    p.add_argument("--byte_tokenizer", action="store_true",
                   help="Use the offline ByteTokenizer (the only tokenizer "
                        "ported; required by --mode train).")
    # serving (--mode serve)
    p.add_argument("--serve_slots", type=int, default=8)
    p.add_argument("--serve_max_len", type=int, default=0,
                   help="Per-slot token capacity; 0 uses the model context.")
    p.add_argument("--serve_max_new_tokens", type=int, default=128)
    p.add_argument("--serve_max_top_k", type=int, default=64)
    p.add_argument("--serve_max_queue", type=int, default=64)
    p.add_argument("--serve_prompts", type=str, default=None,
                   help="JSONL of requests with 'prompt_ids'.")
    p.add_argument("--serve_out", type=str, default=None,
                   help="JSONL results (default stdout).")
    p.add_argument("--serve_prefix_cache", type=str, default="off",
                   choices=["on", "off"],
                   help="KV prefix caching: requests sharing a prompt prefix "
                        "(system prompts) reuse its KV instead of recomputing "
                        "it; LRU-evicted under --serve_prefix_budget_mb. "
                        "Implies chunked prefill (--serve_prefill_chunk, "
                        "default 64 when unset).")
    p.add_argument("--serve_prefill_chunk", type=int, default=0,
                   help="Chunked prefill: prompts prefill in chunks of this "
                        "many tokens interleaved with decode ticks. 0 = "
                        "monolithic bucketed prefill.")
    p.add_argument("--serve_prefix_budget_mb", type=float, default=256.0,
                   help="Prefix-store byte budget (MiB of device memory).")
    p.add_argument("--serve_kv_paged", type=str, default="off",
                   choices=["on", "off"],
                   help="Paged KV cache: slot KV lives in fixed-size pages of "
                        "a shared pool addressed through per-slot page "
                        "tables; prefix hits share refcounted pages (no "
                        "copy) and admission checks free pages. Implies "
                        "chunked prefill (--serve_prefill_chunk, default 64 "
                        "when unset).")
    p.add_argument("--serve_kv_page_tokens", type=int, default=16,
                   help="Tokens per KV page when --serve_kv_paged on; the "
                        "prefill chunk must be a whole number of pages.")
    p.add_argument("--serve_adapters", type=str, default=None,
                   help="Multi-tenant LoRA serving: comma-separated name=path "
                        "pairs of adapter artifacts (models.lora.save_adapter "
                        ".npz files of either package) loaded into the "
                        "engine's stacked adapter pool. Requests pick one "
                        "with their 'adapter' field; base-model traffic "
                        "co-batches with any adapter mix.")
    p.add_argument("--serve_adapter_slots", type=int, default=0,
                   help="Adapter-pool capacity (rows) for --serve_adapters; "
                        "hot-loads beyond it are refused. 0 = number of "
                        "listed adapters + 1 spare row.")
    return p


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    unported = sorted({u.split("=", 1)[0] for u in unknown
                       if u.split("=", 1)[0] in UNPORTED_FLAGS})
    if unported:
        where = [f"{u}: ROADMAP {QUEUE_ITEMS[u]}" for u in unported
                 if u in QUEUE_ITEMS]
        parser.error(f"{', '.join(unported)}: flag(s) of the JAX package "
                     "that the PyTorch port does not support yet"
                     + (f" ({'; '.join(where)})" if where else ""))
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    perform_checks(args)
    return args


def perform_checks(args) -> None:
    if args.num_params not in MODEL_PARAMS_MAPPING.get(args.model, []):
        raise ValueError(
            f"Unsupported model configuration: {args.model} with "
            f"{args.num_params}. Supported sizes: "
            f"{MODEL_PARAMS_MAPPING.get(args.model, [])}")
    if args.init_params_from and not os.path.isfile(args.init_params_from):
        raise ValueError(
            f"--init_params_from '{args.init_params_from}' does not exist.")
    if args.mode not in ("serve", "train"):
        raise ValueError(f"--mode {args.mode} is not ported yet; the PyTorch "
                         "port runs --mode train and --mode serve")
    if args.mode == "serve":
        _check_serve(args)
        return
    # a serve flag set outside serve mode is a missing --mode serve, not a
    # flag to drop silently
    stray = [f"--{name}" for name, default in _SERVE_DEFAULTS
             if getattr(args, name) != default]
    if stray:
        raise ValueError(f"{', '.join(stray)} require --mode serve.")
    _check_train(args)


#: the serve flags and their defaults (the stray-flag rule)
_SERVE_DEFAULTS = (
    ("serve_prompts", None), ("serve_out", None), ("serve_slots", 8),
    ("serve_max_queue", 64), ("serve_max_new_tokens", 128),
    ("serve_max_len", 0), ("serve_max_top_k", 64),
    ("serve_prefix_cache", "off"), ("serve_prefill_chunk", 0),
    ("serve_prefix_budget_mb", 256.0), ("serve_kv_paged", "off"),
    ("serve_kv_page_tokens", 16), ("serve_adapters", None),
    ("serve_adapter_slots", 0),
)


def _check_serve(args) -> None:
    if not args.serve_prompts:
        raise ValueError("--mode serve needs --serve_prompts <requests.jsonl>")
    if not os.path.isfile(args.serve_prompts):
        raise ValueError(f"--serve_prompts '{args.serve_prompts}' does not exist.")
    for flag in ("serve_slots", "serve_max_queue", "serve_max_new_tokens",
                 "serve_max_top_k"):
        if getattr(args, flag) < 1:
            raise ValueError(f"--{flag} must be >= 1.")
    if args.serve_max_len < 0:
        raise ValueError("--serve_max_len must be >= 0 (0 = model context).")
    if args.serve_prefill_chunk < 0:
        raise ValueError("--serve_prefill_chunk must be >= 0 "
                         "(0 = monolithic bucketed prefill).")
    if args.serve_prefix_budget_mb <= 0:
        raise ValueError("--serve_prefix_budget_mb must be > 0.")
    if args.serve_kv_page_tokens < 1:
        raise ValueError("--serve_kv_page_tokens must be >= 1.")
    if args.serve_adapter_slots < 0:
        raise ValueError("--serve_adapter_slots must be >= 0 "
                         "(0 = sized to the listed adapters).")
    if args.serve_adapters:
        from building_llm_from_scratch_tpu_torch.serving.frontend import (
            parse_adapter_specs,
        )

        specs = parse_adapter_specs(args.serve_adapters)
        if 0 < args.serve_adapter_slots < len(specs):
            raise ValueError(
                f"--serve_adapter_slots {args.serve_adapter_slots} cannot hold "
                f"the {len(specs)} adapters listed in --serve_adapters.")
        for name, path in specs.items():
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"--serve_adapters '{name}': artifact '{path}' does not "
                    "exist.")
    if args.serve_kv_paged == "on":
        chunk = args.serve_prefill_chunk or 64
        if chunk % args.serve_kv_page_tokens != 0:
            raise ValueError(
                f"--serve_prefill_chunk {chunk} must be a whole number of "
                f"pages (--serve_kv_page_tokens {args.serve_kv_page_tokens}): "
                "chunk scatters land on page boundaries.")


def _check_train(args) -> None:
    if not os.path.exists(args.data_dir):
        raise FileNotFoundError(
            f"Data directory '{args.data_dir}' does not exist.")
    if args.data_type == "fp16":
        raise ValueError(
            "--data_type fp16 trains with dynamic loss scaling, which is not "
            "ported yet (ROADMAP queue 1, precision policies); use bf16 or "
            "fp32")
    if not args.byte_tokenizer:
        raise ValueError(
            "--mode train needs --byte_tokenizer: the BPE tokenizers' asset "
            "files are not in the repository (ROADMAP queue 1, tokenizers)")
    for flag in ("n_epochs", "batch_size", "eval_freq", "print_sample_iter"):
        if getattr(args, flag) < 1:
            raise ValueError(f"--{flag} must be >= 1.")
