"""Command-line flags of the port: the ``--mode serve`` subset of the JAX
package's CLI, with the same names and defaults, plus ``--device``.

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
    "--data_dir", "--output_dir", "--serve_replicas", "--serve_workers",
    "--serve_tp", "--serve_sp", "--serve_max_prompt", "--serve_port",
    "--serve_host", "--drain_timeout", "--serve_tick_timeout",
    "--serve_max_restarts", "--serve_deadline_s", "--serve_adapters",
    "--serve_adapter_slots", "--serve_metrics_every", "--serve_prefix_cache",
    "--serve_prefill_chunk", "--serve_kv_quant", "--serve_prefix_budget_mb",
    "--serve_kv_paged", "--serve_kv_page_tokens", "--serve_spec_k",
    "--fleet_jobs", "--fleet_rows_per_job", "--fleet_capacity",
    "--fleet_export_dir", "--fleet_style", "--n_epochs", "--batch_size",
    "--grad_accum", "--lr", "--warmup_steps", "--initial_lr", "--min_lr",
    "--prefetch", "--async_ckpt", "--tokenizer_cache_dir",
    "--print_sample_iter", "--eval_freq", "--save_ckpt_freq",
    "--metrics_jsonl", "--log_every", "--compile_cache_dir",
    "--stall_timeout", "--load_weights", "--weights_dir", "--run_type",
    "--shard_mode", "--pp", "--pp_micro", "--tp", "--sp", "--use_actv_ckpt",
    "--mixed_precision", "--attn_impl", "--finetune", "--dataset",
    "--use_lora", "--lora_rank", "--lora_alpha", "--save_adapter",
    "--tokenizer_path", "--byte_tokenizer", "--resume_from", "--resume",
    "--keep_ckpts", "--watchdog", "--loss_spike_factor", "--watchdog_window",
    "--profile", "--profile_steps", "--warnings",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m building_llm_from_scratch_tpu_torch",
        description="PyTorch/CUDA port: continuous-batching serving of "
                    "token-id prompts.")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "serve", "finetune_fleet"],
                   help="Only 'serve' is ported so far.")
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
                   help="Seed of the random weights.")
    p.add_argument("--init_params_from", type=str, default=None,
                   help="Load params from a JAX export_params .npz.")
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
    return p


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    unported = sorted({u.split("=", 1)[0] for u in unknown
                       if u.split("=", 1)[0] in UNPORTED_FLAGS})
    if unported:
        parser.error(f"{', '.join(unported)}: flag(s) of the JAX package "
                     "that the PyTorch port does not support yet")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    perform_checks(args)
    return args


def perform_checks(args) -> None:
    if args.mode != "serve":
        raise ValueError(f"--mode {args.mode} is not ported yet; the PyTorch "
                         "port runs --mode serve only")
    if not args.serve_prompts:
        raise ValueError("--mode serve needs --serve_prompts <requests.jsonl>")
    if not os.path.isfile(args.serve_prompts):
        raise ValueError(f"--serve_prompts '{args.serve_prompts}' does not exist.")
    if args.num_params not in MODEL_PARAMS_MAPPING.get(args.model, []):
        raise ValueError(
            f"Unsupported model configuration: {args.model} with "
            f"{args.num_params}. Supported sizes: "
            f"{MODEL_PARAMS_MAPPING.get(args.model, [])}")
    for flag in ("serve_slots", "serve_max_queue", "serve_max_new_tokens",
                 "serve_max_top_k"):
        if getattr(args, flag) < 1:
            raise ValueError(f"--{flag} must be >= 1.")
    if args.serve_max_len < 0:
        raise ValueError("--serve_max_len must be >= 0 (0 = model context).")
    if args.init_params_from and not os.path.isfile(args.init_params_from):
        raise ValueError(
            f"--init_params_from '{args.init_params_from}' does not exist.")
