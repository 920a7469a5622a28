"""Command-line flags of the port: the ``--mode serve`` and ``--mode train``
(pretraining, and instruction finetuning with ``--finetune --dataset
alpaca``, on the whole model or a LoRA adapter) subsets of the JAX
package's CLI, with the same names, defaults and checks, plus ``--device``:
pretrained weights from a local directory (``--load_weights
--weights_dir``), train-state checkpoints, resume, retention and the loss
watchdog, the precision policies (``--mixed_precision``, ``--data_type
fp16`` with loss scaling), gradient accumulation, activation
checkpointing, batch prefetch and asynchronous checkpoint writes.

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
    "--tokenizer_cache_dir",
    "--metrics_jsonl", "--log_every", "--compile_cache_dir",
    "--stall_timeout", "--run_type",
    "--shard_mode", "--pp", "--pp_micro", "--tp", "--sp",
    "--attn_impl", "--tokenizer_path",
    "--profile", "--profile_steps", "--warnings",
)

#: the ROADMAP queue item that brings an unported training flag
QUEUE_ITEMS = {
    "--tokenizer_path": "queue 1, tokenizers",
    "--serve_kv_quant": "queue 1 item 5, int8 KV",
    "--serve_spec_k": "queue 1 item 8, speculative decoding",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m building_llm_from_scratch_tpu_torch",
        description="PyTorch/CUDA port: GPT-2 and LLaMA-family pretraining "
                    "and instruction finetuning (LoRA or full), and "
                    "continuous-batching serving of token-id prompts.")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "serve", "finetune_fleet"],
                   help="'train' (pretraining or --finetune, "
                        "--byte_tokenizer) and 'serve' are ported; "
                        "'finetune_fleet' is not.")
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
    p.add_argument("--load_weights", action="store_true",
                   help="Load pretrained HF weights (from --weights_dir: the "
                        "port reads local files only).")
    p.add_argument("--weights_dir", type=str, default=None,
                   help="Local directory holding the pretrained checkpoint "
                        "files (model.safetensors, the LLaMA-3 shards, or "
                        "Meta's consolidated.00.pth).")
    # training (--mode train)
    p.add_argument("--data_dir", type=str, default="data",
                   help="Path to the dataset directory (.txt files; .json "
                        "Alpaca records with --finetune).")
    p.add_argument("--output_dir", type=str, default="model_checkpoints",
                   help="Directory of the final export.")
    p.add_argument("--n_epochs", type=int, default=2,
                   help="Number of training epochs.")
    p.add_argument("--batch_size", type=int, default=4,
                   help="Batch size for training.")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="Gradient-accumulation microbatches per step: the "
                        "batch is split into this many microbatches whose "
                        "gradients sum in fp32 (activation memory of one "
                        "microbatch, the full batch's weighted mean).")
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
    p.add_argument("--save_ckpt_freq", type=int, default=100,
                   help="Checkpoint save frequency (in steps).")
    p.add_argument("--prefetch", type=int, default=2,
                   help="Batch-prefetch depth: a worker thread keeps this "
                        "many batches built and copied to the card (on a "
                        "side stream) ahead of the step, in the exact "
                        "order of the synchronous path. 0 disables.")
    p.add_argument("--async_ckpt", type=str, default="off",
                   choices=["on", "off"],
                   help="Write periodic checkpoints on a worker thread: the "
                        "step loop pays only the host snapshot. final and "
                        "interrupted checkpoints still wait until durable.")
    p.add_argument("--use_actv_ckpt", action="store_true",
                   help="Activation checkpointing: recompute each block in "
                        "the backward.")
    p.add_argument("--mixed_precision", type=str, default=None,
                   choices=["fp16", "bf16", "bf16_hybrid", "fp32"],
                   help="Mixed-precision policy: master weights in "
                        "--data_type, forward and backward on a copy cast to "
                        "the policy's compute dtype (fp16 with dynamic loss "
                        "scaling; bf16_hybrid computes in fp32 on one "
                        "device).")
    # run management / fault tolerance (--mode train)
    p.add_argument("--resume_from", type=str, default=None,
                   help="Resume training from a checkpoint directory.")
    p.add_argument("--resume", type=str, default="auto",
                   help="'auto' (default): resume from the latest VALID "
                        "checkpoint in --output_dir (manifest + per-shard "
                        "size/sha256 checks; corrupt checkpoints fall back "
                        "to the previous valid one) — a preempted job "
                        "relaunches with its original command; 'off': "
                        "always start fresh; or an explicit checkpoint dir.")
    p.add_argument("--keep_ckpts", type=int, default=0,
                   help="Retention GC: keep at most N step-tagged "
                        "checkpoints (model_pg_<step>), pruning the oldest "
                        "after each save. 'interrupted'/'final' checkpoints "
                        "are never pruned. 0 keeps all.")
    p.add_argument("--watchdog", type=str, default="on", choices=["on", "off"],
                   help="Loss anomaly watchdog: halt with a diagnostic on "
                        "non-finite train loss or a spike above "
                        "--loss_spike_factor x the running median "
                        "(bf16/fp32 runs).")
    p.add_argument("--loss_spike_factor", type=float, default=10.0,
                   help="Watchdog spike threshold as a multiple of the "
                        "running median train loss.")
    p.add_argument("--watchdog_window", type=int, default=50,
                   help="Steps in the watchdog's running-median window.")
    p.add_argument("--byte_tokenizer", action="store_true",
                   help="Use the offline ByteTokenizer (the only tokenizer "
                        "ported; required by --mode train).")
    # instruction finetuning and LoRA (--mode train)
    p.add_argument("--finetune", action="store_true",
                   help="Enable instruction-finetuning mode.")
    p.add_argument("--dataset", type=str, default="gutenberg",
                   choices=["gutenberg", "alpaca"],
                   help="Dataset name (alpaca: the .json files under "
                        "--data_dir).")
    p.add_argument("--use_lora", action="store_true",
                   help="Enable LoRA fine-tuning.")
    p.add_argument("--lora_rank", type=int, default=64, help="LoRA rank.")
    p.add_argument("--lora_alpha", type=float, default=32, help="LoRA alpha.")
    p.add_argument("--save_adapter", type=str, default=None,
                   help="After a --use_lora run, export the trained adapter "
                        "as a standalone npz artifact (A/B tree + rank/alpha "
                        "+ base-config fingerprint) loadable by "
                        "--serve_adapters.")
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
    if args.mode == "serve":
        train_only = [f"--{name}" for name, default in _TRAIN_ONLY_DEFAULTS
                      if getattr(args, name) != default]
        if train_only:
            parser.error(f"{', '.join(train_only)}: training flag(s); --mode "
                         "serve takes adapters as --serve_adapters artifacts")
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
    _check_weights(args)
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


#: the finetuning, LoRA and run-management flags and their defaults
#: (refused in serve mode)
_TRAIN_ONLY_DEFAULTS = (
    ("finetune", False), ("dataset", "gutenberg"), ("use_lora", False),
    ("lora_rank", 64), ("lora_alpha", 32), ("save_adapter", None),
    ("save_ckpt_freq", 100), ("resume_from", None), ("resume", "auto"),
    ("keep_ckpts", 0), ("watchdog", "on"), ("loss_spike_factor", 10.0),
    ("watchdog_window", 50), ("grad_accum", 1), ("prefetch", 2),
    ("async_ckpt", "off"), ("use_actv_ckpt", False), ("mixed_precision", None),
)

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


def _check_weights(args) -> None:
    """The weight sources: pretrained files from a local directory, an
    ``.npz`` export, or (training) a train-state checkpoint."""
    if args.load_weights and not args.weights_dir:
        raise ValueError(
            "--load_weights needs --weights_dir: the PyTorch port reads "
            "pretrained weights from local files only (the HF-hub download "
            "is not ported)")
    if args.weights_dir and not args.load_weights:
        raise ValueError("--weights_dir requires --load_weights.")
    if args.weights_dir and not os.path.isdir(args.weights_dir):
        raise FileNotFoundError(
            f"--weights_dir '{args.weights_dir}' does not exist.")
    if args.init_params_from is not None:
        if args.load_weights:
            raise ValueError(
                "--init_params_from and --load_weights are mutually "
                "exclusive (local export vs pretrained weights).")
        if args.resume_from is not None:
            raise ValueError(
                "--init_params_from and --resume_from are mutually "
                "exclusive: resume restores the FULL train state and "
                "would silently discard the .npz params.")


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
    if not args.byte_tokenizer:
        raise ValueError(
            "--mode train needs --byte_tokenizer: the BPE tokenizers' asset "
            "files are not in the repository (ROADMAP queue 1, tokenizers)")
    for flag in ("n_epochs", "batch_size", "eval_freq", "print_sample_iter",
                 "save_ckpt_freq", "watchdog_window"):
        if getattr(args, flag) < 1:
            raise ValueError(f"--{flag} must be >= 1.")
    if args.keep_ckpts < 0:
        raise ValueError("--keep_ckpts must be >= 0 (0 keeps all).")
    if args.prefetch < 0:
        raise ValueError("--prefetch must be >= 0 (0 disables).")
    if args.grad_accum < 1:
        raise ValueError("--grad_accum must be >= 1.")
    if args.grad_accum > 1:
        if args.batch_size % args.grad_accum:
            raise ValueError(
                f"--batch_size {args.batch_size} must be divisible by "
                f"--grad_accum {args.grad_accum}.")
        if args.mixed_precision == "bf16_hybrid":
            raise ValueError(
                "--grad_accum does not compose with --mixed_precision "
                "bf16_hybrid (the explicit reduce-dtype step does not "
                "accumulate).")
    # fp16 parameters under another policy would bypass the loss scaler and
    # underflow their gradients; fp16 alone gets the fp16 policy
    if args.data_type == "fp16" and args.mixed_precision not in (None, "fp16"):
        raise ValueError(
            "--data_type fp16 requires --mixed_precision fp16 (or unset); "
            f"got --mixed_precision {args.mixed_precision}.")
    if args.loss_spike_factor <= 1.0:
        raise ValueError("--loss_spike_factor must be > 1.")
    if args.finetune and args.dataset == "gutenberg":
        raise ValueError(
            "--finetune requires an instruction dataset (--dataset alpaca).")
    if not args.finetune and args.dataset == "alpaca":
        raise ValueError("--dataset alpaca requires --finetune.")
    if args.use_lora and args.lora_rank < 1:
        raise ValueError("--lora_rank must be >= 1.")
    if args.save_adapter and not args.use_lora:
        raise ValueError("--save_adapter requires --use_lora (there is "
                         "no adapter to export otherwise).")
