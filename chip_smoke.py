#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failed check raises and the script
exits non-zero):

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, capability (must be 9.0); TF32 off for matmuls and cuDNN.
  2. build: compiles the package's CUDA kernels from ``csrc/`` with nvcc;
     prints every kernel's registers and spill bytes (``-Xptxas -v``).
  3. decode kernel vs twin: the fused decode-step kernel (B5) against its
     plain PyTorch twin at the serving shapes of LLaMA-3.2-1B (bf16),
     GPT-2-124M (fp32), LLaMA-3-8B (bf16) and longctx-32k (bf16, a
     32,768-long cache with both rows past 8,192): caches bit-equal, outputs
     within tolerance of the twin and within one unit in the last place of
     the exact (fp32) result, bit-equal over two calls and for the longest
     row alone (S = 1); the split plan (C, n_splits), the blocks with work;
     times of the kernel, the twin and ``scaled_dot_product_attention`` on
     the same cache, beside the bound the card's memory rate sets, and the
     achieved GB/s.
     3b. the paged decode-attention kernel (B7) against its twin at the
     paged serving shapes of LLaMA-3.2-1B (bf16) and GPT-2-124M (fp32),
     page 16, over phase 3's lengths on a pool of shuffled pages: within
     phase 3's tolerances of the twin and of the exact result, and bit-equal
     to B5 on the same rows laid out contiguously (B7 runs B5's split pass
     and merge); times of the kernel, the twin, the library's two calls
     (page gather + SDPA) and B5 on those rows, beside the bytes bound.
     3c. the BGMV kernel (B6) against its twin at every adapted projection
     shape of LLaMA-3.2-1B (bf16) and GPT-2-124M (fp32), S 8 rows over a
     pool of 4 rows of rank 16 (ids with -1 and repeats), the pool read in
     place as a layer's slice: within the bounds of the twin and of the
     exact fp64 result relative to the second product's magnitude; the twin
     with permuted ids must fail them; each row's output alone bit-equal to
     its output co-batched. Times of the kernel, the twin and the gathered
     library path (index_select + two bmm), beside the bytes bound.
  4. serving: the continuous-batching engine at full width, random weights
     from a seed: LLaMA-3.2-1B in bf16 with its 16 layers and GPT-2-124M in
     fp32 (24 requests over 8 slots of 1024), then LLaMA-3-8B in bf16 cut to
     2 layers (12 requests over 4 slots of 4096). Every request finishes its
     budget, the kernel's launch count equals layers x decode ticks, three
     greedy requests re-run alone in a fresh engine give the same tokens,
     and the card's logits agree with an fp32 CPU reference more closely
     than a reference without decode attention does.
     4b. paged KV with prefix sharing and chunked prefill (64-token chunks,
     16-token pages): LLaMA-3.2-1B bf16 through the CLI (``main.run --mode
     serve --serve_kv_paged on --serve_prefix_cache on``), GPT-2-124M fp32
     paged, and LLaMA-3.2-1B with the prefix cache over contiguous slots;
     24 requests, 20 behind 3 seeded 320-token system prompts. Every request
     finishes its budget, prefix hits >= 17, no pane copy when paged, the
     idle pool holds only the store's pages with nothing reserved, B7 =
     layers x decode ticks and B5 = 0 when paged (the reverse otherwise),
     three greedy requests alone give the same tokens; a paged reference
     check against the fp32 CPU with its no-attention control; prefill of
     the sharers with and without the warm prefix cache.
     4c. multi-LoRA serving: LLaMA-3.2-1B bf16 through the CLI
     (``--serve_adapters`` with adapters of ranks 8, 16 and 16, pool 4 x
     rank 16) and GPT-2-124M fp32 in process (2 adapters), phase 4's
     weights; artifacts written by ``save_adapter`` with each delta about
     0.2 of its projection's rms; 24 requests, adapters and base in turn.
     Every budget finishes, B6 = adapted projections x layers x ticks (by
     shape) and B5 = layers x ticks, per-adapter counts match the traffic,
     three adapted greedy requests alone give the same tokens, adapted
     greedy tokens differ from the base model's on at least half the
     prompts, and an adapted card-vs-CPU fp32 reference passes while the
     same ticks with other adapters' ids fail it. Ticks with and without
     adapters in alternating windows; pool bytes and peak memory. After
     phase 6s, LLaMA-3.2-1B's trained SFT adapter is served through the
     CLI (``--serve_adapters sft=<path>``, phase 3c's pool shape) on the base
     it was trained on: 8 requests, B6 = 7 x layers x ticks, the adapted
     rows within the fp32 CPU reference, and the same ticks as the base
     model (ids -1) outside it.
     4d. long context through the contiguous engine: longctx-32k (bf16)
     cut to 2 layers on 2 slots of its native 32,768 tokens, a 4,096-token
     prompt decoding 4,200 tokens (its row ends past 8,192) beside a
     512-token one decoding 64. Every budget finishes, B5 = layers x
     ticks, every tick's logits are finite.
  5. flash-attention kernels vs twins: forward (B1), dq (B2a) and dk/dv
     summed over each kv head's query heads (B2b, (B, T, Hkv, D); its twin
     is the per-query-head twin followed by group_sum) at LLaMA-3.2-1B's
     training shape (B 4, Hq 32, Hkv 8, T 1024, hd 64) in bf16 and in fp32
     (the 3xTF32 kernels), the reference shapes (B 1, T 256, fp32 and
     bf16) and GPT-2-124M's training shape in fp16 (B 8, H 12, T 1024,
     hd 64: phase 6m's fp16 policy; fp16 held at bf16's bounds, the twin
     tolerance TWIN_TOL["fp16"]): out, lse and the gradients within tolerance of the twin and of
     the exact (fp32) result, each bound shown to fail for a wrong result;
     times of the kernels, the twins and ``scaled_dot_product_attention``
     (forward, forward+backward, and backward alone through autograd.grad
     of one saved forward; in fp32 with GQA also on K and V repeated to the
     query heads, SDPA's memory-efficient kernel), beside the bound the
     card's peak rate sets (fp32 flash: a third of the TF32 rate). In fp32
     the twins on one TF32 product (1xTF32) must fail the bounds of out and
     of every gradient (here and in 5b), so a kernel that lost the 3xTF32
     split's lo terms cannot pass.
     5b. the same kernels with attention dropout p = 0.1 at GPT-2-124M's
     training shape (B 8, H 12, T 1024, hd 64) in bf16, fp32 and fp16, and
     its fp32 reference shape (B 1, T 256): against the twin (the same mask) and an
     exact fp32 oracle built from the dumped mask; the mask's keep fraction
     (within 1e-3 of 0.9 over the causal entries), the same mask for the
     same seed and another for the next; the twin with the next seed must
     fail the bound. SDPA with dropout_p = 0.1 is the library yardstick.
     5c. the fused dropout kernel B3 (dropout, dropout + add, backward) at
     (8 x 1024, 768) in bf16, fp32 and fp16: bit-equal to the twins, p = 0 the
     identity, the keep fraction, the backward of ones equal to the
     forward's mask times 1/(1-p); F.dropout (+ add) as the yardstick.
     5d. the vocab-streamed cross-entropy forward B4 at N 8192, D 768,
     V 50257 in bf16, fp32 and fp16 (GPT-2-124M's training shape in its
     training dtypes and under the fp16 policy): lse and nll against the twin at the JAX test's
     bounds; the twin without the padded-column mask must fail them. Each
     row names the route (source) and its plan; the fp32 bound is a third
     of the TF32 rate (3xTF32), its library call torch.mm in full fp32. fp32
     B4 again on a head W ~ 0.1 randn against the full-fp32 twin at the same
     bounds, where the twin on 1xTF32 products must fail them (at W ~ 0.02
     the bounds cannot tell the two apart).
  6. training: ``main.run`` (--mode train) at full width on a seeded text
     file, 20 steps, one evaluation, the warm-up and one greedy sample, the
     final export: LLaMA-3.2-1B (bf16, 16 layers, batch 4, context 1024),
     then GPT-2-124M (bf16, 12 layers, batch 8, context 1024, dropout 0.1,
     the chunked cross entropy), then GPT-2-124M without --data_type (the
     default, fp32) and LLaMA-3.2-1B in fp32, the same shapes, whose flash
     calls take the 3xTF32 kernels. Launch counts exact (B1 = layers x (steps
     + eval batches), B2a = B2b = layers x steps, B3 forward and backward =
     (1 + 2 x layers) x steps with dropout, B4 = 0), every loss finite,
     the last below the first; the export loads back bit for bit and is
     served by the CLI. The run's own rate (all steps over their wall time,
     the trainer's window) and each step's device time (CUDA events around
     every step, step 1 apart); then steady step time, tokens/s, MFU, peak
     memory and a profiled window over re-runs of one batch (with the
     flash family's ms per step; the GQA group_sum must not run); MFU
     against the run dtype's dense peak (bf16 tensor cores, fp32 CUDA
     cores). For GPT-2, in bf16 and at the default dtype, the same 20
     steps again with BLLM_XENT_PALLAS=1: B4 = steps + eval batches, and
     the step-1 loss equal to the first run's to 1e-5. Each run's ``final``
     train state is counted, not written (phase 8r writes them).
  6m. precision policies, accumulation and remat through the CLI, full
     width: GPT-2-124M (B 8 x T 1024, p 0.1, fp32 masters, 20 steps) with
     --mixed_precision bf16, with --mixed_precision fp16 and B4 on (its
     skipped steps and loss-scale trace printed), and with --grad_accum 2
     in fp32 and B4 on (the sums loss); LLaMA-3.2-1B bf16 (B 4 x T 1024)
     with --use_actv_ckpt, whose per-step losses, evaluations and final
     parameters equal phase 6's run bit for bit, and with --use_actv_ckpt
     --grad_accum 2 --batch_size 8. Launch counts exact (remat: B1 twice a
     layer and microbatch), finite falling losses, the masters fp32 under
     a policy, GPT-2's exports loaded back bit for bit (LLaMA's counted,
     not written); GPT-2 fp32 one step with and without two microbatches
     from the same weights and batch at dropout 0 (p 0.1 draws other masks
     per microbatch): loss within 1e-5, gradients 1e-4. Step ms, tokens/s,
     MFU against the compute dtype's peak, peak memory.
  6h. host overlap: GPT-2-124M bf16 (B 8 x T 1024, p 0.1), 20 steps,
     --save_ckpt_freq 10 --keep_ckpts 1, once with --prefetch 0
     --async_ckpt off and once with --prefetch 2 --async_ckpt on: per-step
     losses and evaluations bit-equal, step 10's checkpoint pruned on step
     20's commit, the step-20 checkpoints valid and the same leaf for leaf.
     The save step's stall on the host clock, save seconds against the
     snapshot's, the write's and its overlap, the steady step, the
     device's idle share over a profiled window, prefetch stalls.
  6s. LoRA instruction finetuning through the CLI (``--finetune --dataset
     alpaca --use_lora``) on a ``scripts/build_local_alpaca.py`` file sized
     for 20 steps and 7 eval batches: LLaMA-3.2-1B bf16 (rank 16, alpha 32,
     batch 4, ``--save_adapter``), GPT-2-124M fp32 (batch 8, dropout 0.1),
     chunked and then with B4. Launch counts exact (phase 6's rule, less
     the frozen embedding's dropout backward), finite weighted losses, the
     last under the first, the base bit-equal to a fresh build, every B
     leaf moved, the merged export bit-equal to ``merge_lora`` on the card,
     the adapter read back with its rank, alpha and fingerprint, the B4
     run's step-1 loss within 1e-5 of the chunked one. Step ms (CUDA
     events), tokens/s, supervised tokens/s, peak memory and a profile,
     beside phase 6's pretraining step of the same model.
  7. training reference: one step at full width cut to 2 layers, B 1,
     T 256, in fp32 and in bf16, on the card and on the CPU (the twins)
     with the same weights, batch and dropout seed: loss and every leaf's
     gradient within the dtype's bound. Controls: LLaMA-3.2-1B without
     attention fails the gradient bound; GPT-2-124M (dropout 0.1) with
     another dropout seed on the CPU side fails the gradient bound, and in
     fp32 the loss bound (in bf16 its loss change is reported: it lies
     inside bf16's loss bound at this size).
  7m. the same cut of GPT-2-124M (2 layers, T 256, p 0.1) for one step
     under the bf16 policy and the fp16 policy on fp32 masters and under
     --data_type fp16 (fp16 masters, the fp16 policy), B 1, and with two
     microbatches in fp32 on two collated Alpaca records whose supervised
     counts differ: card against CPU within REF_BOUNDS (fp16: 1e-3 loss,
     1e-2 gradients), no step skipped, launches exact; the policies' CPU
     step with another dropout seed fails the gradient bound, and the mean
     of the microbatches' own means fails the accumulation's loss bound.
  7s. the same for one LoRA SFT step (rank 16, B drawn nonzero) on one
     collated Alpaca record: the loss and every adapter gradient within
     the dtype's bound; the CPU step with all-ones loss weights must fail
     the loss bound.
  8w. pretrained weights: HF-format files written from seeded models
     with every leaf drawn (GPT-2-124M fp32 ``model.safetensors`` with the
     fused c_attn and no lm_head; LLaMA-3.2-1B bf16 in HF naming without
     lm_head, so the tied fallback runs; LLaMA-2-7B bf16 cut to 2 layers as
     Meta's ``consolidated.00.pth``), each read back by ``load_hf_weights
     (weights_dir=)``: every leaf bit-equal; a GPT-2 file with q and k
     swapped in c_attn and a Meta file without the w2/w3 swap must not load
     bit-equal. Load seconds, bytes read, peak host RSS over the file.
     GPT-2 and LLaMA-3.2-1B served through ``--mode serve --load_weights
     --weights_dir`` (8 requests, 8 slots of 1024): B5 = layers x ticks,
     the greedy tokens those of the same weights served by the engine in
     process.
  8r. train-state checkpoints and resume through the CLI, at full width
     cut to 2 layers: GPT-2-124M fp32 (dropout 0.1, B 8 x T 1024)
     pretraining over two corpus files and LLaMA-3.2-1B bf16 LoRA SFT
     (rank 16, B 4 x T 1024) from 8w's files over two Alpaca files, 10
     steps, a checkpoint every 5. The unbroken command (``--resume off``;
     GPT-2's twice, bit-equal); the same with ``--keep_ckpts 1`` stopped by
     SIGTERM after step 7 (it returns, with an ``interrupted`` checkpoint
     holding the cursor and no export) and relaunched as it was: the
     remaining per-step losses, evaluations, counts and exports equal the
     unbroken run's bit for bit; a copy of the stopped dir with a shard of
     ``interrupted`` corrupted resumes, with an error line, from step 5.
     Launches exact in every run. Save seconds and bytes, restore seconds,
     relaunch to first step. Phases 6 and 6s write no ``final`` train
     state (its bytes are reported): the script keeps its disk writes under
     45 GiB, and phase 8r's saves need that room.
  9. the bytes the script wrote to disk, the ``kernels`` line (one row
     per kernel and shape, each with the launches of the run at that
     shape; B6 by projection shape from phase 4c; B5's rows add 8w's CLI
     launches, the training rows 8r's, 6m's and 6h's), then the card line
     and the result line.

It exits non-zero without printing a result when no CUDA device is present
or when the package is not beside it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import time


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase, with the script's elapsed seconds."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 1),
                      **fields}), flush=True)


def written_bytes() -> dict:
    """What this process wrote (Linux ``/proc/self/io``): ``wchar``, the
    bytes passed to write calls (files, and the few on stdout), and
    ``write_bytes``, what reached storage. The card's machine caps a
    call's disk writes."""
    with open("/proc/self/io") as f:
        fields = dict(ln.split(": ") for ln in f.read().splitlines())
    return {k: int(fields[k]) for k in ("wchar", "write_bytes")}


# card figures from NVIDIA's data sheets: memory bytes/s and dense peak
# operations/s for 16-bit and TF32 (tensor cores) and 32-bit float (CUDA
# cores)
_CARDS = {
    "H100 PCIe": dict(bw=2.0e12, peak16=756e12, peak_tf32=378e12, peak32=51e12),
    "H100 NVL": dict(bw=3.9e12, peak16=835e12, peak_tf32=417.5e12, peak32=60e12),
    "H100 SXM": dict(bw=3.35e12, peak16=989e12, peak_tf32=495e12, peak32=67e12),
}


def flash_peak(fig: dict, dtype: str) -> float:
    """The operations/s that bound a flash kernel: the 16-bit tensor-core
    rate, or for fp32 the fp32-grade rate of 3xTF32 on the tensor cores
    (three TF32 products per product: a third of the TF32 rate)."""
    return fig["peak_tf32"] / 3 if dtype == "fp32" else fig["peak16"]


def card_figures(name: str) -> tuple:
    for key in ("H100 PCIe", "H100 NVL"):
        if key.split()[1] in name:
            return key, _CARDS[key]
    return "H100 SXM", _CARDS["H100 SXM"]


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    figure_name, figures = card_figures(name)
    emit("env", nvidia_smi=card_line, device=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, capability=list(cap),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         bound_figures=figure_name, **figures)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    return dict(card_line=card_line, name=name, figures=figures)


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from building_llm_from_scratch_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    info = _kernels.build()
    _kernels.load_library()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         built=info["built"], library=info["path"],
         sources=[str(s.name) for s in _kernels.sources()],
         ptxas=ptxas_resources(info.get("log", "")))


def ptxas_resources(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function in nvcc's ``-Xptxas -v`` output (mangled names cut to
    their kernel name and template arguments)."""
    import re

    rows, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            # Itanium <length><identifier>; a length may follow other digits
            for d in re.finditer(r"\d+", name):
                run = d.group()
                hit = next((name[d.end():d.end() + int(run[i:])] for i in range(len(run))
                            if name[d.end():d.end() + int(run[i:])].endswith("_kernel")),
                           None)
                if hit:
                    args = re.match(r"I(.*?)EE?v", name[d.end() + len(hit):])
                    name = hit + (f"<{args.group(1)}>" if args else "")
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name, spill = None, (0, 0)
    return rows


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

KERNEL_SHAPES = [
    # name (the model served at this shape in phase 4), S, Hq, Hkv, hd,
    # Tmax, dtype
    ("llama3_2-1B", 8, 32, 8, 64, 1024, "bf16"),
    ("gpt2-124M", 8, 12, 12, 64, 1024, "fp32"),
    ("llama3-8B", 4, 32, 8, 128, 4096, "bf16"),
    # longctx-32k's decode shape at its native context (phase 4d): a cache
    # past the TPU kernel's 8192, both rows longer than 8192
    ("longctx-32k", 2, 16, 4, 64, 32768, "bf16"),
]

# (atol, rtol) of the kernel against its twin, which rounds the softmax
# weights to the model dtype before P.V as the JAX package does (the
# kernel keeps them in fp32): the JAX kernel test's tolerance for 16-bit
# types.
TWIN_TOL = {"fp32": (1e-5, 1e-5), "fp16": (2e-2, 2e-2), "bf16": (2e-2, 2e-2)}
# (atol, rtol) of the kernel against the exact result (the twin on the same
# inputs in fp32): the kernel rounds only its output, so one unit in the
# last place of the output dtype, plus fp32 summation noise near 0.
EXACT_TOL = {"fp32": (1e-5, 1e-5), "fp16": (1e-5, 2.0 ** -10),
             "bf16": (1e-5, 2.0 ** -7)}


def device_time_ms(torch, fn, flush, runs: int = 25, warmup: int = 5) -> float:
    """Median device time of one call of ``fn``: each run flushes L2 (the
    main path finds the cache cold), queues a sleep so the host has enqueued
    the call before the device reaches it, and reads CUDA events around
    the call alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(torch, card: dict) -> list:
    import torch.nn.functional as F

    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops.decode_step import (
        fused_decode_step,
        fused_decode_step_plain,
        split_kv_plan,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    fig = card["figures"]
    rows = []
    for name, S, Hq, Hkv, hd, Tmax, dt in KERNEL_SHAPES:
        dtype = DTYPE_MAP[dt]
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,  # noqa: E731
                                         dtype=torch.float32).to(dtype)
        q, kn, vn = rnd(S, 1, Hq, hd), rnd(S, 1, Hkv, hd), rnd(S, 1, Hkv, hd)
        K, V = rnd(S, Hkv, Tmax, hd), rnd(S, Hkv, Tmax, hd)
        lens = torch.randint(1, Tmax - 1, (S,), generator=gen, device=dev)
        lens[0], lens[1] = (8200 if Tmax > 8192 else 0), Tmax - 1
        lens = lens.to(torch.int32)

        Kk, Vk = K.clone(), V.clone()
        out_k, Ko, Vo = fused_decode_step(q, kn, vn, Kk, Vk, lens)
        torch.cuda.synchronize()
        Kt, Vt = K.clone(), V.clone()
        out_t, _, _ = fused_decode_step_plain(q, kn, vn, Kt, Vt, lens)
        torch.cuda.synchronize()
        if Ko is not Kk or Vo is not Vk:
            raise AssertionError("the kernel must return its cache tensors")
        if not (torch.equal(Kk, Kt) and torch.equal(Vk, Vt)):
            raise AssertionError(f"{name}: kernel caches differ from the twin's")
        atol, rtol = TWIN_TOL[dt]
        err = (out_k.float() - out_t.float()).abs().max().item()
        if not torch.allclose(out_k.float(), out_t.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"{name}: kernel output off the twin by {err}")
        f32 = lambda t: t.float().clone()  # noqa: E731
        out_x, _, _ = fused_decode_step_plain(f32(q), f32(kn), f32(vn), f32(K),
                                              f32(V), lens)
        ex_atol, ex_rtol = EXACT_TOL[dt]
        exact_err = (out_k.float() - out_x).abs().max().item()
        if not torch.allclose(out_k.float(), out_x, atol=ex_atol, rtol=ex_rtol):
            raise AssertionError(f"{name}: kernel output off the exact result "
                                 f"by {exact_err}")
        del out_x
        if not torch.isfinite(out_k).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        # bit-equal over two calls, and for the longest row alone (S = 1)
        again, _, _ = fused_decode_step(q, kn, vn, K.clone(), V.clone(), lens)
        alone, _, _ = fused_decode_step(q[1:2].clone(), kn[1:2].clone(),
                                        vn[1:2].clone(), K[1:2].clone(),
                                        V[1:2].clone(), lens[1:2].clone())
        if not (torch.equal(again, out_k) and torch.equal(alone, out_k[1:2])):
            raise AssertionError(f"{name}: the kernel's output is not bit-equal "
                                 "over two calls or for a row alone")
        del again, alone
        C, n_splits = split_kv_plan(Tmax, hd, dtype)

        # the library yardstick: SDPA over the same (already appended) cache
        pos = torch.arange(Tmax, device=dev)
        mask = (pos[None, :] <= lens[:, None].long())[:, None, None, :]
        qh = q.transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(qh, Kk, Vk, attn_mask=mask,
                                                  enable_gqa=True)

        lib_out = library().transpose(1, 2)
        lib_err = (lib_out.float() - out_t.float()).abs().max().item()
        if not torch.allclose(lib_out.float(), out_t.float(), atol=atol * 5,
                              rtol=rtol * 5):
            raise AssertionError(f"{name}: the library call disagrees by "
                                 f"{lib_err}")

        ms = device_time_ms(torch, lambda: fused_decode_step(q, kn, vn, Kk, Vk, lens),
                            flush)
        plain_ms = device_time_ms(
            torch, lambda: fused_decode_step_plain(q, kn, vn, Kt, Vt, lens), flush)
        library_ms = device_time_ms(torch, library, flush)

        elt = K.element_size()
        prefix = int(lens.long().sum().item())
        bytes_moved = elt * (2 * S * Hq * hd + 4 * S * Hkv * hd
                             + 2 * prefix * Hkv * hd) + 4 * S
        ops = 4 * (prefix + S) * Hq * hd
        peak = fig["peak32"] if dtype == torch.float32 else fig["peak16"]
        t_bytes, t_ops = bytes_moved / fig["bw"], ops / peak
        row = dict(shape=name, S=S, Hq=Hq, Hkv=Hkv, hd=hd, Tmax=Tmax, dtype=dt,
                   lengths=[int(x) for x in lens.tolist()], C=C, n_splits=n_splits,
                   blocks_with_work=sum(Hkv * (int(t) // C + 1) for t in lens.tolist()),
                   gbps=bytes_moved / (ms * 1e-3) / 1e9,
                   max_abs_err=err, atol=atol, rtol=rtol,
                   exact_max_abs_err=exact_err, exact_atol=ex_atol,
                   exact_rtol=ex_rtol,
                   out_rms=out_t.float().pow(2).mean().sqrt().item(),
                   library_max_abs_err=lib_err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bytes=bytes_moved, ops=ops,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit("kernel", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 3b: the paged decode-attention kernel (B7) against its twin
# ---------------------------------------------------------------------------

PAGED_SHAPES = [
    # name (the model served paged at this shape in phase 4b), S, Hq, Hkv,
    # hd, page tokens P, table width M (M x P = phase 3's Tmax), dtype
    ("llama3_2-1B", 8, 32, 8, 64, 16, 64, "bf16"),
    ("gpt2-124M", 8, 12, 12, 64, 16, 64, "fp32"),
]


def phase_paged_kernel(torch, card: dict, b5_rows: list) -> list:
    """B7 at the served shapes, over phase 3's row lengths on a pool of
    shuffled pages (each row's own pages, columns past its frontier on the
    trash page): within B5's tolerances of the twin and of the exact fp32
    result. Times of the kernel, its twin, the library's two calls (an
    index gather of the rows' pages, then ``scaled_dot_product_attention``
    with a length mask) and B5 on the same logical rows in the contiguous
    layout."""
    import torch.nn.functional as F

    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops.decode_step import (
        fused_decode_step,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_view,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    fig = card["figures"]
    lengths = {r["shape"]: r["lengths"] for r in b5_rows}
    rows = []
    for name, S, Hq, Hkv, hd, P, M, dt in PAGED_SHAPES:
        dtype = DTYPE_MAP[dt]
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,  # noqa: E731
                                         dtype=torch.float32).to(dtype)
        N = S * M + 1
        q, K, V = rnd(S, 1, Hq, hd), rnd(N, Hkv, P, hd), rnd(N, Hkv, P, hd)
        lens = torch.tensor(lengths[name], dtype=torch.int32, device=dev)
        pages = (torch.randperm(N - 1, generator=gen, device=dev) + 1).view(S, M)
        used = lens.long() // P + 1                       # pages each row reads
        col = torch.arange(M, device=dev)[None, :]
        table = torch.where(col < used[:, None], pages, 0).to(torch.int32).contiguous()

        out_k = paged_decode_attention(q, K, V, table, lens)
        torch.cuda.synchronize()
        out_t = paged_decode_attention_plain(q, K, V, table, lens)
        atol, rtol = TWIN_TOL[dt]
        err = (out_k.float() - out_t.float()).abs().max().item()
        if not torch.allclose(out_k.float(), out_t.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"{name}: B7 off its twin by {err}")
        out_x = paged_decode_attention_plain(q.float(), K.float(), V.float(),
                                             table, lens)
        ex_atol, ex_rtol = EXACT_TOL[dt]
        exact_err = (out_k.float() - out_x).abs().max().item()
        if not torch.allclose(out_k.float(), out_x, atol=ex_atol, rtol=ex_rtol):
            raise AssertionError(f"{name}: B7 off the exact result by {exact_err}")
        if not torch.isfinite(out_k).all():
            raise AssertionError(f"{name}: non-finite B7 output")

        # B5 on the same logical rows, laid out contiguously (its append
        # rewrites each row's last position with the value it holds)
        Kc = paged_view(K, table, M * P).contiguous()
        Vc = paged_view(V, table, M * P).contiguous()
        at = (torch.arange(S, device=dev), slice(None), lens.long())
        kn, vn = Kc[at][:, None].contiguous(), Vc[at][:, None].contiguous()
        out_b5, _, _ = fused_decode_step(q, kn, vn, Kc, Vc, lens)
        b5_err = (out_b5.float() - out_k.float()).abs().max().item()
        if not torch.equal(out_b5, out_k):
            raise AssertionError(f"{name}: B7 is not bit-equal to B5 on the same "
                                 f"rows (max |diff| {b5_err})")

        # the library yardstick, two calls: gather the pages, then SDPA
        mask = (torch.arange(M * P, device=dev)[None, :]
                <= lens[:, None].long())[:, None, None, :]
        qh = q.transpose(1, 2)

        def library():
            Kg = paged_view(K, table, M * P)
            Vg = paged_view(V, table, M * P)
            return F.scaled_dot_product_attention(qh, Kg, Vg, attn_mask=mask,
                                                  enable_gqa=True)

        lib_out = library().transpose(1, 2)
        lib_err = (lib_out.float() - out_t.float()).abs().max().item()
        if not torch.allclose(lib_out.float(), out_t.float(), atol=atol * 5,
                              rtol=rtol * 5):
            raise AssertionError(f"{name}: the library calls disagree by {lib_err}")

        ms = device_time_ms(
            torch, lambda: paged_decode_attention(q, K, V, table, lens), flush)
        plain_ms = device_time_ms(
            torch, lambda: paged_decode_attention_plain(q, K, V, table, lens), flush)
        library_ms = device_time_ms(torch, library, flush)
        b5_ms = device_time_ms(
            torch, lambda: fused_decode_step(q, kn, vn, Kc, Vc, lens), flush)

        # what the call must move: each row's k/v rows [0, t] (the pages it
        # reads up to its length), q, the output, the table entries it
        # reads and the lengths
        elt = K.element_size()
        rows_read = int(lens.long().sum().item()) + S
        bytes_moved = (elt * (2 * S * Hq * hd + 2 * rows_read * Hkv * hd)
                       + 4 * int(used.sum().item()) + 4 * S)
        ops = 4 * rows_read * Hq * hd
        peak = fig["peak32"] if dtype == torch.float32 else fig["peak16"]
        t_bytes, t_ops = bytes_moved / fig["bw"], ops / peak
        row = dict(shape=name, S=S, Hq=Hq, Hkv=Hkv, hd=hd, P=P, M=M, N=N,
                   dtype=dt, lengths=[int(x) for x in lens.tolist()],
                   max_abs_err=err, atol=atol, rtol=rtol,
                   exact_max_abs_err=exact_err, exact_atol=ex_atol,
                   exact_rtol=ex_rtol, b5_max_abs_diff=b5_err,
                   library_max_abs_err=lib_err,
                   library_calls="index gather of the pages + "
                                 "scaled_dot_product_attention (two calls)",
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   b5_contiguous_ms=b5_ms, bytes=bytes_moved, ops=ops,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit("paged_kernel", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 3c: the BGMV kernel (B6) against its twin
# ---------------------------------------------------------------------------

LORA_SHAPES = [
    # name (the model served with adapters in phase 4c), the projections of
    # that (in D, out O), D, O, dtype; every shape at S 8 rows over a pool of
    # N 4 rows of rank 16, a layer's slice of the stacked (N, L, D, r) pool
    ("llama3_2-1B", "wq,wo", 2048, 2048, "bf16"),
    ("llama3_2-1B", "wk,wv", 2048, 512, "bf16"),
    ("llama3_2-1B", "gate,up", 2048, 8192, "bf16"),
    ("llama3_2-1B", "down", 8192, 2048, "bf16"),
    ("gpt2-124M", "wq,wk,wv,wo", 768, 768, "fp32"),
    ("gpt2-124M", "up", 768, 3072, "fp32"),
    ("gpt2-124M", "down", 3072, 768, "fp32"),
]
LORA_S, LORA_POOL, LORA_RANK = 8, 4, 16
LORA_IDS = [0, 1, 2, -1, 0, 2, 1, -1]
# Bounds per output element, relative to M = |scale| * (|x @ A| @ |B|) in
# fp64 (the magnitude of the second product's terms): the kernel rounds the
# rank-r intermediate to the pool dtype (half a unit, 2^-9 in bf16) and sums
# in fp32 (about sqrt(D) 2^-24 relative, 5e-6 at D 8192). (twin, exact):
# bf16 (2^-7, 2^-8), the twin rounding the same intermediate from its own
# fp32 sum; fp32 (1e-4, 1e-4). Rows with id -1 have M = 0 and must be 0.
# The library path (gathered, two bmm in the pool dtype) also rounds its
# output: 2^-7 of the exact result. The same bounds as test_torch_cuda.py.
BGMV_TOL = {"fp32": (1e-4, 1e-4), "bf16": (2.0 ** -7, 2.0 ** -8)}


def bgmv_magnitude(torch, x, A, B, ids, scales):
    """(fp64 exact B6 result, the magnitude M of the bounds)."""
    idx = ids.long().clamp(0, A.shape[0] - 1)
    xa = torch.bmm(x.double()[:, None], A.double()[idx])
    keep = (ids >= 0).double()[:, None] * scales.double()[idx][:, None]
    return (torch.bmm(xa, B.double()[idx])[:, 0] * keep,
            torch.bmm(xa.abs(), B.double()[idx].abs())[:, 0] * keep.abs())


def _rel_err(torch, out, ref, mag) -> float:
    """max |out - ref| / M over the elements with M > 0; inf where M = 0
    and out differs."""
    diff = (out.double() - ref.double()).abs()
    if bool((diff[mag == 0] > 0).any()):
        return math.inf
    return (diff / mag.clamp_min(1e-300)).max().item()


def phase_lora_kernel(torch, card: dict) -> list:
    """B6 at every projection shape that phase 4c serves, on a pool laid
    out as the registry lays it (a layer's strided slice): within the
    bounds of the twin and of the exact fp64 result; the twin with the ids
    permuted must fail the twin bound. Times of the kernel, the twin and
    the library path (the gathered ``index_select`` + two ``bmm`` in the
    pool dtype, the JAX package's default path) with L2 flushed."""
    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops.decode_step import (
        bgmv_plan,
        lora_bgmv,
        lora_bgmv_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    fig = card["figures"]
    S, N, r = LORA_S, LORA_POOL, LORA_RANK
    ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=dev)
    perm = ids[torch.tensor([1, 2, 3, 4, 5, 6, 7, 0], device=dev)]
    rows = []
    for name, projs, D, O, dt in LORA_SHAPES:
        dtype = DTYPE_MAP[dt]
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
        x = rnd(S, D).to(dtype)
        A = (rnd(N, 2, D, r) / math.sqrt(D)).to(dtype)[:, 1]
        B = rnd(N, 2, r, O).to(dtype)[:, 1]
        sc = torch.rand(N, generator=gen, device=dev) + 0.5

        out = lora_bgmv(x, A, B, ids, sc)
        torch.cuda.synchronize()
        twin = lora_bgmv_plain(x, A, B, ids, sc)
        exact, mag = bgmv_magnitude(torch, x, A, B, ids, sc)
        t_twin, t_exact = BGMV_TOL[dt]
        err = (out - twin).abs().max().item()
        rel_twin = _rel_err(torch, out, twin, mag)
        rel_exact = _rel_err(torch, out, exact, mag)
        if not (rel_twin <= t_twin and rel_exact <= t_exact):
            raise AssertionError(f"{name} {projs}: B6 off its twin by "
                                 f"{rel_twin} M, off the exact result by "
                                 f"{rel_exact} M")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name} {projs}: non-finite B6 output")
        control = _rel_err(torch, lora_bgmv_plain(x, A, B, perm, sc), out, mag)
        if control <= t_twin:
            raise AssertionError(f"{name} {projs}: the bound does not catch "
                                 f"permuted ids ({control} M)")
        # a row alone has the bits it has co-batched (the plan takes no batch)
        for srow in range(S):
            alone = lora_bgmv(x[srow:srow + 1].contiguous(), A, B,
                              ids[srow:srow + 1].contiguous(), sc)
            if not torch.equal(alone[0], out[srow]):
                raise AssertionError(f"{name} {projs}: row {srow} alone is not "
                                     "bit-equal to its output co-batched")

        def library():
            idx = ids.long().clamp(0, N - 1)
            s = torch.where(ids >= 0, sc[idx], 0.0)
            xa = torch.bmm(x[:, None], A.index_select(0, idx))
            return torch.bmm(xa, B.index_select(0, idx))[:, 0] * s[:, None]

        lib_rel = _rel_err(torch, library(), exact, mag)
        if lib_rel > 2.0 ** -7:
            raise AssertionError(f"{name} {projs}: the library path is off "
                                 f"the exact result by {lib_rel} M")
        ms = device_time_ms(torch, lambda: lora_bgmv(x, A, B, ids, sc), flush)
        plain_ms = device_time_ms(
            torch, lambda: lora_bgmv_plain(x, A, B, ids, sc), flush)
        library_ms = device_time_ms(torch, library, flush)

        # what the call must move: the distinct adapters' A and B panes, x,
        # the fp32 output, the ids and the scales; two multiply-adds per
        # pane element for each active row
        elt = x.element_size()
        active = [i for i in LORA_IDS if i >= 0]
        distinct = len(set(active))
        bytes_moved = (elt * (distinct * (D * r + r * O) + S * D) + 4 * S * O
                       + 4 * S + 4 * N)
        ops = 2 * len(active) * (D * r + r * O)
        peak = fig["peak32"] if dtype == torch.float32 else fig["peak16"]
        t_bytes, t_ops = bytes_moved / fig["bw"], ops / peak
        row = dict(shape=name, projections=projs, S=S, N=N, D=D, r=r, O=O,
                   dtype=dt, ids=LORA_IDS, distinct_adapters=distinct,
                   max_abs_err=err, twin_err_over_m=rel_twin,
                   exact_err_over_m=rel_exact, twin_bound=t_twin,
                   exact_bound=t_exact, permuted_ids_err_over_m=control,
                   library_err_over_m=lib_rel, alone_equals_cobatched=True,
                   plan=dict(zip(("Dc", "n_splits", "Ot", "n_tiles"),
                                 bgmv_plan(D, r, O, dtype))),
                   library_calls="index_select x2 + bmm x2 + scale (the "
                                 "gathered path)",
                   out_rms=twin.pow(2).mean().sqrt().item(),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bytes=bytes_moved, ops=ops,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit("lora_kernel", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 5: the flash-attention kernels (B1, B2a, B2b) against their twins
# ---------------------------------------------------------------------------

ATTN_SHAPES = [
    # name, B, Hq, Hkv, T, hd, dtype: the training shape of LLaMA-3.2-1B
    # in bf16 and in fp32 (phase 6) and the reference shapes (phase 7: full
    # width cut to 2 layers, B 1, T 256, fp32 and bf16); GPT-2-124M's
    # training shape in fp16 (phase 6m's fp16 policy: its evaluations run
    # the kernels at p 0)
    ("llama3_2-1B-train", 4, 32, 8, 1024, 64, "bf16"),
    ("llama3_2-1B-train-fp32", 4, 32, 8, 1024, 64, "fp32"),
    ("llama3_2-1B-ref", 1, 32, 8, 256, 64, "fp32"),
    ("llama3_2-1B-ref-bf16", 1, 32, 8, 256, 64, "bf16"),
    ("gpt2-124M-train-fp16", 8, 12, 12, 1024, 64, "fp16"),
]

# max |kernel - ref| / max |ref| per tensor (lse: absolute), against the
# twin and against the exact result (the twin in fp32 on the same inputs):
# fp32 the same arithmetic in another order (1e-5 for out and lse, 5e-5 for
# gradients summed over up to T terms); bf16 2e-2 (P and dS are rounded to 8
# bits before their products, at other places in the kernel and the twin);
# fp16 TWIN_TOL's, the bf16 limit (fp16 rounds the same places to 11 bits).
# The same limits as tests/test_torch_cuda.py.
FLASH_TOL = {"fp32": (1e-5, 5e-5), "bf16": (2e-2, 2e-2), "fp16": TWIN_TOL["fp16"]}


def _flash_err(torch, name: str, a, b) -> float:
    if name == "lse":
        return (a - b).abs().max().item()
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def grouped_dkv_plain(q, k, v, do, lse, delta, rate=0.0, seed=0, **kw):
    """B2b's twin: the per-query-head twin, then the GQA group sum (B2b
    returns dk/dv per kv head, (B, T, Hkv, D)); ``kw`` (``einsum=``) goes to
    the twin."""
    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

    dk, dv = tfa.fused_attention_dkv_plain(q, k, v, do, lse, delta, rate, seed, **kw)
    return tfa.group_sum(dk, k.shape[2]), tfa.group_sum(dv, k.shape[2])


def flash_tf32x1_control(torch, shape: str, run, twin, tols: dict) -> dict:
    """The fp32 gates against a kernel that lost its lo terms: the three
    twins on one TF32 product (``tf32x1_products``) through ``run`` must
    fail the bound of out and of every gradient against the full-fp32
    twin, as they do in tests/test_torch_tf32x3.py."""
    import functools

    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

    ein = tf32x1_products(torch)[1]
    got = run(functools.partial(tfa.fused_attention_fwd_plain, einsum=ein),
              functools.partial(tfa.fused_attention_dq_plain, einsum=ein),
              functools.partial(grouped_dkv_plain, einsum=ein))
    err = {n: _flash_err(torch, n, a, b)
           for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, twin)}
    missed = [n for n in ("out", "dq", "dk", "dv") if err[n] <= tols[n]]
    if missed:
        raise AssertionError(f"{shape}: the fp32 bounds of {missed} do not catch "
                             f"1xTF32 products: {err}")
    return err


def flash_work(B, Hq, Hkv, T, hd, elt) -> dict:
    """(operations, bytes) of each flash kernel: the causal products, each
    input read once and each output written once (dk/dv per kv head)."""
    pairs = B * Hq * T * (T + 1) // 2          # causal (q, k) pairs
    qb, kvb, stat = B * T * Hq * hd * elt, B * T * Hkv * hd * elt, B * Hq * T * 4
    return {"fwd": (4 * hd * pairs, qb + 2 * kvb + qb + stat),
            "dq": (6 * hd * pairs, 2 * qb + 2 * kvb + 2 * stat + qb),
            "dkv": (8 * hd * pairs, 2 * qb + 2 * kvb + 2 * stat + 2 * kvb)}


def sdpa_timings(torch, F, q, k, v, do, rate, flush) -> dict:
    """SDPA's forward, forward+backward and backward alone (autograd.grad
    of one saved forward, retain_graph) on the same inputs: the library
    yardsticks of B1 and of B2a+B2b."""
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    doh = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              dropout_p=rate, enable_gqa=True)

    def sdpa_fwd_bwd():
        sdpa().backward(doh)

    fwd_ms = device_time_ms(torch, lambda: sdpa().detach(), flush)
    fwd_bwd_ms = device_time_ms(torch, sdpa_fwd_bwd, flush)
    saved = sdpa()
    bwd_ms = device_time_ms(torch, lambda: torch.autograd.grad(
        saved, (qh, kh, vh), doh, retain_graph=True), flush)
    out = sdpa().detach().transpose(1, 2)
    del saved
    return dict(sdpa_fwd_ms=fwd_ms, sdpa_fwd_bwd_ms=fwd_bwd_ms, sdpa_bwd_ms=bwd_ms,
                sdpa_out=out)


def sdpa_repeated_kv(torch, F, q, k, v, do, rate, flush) -> dict:
    """SDPA's timings on K and V repeated to the query heads: with more
    query than kv heads in fp32 SDPA has no fused kernel for the GQA call
    and runs its math path, so its memory-efficient kernel (3xTF32 on the
    tensor cores) is timed on repeated K and V as the stricter yardstick."""
    if q.dtype != torch.float32 or q.shape[2] == k.shape[2]:
        return {}
    G = q.shape[2] // k.shape[2]
    lib = sdpa_timings(torch, F, q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2),
                       do, rate, flush)
    del lib["sdpa_out"]
    return {f"sdpa_repeated_kv_{key[5:]}": val for key, val in lib.items()}


def phase_attention(torch, card: dict) -> list:
    import torch.nn.functional as F

    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    fig = card["figures"]
    names = ("out", "lse", "dq", "dk", "dv")
    rows = []
    for shape, B, Hq, Hkv, T, hd, dt in ATTN_SHAPES:
        dtype = DTYPE_MAP[dt]
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        q, k, v = rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd)
        do = rnd(B, T, Hq, hd)

        def run(fwd, dq_fn, dkv_fn, q=q, k=k, v=v, do=do, lse_shift=0.0,
                zero_delta=False):
            out, lse = fwd(q, k, v)
            delta = tfa.attention_delta(out, do)
            if zero_delta:
                delta = torch.zeros_like(delta)
            lse_b = lse + lse_shift
            return (out, lse, dq_fn(q, k, v, do, lse_b, delta)) + tuple(
                dkv_fn(q, k, v, do, lse_b, delta))

        kern = (tfa.flash_attention_fwd, tfa.flash_attention_dq,
                tfa.flash_attention_dkv)
        plain = (tfa.fused_attention_fwd_plain, tfa.fused_attention_dq_plain,
                 grouped_dkv_plain)
        got = run(*kern)
        torch.cuda.synchronize()
        twin = run(*plain)
        f32 = [t.float() for t in (q, k, v, do)]
        exact = run(*plain, *f32)
        tol_out, tol_grad = FLASH_TOL[dt]
        tols = dict(out=tol_out, lse=tol_out, dq=tol_grad, dk=tol_grad, dv=tol_grad)
        err, exact_err, abs_err = {}, {}, {}
        for n, a, b, c in zip(names, got, twin, exact):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{shape}: non-finite kernel {n}")
            err[n], exact_err[n] = _flash_err(torch, n, a, b), _flash_err(torch, n, a, c)
            abs_err[n] = (a.float() - b.float()).abs().max().item()
            if err[n] > tols[n] or exact_err[n] > tols[n]:
                raise AssertionError(f"{shape}: kernel {n} off the twin by "
                                     f"{err[n]} / the exact result by {exact_err[n]}")
        # controls: each bound fails for a deliberately wrong result. out and
        # lse from half-scaled queries (a wrong softmax scale), dq and dk
        # with dS computed without delta, dv with P off by a factor of 2
        wrong_fwd = tfa.fused_attention_fwd_plain(q * 0.5, k, v)
        no_delta = run(*plain, zero_delta=True)
        half_p = run(*plain, lse_shift=0.6931471805599453)
        controls = dict(out=wrong_fwd[0], lse=wrong_fwd[1], dq=no_delta[2],
                        dk=no_delta[3], dv=half_p[4])
        control_err = {n: _flash_err(torch, n, controls[n], twin[i])
                       for i, n in enumerate(names)}
        for n in names:
            if control_err[n] <= tols[n]:
                raise AssertionError(f"{shape}: the {n} bound does not catch "
                                     f"a wrong result ({control_err[n]})")
        if dt == "fp32":
            control_err["tf32x1"] = flash_tf32x1_control(torch, shape, run, twin, tols)
        del twin, exact, no_delta, half_p, controls, wrong_fwd

        out, lse = got[0], got[1]
        delta = tfa.attention_delta(out, do)
        calls = {
            "fwd": (lambda: kern[0](q, k, v), lambda: plain[0](q, k, v)),
            "dq": (lambda: kern[1](q, k, v, do, lse, delta),
                   lambda: plain[1](q, k, v, do, lse, delta)),
            "dkv": (lambda: kern[2](q, k, v, do, lse, delta),
                    lambda: plain[2](q, k, v, do, lse, delta)),
        }
        lib = sdpa_timings(torch, F, q, k, v, do, 0.0, flush)
        sdpa_err = _flash_err(torch, "out", lib.pop("sdpa_out"), out)
        sdpa_ms = lib["sdpa_fwd_ms"]
        lib.update(sdpa_repeated_kv(torch, F, q, k, v, do, 0.0, flush))
        work = flash_work(B, Hq, Hkv, T, hd, q.element_size())
        peak = flash_peak(fig, dt)
        for kname, (kfn, pfn) in calls.items():
            ops, nbytes = work[kname]
            t_bytes, t_ops = nbytes / fig["bw"], ops / peak
            row = dict(shape=shape, kernel=kname, B=B, Hq=Hq, Hkv=Hkv, T=T,
                       hd=hd, dtype=dt, ms=device_time_ms(torch, kfn, flush, runs=15),
                       plain_ms=device_time_ms(torch, pfn, flush, runs=5, warmup=2),
                       library_ms=sdpa_ms if kname == "fwd" else None, **lib,
                       sdpa_max_rel_err=sdpa_err, ops=ops, bytes=nbytes,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=(abs_err["out"] if kname == "fwd" else
                                    abs_err["dq"] if kname == "dq" else
                                    max(abs_err["dk"], abs_err["dv"])),
                       err=err, exact_err=exact_err, control_err=control_err,
                       tol=tols)
            emit("attention_kernel", **row)
            rows.append(row)
        del got
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5b: the flash-attention kernels with attention dropout
# ---------------------------------------------------------------------------

DROPOUT_ATTN_SHAPES = [
    # name, B, Hq, Hkv, T, hd, dtype: GPT-2-124M's training shape in bf16
    # and in fp32, its default dtype (phase 6), and its reference shape
    # (phase 7b: 2 layers, B 1, T 256, fp32); the training shape in fp16
    # (phase 6m's fp16 policy)
    ("gpt2-124M-train", 8, 12, 12, 1024, 64, "bf16"),
    ("gpt2-124M-train-fp32", 8, 12, 12, 1024, 64, "fp32"),
    ("gpt2-124M-ref", 1, 12, 12, 256, 64, "fp32"),
    ("gpt2-124M-train-fp16", 8, 12, 12, 1024, 64, "fp16"),
]
DROP_RATE = 0.1


def dense_dropout_oracle(torch, q, k, v, do, keep, rate):
    """Exact fp32 attention with the dumped keep mask on the softmax
    weights (the same-mask oracle), and its autograd gradients; dk and dv
    per kv head (autograd sums the query heads of each, as B2b does)."""
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    qh, kh, vh = (t.float().transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = (qh @ kh.repeat_interleave(G, 1).transpose(-1, -2)) / D ** 0.5
    s = s.masked_fill(~causal, -1e30)
    lse = torch.logsumexp(s, -1)
    p = torch.softmax(s, -1) * keep / (1.0 - rate)
    out = p @ vh.repeat_interleave(G, 1)
    out.backward(do.float().transpose(1, 2))
    return (out.detach().transpose(1, 2), lse.detach(), qh.grad.transpose(1, 2),
            kh.grad.transpose(1, 2), vh.grad.transpose(1, 2))


def phase_attention_dropout(torch, card: dict) -> list:
    """B1/B2a/B2b with p = 0.1: each against its twin (the same mask) and
    the exact fp32 same-mask oracle at FLASH_TOL; the mask's keep fraction,
    determinism and seed dependence; the twin with the next seed as the
    control that must fail; times beside SDPA with dropout_p = 0.1."""
    import torch.nn.functional as F

    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    fig = card["figures"]
    names = ("out", "lse", "dq", "dk", "dv")
    rows = []
    for shape, B, Hq, Hkv, T, hd, dt in DROPOUT_ATTN_SHAPES:
        dtype = DTYPE_MAP[dt]
        seed = 0x5EED0000ABCD + T
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        q, k, v = rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd)
        do = rnd(B, T, Hq, hd)
        kern = (tfa.flash_attention_fwd, tfa.flash_attention_dq, tfa.flash_attention_dkv)
        plain = (tfa.fused_attention_fwd_plain, tfa.fused_attention_dq_plain,
                 grouped_dkv_plain)

        def run(fwd, dq_fn, dkv_fn, s=seed):
            out, lse = fwd(q, k, v, DROP_RATE, s)
            delta = tfa.attention_delta(out, do)
            return (out, lse, dq_fn(q, k, v, do, lse, delta, DROP_RATE, s)) + tuple(
                dkv_fn(q, k, v, do, lse, delta, DROP_RATE, s))

        got = run(*kern)
        torch.cuda.synchronize()
        twin = run(*plain)
        keep = tfa.keep_mask(seed, B, Hq, T, DROP_RATE, dev)
        causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        keep_fraction = keep[:, :, causal].float().mean().item()
        same = torch.equal(keep, tfa.keep_mask(seed, B, Hq, T, DROP_RATE, dev))
        differ = (keep != tfa.keep_mask(seed + 1, B, Hq, T, DROP_RATE, dev)
                  ).float().mean().item()
        oracle = dense_dropout_oracle(torch, q, k, v, do, keep, DROP_RATE)
        del keep
        tol_out, tol_grad = FLASH_TOL[dt]
        tols = dict(out=tol_out, lse=tol_out, dq=tol_grad, dk=tol_grad, dv=tol_grad)
        err, oracle_err, abs_err = {}, {}, {}
        for n, a, b, c in zip(names, got, twin, oracle):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{shape}: non-finite kernel {n}")
            err[n], oracle_err[n] = _flash_err(torch, n, a, b), _flash_err(torch, n, a, c)
            abs_err[n] = (a.float() - b.float()).abs().max().item()
            if err[n] > tols[n] or oracle_err[n] > tols[n]:
                raise AssertionError(f"{shape}: dropout kernel {n} off the twin by "
                                     f"{err[n]} / the oracle by {oracle_err[n]}")
        if abs(keep_fraction - (1 - DROP_RATE)) > 1e-3 or not same or not 0.1 < differ < 0.3:
            raise AssertionError(f"{shape}: keep fraction {keep_fraction}, same mask "
                                 f"{same}, next seed differs on {differ}")
        control = run(*plain, s=seed + 1)
        control_err = {n: _flash_err(torch, n, control[i], twin[i])
                       for i, n in enumerate(names) if n != "lse"}
        for n, e in control_err.items():
            if e <= tols[n]:
                raise AssertionError(f"{shape}: the {n} bound does not catch the "
                                     f"next seed's mask ({e})")
        if dt == "fp32":
            control_err["tf32x1"] = flash_tf32x1_control(torch, shape, run, twin, tols)
        del twin, oracle, control

        out, lse = got[0], got[1]
        delta = tfa.attention_delta(out, do)
        calls = {
            "fwd": (lambda: kern[0](q, k, v, DROP_RATE, seed),
                    lambda: plain[0](q, k, v, DROP_RATE, seed)),
            "dq": (lambda: kern[1](q, k, v, do, lse, delta, DROP_RATE, seed),
                   lambda: plain[1](q, k, v, do, lse, delta, DROP_RATE, seed)),
            "dkv": (lambda: kern[2](q, k, v, do, lse, delta, DROP_RATE, seed),
                    lambda: plain[2](q, k, v, do, lse, delta, DROP_RATE, seed)),
        }
        lib = sdpa_timings(torch, F, q, k, v, do, DROP_RATE, flush)
        del lib["sdpa_out"]
        sdpa_ms = lib["sdpa_fwd_ms"]
        lib.update(sdpa_repeated_kv(torch, F, q, k, v, do, DROP_RATE, flush))
        work = flash_work(B, Hq, Hkv, T, hd, q.element_size())
        peak = flash_peak(fig, dt)
        for kname, (kfn, pfn) in calls.items():
            ops, nbytes = work[kname]
            t_bytes, t_ops = nbytes / fig["bw"], ops / peak
            row = dict(shape=shape, kernel=kname, B=B, Hq=Hq, Hkv=Hkv, T=T, hd=hd,
                       dtype=dt, rate=DROP_RATE,
                       ms=device_time_ms(torch, kfn, flush, runs=15),
                       plain_ms=device_time_ms(torch, pfn, flush, runs=5, warmup=2),
                       library_ms=sdpa_ms if kname == "fwd" else None, **lib,
                       ops=ops, bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=(abs_err["out"] if kname == "fwd" else
                                    abs_err["dq"] if kname == "dq" else
                                    max(abs_err["dk"], abs_err["dv"])),
                       err=err, oracle_err=oracle_err, control_err=control_err,
                       tol=tols, keep_fraction=keep_fraction, next_seed_differs=differ)
            emit("attention_dropout_kernel", **row)
            rows.append(row)
        del got
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5c: the fused dropout kernel (B3)
# ---------------------------------------------------------------------------

# name (the training run whose launches the row reads), rows, width, dtype
DROPOUT_SHAPES = [("gpt2-124M-train", 8 * 1024, 768, "bf16"),
                  ("gpt2-124M-train-fp32", 8 * 1024, 768, "fp32"),
                  ("gpt2-124M-train-fp16", 8 * 1024, 768, "fp16")]


def phase_dropout(torch, card: dict) -> list:
    """B3 forward (with and without the residual add) and backward at
    (8 x 1024, 768): bit-equal to the twins; p = 0 the identity; the keep
    fraction within 1e-3 of 0.9; the backward of a ones cotangent equal to
    the forward's mask times 1/(1-p). Times beside F.dropout (+ add)."""
    import torch.nn.functional as F

    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import fused_dropout as tfd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    fig = card["figures"]
    rows = []
    for shape, N, D, dt in DROPOUT_SHAPES:
        dtype = DTYPE_MAP[dt]
        seed = 0xD20F0000 + N
        x = torch.randn(N, D, generator=gen, device=dev).to(dtype)
        h = torch.randn(N, D, generator=gen, device=dev).to(dtype)
        calls = {"fwd": (lambda: tfd.dropout_fwd(None, h, seed, DROP_RATE),
                         lambda: tfd.dropout_fwd_plain(None, h, seed, DROP_RATE),
                         lambda: F.dropout(h, DROP_RATE), 2),
                 "fwd_add": (lambda: tfd.dropout_fwd(x, h, seed, DROP_RATE),
                             lambda: tfd.dropout_fwd_plain(x, h, seed, DROP_RATE),
                             lambda: x + F.dropout(h, DROP_RATE), 3),
                 "bwd": (lambda: tfd.dropout_bwd(h, seed, DROP_RATE),
                         lambda: tfd.dropout_bwd_plain(h, seed, DROP_RATE),
                         lambda: F.dropout(h, DROP_RATE), 2)}
        checks = {}
        for name, (kfn, pfn, _, _) in calls.items():
            a = kfn()
            torch.cuda.synchronize()
            b = pfn()
            checks[name] = torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        ones = torch.ones_like(h)
        fwd_mask = tfd.dropout_fwd(None, ones, seed, DROP_RATE)
        bwd_ones = tfd.dropout_bwd(ones, seed, DROP_RATE)
        inv = tfd.inv_keep(DROP_RATE, dtype)
        keep_fraction = (fwd_mask != 0).float().mean().item()
        checks["bwd_ones_is_fwd_mask_times_inv"] = bool(
            torch.equal(bwd_ones, fwd_mask) and torch.all((fwd_mask == 0) | (fwd_mask == inv)))
        checks["rate0_identity"] = torch.equal(tfd.dropout_fwd(None, h, seed, 0.0), h)
        checks["keep_fraction"] = abs(keep_fraction - (1 - DROP_RATE)) <= 1e-3
        if not all(checks.values()):
            raise AssertionError(f"{shape} {dt}: dropout kernel checks {checks}, keep "
                                 f"fraction {keep_fraction}")
        elt = h.element_size()
        for name, (kfn, pfn, lfn, n_tensors) in calls.items():
            nbytes = n_tensors * N * D * elt
            ops = N * D * (2 if name == "fwd_add" else 1)
            peak = fig["peak32"] if dtype == torch.float32 else fig["peak16"]
            t_bytes, t_ops = nbytes / fig["bw"], ops / peak
            row = dict(shape=shape, kernel=name, N=N, D=D, dtype=dt, rate=DROP_RATE,
                       ms=device_time_ms(torch, kfn, flush),
                       plain_ms=device_time_ms(torch, pfn, flush, runs=10),
                       library_ms=device_time_ms(torch, lfn, flush),
                       bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=0.0, bit_equal=checks[name], checks=checks,
                       keep_fraction=keep_fraction)
            emit("dropout_kernel", **row)
            rows.append(row)
        del x, h, ones, fwd_mask, bwd_ones
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5d: the vocab-streamed cross-entropy forward (B4)
# ---------------------------------------------------------------------------

# name (the training run whose launches the row reads: phase 6's B4 run of
# GPT-2-124M in bf16, and at the default dtype, fp32; phase 6m's fp16
# policy run, which takes B4), N, D, V, dtype
XENT_SHAPES = [("gpt2-124M-train", 8 * 1024, 768, 50257, "bf16"),
               ("gpt2-124M-train-fp32", 8 * 1024, 768, 50257, "fp32"),
               ("gpt2-124M-train-fp16", 8 * 1024, 768, 50257, "fp16")]


def phase_xent(torch, card: dict) -> list:
    """B4 at GPT-2-124M's training shape in each of XENT_SHAPES' dtypes."""
    rows = [xent_row(torch, card, *spec) for spec in XENT_SHAPES]
    torch.cuda.empty_cache()
    return rows


def xent_row(torch, card: dict, shape: str, N: int, D: int, V: int, dt: str) -> dict:
    """B4 at one shape and dtype: lse and nll against the twin at the JAX
    kernel test's bounds (lse 1e-5; nll 1e-4 relative, 2e-4 absolute); the
    twin over W padded with unmasked zero columns must fail them. Times
    beside the library call: torch.mm (with an fp32 output for 16-bit
    inputs, in full fp32 for fp32 ones) + logsumexp + gather. The bound
    takes the 16-bit tensor-core rate, or for fp32 a third of the TF32
    rate (3xTF32, as the fp32 flash kernels)."""
    import torch.nn.functional as F

    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf

    dtype = DTYPE_MAP[dt]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9753)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    fig = card["figures"]
    x = torch.randn(N, D, generator=gen, device=dev).to(dtype)
    w = (0.02 * torch.randn(D, V, generator=gen, device=dev)).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device=dev)
    t[0] = V - 1
    nll, lse = txf.xent_fwd(x, w, t)
    torch.cuda.synchronize()
    nll_t, lse_t = txf.xent_fwd_plain(x, w, t)
    ok = (torch.allclose(lse, lse_t, rtol=1e-5, atol=1e-5)
          and torch.allclose(nll, nll_t, rtol=1e-4, atol=2e-4)
          and bool(torch.isfinite(nll).all()))
    vp = -(-V // 512) * 512
    _, lse_c = txf.xent_fwd_plain(x, F.pad(w, (0, vp - V)), t)
    control_fails = not torch.allclose(lse, lse_c, rtol=1e-5, atol=1e-5)
    errs = dict(lse_max_abs=(lse - lse_t).abs().max().item(),
                nll_max_abs=(nll - nll_t).abs().max().item(),
                control_lse_max_abs=(lse_c - lse_t).abs().max().item())
    if not ok or not control_fails:
        raise AssertionError(f"xent kernel: within bounds {ok}, control fails "
                             f"{control_fails}: {errs}")

    def library():
        logits = (torch.mm(x, w) if dtype == torch.float32
                  else torch.mm(x, w, out_dtype=torch.float32))
        lse_l = torch.logsumexp(logits, dim=-1)
        return lse_l - logits.gather(1, t[:, None])[:, 0], lse_l

    lib_nll, _ = library()
    errs["library_nll_max_abs"] = (lib_nll - nll_t).abs().max().item()
    split = xent_split_check(torch, x, t, V, gen) if dtype == torch.float32 else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = txf.f32_plan(N, V, sms) if dtype == torch.float32 else txf.sm90_plan(N, V, sms)
    elt = x.element_size()
    ops = 2 * N * D * V
    nbytes = (N * D + D * V) * elt + N * 8 + 2 * N * 4
    t_bytes, t_ops = nbytes / fig["bw"], ops / flash_peak(fig, dt)
    row = dict(shape=shape, N=N, D=D, V=V, dtype=dt, route=txf.kernel_source(dtype),
               padded_V=plan.get("Vp"), splits=plan["splits"],
               ms=device_time_ms(torch, lambda: txf.xent_fwd(x, w, t), flush, runs=10),
               plain_ms=device_time_ms(torch, lambda: txf.xent_fwd_plain(x, w, t), flush, runs=5, warmup=2),
               library_ms=device_time_ms(torch, library, flush, runs=10),
               ops=ops, bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=max(errs["lse_max_abs"], errs["nll_max_abs"]), **errs)
    if split is not None:
        row["split_check"] = split
    emit("xent_kernel", **row)
    del x, w, nll_t, lse_t, lse_c
    return row


def tf32x1_products(torch):
    """(matmul, einsum) on one TF32 product: the operands rounded to TF32
    (``fused_attention.tf32_split_plain``'s hi) and multiplied in fp32,
    what the tensor cores give for fp32 without the 3xTF32 split (the
    CPU tests' 1xTF32 control)."""
    from building_llm_from_scratch_tpu_torch.ops.fused_attention import (
        tf32_split_plain,
    )

    def hi(a):
        return tf32_split_plain(a)[0]

    return (lambda a, b: hi(a) @ hi(b),
            lambda eq, a, b: torch.einsum(eq, hi(a), hi(b)))


def xent_within(torch, nll, lse, nll_ref, lse_ref) -> bool:
    """The JAX B4 test's bounds: lse 1e-5 (absolute and relative), nll 1e-4
    relative and 2e-4 absolute."""
    return (torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5)
            and torch.allclose(nll, nll_ref, rtol=1e-4, atol=2e-4))


def xent_split_check(torch, x, t, V: int, gen) -> dict:
    """fp32 B4 at the training shape on a head W ~ 0.1 randn (logits with a
    spread of about 2.8, where one TF32 product is visibly off) against the
    full-fp32 twin at the JAX bounds; the twin on 1xTF32 products must fail
    them. At chip_smoke's W ~ 0.02 the bounds cannot tell the two apart."""
    from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf

    w = 0.1 * torch.randn(x.shape[1], V, generator=gen, device=x.device)
    nll, lse = txf.xent_fwd(x, w, t)
    torch.cuda.synchronize()
    nll_t, lse_t = txf.xent_fwd_plain(x, w, t)
    nll_c, lse_c = txf.xent_fwd_plain(x, w, t, matmul=tf32x1_products(torch)[0])
    out = dict(w_scale=0.1, lse_max_abs=(lse - lse_t).abs().max().item(),
               nll_max_abs=(nll - nll_t).abs().max().item(),
               tf32x1_lse_max_abs=(lse_c - lse_t).abs().max().item(),
               tf32x1_nll_max_abs=(nll_c - nll_t).abs().max().item())
    ok, control_fails = (xent_within(torch, nll, lse, nll_t, lse_t),
                         not xent_within(torch, nll_c, lse_c, nll_t, lse_t))
    if not ok or not control_fails:
        raise AssertionError(f"fp32 xent kernel at W ~ 0.1: within bounds {ok}, "
                             f"1xTF32 control fails {control_fails}: {out}")
    del w, nll_t, lse_t, nll_c, lse_c
    return out


# ---------------------------------------------------------------------------
# phase 6: training at full width through the CLI
# ---------------------------------------------------------------------------

TRAIN = dict(model="llama3_2", size="1B", dtype="bf16", batch=4, context=1024,
             steps=20, keep_final=True)
# GPT-2-124M as configured (drop_rate 0.1), the chunked cross entropy its
# width takes; then the same run with the opt-in B4 forward (in both dtypes)
TRAIN_GPT2 = dict(model="GPT2", size="124M", dtype="bf16", batch=8, context=1024,
                  steps=20, xent_run=True)
# fp32, the trainer's default dtype: GPT-2-124M through the CLI without
# --data_type (dtype None), and LLaMA-3.2-1B in fp32 (its flash rows'
# launches)
TRAIN_GPT2_FP32 = dict(model="GPT2", size="124M", dtype=None, batch=8, context=1024,
                       steps=20, xent_run=True)
TRAIN_FP32 = dict(model="llama3_2", size="1B", dtype="fp32", batch=4, context=1024,
                  steps=20)


def dtype_flags(t: dict) -> list:
    """--data_type of a run, none for the default (fp32)."""
    return [] if t["dtype"] is None else ["--data_type", t["dtype"]]


_WORDS = ("the a quick brown fox jumps over lazy dog every effort moves you "
          "closer to mastery of small steps and long roads bring light "
          "water stone river tree wind sings").split()
def write_corpus(path: str, seed: int, n_chars: int) -> None:
    """A seeded text of ``n_chars`` characters: sentences of 4-12 words
    from a small vocabulary (learnable, so the loss can fall)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts, n = [], 0
    while n < n_chars:
        words = rng.choice(_WORDS, int(rng.integers(4, 13)))
        sent = " ".join(words).capitalize() + ". "
        parts.append(sent)
        n += len(sent)
    with open(path, "w") as f:
        f.write("".join(parts)[:n_chars])


def train_flops_per_token(cfg) -> int:
    """Analytic fwd+bwd FLOPs per token, the JAX package's formula
    (obs/mfu.py): 6 x the non-embedding parameters (the head included)
    + 12 x layers x width x context for the attention products."""
    return (6 * cfg.num_params(exclude_embeddings=True)
            + 12 * cfg.n_layers * cfg.emb_dim * cfg.context_length)


def train_profile(torch, trainer, batch, step_ms: float, n_steps: int = 3) -> dict:
    """Device time by kernel over a few steady train steps (torch.profiler),
    run after the main path; the idle share is taken against the
    unprofiled median step. The flash family's share is reported per step,
    and the GQA group sum must not run (B2b sums in the kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

    group_sums = []
    group_sum = tfa.group_sum

    def counted_group_sum(*args, **kwargs):
        group_sums.append(1)
        return group_sum(*args, **kwargs)

    torch.cuda.synchronize()
    tfa.group_sum = counted_group_sum
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
    finally:
        tfa.group_sum = group_sum
    if group_sums:
        raise AssertionError(f"group_sum ran {len(group_sums)} times in {n_steps} "
                             "profiled steps: B2b must sum the GQA heads itself")
    rows = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / n_steps / 1e3
    groups = (("flash_attention", ("attn_fwd", "attn_dq", "attn_dkv")),
              ("gemm", ("nvjet", "gemm", "cutlass")),
              ("elementwise", ("elementwise", "copy", "fill")),
              ("reduction", ("reduce", "norm", "softmax")))
    by_group = {}
    for t_us, key, _ in rows:
        group = next((g for g, pats in groups if any(p in key for p in pats)),
                     "other")
        by_group[group] = by_group.get(group, 0.0) + t_us / n_steps / 1e3
    return dict(steps=n_steps, device_busy_ms_per_step=busy_ms,
                ms_per_step_by_group=by_group,
                flash_ms_per_step=by_group.get("flash_attention", 0.0),
                group_sum_calls=len(group_sums),
                device_idle_share=1.0 - busy_ms / step_ms,
                kernels_per_step=sum(r[2] for r in rows) / n_steps,
                top=[dict(kernel=k[:80], ms_per_step=t / n_steps / 1e3,
                          calls_per_step=c / n_steps) for t, k, c in rows[:16]])


def train_kernels():
    """The counted kernel wrappers a training run can launch, by name."""
    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa
    from building_llm_from_scratch_tpu_torch.ops import fused_dropout as tfd
    from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf

    return dict(fwd=tfa.flash_attention_fwd, dq=tfa.flash_attention_dq,
                dkv=tfa.flash_attention_dkv, dropout_fwd=tfd.dropout_fwd,
                dropout_bwd=tfd.dropout_bwd, xent_fwd=txf.xent_fwd)


def expected_launches(cfg, steps: int, eval_batches: int, xent_kernel: bool,
                      lora: bool = False, grad_accum: int = 1) -> dict:
    """Each kernel's launches in a run: B1 per layer in every train and
    eval step, B2a/B2b per layer in every train step, B3 forward and
    backward once for the embedding and twice per layer in every train step
    of a dropout config, B4 once per train and eval step when it is on. In
    a LoRA run the embedding is frozen, so nothing needs the gradient of
    its dropout's input and that backward does not run. With
    ``grad_accum`` every microbatch is a train step's forward and
    backward. With remat (``cfg.use_actv_ckpt``) the backward recomputes
    each block's forward up to its last saved tensor: B1 and the first
    residual's B3 again, not the second residual's (nothing after it is
    saved)."""
    L, remat = cfg.n_layers, cfg.use_actv_ckpt
    micro = steps * grad_accum
    drops = (1 + 2 * L) * micro if cfg.drop_rate > 0 else 0
    drops_bwd = drops - micro if lora and drops else drops
    if remat and drops:
        drops += L * micro
    return dict(fwd=L * ((2 if remat else 1) * micro + eval_batches),
                dq=L * micro, dkv=L * micro, dropout_fwd=drops,
                dropout_bwd=drops_bwd,
                xent_fwd=(micro + eval_batches) if xent_kernel else 0)


@contextlib.contextmanager
def main_path(torch, xent_kernel: bool):
    """Around one CLI training run: BLLM_XENT_PALLAS set for it, every
    training kernel's launches counted from 0, CUDA events around every
    step (each step's time on the device's clock, idle gaps while the host
    enqueues included; no host sync) and each batch's supervised tokens
    (the sum of its loss weights, when it has them). Yields a dict that is
    filled when the run ends: launches, run_step_ms, step_starts (the host
    clock at each step's call), supervised, wall_s, peak_gb."""
    import building_llm_from_scratch_tpu_torch.training.trainer as ttr

    kernels = train_kernels()
    events, supervised, starts = [], [], []
    make_train_step = ttr.make_train_step

    def timed_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def timed_step(state, batch):
            starts.append(time.perf_counter())
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = step(state, batch)
            pair[1].record()
            events.append(pair)
            if "weights" in batch:
                supervised.append(batch["weights"].sum())
            return out
        return timed_step

    torch.cuda.reset_peak_memory_stats()
    env = os.environ.get("BLLM_XENT_PALLAS")
    os.environ["BLLM_XENT_PALLAS"] = "1" if xent_kernel else "0"
    for f in kernels.values():
        f.launches = 0                              # the main path's count
    ttr.make_train_step = timed_make_train_step
    facts = {}
    t0 = time.perf_counter()
    try:
        yield facts
        torch.cuda.synchronize()
    finally:
        ttr.make_train_step = make_train_step
        if env is None:
            os.environ.pop("BLLM_XENT_PALLAS")
        else:
            os.environ["BLLM_XENT_PALLAS"] = env
    facts.update(wall_s=time.perf_counter() - t0,
                 launches={k: f.launches for k, f in kernels.items()},
                 step_starts=starts,
                 run_step_ms=[a.elapsed_time(b) for a, b in events],
                 supervised=[float(w) for w in supervised],
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)


@contextlib.contextmanager
def final_checkpoint_unwritten():
    """Around a phase 6 / 6s CLI run: the ``final`` train-state checkpoint
    the CLI saves after training is counted (its leaves' bytes) but not
    written. It would write 3x the parameters (18 GB for LLaMA-3.2-1B in
    fp32), and the script keeps its disk writes under 45 GiB; phase 8r
    writes and times final checkpoints."""
    import numpy as np

    import building_llm_from_scratch_tpu_torch.training.trainer as ttr

    save = ttr.Trainer.save_checkpoint

    def counted(self, tag, cursor=None, prune_after=False):
        if tag != "final":
            return save(self, tag, cursor=cursor, prune_after=prune_after)
        tree = ttr.checkpoint_tree(self.state)
        nbytes = sum(v.numel() * v.element_size() if hasattr(v, "numel")
                     else np.asarray(v).nbytes for v in tree.values())
        self.checkpoint_saves.append(dict(tag=tag, step=self.global_step,
                                          bytes=nbytes, leaves=len(tree),
                                          seconds=None, written=False))
        return os.path.join(self.output_dir, f"model_pg_{tag}")

    ttr.Trainer.save_checkpoint = counted
    try:
        yield
    finally:
        ttr.Trainer.save_checkpoint = save


@contextlib.contextmanager
def export_unwritten(write: bool = True):
    """Around a CLI run whose final ``.npz`` export is counted (its leaves'
    bytes, on ``trainer.export_unwritten_bytes``) but not written: phase
    6m's LLaMA runs, whose parameters are checked against phase 6's in
    memory (the disk budget). ``write`` True leaves the export alone."""
    import building_llm_from_scratch_tpu_torch.training.trainer as ttr

    export = ttr.Trainer.export_final

    def counted(self, filename="model_pg_final.npz"):
        self.export_unwritten_bytes = sum(
            v.numel() * v.element_size() for v in self._full_params().values())
        return os.path.join(self.output_dir, filename)

    if not write:
        ttr.Trainer.export_final = counted
    try:
        yield
    finally:
        ttr.Trainer.export_final = export


def final_checkpoint(trainer) -> dict:
    """The run's ``final`` train state, counted by
    ``final_checkpoint_unwritten``. A fresh run must not have resumed (it
    would break the phase's counts)."""
    if trainer.restored is not None:
        raise AssertionError(f"a fresh run resumed from {trainer.restored}")
    save = trainer.checkpoint_saves[-1]
    if save["tag"] != "final":
        raise AssertionError(f"no final checkpoint: {trainer.checkpoint_saves}")
    return dict(bytes_unwritten=save["bytes"], leaves=save["leaves"])


def train_run(torch, t: dict, workdir: str, xent_kernel: bool = False):
    """One ``main.run`` (--mode train) of ``t`` on a seeded corpus sized for
    exactly t["steps"] steps, with each step's device time (CUDA events) and
    every kernel's launches counted from 0 (``main_path``). Returns
    (trainer, facts)."""
    from building_llm_from_scratch_tpu_torch import main as tmain

    data_dir = os.path.join(workdir, "data")
    out_dir = os.path.join(workdir, "out-xent-kernel" if xent_kernel else "out")
    os.makedirs(data_dir, exist_ok=True)
    # the first 90% of the text (+ " <|endoftext|> ", 15 characters) is the
    # train split: W*T + T/2 byte tokens make exactly W = steps x batch
    # windows of T, and the rest the validation batches
    windows = t["steps"] * t["batch"]
    n_chars = int((windows * t["context"] + t["context"] // 2) / 0.9) - 15
    corpus = os.path.join(data_dir, "corpus.txt")
    write_corpus(corpus, seed=11, n_chars=n_chars)
    flags = ["--mode", "train", "--model", t["model"], "--num_params", t["size"],
             *dtype_flags(t), "--byte_tokenizer",
             "--data_dir", data_dir, "--output_dir", out_dir,
             "--n_epochs", "1", "--batch_size", str(t["batch"]),
             "--eval_freq", str(t["steps"]), "--print_sample_iter", str(t["steps"]),
             *t.get("flags", [])]
    with main_path(torch, xent_kernel) as run, final_checkpoint_unwritten(), \
            export_unwritten(t.get("export", True)):
        trainer = tmain.run(flags)
    launches, run_step_ms = run["launches"], run["run_step_ms"]
    final_ckpt = final_checkpoint(trainer)

    cfg, loader = trainer.cfg, trainer.loader
    tr_ds, va_ds = loader.create_datasets_for_file(corpus, cfg.eos_text)
    n_evals = len(trainer.train_losses)
    eval_batches = n_evals * (min(5, loader.num_batches(tr_ds))
                              + min(5, loader.num_batches(va_ds)))
    steps = trainer.global_step
    want = expected_launches(cfg, steps, eval_batches, xent_kernel,
                             grad_accum=trainer.grad_accum)
    losses = [m["loss"] for m in trainer.step_metrics]
    check = dict(steps=steps, evals=n_evals, eval_batches=eval_batches,
                 launches=launches, expected=want)
    if steps != t["steps"] or n_evals != 1 or launches != want or \
            len(run_step_ms) != steps:
        raise AssertionError(f"training run: {check}, {len(run_step_ms)} "
                             "timed steps")
    if len(losses) != steps or not all(map(math.isfinite, losses + trainer.train_losses
                                           + trainer.val_losses)):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the train loss did not fall: {losses}")
    if len(trainer.samples) != 2:
        raise AssertionError(f"expected the warm-up and one sample: {trainer.samples}")
    facts = dict(check, wall_s=run["wall_s"], corpus=corpus, corpus_chars=n_chars,
                 out_dir=out_dir, run_step_ms=run_step_ms, peak_gb=run["peak_gb"],
                 losses=losses, tr_ds=tr_ds, final_ckpt=final_ckpt,
                 step_starts=run["step_starts"],
                 # main.py draws it with matplotlib, or warns that it did not
                 losses_pdf=os.path.exists(os.path.join(out_dir, "losses.pdf")))
    return trainer, facts


def phase_train(torch, card: dict, workdir: str, t: dict) -> dict:
    """Training at full width through the CLI (``train_run``), the export
    loaded back bit for bit and served by the CLI, the run's own rate, then
    steady steps, tokens/s, MFU and a profile over re-runs of one batch.
    For a config whose loss takes the chunked cross entropy, a second run
    of the same steps with B4 on (BLLM_XENT_PALLAS=1) must launch it for
    every train and eval step and give the same step-1 loss to 1e-5."""
    import os

    from building_llm_from_scratch_tpu_torch import main as tmain

    trainer, facts = train_run(torch, t, workdir)
    cfg, loader = trainer.cfg, trainer.loader
    L, losses = cfg.n_layers, facts["losses"]
    final = None
    if t.get("keep_final"):         # phase 6m's remat run is held against it
        final = dict(params={k: v.detach().cpu() for k, v in
                             trainer.model.stacked.items()},
                     losses=losses, train_loss=trainer.train_losses,
                     val_loss=trainer.val_losses, peak_gb=facts["peak_gb"],
                     later_steps_median_ms=statistics.median(
                         facts["run_step_ms"][1:]))
    export = os.path.join(facts["out_dir"], "model_pg_final.npz")
    check_export(torch, trainer, facts["out_dir"])

    # the export served by the CLI (--mode serve --init_params_from)
    req = os.path.join(workdir, "req.jsonl")
    with open(req, "w") as f:
        for text in ("Every ", "effort "):
            ids = trainer.tokenizer.encode(text)
            f.write(json.dumps({"prompt_ids": ids, "max_new_tokens": 8}) + "\n")
    served_out = os.path.join(workdir, "served.jsonl")
    eng = tmain.run(["--mode", "serve", "--model", t["model"], "--num_params",
                     t["size"], *dtype_flags(t), "--init_params_from",
                     export, "--serve_prompts", req, "--serve_out", served_out,
                     "--serve_slots", "2"])
    with open(served_out) as f:
        served = [json.loads(line) for line in f]
    if eng.stats()["requests_finished"] != 2 or any(
            len(r["token_ids"]) != 8 for r in served):
        raise AssertionError(f"serving the export failed: {served}")
    del eng

    # the run's own rate: the trainer's window (every step up to the
    # evaluation, sample time left out), step 1 apart from the rest
    tokens = t["batch"] * t["context"]
    fpt = train_flops_per_token(cfg)
    # MFU against the dense peak of the run's dtype: bf16 on the tensor
    # cores; fp32 on the CUDA cores (its GEMMs run in full fp32, TF32 off)
    dt = t["dtype"] or "fp32"
    peak = card["figures"]["peak32" if dt == "fp32" else "peak16"]
    window_tps = trainer.throughput_tokens_per_s[0]
    run_step_ms = facts["run_step_ms"]
    run_rate = dict(window_tokens_per_s=window_tps,
                    window_ms_per_step=tokens / window_tps * 1e3,
                    window_mfu=window_tps * fpt / peak,
                    run_step_ms=run_step_ms, step1_ms=run_step_ms[0],
                    later_steps_median_ms=statistics.median(run_step_ms[1:]),
                    later_steps_sum_ms=sum(run_step_ms[1:]))

    # timing: steady steps after the main path (not in its counts)
    batch = trainer._device_batch(next(iter(loader.batches(facts["tr_ds"], epoch=1))))
    step_times = []
    for _ in range(8):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t1) * 1e3)
    step_ms = statistics.median(step_times[2:])
    tps = tokens / (step_ms / 1e3)
    prof = train_profile(torch, trainer, batch, step_ms)
    check = {k: facts[k] for k in ("steps", "evals", "eval_batches", "launches",
                                   "expected")}
    result = dict(model=cfg.name, dtype=dt, dtype_flag=t["dtype"], layers=L,
                  emb_dim=cfg.emb_dim,
                  vocab=cfg.vocab_size, drop_rate=cfg.drop_rate, batch=t["batch"],
                  context=t["context"], corpus_chars=facts["corpus_chars"],
                  wall_s=facts["wall_s"], **check,
                  first_loss=losses[0], last_loss=losses[-1], step_losses=losses,
                  train_loss=trainer.train_losses, val_loss=trainer.val_losses,
                  grad_norms=[m["grad_norm"] for m in trainer.step_metrics],
                  lrs=trainer.track_lrs, sample=trainer.samples[-1][:120],
                  served_tokens=[r["token_ids"] for r in served], **run_rate,
                  step_ms=step_ms, step_ms_all=step_times, tokens_per_s=tps,
                  flops_per_token=fpt, mfu=tps * fpt / peak,
                  mfu_basis="flops_per_token = 6 x non-embedding params (head "
                            "included) + 12 x layers x emb_dim x context; "
                            f"peak = {dt} dense ({peak / 1e12:g} TFLOP/s)",
                  peak_memory_gb=facts["peak_gb"], profile=prof,
                  final_checkpoint=facts["final_ckpt"], losses_pdf=facts["losses_pdf"])
    emit("train", **result)
    runs = {"main": facts["launches"], "final": final, "step1_loss": losses[0],
            "pretrain": {k: result[k] for k in (
                "later_steps_median_ms", "step1_ms", "window_tokens_per_s",
                "step_ms", "tokens_per_s", "peak_memory_gb")}}
    del trainer, batch
    torch.cuda.empty_cache()

    if t.get("xent_run"):           # the chunked loss: the B4 run
        trainer, kfacts = train_run(torch, t, workdir, xent_kernel=True)
        first, first_k = losses[0], kfacts["losses"][0]
        agree = abs(first_k - first) <= 1e-5 * abs(first)
        emit("train_xent_kernel", model=cfg.name, steps=kfacts["steps"],
             eval_batches=kfacts["eval_batches"], launches=kfacts["launches"],
             expected=kfacts["expected"], wall_s=kfacts["wall_s"],
             step1_loss=first_k, step1_loss_chunked=first,
             step1_rel_diff=abs(first_k - first) / abs(first),
             last_loss=kfacts["losses"][-1], step_losses=kfacts["losses"],
             later_steps_median_ms=statistics.median(kfacts["run_step_ms"][1:]),
             peak_memory_gb=kfacts["peak_gb"])
        if not agree:
            raise AssertionError(f"B4 run's step-1 loss {first_k} differs from "
                                 f"the chunked run's {first}")
        runs["xent_kernel"] = kfacts["launches"]
        runs["xent_step1_loss"] = first_k
        del trainer
        torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)     # the exports: up to 5 GB a run
    return runs


# ---------------------------------------------------------------------------
# phase 6s: LoRA instruction finetuning at full width through the CLI
# ---------------------------------------------------------------------------

SFT = [
    # LLaMA-3.2-1B in bf16 (the README's SFT model) at the rank of its
    # adapter hand-off; the adapter is written and then served (phase 4c)
    dict(model="llama3_2", size="1B", dtype="bf16", batch=4, context=1024,
         steps=20, rank=16, alpha=32.0, save_adapter=True),
    # GPT-2-124M at the default dtype (fp32) with its dropout 0.1: the
    # chunked cross entropy, then the same steps with B4
    dict(model="GPT2", size="124M", dtype=None, batch=8, context=1024,
         steps=20, rank=16, alpha=32.0, xent_run=True),
]
#: the weights' seed of the SFT runs: the serving CLI's (``serve_cli``), so
#: phase 4c serves the adapter on the base it was trained on
SFT_SEED = 0


def write_alpaca(path: str, n: int) -> None:
    """``n`` Alpaca-format records from ``scripts/build_local_alpaca.py``
    (run as it is, in its own process)."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "build_local_alpaca.py")
    subprocess.run([sys.executable, script, path, str(n)], check=True,
                   capture_output=True)


def same_bits(torch, a, b) -> bool:
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def sft_run(torch, t: dict, workdir: str, xent_kernel: bool = False):
    """One ``main.run --finetune --dataset alpaca --use_lora`` of ``t`` on
    a ``build_local_alpaca.py`` file sized for exactly t["steps"] steps
    (ceil(steps x batch / 0.9) records: the 90% split is steps x batch
    records, the rest two validation batches), counted by ``main_path``.
    Gates: the launches of phase 6's rule at 20 steps and 7 eval batches,
    finite weighted losses, the last under the first, the base bit-equal
    to a fresh build from the seed, every B leaf moved from 0, the merged
    export bit-equal to ``merge_lora`` of the base and the adapter on the
    card, the saved adapter read back by ``load_adapter`` with its rank,
    alpha and fingerprint. Returns (trainer, facts)."""
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.models.lora import (
        adapter_fingerprint,
        flatten_lora,
        load_adapter,
        merge_lora,
    )
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_exported_params,
    )

    data_dir = os.path.join(workdir, "data")
    out_dir = os.path.join(workdir, "out-xent-kernel" if xent_kernel else "out")
    os.makedirs(data_dir, exist_ok=True)
    records = math.ceil(t["steps"] * t["batch"] / 0.9)
    data = os.path.join(data_dir, "alpaca.json")
    write_alpaca(data, records)
    adapter = (os.path.join(workdir, "sft-adapter.npz")
               if t.get("save_adapter") and not xent_kernel else None)
    flags = ["--mode", "train", "--model", t["model"], "--num_params", t["size"],
             *dtype_flags(t), "--byte_tokenizer", "--finetune", "--dataset", "alpaca",
             "--use_lora", "--lora_rank", str(t["rank"]), "--lora_alpha", str(t["alpha"]),
             "--seed", str(SFT_SEED), "--data_dir", data_dir, "--output_dir", out_dir,
             "--n_epochs", "1", "--batch_size", str(t["batch"]),
             "--eval_freq", str(t["steps"]), "--print_sample_iter", str(t["steps"])]
    if adapter:
        flags += ["--save_adapter", adapter]
    with main_path(torch, xent_kernel) as run, final_checkpoint_unwritten():
        trainer = tmain.run(flags)
    final_ckpt = final_checkpoint(trainer)

    cfg, loader = trainer.cfg, trainer.loader
    with open(data) as f:
        tr_ds, va_ds = loader.create_datasets(json.load(f))
    n_evals = len(trainer.train_losses)
    eval_batches = n_evals * (min(5, loader.num_batches(tr_ds))
                              + min(5, loader.num_batches(va_ds)))
    steps = trainer.global_step
    want = expected_launches(cfg, steps, eval_batches, xent_kernel, lora=True)
    losses = [m["loss"] for m in trainer.step_metrics]
    check = dict(records=records, steps=steps, evals=n_evals,
                 eval_batches=eval_batches, launches=run["launches"], expected=want)
    if (steps != t["steps"] or n_evals != 1 or eval_batches != 7
            or run["launches"] != want or len(run["run_step_ms"]) != steps
            or len(run["supervised"]) != steps):
        raise AssertionError(f"SFT run: {check}")
    if len(losses) != steps or not all(map(math.isfinite, losses + trainer.train_losses
                                           + trainer.val_losses)):
        raise AssertionError(f"non-finite or missing SFT losses: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the weighted SFT loss did not fall: {losses}")

    fresh = build_model(cfg, SFT_SEED, "cuda").flat_params()
    moved = [k for k, v in trainer.model.flat_params().items()
             if not same_bits(torch, v, fresh[k])]
    del fresh
    lora = {"/".join(p): leaf.detach() for p, leaf in flatten_lora(trainer.lora_params).items()}
    b_zero = [k for k, v in lora.items() if k.endswith("/B") and not v.any()]
    if moved or b_zero:
        raise AssertionError(f"SFT run: base leaves changed {moved}; B leaves "
                             f"still 0 {b_zero}")
    with torch.no_grad():
        merged = merge_lora(trainer.model.flat_params(), trainer.lora_params,
                            t["alpha"], t["rank"])
    export = load_exported_params(os.path.join(out_dir, "model_pg_final.npz"), cfg,
                                  "cuda").flat_params()
    off = [k for k, v in merged.items() if not same_bits(torch, v, export[k])]
    del merged, export
    if off:
        raise AssertionError(f"merged export differs from merge_lora on the card: {off}")
    if adapter:
        tree, meta = load_adapter(adapter)
        back = {"/".join(p): leaf for p, leaf in flatten_lora(tree).items()}
        if ((meta["rank"], meta["alpha"], meta["fingerprint"])
                != (t["rank"], t["alpha"], adapter_fingerprint(cfg))
                or set(back) != set(lora)
                or not all(same_bits(torch, back[k].cuda(), v) for k, v in lora.items())):
            raise AssertionError(f"the saved adapter does not read back: {meta}")
    facts = dict(check, losses=losses, adapter=adapter, wall_s=run["wall_s"],
                 final_ckpt=final_ckpt,
                 run_step_ms=run["run_step_ms"], supervised=run["supervised"],
                 peak_gb=run["peak_gb"], tr_ds=tr_ds)
    return trainer, facts


def phase_sft(torch, card: dict, workdir: str, t: dict, pretrain: dict) -> dict:
    """LoRA SFT at full width through the CLI (``sft_run``): the step time
    (CUDA events, step 1 apart), tokens/s and supervised tokens/s (the
    weights' sum) of the run, its peak memory and a profile over re-runs of
    one batch, beside the same model's pretraining step from phase 6 of
    this run (``pretrain``). With the chunked loss, the same steps again
    with B4 on: B4 = steps + eval batches, step-1 loss within 1e-5."""
    trainer, facts = sft_run(torch, t, workdir)
    cfg, losses = trainer.cfg, facts["losses"]
    ms = facts["run_step_ms"]
    later = sum(ms[1:]) / 1e3
    tokens = t["batch"] * t["context"]
    batch = trainer._device_batch(next(iter(trainer.loader.batches(facts["tr_ds"],
                                                                    epoch=1))))
    step_ms = statistics.median(ms[1:])
    result = dict(card=card["card_line"], model=cfg.name, dtype=t["dtype"] or "fp32",
                  layers=cfg.n_layers, rank=t["rank"], alpha=t["alpha"], batch=t["batch"],
                  context=t["context"], drop_rate=cfg.drop_rate,
                  records=facts["records"], steps=facts["steps"],
                  eval_batches=facts["eval_batches"], launches=facts["launches"],
                  expected=facts["expected"], wall_s=facts["wall_s"],
                  first_loss=losses[0], last_loss=losses[-1], step_losses=losses,
                  train_loss=trainer.train_losses, val_loss=trainer.val_losses,
                  lrs=trainer.track_lrs, sample=trainer.samples[-1][-120:],
                  run_step_ms=ms, step1_ms=ms[0], later_steps_median_ms=step_ms,
                  tokens_per_s=tokens * (len(ms) - 1) / later,
                  supervised_per_step=facts["supervised"],
                  supervised_tokens_per_s=sum(facts["supervised"][1:]) / later,
                  peak_memory_gb=facts["peak_gb"],
                  trainable_params=sum(p.numel() for p in trainer.state.params.values()),
                  pretrain=pretrain,
                  step_ratio_to_pretrain=step_ms / pretrain["later_steps_median_ms"],
                  profile=train_profile(torch, trainer, batch, step_ms),
                  adapter=facts["adapter"], final_checkpoint=facts["final_ckpt"])
    emit("sft", **result)
    runs = {"main": facts["launches"], "adapter": facts["adapter"], "step_ms": step_ms}
    del trainer, batch
    torch.cuda.empty_cache()
    if t.get("xent_run"):
        trainer, kfacts = sft_run(torch, t, workdir, xent_kernel=True)
        first, first_k = losses[0], kfacts["losses"][0]
        emit("sft_xent_kernel", model=cfg.name, steps=kfacts["steps"],
             eval_batches=kfacts["eval_batches"], launches=kfacts["launches"],
             expected=kfacts["expected"], wall_s=kfacts["wall_s"],
             step1_loss=first_k, step1_loss_chunked=first,
             step1_rel_diff=abs(first_k - first) / abs(first),
             last_loss=kfacts["losses"][-1], step_losses=kfacts["losses"],
             later_steps_median_ms=statistics.median(kfacts["run_step_ms"][1:]),
             peak_memory_gb=kfacts["peak_gb"])
        if abs(first_k - first) > 1e-5 * abs(first):
            raise AssertionError(f"the B4 SFT run's step-1 loss {first_k} differs "
                                 f"from the chunked run's {first}")
        runs["xent_kernel"] = kfacts["launches"]
        del trainer
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 7s: one LoRA SFT step on the card against the CPU
# ---------------------------------------------------------------------------

SFT_REFERENCES = [dict(model="llama3_2", size="1B"), dict(model="GPT2", size="124M")]


def phase_sft_reference(torch, spec: dict, workdir: str) -> dict:
    """The model of ``spec`` at full width cut to 2 layers, B 1, T 256, in
    fp32 and in bf16, with a rank-16 adapter (B drawn nonzero, so that A
    has gradients) on one Alpaca record collated as the loader does (the
    prompt masked, the eos supervised, pads masked): the same LoRA step
    (same weights, adapter, batch and dropout seed) on the card and on the
    CPU, the loss and every adapter gradient within REF_BOUNDS. Control:
    the CPU step with every loss weight 1 must fail the loss bound."""
    import building_llm_from_scratch_tpu_torch.models.transformer as ttf
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.data.instruct import (
        InstructionDataset,
        collate_batch,
    )
    from building_llm_from_scratch_tpu_torch.data.tokenizers import ByteTokenizer
    from building_llm_from_scratch_tpu_torch.models.lora import (
        flatten_lora,
        init_lora_params,
        unflatten_lora,
    )
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    data = os.path.join(workdir, "ref-alpaca.json")
    write_alpaca(data, 1)
    with open(data) as f:
        records = json.load(f)
    kernels = train_kernels()
    results = {}
    for dtype in ("fp32", "bf16"):
        t0 = time.perf_counter()
        cfg = get_config(spec["model"], spec["size"], dtype=dtype,
                         target_context_length=256).replace(n_layers=2)
        card_model = ttf.build_model(cfg, seed=3, device="cuda")
        cpu_flat = {k: v.cpu().clone() for k, v in card_model.flat_params().items()}
        gen = torch.Generator().manual_seed(5)
        lora = flatten_lora(init_lora_params(cfg, gen, 16))
        for path, leaf in lora.items():
            if path[-1] == "B":
                leaf.copy_((0.02 * torch.randn(leaf.shape, generator=gen)).to(leaf.dtype))
        ds = InstructionDataset(records, ByteTokenizer())
        inputs, targets, weights = (torch.from_numpy(a) for a in collate_batch(
            [ds[0]], pad_token_id=cfg.eos_id, allowed_max_length=256))

        def one_step(model, w, seed=REF_SEED):
            dev = model.device
            tree = unflatten_lora({p: v.to(dev).clone() for p, v in lora.items()})
            opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 10, 100),
                             grad_clip_norm=float("inf"))   # keep the raw gradients
            state = tts.init_train_state(tree, opt, seed=seed, frozen=model)
            batch = {"inputs": inputs.long().to(dev), "targets": targets.long().to(dev),
                     "weights": w.to(dev)}
            _, m = tts.make_train_step(cfg, opt, lora_alpha=32.0, lora_rank=16)(state, batch)
            return m["loss"].item(), {k: g.cpu().float() for k, g in state.grads.items()}

        for f in kernels.values():
            f.launches = 0
        card_loss, card_grads = one_step(card_model, weights)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in kernels.items()}
        del card_model
        torch.cuda.empty_cache()
        t_cpu = time.perf_counter()
        cpu_loss, cpu_grads = one_step(ttf.Transformer(cfg, cpu_flat), weights)
        cpu_s = time.perf_counter() - t_cpu
        ctl_loss, ctl_grads = one_step(ttf.Transformer(cfg, cpu_flat),
                                       torch.ones_like(weights))

        def rel_l2(a, b):
            return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

        card = {k: rel_l2(card_grads[k], cpu_grads[k]) for k in cpu_grads}
        loss_bound, grad_bound = REF_BOUNDS[dtype]
        want = expected_launches(cfg, 1, 0, False, lora=True)
        result = dict(model=cfg.name, layers=2, dtype=dtype, B=1, T=256, rank=16,
                      drop_rate=cfg.drop_rate, supervised=float(weights.sum()),
                      launches=launches, expected=want, card_loss=card_loss,
                      cpu_loss=cpu_loss, loss_rel=abs(card_loss - cpu_loss) / abs(cpu_loss),
                      ones_weights_loss=ctl_loss,
                      ones_weights_loss_rel=abs(ctl_loss - cpu_loss) / abs(cpu_loss),
                      ones_weights_grad_rel_l2_max=max(
                          rel_l2(ctl_grads[k], cpu_grads[k]) for k in cpu_grads),
                      grad_rel_l2=card, bound=dict(grad_rel_l2=grad_bound,
                                                   loss_rel=loss_bound),
                      cpu_step_s=cpu_s, seconds=time.perf_counter() - t0)
        emit("sft_reference", **result)
        if launches != want:
            raise AssertionError(f"{cfg.name} {dtype} SFT reference step launches "
                                 f"{launches}, expected {want}")
        if result["loss_rel"] > loss_bound or max(card.values()) > grad_bound:
            raise AssertionError(f"{dtype} card SFT step off the CPU step: {result}")
        if result["ones_weights_loss_rel"] <= loss_bound:
            raise AssertionError(f"{cfg.name} {dtype}: the loss bound does not catch "
                                 f"all-ones loss weights: {result}")
        results[dtype] = result
    return results


# ---------------------------------------------------------------------------
# phase 7: one training step on the card against the CPU
# ---------------------------------------------------------------------------

# (relative error of the loss, relative L2 error of every leaf's gradient)
# of the card's step against the CPU's: fp32 is the same arithmetic in
# another order; in bf16 both devices round every operation to 8 bits, but
# GEMM sums and the flash kernel round at other places than the CPU's
# GEMMs and the twin (the port against the JAX package on the CPU, at a
# small size, measures about 1e-2: tests/test_torch_training.py); fp16
# (phase 7m) rounds at the same places to 11 bits, 8x finer than bf16:
# bf16's loss bound, a third of its gradient bound
REF_BOUNDS = {"fp32": (1e-5, 1e-4), "bf16": (1e-3, 3e-2), "fp16": (1e-3, 1e-2)}


REFERENCES = [
    # LLaMA-3.2-1B (no dropout; control: no attention) and GPT-2-124M with
    # its dropout 0.1 (both devices draw the same masks; control: another
    # dropout seed on the CPU side), each cut to 2 layers, B 1, T 256
    dict(model="llama3_2", size="1B", control="no_attention"),
    dict(model="GPT2", size="124M", control="other_seed"),
]
REF_SEED = 424242


def phase_train_reference(torch, spec: dict) -> dict:
    """The model of ``spec`` at full width cut to 2 layers, B 1, T 256, in
    fp32 and in bf16: the same step (same weights, batch and dropout seed)
    on the card (the kernels) and on the CPU (the twins). The control run
    on the CPU must fall outside the bounds it is named for: without
    attention the gradient bound of wq/wk/wv; with another dropout seed
    the gradient bound, and in fp32 the loss bound too."""
    import building_llm_from_scratch_tpu_torch.models.transformer as ttf
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    kernels = train_kernels()
    results = {}
    for dtype in ("fp32", "bf16"):
        t0 = time.perf_counter()
        cfg = get_config(spec["model"], spec["size"], dtype=dtype,
                         target_context_length=256).replace(n_layers=2)
        card_model = ttf.build_model(cfg, seed=3, device="cuda")
        cpu_flat = {k: v.cpu().clone() for k, v in card_model.flat_params().items()}
        gen = torch.Generator().manual_seed(5)
        x = torch.randint(0, cfg.vocab_size, (1, 257), generator=gen)

        def one_step(model, seed=REF_SEED):
            dev = model.device
            opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 10, 100),
                             grad_clip_norm=float("inf"))   # keep the raw gradients
            state = tts.init_train_state(model, opt, seed=seed)
            batch = {"inputs": x[:, :-1].to(dev), "targets": x[:, 1:].to(dev)}
            _, m = tts.make_train_step(cfg, opt)(state, batch)
            return m["loss"].item(), {k: g.cpu().float() for k, g in state.grads.items()}

        for f in kernels.values():
            f.launches = 0
        card_loss, card_grads = one_step(card_model)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in kernels.items()}
        del card_model
        torch.cuda.empty_cache()
        t_cpu = time.perf_counter()
        cpu_loss, cpu_grads = one_step(
            ttf.Transformer(cfg, {k: v.clone() for k, v in cpu_flat.items()}))
        cpu_s = time.perf_counter() - t_cpu
        if spec["control"] == "no_attention":
            attention = ttf.causal_attention
            ttf.causal_attention = lambda q, k, v, **kw: torch.zeros_like(q)
            try:
                ctl_loss, ctl_grads = one_step(ttf.Transformer(cfg, cpu_flat))
            finally:
                ttf.causal_attention = attention
        else:
            ctl_loss, ctl_grads = one_step(ttf.Transformer(cfg, cpu_flat),
                                           seed=REF_SEED + 1)

        def rel_l2(a, b):
            return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

        card = {k: rel_l2(card_grads[k], cpu_grads[k]) for k in cpu_grads}
        control = {k: rel_l2(ctl_grads[k], cpu_grads[k]) for k in cpu_grads}
        loss_bound, grad_bound = REF_BOUNDS[dtype]
        want = expected_launches(cfg, 1, 0, False)
        result = dict(model=cfg.name, layers=2, dtype=dtype, B=1, T=256,
                      drop_rate=cfg.drop_rate, launches=launches, expected=want,
                      card_loss=card_loss, cpu_loss=cpu_loss,
                      control=spec["control"], control_loss=ctl_loss,
                      loss_rel=abs(card_loss - cpu_loss) / abs(cpu_loss),
                      control_loss_rel=abs(ctl_loss - cpu_loss) / abs(cpu_loss),
                      grad_rel_l2=card, control_rel_l2=control,
                      bound=dict(grad_rel_l2=grad_bound, loss_rel=loss_bound),
                      cpu_step_s=cpu_s, seconds=time.perf_counter() - t0)
        emit("train_reference", **result)
        if launches != want:
            raise AssertionError(f"{cfg.name} {dtype} reference step launches "
                                 f"{launches}, expected {want}")
        if result["loss_rel"] > loss_bound or max(card.values()) > grad_bound:
            raise AssertionError(f"{dtype} card step off the CPU step: {result}")
        if spec["control"] == "no_attention":
            caught = max(control[k] for k in ("blocks/attn/wq", "blocks/attn/wk",
                                              "blocks/attn/wv")) > grad_bound
        else:
            # another seed's masks move the mean loss of these 256 tokens by
            # about 1e-3 relative (7.2e-4 and 7.6e-4 measured on an H100),
            # inside bf16's loss bound: there the gradient bound, which
            # every leaf fails, is what tells the masks apart
            caught = (max(control.values()) > grad_bound
                      and (dtype == "bf16" or result["control_loss_rel"] > loss_bound))
        if not caught:
            raise AssertionError(f"{cfg.name} {dtype}: the bounds do not catch "
                                 f"the control ({spec['control']}): {result}")
        results[dtype] = result
    return results


# ---------------------------------------------------------------------------
# phase 6m: precision policies, accumulation and remat through the CLI
# ---------------------------------------------------------------------------

#: GPT-2-124M (B 8 x T 1024, p 0.1, fp32 masters) under the bf16 and the
#: fp16 policy and with two microbatches in fp32, the last two with B4 on
#: (its fp16 route, and the sums loss); LLaMA-3.2-1B bf16 (B 4 x T 1024)
#: with remat, held bit for bit against phase 6's run, and with remat and
#: two microbatches of 4. ``compute``: the dtype of the MFU's peak;
#: ``shape``: the kernel rows whose ``launches_6m`` the run gives;
#: ``export`` False: the export is counted, not written (the disk budget:
#: the LLaMA runs' 3 GB each; the remat run's parameters are compared in
#: memory).
MIXED = [
    dict(label="gpt2-bf16-policy", model="GPT2", size="124M", dtype=None, batch=8,
         context=1024, steps=20, flags=["--mixed_precision", "bf16"],
         compute="bf16", shape="gpt2-124M-train"),
    dict(label="gpt2-fp16-policy", model="GPT2", size="124M", dtype=None, batch=8,
         context=1024, steps=20, flags=["--mixed_precision", "fp16"],
         compute="fp16", xent_kernel=True, shape="gpt2-124M-train-fp16"),
    dict(label="gpt2-fp32-accum2", model="GPT2", size="124M", dtype=None, batch=8,
         context=1024, steps=20, flags=["--grad_accum", "2"], compute="fp32",
         xent_kernel=True, shape="gpt2-124M-train-fp32"),
    dict(label="llama-bf16-remat", model="llama3_2", size="1B", dtype="bf16",
         batch=4, context=1024, steps=20, flags=["--use_actv_ckpt"],
         compute="bf16", export=False, shape="llama3_2-1B-train"),
    dict(label="llama-bf16-remat-accum2", model="llama3_2", size="1B", dtype="bf16",
         batch=8, context=1024, steps=20,
         flags=["--use_actv_ckpt", "--grad_accum", "2"], compute="bf16",
         export=False, shape="llama3_2-1B-train"),
]


def check_export(torch, trainer, out_dir: str) -> None:
    """The run's ``model_pg_final.npz`` loads back bit for bit."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_exported_params,
    )

    back = load_exported_params(os.path.join(out_dir, "model_pg_final.npz"),
                                trainer.cfg, "cuda")
    for key, leaf in trainer.model.stacked.items():
        if not same_bits(torch, leaf.detach(), back.stacked[key]):
            raise AssertionError(f"export leaf {key} does not load back bit for bit")
    del back


def run_rates(card: dict, t: dict, trainer, facts: dict) -> dict:
    """Step 1 and the median later step (CUDA events around each CLI step),
    tokens/s and MFU against the dense peak of the run's compute dtype."""
    tokens = t["batch"] * t["context"]
    step_ms = statistics.median(facts["run_step_ms"][1:])
    fpt = train_flops_per_token(trainer.cfg)
    peak = card["figures"]["peak32" if t["compute"] == "fp32" else "peak16"]
    tps = tokens / (step_ms / 1e3)
    return dict(step1_ms=facts["run_step_ms"][0], step_ms=step_ms,
                tokens_per_s=tps, mfu=tps * fpt / peak,
                mfu_basis=f"peak = {t['compute']} dense ({peak / 1e12:g} TFLOP/s)",
                peak_memory_gb=facts["peak_gb"])


def accum_full_batch_check(torch) -> dict:
    """GPT-2-124M fp32 at full width and depth, B 8 x T 1024, dropout 0
    (two microbatches draw their own masks, so with p 0.1 no step of the
    CLI run can equal the full batch's): one step with two microbatches
    and one without, from the same weights and batch; the step-1 loss
    within 1e-5 relative and every gradient within 1e-4 relative L2."""
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    cfg = get_config("GPT2", "124M").replace(drop_rate=0.0)
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randint(0, cfg.vocab_size, (8, 1025), generator=gen, device="cuda")
    batch = {"inputs": x[:, :-1], "targets": x[:, 1:]}
    out = {}
    for accum in (1, 2):
        model = build_model(cfg, 7, "cuda")
        opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 10, 100),
                         grad_clip_norm=float("inf"))   # keep the raw gradients
        state = tts.init_train_state(model, opt, seed=1)
        _, m = tts.make_train_step(cfg, opt, grad_accum=accum)(state, batch)
        out[accum] = (m["loss"].item(), {k: g.clone() for k, g in state.grads.items()})
        del model, state, opt
    (l1, g1), (l2, g2) = out[1], out[2]
    grad_rel = max(((g2[k] - g1[k]).norm() / g1[k].norm()).item() for k in g1)
    result = dict(loss_full=l1, loss_accum2=l2, loss_rel=abs(l2 - l1) / abs(l1),
                  grad_rel_l2_max=grad_rel, bound=dict(loss_rel=1e-5, grad_rel_l2=1e-4))
    if result["loss_rel"] > 1e-5 or grad_rel > 1e-4:
        raise AssertionError(f"--grad_accum 2 off the full batch: {result}")
    del out, g1, g2
    torch.cuda.empty_cache()
    return result


def phase_mixed(torch, card: dict, workdir: str, base: dict) -> dict:
    """Phase 6m: the ``MIXED`` runs through the CLI (``train_run``: exact
    launch counts, finite losses that fall), each export loaded back bit
    for bit; the policies' masters stay fp32, the fp16 run prints its
    skipped steps and loss-scale trace; the remat run's per-step losses,
    evaluations and final parameters equal phase 6's LLaMA run's bit for
    bit (``base["llama"]``); the accumulation's full-batch check
    (``accum_full_batch_check``). Step ms, tokens/s, MFU and peak memory."""
    results = {}
    for t in MIXED:
        trainer, facts = train_run(torch, t, os.path.join(workdir, t["label"]),
                                   xent_kernel=t.get("xent_kernel", False))
        cfg, metrics = trainer.cfg, trainer.step_metrics
        masters = {str(v.dtype) for v in trainer.model.stacked.values()}
        extra = {}
        if t.get("export", True):
            check_export(torch, trainer, facts["out_dir"])
        else:
            extra["export_bytes_unwritten"] = trainer.export_unwritten_bytes
        if trainer.policy is not None:
            if masters != {"torch.float32"} or trainer.policy.name != t["compute"]:
                raise AssertionError(f"{t['label']}: policy {trainer.policy}, "
                                     f"masters {masters}")
        if t["compute"] == "fp16":
            extra.update(skipped=[m["skipped"] for m in metrics],
                         loss_scale=[m["loss_scale"] for m in metrics])
            print(f"{t['label']}: skipped steps {sum(extra['skipped'])} of "
                  f"{len(metrics)}, loss scale {extra['loss_scale']}", flush=True)
        if trainer.grad_accum > 1 and t["model"] == "GPT2":
            extra["full_batch_check"] = accum_full_batch_check(torch)
            ref = base["gpt2_fp32"]["xent_step1_loss"]
            extra["step1_loss_vs_phase6_b4_rel"] = abs(facts["losses"][0] - ref) / ref
        if cfg.use_actv_ckpt and trainer.grad_accum == 1:
            ref = base["llama"]["final"]
            same = dict(losses=facts["losses"] == ref["losses"],
                        evals=(trainer.train_losses == ref["train_loss"]
                               and trainer.val_losses == ref["val_loss"]),
                        params=all(same_bits(torch, v.detach().cpu(), ref["params"][k])
                                   for k, v in trainer.model.stacked.items()))
            extra.update(bit_equal_to_phase6=same,
                         phase6_peak_memory_gb=ref["peak_gb"],
                         phase6_later_steps_median_ms=ref["later_steps_median_ms"])
            if not all(same.values()):
                raise AssertionError(f"{t['label']}: not bit-equal to phase 6's run: "
                                     f"{same}")
        summary = dict(label=t["label"], model=cfg.name, flags=t["flags"],
                       policy=trainer.policy and trainer.policy.name,
                       masters=sorted(masters), grad_accum=trainer.grad_accum,
                       remat=cfg.use_actv_ckpt, batch=t["batch"], context=t["context"],
                       xent_kernel=t.get("xent_kernel", False),
                       **{k: facts[k] for k in ("steps", "evals", "eval_batches",
                                                "launches", "expected", "wall_s")},
                       **run_rates(card, t, trainer, facts),
                       first_loss=facts["losses"][0], last_loss=facts["losses"][-1],
                       step_losses=facts["losses"], train_loss=trainer.train_losses,
                       val_loss=trainer.val_losses,
                       final_checkpoint=facts["final_ckpt"],
                       losses_pdf=facts["losses_pdf"], **extra)
        emit("train_mixed", **summary)
        if not facts["losses_pdf"]:
            print(f"{t['label']}: losses.pdf not drawn (matplotlib is not "
                  "installed)", flush=True)
        results[t["label"]] = dict(launches=facts["launches"], shape=t["shape"],
                                   step_ms=summary["step_ms"],
                                   peak_memory_gb=summary["peak_memory_gb"])
        del trainer
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(workdir, t["label"]), ignore_errors=True)
    base["llama"]["final"] = None                   # the host copy can go
    return results


# ---------------------------------------------------------------------------
# phase 6h: host overlap (prefetch and asynchronous checkpoints)
# ---------------------------------------------------------------------------

#: GPT-2-124M bf16 (B 8 x T 1024, p 0.1), 20 steps, a checkpoint every 10
#: steps with one kept; run synchronously, then with the overlap on
HOST = dict(model="GPT2", size="124M", dtype="bf16", batch=8, context=1024,
            steps=20, export=False)
HOST_RUNS = [("sync", ["--prefetch", "0", "--async_ckpt", "off"]),
             ("overlap", ["--prefetch", "2", "--async_ckpt", "on"])]
HOST_SAVES = ["--save_ckpt_freq", "10", "--keep_ckpts", "1"]
#: the profiled steps (1-based calls, the last one excluded): clear of the
#: save at step 10 and of the steady steps 2-9 the step time is read from
HOST_PROFILE = (12, 16)


@contextlib.contextmanager
def profile_window(torch, first: int, last: int):
    """Profile the device over calls ``first`` .. ``last - 1`` of the CLI
    run's train step, between two synchronisations. Yields a dict filled
    with the window's wall ms, the device's busy ms (the CUDA events' self
    time: kernels and copies) and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    import building_llm_from_scratch_tpu_torch.training.trainer as ttr

    make = ttr.make_train_step
    out: dict = {}

    def hooked(*args, **kwargs):
        inner = make(*args, **kwargs)
        calls = [0]

        def step_fn(state, batch):
            calls[0] += 1
            if calls[0] == first:
                torch.cuda.synchronize()
                out["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
                out["prof"].__enter__()
                out["t0"] = time.perf_counter()
            elif calls[0] == last:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - out.pop("t0")) * 1e3
                prof = out.pop("prof")
                prof.__exit__(None, None, None)
                busy_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                              if str(ev.device_type).endswith("CUDA"))
                out.update(steps=last - first, wall_ms=wall_ms,
                           busy_ms=busy_us / 1e3,
                           idle_share=1.0 - busy_us / 1e3 / wall_ms)
            return inner(state, batch)
        return step_fn

    ttr.make_train_step = hooked
    try:
        yield out
    finally:
        ttr.make_train_step = make


def _manifest_leaves(path: str) -> list:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["leaves"]


def phase_host_overlap(torch, workdir: str) -> dict:
    """Phase 6h: ``HOST`` through the CLI synchronously (``--prefetch 0
    --async_ckpt off``), then overlapped (``--prefetch 2 --async_ckpt on``):
    per-step losses and evaluations bit-equal; in each run step 10's
    checkpoint was pruned on step 20's commit (``--keep_ckpts 1``) and step
    20's validates; the two step-20 checkpoints are the same leaf for leaf
    (bytes and sha256 of every shard). Reported: the save step's stall on
    the host clock (step 10's call to step 11's, beside the median such
    gap of steps 2-9), the synchronous save's seconds against the
    snapshot's, the write's and its overlap, the steady step (CUDA events,
    steps 2-9), the device's idle share over ``HOST_PROFILE``'s steps, and
    the prefetch stalls. ``final`` states are counted, not written."""
    from building_llm_from_scratch_tpu_torch.training.resilience import (
        validate_checkpoint,
    )

    runs = {}
    for name, flags in HOST_RUNS:
        t = dict(HOST, flags=flags + HOST_SAVES)
        with profile_window(torch, *HOST_PROFILE) as window:
            trainer, facts = train_run(torch, t, os.path.join(workdir, name))
        out_dir = facts["out_dir"]
        kept = sorted(n for n in os.listdir(out_dir) if n.startswith("model_pg_"))
        if kept != ["model_pg_20"] or validate_checkpoint(
                os.path.join(out_dir, "model_pg_20")) is not None:
            raise AssertionError(f"6h {name}: checkpoints {kept}")
        gaps = [(b - a) * 1e3 for a, b in zip(facts["step_starts"],
                                               facts["step_starts"][1:])]
        saves = [s for s in trainer.checkpoint_saves if s["tag"] != "final"]
        runs[name] = dict(
            flags=t["flags"], launches=facts["launches"], losses=facts["losses"],
            evals=(trainer.train_losses, trainer.val_losses),
            leaves=_manifest_leaves(os.path.join(out_dir, "model_pg_20")),
            report=dict(
                run=name, flags=t["flags"], wall_s=facts["wall_s"],
                save_step_gap_ms=gaps[9], steady_gap_ms=statistics.median(gaps[1:9]),
                steady_step_ms=statistics.median(facts["run_step_ms"][1:9]),
                saves=[{k: s.get(k) for k in ("tag", "bytes", "seconds", "snapshot_s",
                                              "write_s", "overlap_s")} for s in saves],
                profile_window=dict(window, first_step=HOST_PROFILE[0]),
                prefetch_stall_total=trainer.prefetch_stall_total,
                window_logs=trainer.window_logs, peak_memory_gb=facts["peak_gb"],
                final_checkpoint=facts["final_ckpt"]))
        emit("host_overlap", **runs[name]["report"])
        del trainer
        torch.cuda.empty_cache()
    sync, overlap = runs["sync"], runs["overlap"]
    same = dict(losses=sync["losses"] == overlap["losses"],
                evals=sync["evals"] == overlap["evals"],
                checkpoint=sync["leaves"] == overlap["leaves"])
    emit("host_overlap_compare", bit_equal=same,
         save_stall_ms=dict(sync=sync["report"]["save_step_gap_ms"],
                            overlap=overlap["report"]["save_step_gap_ms"]),
         steady_step_ms=dict(prefetch0=sync["report"]["steady_step_ms"],
                             prefetch2=overlap["report"]["steady_step_ms"]))
    if not all(same.values()):
        raise AssertionError(f"6h: the overlapped run differs from the synchronous "
                             f"one: {same}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {name: dict(launches=r["launches"]) for name, r in runs.items()}


# ---------------------------------------------------------------------------
# phase 7m: one step under each policy and with accumulation, card vs CPU
# ---------------------------------------------------------------------------

#: phase 7's cut (GPT-2-124M at 2 layers, T 256, dropout 0.1): the bf16 and
#: fp16 policies on fp32 masters and --data_type fp16 (the fp16 policy on
#: fp16 masters) on B 1, and two microbatches in fp32 on a batch of two
#: collated Alpaca records whose supervised counts differ
MIXED_REFERENCES = [
    dict(label="bf16-policy", dtype="fp32", policy="bf16", bounds="bf16"),
    dict(label="fp16-policy", dtype="fp32", policy="fp16", bounds="fp16"),
    dict(label="fp16-data-type", dtype="fp16", policy="fp16", bounds="fp16"),
    dict(label="fp32-accum2-sft", dtype="fp32", policy=None, grad_accum=2,
         bounds="fp32"),
]


def microbatch_means_loss(torch, model, cfg, batch, seed: int, grad_accum: int) -> float:
    """The accumulation control: the mean of each microbatch's own
    weighted mean, with the microbatches' dropout seeds (the step's seed
    folded with the index), where the step divides the sums once."""
    from building_llm_from_scratch_tpu_torch.models.transformer import forward_hidden
    from building_llm_from_scratch_tpu_torch.training import train_step as tts
    from building_llm_from_scratch_tpu_torch.utils.seeding import step_seed

    sums = tts.make_sums_fn(cfg)
    s = step_seed(seed, 0)
    mb = batch["inputs"].shape[0] // grad_accum
    means = []
    with torch.no_grad():
        for i in range(grad_accum):
            rows = slice(i * mb, (i + 1) * mb)
            h = forward_hidden(model, batch["inputs"][rows], seed=step_seed(s, i),
                               deterministic=False)
            nll, w = sums(model, h, batch["targets"][rows], batch["weights"][rows])
            means.append((nll / w.clamp_min(1.0)).item())
    return sum(means) / len(means)


def phase_mixed_reference(torch, workdir: str) -> dict:
    """Phase 7m: each ``MIXED_REFERENCES`` step on the card and on the CPU
    with the same weights, batch and dropout seed: the loss and every
    gradient within ``REF_BOUNDS`` of the case's dtype, no step skipped.
    Controls: the policies' CPU step with another dropout seed must fail
    the gradient bound (phase 7's); accumulation's mean of per-microbatch
    means must fail the loss bound."""
    import building_llm_from_scratch_tpu_torch.models.transformer as ttf
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.data.instruct import (
        InstructionDataset,
        collate_batch,
    )
    from building_llm_from_scratch_tpu_torch.data.tokenizers import ByteTokenizer
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import precision as tprec
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    data = os.path.join(workdir, "ref-alpaca.json")
    write_alpaca(data, 16)
    with open(data) as f:
        records = json.load(f)
    kernels = train_kernels()
    results = {}
    for spec in MIXED_REFERENCES:
        t0 = time.perf_counter()
        accum = spec.get("grad_accum", 1)
        policy = tprec.get_policy(spec["policy"])
        cfg = get_config("GPT2", "124M", dtype=spec["dtype"],
                         target_context_length=256).replace(n_layers=2)
        card_model = ttf.build_model(cfg, seed=3, device="cuda")
        cpu_flat = {k: v.cpu().clone() for k, v in card_model.flat_params().items()}
        if accum > 1:
            # record 0 and the first record whose supervised count differs
            ds = InstructionDataset(records, ByteTokenizer())
            for j in range(1, len(ds)):
                x, y, w = (torch.from_numpy(a) for a in collate_batch(
                    [ds[0], ds[j]], pad_token_id=cfg.eos_id, allowed_max_length=256))
                if w[0].sum() != w[1].sum():
                    break
            host = {"inputs": x.long(), "targets": y.long(), "weights": w.float()}
        else:
            gen = torch.Generator().manual_seed(5)
            x = torch.randint(0, cfg.vocab_size, (1, 257), generator=gen)
            host = {"inputs": x[:, :-1], "targets": x[:, 1:]}

        def one_step(model, seed=REF_SEED):
            dev = model.device
            opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 10, 100),
                             grad_clip_norm=float("inf"))   # keep the raw gradients
            state = tts.init_train_state(model, opt, seed=seed, policy=policy)
            batch = {k: v.to(dev) for k, v in host.items()}
            _, m = tts.make_train_step(cfg, opt, policy=policy, grad_accum=accum)(
                state, batch)
            # the gradient buffers (scaled for fp16 masters: the relative
            # errors below do not see the scale, the same on both sides)
            return (m["loss"].item(), {k: g.cpu().float() for k, g in state.grads.items()},
                    m.get("skipped", 0))

        for f in kernels.values():
            f.launches = 0
        card_loss, card_grads, card_skipped = one_step(card_model)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in kernels.items()}
        del card_model
        torch.cuda.empty_cache()
        t_cpu = time.perf_counter()
        cpu_loss, cpu_grads, cpu_skipped = one_step(
            ttf.Transformer(cfg, {k: v.clone() for k, v in cpu_flat.items()}))
        cpu_s = time.perf_counter() - t_cpu

        def rel_l2(a, b):
            return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

        card = {k: rel_l2(card_grads[k], cpu_grads[k]) for k in cpu_grads}
        loss_bound, grad_bound = REF_BOUNDS[spec["bounds"]]
        result = dict(label=spec["label"], model=cfg.name, layers=2, T=256,
                      B=host["inputs"].shape[0], masters=spec["dtype"],
                      policy=spec["policy"], grad_accum=accum, drop_rate=cfg.drop_rate,
                      launches=launches,
                      expected=expected_launches(cfg, 1, 0, False, grad_accum=accum),
                      card_loss=card_loss, cpu_loss=cpu_loss,
                      loss_rel=abs(card_loss - cpu_loss) / abs(cpu_loss),
                      grad_rel_l2=card, skipped=[card_skipped, cpu_skipped],
                      bound=dict(loss_rel=loss_bound, grad_rel_l2=grad_bound),
                      cpu_step_s=cpu_s)
        if accum > 1:
            ctl = microbatch_means_loss(torch, ttf.Transformer(cfg, cpu_flat), cfg,
                                        host, REF_SEED, accum)
            result.update(supervised=[float(r.sum()) for r in host["weights"]],
                          control="mean of microbatch means", control_loss=ctl,
                          control_loss_rel=abs(ctl - cpu_loss) / abs(cpu_loss))
            caught = result["control_loss_rel"] > loss_bound
        else:
            _, ctl_grads, _ = one_step(ttf.Transformer(cfg, cpu_flat), seed=REF_SEED + 1)
            control = {k: rel_l2(ctl_grads[k], cpu_grads[k]) for k in cpu_grads}
            result.update(control="other dropout seed", control_rel_l2=control)
            caught = max(control.values()) > grad_bound
        result["seconds"] = time.perf_counter() - t0
        emit("mixed_reference", **result)
        if launches != result["expected"]:
            raise AssertionError(f"7m {spec['label']}: launches {launches}, expected "
                                 f"{result['expected']}")
        if card_skipped or cpu_skipped:
            raise AssertionError(f"7m {spec['label']}: a step was skipped: {result}")
        if result["loss_rel"] > loss_bound or max(card.values()) > grad_bound:
            raise AssertionError(f"7m {spec['label']}: card step off the CPU step: "
                                 f"{result}")
        if not caught:
            raise AssertionError(f"7m {spec['label']}: the bounds do not catch the "
                                 f"control: {result}")
        results[spec["label"]] = result
    return results


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

SERVE_MODELS = [
    # full width, seeded random weights; each serves at one KERNEL_SHAPES
    # row: slots = S, max_len = Tmax. LLaMA-3-8B is cut to 2 of its 32
    # layers to keep the run short.
    dict(model="llama3_2", size="1B", dtype="bf16", context=1024, layers=None,
         slots=8, requests=24, max_prompt=768),
    dict(model="GPT2", size="124M", dtype="fp32", context=1024, layers=None,
         slots=8, requests=24, max_prompt=768),
    dict(model="llama3", size="8B", dtype="bf16", context=4096, layers=2,
         slots=4, requests=12, max_prompt=3072),
]


def make_requests(cfg, seed: int, n: int, max_prompt: int) -> list:
    """n requests: prompts of 16-max_prompt tokens, budgets of 32-128 new
    tokens, eos ignored; every sixth samples with top-k, the rest are
    greedy."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.serving.request import (
        SamplingParams,
    )

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tp = int(rng.integers(16, max_prompt + 1))
        sampled = i % 6 == 5
        sp = SamplingParams(max_new_tokens=int(rng.integers(32, 129)),
                            temperature=0.8 if sampled else 0.0,
                            top_k=40 if sampled else None, seed=1000 + i,
                            ignore_eos=True)
        out.append((rng.integers(0, cfg.vocab_size, tp).tolist(), sp))
    return out


def serve(engine, requests: list) -> list:
    """Submit through the engine's background loop, wait for every result."""
    engine.start()
    try:
        handles = [engine.submit(p, sp, block=True) for p, sp in requests]
        for h in handles:
            h.result(timeout=600)
    finally:
        engine.shutdown()
    return handles


def _agreement(torch, pairs) -> dict:
    """Worst cosine and largest abs difference over (logits, reference)
    pairs, beside the smallest rms of the reference logits."""
    cos = min(torch.nn.functional.cosine_similarity(
        a.reshape(1, -1).double(), b.reshape(1, -1).double()).item()
        for a, b in pairs)
    diff = max((a - b).abs().max().item() for a, b in pairs)
    rms = min(b.pow(2).mean().sqrt().item() for _, b in pairs)
    return dict(cosine_min=cos, max_abs_diff=diff, ref_rms=rms)


def _within(cfg, m: dict) -> bool:
    """fp32 on the card must match the fp32 CPU reference to 1e-3; bf16
    to within a tenth of the logits' rms and a cosine of 0.9995."""
    if cfg.dtype == "fp32":
        return m["max_abs_diff"] <= 1e-3
    return m["cosine_min"] >= 0.9995 and m["max_abs_diff"] <= 0.1 * m["ref_rms"]


def reference_check(torch, model, cfg) -> dict:
    """A small input through the card's serving functions (prefill, then
    decode ticks through the kernel) against the same functions on the CPU
    in fp32 (the plain twin), teacher-forced on the card's greedy tokens.

    A control shows the bound can fail: the CPU reference run again with
    the decode steps' attention output zeroed must fall outside it."""
    import building_llm_from_scratch_tpu_torch.models.transformer as ttf
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        Transformer,
        decode_slots,
        init_slot_cache,
        prefill_into_slot,
    )

    ref_cfg = cfg.replace(dtype="fp32")
    ref = Transformer(ref_cfg, {k: v.float().cpu()
                                for k, v in model.flat_params().items()})
    gen = torch.Generator().manual_seed(7)
    S, Tmax, Tp = 2, 64, 16
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    prompt[0, Tp:] = 0
    dev_cache = init_slot_cache(cfg, S, Tmax, "cuda")
    ref_cache = init_slot_cache(ref_cfg, S, Tmax, "cpu")
    for slot in range(S):
        a = prefill_into_slot(model, prompt.cuda(), Tp, slot, dev_cache)
        b = prefill_into_slot(ref, prompt, Tp, slot, ref_cache)
    ablated_cache = {k: [t.clone() for t in v] for k, v in ref_cache.items()}
    toks = a.argmax().cpu().view(1, 1).repeat(S, 1)
    lengths = torch.full((S,), Tp, dtype=torch.int32)
    pairs, ablated = [(a.cpu(), b)], []
    twin = ttf.fused_decode_step_plain

    def no_attention(*args):
        out, k, v = twin(*args)
        return torch.zeros_like(out), k, v

    for _ in range(4):
        a = decode_slots(model, toks.cuda(), lengths.cuda(), dev_cache)
        b = decode_slots(ref, toks, lengths, ref_cache)
        ttf.fused_decode_step_plain = no_attention
        try:
            c = decode_slots(ref, toks, lengths, ablated_cache)
        finally:
            ttf.fused_decode_step_plain = twin
        pairs.append((a.cpu(), b))
        ablated.append((c, b))
        toks = a.argmax(-1).cpu().view(S, 1)
        lengths += 1
    card, control = _agreement(torch, pairs), _agreement(torch, ablated)
    result = dict(card=card, no_attention_control=control,
                  bound="max_abs<=1e-3" if cfg.dtype == "fp32"
                  else "cosine>=0.9995 and max_abs<=0.1*rms(ref)")
    if not _within(cfg, card):
        raise AssertionError(f"{cfg.name}: card logits off the fp32 CPU "
                             f"reference: {result}")
    if _within(cfg, control):
        raise AssertionError(f"{cfg.name}: the reference bound does not "
                             f"catch a model without decode attention: {result}")
    return result


def tick_profile(torch, engine_cls, model, requests: list, tick_ms: float,
                 slots: int, max_len: int, n_ticks: int = 12,
                 kv_policy=None) -> dict:
    """Device time by kernel over a window of steady decode ticks
    (torch.profiler). Runs after the main path and outside its count. The
    profiler slows the host, so the idle share is taken against the
    unprofiled mean tick ``tick_ms`` of the main run, and against the
    unprofiled steady tick timed just before the window (``steady``: the
    main run's mean of a chunked ``kv_policy`` also holds the device time
    of the prefill chunks queued before each tick). A chunked policy is
    stepped until every slot decodes first."""
    from torch.profiler import ProfilerActivity, profile

    eng = engine_cls(model, n_slots=slots, max_len=max_len, max_queue=64,
                     kv_policy=kv_policy)
    for p, sp in requests[:slots]:
        eng.submit(p, sp)
    eng.step()                      # admission (prefill) + first tick
    while eng._prefill_state:
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0, ticks0 = time.perf_counter(), eng.n_ticks
    for _ in range(n_ticks):
        eng.step()
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / (eng.n_ticks - ticks0) * 1e3
    t0, ticks0 = time.perf_counter(), eng.n_ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = eng.n_ticks - ticks0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies), so nothing counts twice
        if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[2] for r in rows)
    busy_ms = busy_us / ticks / 1e3
    # the serving decode kernels' device ms a tick: B5's split pass, B7's,
    # their merge (one kernel, shared), B6's two passes
    families = {"b5_split": ("decode_split_kernel",), "b7_split": ("paged_split_kernel",),
                "merge": ("decode_combine_kernel",),
                "b6": ("bgmv_shrink_kernel", "bgmv_expand_kernel")}
    decode_ms = {f: sum(r[0] for r in rows if any(n in r[1] for n in names)) / ticks / 1e3
                 for f, names in families.items()}
    return dict(ticks=ticks, device_events=len(rows),
                decode_kernels_ms_per_tick=decode_ms,
                profiled_tick_ms=wall / ticks * 1e3,
                device_busy_ms_per_tick=busy_ms,
                device_idle_share=1.0 - busy_ms / tick_ms,
                steady_tick_ms=steady_ms,
                device_idle_share_steady=1.0 - busy_ms / steady_ms,
                kernels_per_tick=launches / ticks,
                top=[dict(kernel=k[:80], ms_per_tick=dt / ticks / 1e3,
                          calls_per_tick=c / ticks) for dt, k, c in rows[:8]])


def phase_serve(torch) -> dict:
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.ops.decode_step import (
        fused_decode_step,
    )
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine

    served = {}
    for m in SERVE_MODELS:
        dt, slots, max_len = m["dtype"], m["slots"], m["context"]
        cfg = get_config(m["model"], m["size"], dtype=dt,
                         target_context_length=m["context"])
        if m["layers"]:
            cfg = cfg.replace(n_layers=m["layers"])
        t0 = time.perf_counter()
        model = build_model(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        requests = make_requests(cfg, seed=1, n=m["requests"],
                                 max_prompt=m["max_prompt"])
        engine = DecodeEngine(model, n_slots=slots, max_len=max_len,
                              max_queue=64)

        fused_decode_step.launches = 0          # the main path's count
        t0 = time.perf_counter()
        handles = serve(engine, requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = fused_decode_step.launches

        st = engine.stats()
        ttft = sorted(h.ttft_s() for h in handles)
        tpot = sorted(h.tpot_s() for h in handles)
        for (p, sp), h in zip(requests, handles):
            if h.finish_reason != "length" or len(h.output_ids) != sp.max_new_tokens:
                raise AssertionError(f"{cfg.name}: request {h.id} ended "
                                     f"{h.finish_reason} after {len(h.output_ids)}"
                                     f"/{sp.max_new_tokens} tokens")
        if st["requests_failed"] or st["requests_finished"] != len(requests):
            raise AssertionError(f"{cfg.name}: {st}")
        if n_launch != cfg.n_layers * st["n_ticks"] or n_launch == 0:
            raise AssertionError(f"{cfg.name}: {n_launch} kernel launches for "
                                 f"{cfg.n_layers} layers x {st['n_ticks']} ticks")
        served[cfg.name] = dict(
            launches=n_launch,
            shape=(slots, cfg.n_heads, cfg.n_kv_groups, cfg.head_dim, max_len,
                   dt))

        # slot independence: three greedy requests alone in a fresh engine
        greedy = [i for i, (_, sp) in enumerate(requests) if sp.temperature == 0][:3]
        solo_engine = DecodeEngine(model, n_slots=slots, max_len=max_len)
        for i in greedy:
            solo = serve(solo_engine, [requests[i]])[0]
            if solo.output_ids != handles[i].output_ids:
                raise AssertionError(f"{cfg.name}: request {i} alone gave other "
                                     "tokens than co-batched")

        ref = reference_check(torch, model, cfg)
        tick_ms = st["decode_seconds"] / st["n_ticks"] * 1e3
        prof = tick_profile(torch, DecodeEngine, model, requests, tick_ms,
                            slots, max_len)
        emit("serve", model=cfg.name, dtype=dt, layers=cfg.n_layers,
             emb_dim=cfg.emb_dim, vocab=cfg.vocab_size, slots=slots,
             max_len=max_len,
             init_s=init_s, requests=len(requests),
             prompt_tokens=sum(len(p) for p, _ in requests),
             new_tokens=st["tokens_generated"], wall_s=wall,
             decode_ticks=st["n_ticks"],
             decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
             mean_tick_ms=tick_ms,
             prefill_s=st["prefill_seconds"], decode_s=st["decode_seconds"],
             ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
             tpot_p50_ms=statistics.median(tpot) * 1e3, tpot_max_ms=tpot[-1] * 1e3,
             latency_samples=len(handles), requests_failed=st["requests_failed"],
             kernel_launches=n_launch, slot_independence=f"{len(greedy)} requests",
             reference=ref, tick_profile=prof,
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, engine, solo_engine
        torch.cuda.empty_cache()
    return served


# ---------------------------------------------------------------------------
# phase 4d: a long-context model through the contiguous engine
# ---------------------------------------------------------------------------

# longctx-32k at its native 32,768-token context, cut to 2 of its 24 layers:
# two slots of the full length. The 4,096-token prompt buckets to 4,096, so
# its prefill's score tensor is Hq x 4096 x 4096 x 4 bytes (1.1 GB); with
# its 4,200-token budget the row ends at 8,296, past the 8,192 that the TPU
# kernel's rule allowed. The 512-token prompt decodes 64 tokens beside it.
LONGCTX = dict(model="longctx", size="32k", dtype="bf16", context=32768, layers=2,
               slots=2, requests=[(4096, 4200), (512, 64)])


def phase_serve_longctx(torch) -> dict:
    """Serve longctx-32k at 2 layers on slots of 32,768 through the
    contiguous DecodeEngine: every budget finishes, B5 launches layers x
    ticks, and every decode tick's logits are finite."""
    import numpy as np

    import building_llm_from_scratch_tpu_torch.serving.engine as teng
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.ops.decode_step import (
        fused_decode_step,
    )
    from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams

    m = LONGCTX
    cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                     target_context_length=m["context"]).replace(n_layers=m["layers"])
    model = build_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    requests = [(rng.integers(0, cfg.vocab_size, n).tolist(),
                 SamplingParams(max_new_tokens=budget, ignore_eos=True))
                for n, budget in m["requests"]]
    engine = teng.DecodeEngine(model, n_slots=m["slots"], max_len=m["context"],
                               max_queue=8)
    # every tick's logits, checked for non-finite values on the device
    bad = []
    decode_slots = teng.decode_slots

    def checked_decode_slots(*args, **kwargs):
        logits = decode_slots(*args, **kwargs)
        bad.append((~torch.isfinite(logits)).sum())
        return logits

    torch.cuda.reset_peak_memory_stats()
    teng.decode_slots = checked_decode_slots
    fused_decode_step.launches = 0              # the main path's count
    t0 = time.perf_counter()
    try:
        handles = serve(engine, requests)
        torch.cuda.synchronize()
    finally:
        teng.decode_slots = decode_slots
    wall = time.perf_counter() - t0
    n_launch = fused_decode_step.launches
    st = engine.stats()
    non_finite = int(torch.stack(bad).sum().item()) if bad else -1
    rows_end = [len(p) + len(h.output_ids) for (p, _), h in zip(requests, handles)]
    for (p, sp), h in zip(requests, handles):
        if h.finish_reason != "length" or len(h.output_ids) != sp.max_new_tokens:
            raise AssertionError(f"{cfg.name}: request {h.id} ended {h.finish_reason} "
                                 f"after {len(h.output_ids)}/{sp.max_new_tokens} tokens")
    if n_launch != cfg.n_layers * st["n_ticks"] or n_launch == 0:
        raise AssertionError(f"{cfg.name}: {n_launch} kernel launches for "
                             f"{cfg.n_layers} layers x {st['n_ticks']} ticks")
    if non_finite != 0 or len(bad) != st["n_ticks"]:
        raise AssertionError(f"{cfg.name}: {non_finite} non-finite logits over "
                             f"{len(bad)} checked ticks of {st['n_ticks']}")
    if max(rows_end) <= 8192:
        raise AssertionError(f"{cfg.name}: no row passed 8192 ({rows_end})")
    emit("serve_longctx", model=cfg.name, dtype=m["dtype"], layers=cfg.n_layers,
         emb_dim=cfg.emb_dim, Hq=cfg.n_heads, Hkv=cfg.n_kv_groups, slots=m["slots"],
         max_len=m["context"], prompts=[len(p) for p, _ in requests],
         budgets=[sp.max_new_tokens for _, sp in requests], rows_end=rows_end,
         wall_s=wall, decode_ticks=st["n_ticks"], kernel_launches=n_launch,
         non_finite_logits=non_finite,
         mean_tick_ms=st["decode_seconds"] / st["n_ticks"] * 1e3,
         prefill_s=st["prefill_seconds"],
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, engine
    torch.cuda.empty_cache()
    return {cfg.name: dict(launches=n_launch,
                           shape=(m["slots"], cfg.n_heads, cfg.n_kv_groups, cfg.head_dim,
                                  m["context"], m["dtype"]))}


# ---------------------------------------------------------------------------
# phase 4b: paged KV with prefix sharing and chunked prefill
# ---------------------------------------------------------------------------

PAGE_TOKENS, PREFILL_CHUNK = 16, 64
SYSTEM_PROMPTS, SYSTEM_TOKENS = 3, 320
PAGED_SERVE = [
    # each at full width with phase 4's seeded weights; LLaMA-3.2-1B paged
    # goes through the CLI (flags, frontend, JSONL); the contiguous run with
    # the prefix cache runs B5 where the paged runs run B7
    dict(label="llama3_2-1B-paged", shape="llama3_2-1B", model="llama3_2",
         size="1B", dtype="bf16", context=1024, slots=8, paged=True, cli=True),
    dict(label="gpt2-124M-paged", shape="gpt2-124M", model="GPT2", size="124M",
         dtype="fp32", context=1024, slots=8, paged=True, cli=False),
    dict(label="llama3_2-1B-prefix", shape="llama3_2-1B", model="llama3_2",
         size="1B", dtype="bf16", context=1024, slots=8, paged=False, cli=False),
]


def make_shared_requests(cfg, seed: int, n: int = 24) -> list:
    """n requests, the many users behind a few system prompts: all but every
    sixth (from the third on) start with one of SYSTEM_PROMPTS seeded
    SYSTEM_TOKENS-token system prompts (in turn), the rest share nothing;
    suffixes of 16-400 tokens, budgets of 32-128, eos ignored, every sixth
    sampled (top-k 40, T 0.8)."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.serving.request import (
        SamplingParams,
    )

    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    systems = [rng.integers(0, V, SYSTEM_TOKENS) for _ in range(SYSTEM_PROMPTS)]
    out = []
    for i in range(n):
        sampled = i % 6 == 5
        sp = SamplingParams(max_new_tokens=int(rng.integers(32, 129)),
                            temperature=0.8 if sampled else 0.0,
                            top_k=40 if sampled else None, seed=2000 + i,
                            ignore_eos=True)
        suffix = rng.integers(0, V, int(rng.integers(16, 401)))
        head = (rng.integers(0, V, SYSTEM_TOKENS) if i % 6 == 2
                else systems[i % SYSTEM_PROMPTS])
        out.append((np.concatenate([head, suffix]).tolist(), sp))
    return out


def paged_policy(paged: bool):
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        KVCachePolicy,
    )

    return KVCachePolicy(prefix_cache=True, prefill_chunk=PREFILL_CHUNK,
                         paged=paged, page_tokens=PAGE_TOKENS)


def serve_cli(torch, m: dict, requests: list, workdir: str, flags=None):
    """``main.run --mode serve`` on a JSONL of the requests (with their
    ``adapter`` fields), with ``flags`` (default: the paging flags);
    returns (engine, result records)."""
    from building_llm_from_scratch_tpu_torch import main as tmain

    if flags is None:
        flags = ["--serve_kv_paged", "on", "--serve_prefix_cache", "on",
                 "--serve_kv_page_tokens", str(PAGE_TOKENS)]
    src = os.path.join(workdir, f"{m['label']}.jsonl")
    dst = os.path.join(workdir, f"{m['label']}.out.jsonl")
    with open(src, "w") as f:
        for p, sp in requests:
            rec = {"prompt_ids": p, "max_new_tokens": sp.max_new_tokens,
                   "temperature": sp.temperature, "top_k": sp.top_k,
                   "seed": sp.seed, "ignore_eos": sp.ignore_eos}
            if sp.adapter is not None:
                rec["adapter"] = sp.adapter
            f.write(json.dumps(rec) + "\n")
    engine = tmain.run([
        "--mode", "serve", "--model", m["model"], "--num_params", m["size"],
        "--data_type", m["dtype"], "--target_context_length", str(m["context"]),
        "--seed", "0", "--serve_prompts", src, "--serve_out", dst,
        "--serve_slots", str(m["slots"]), "--serve_max_len", str(m["context"]),
        "--serve_max_queue", "64", *flags])
    with open(dst) as f:
        return engine, [json.loads(line) for line in f]


def paged_reference_check(torch, model, cfg) -> dict:
    """``reference_check`` through the paged functions: a chunked prefill
    and decode ticks over a pool with shuffled pages on the card (B7)
    against the same functions on the CPU in fp32 (the twin), teacher-forced
    on the card's greedy tokens; the CPU reference run again with the decode
    attention zeroed must fall outside the bound."""
    import building_llm_from_scratch_tpu_torch.models.transformer as ttf
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        Transformer,
        init_slot_cache,
        paged_decode_slots,
        paged_prefill_chunk_into_slot,
    )

    ref_cfg = cfg.replace(dtype="fp32")
    ref = Transformer(ref_cfg, {k: v.float().cpu()
                                for k, v in model.flat_params().items()})
    pol = paged_policy(True)
    S, Tmax, Tp = 2, 64, 20
    gen = torch.Generator().manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_CHUNK), generator=gen)
    prompt[0, Tp:] = 0
    table = torch.tensor([[7, 2, 5, 0], [3, 8, 1, 0]], dtype=torch.int32)
    dev_cache = init_slot_cache(cfg, S, Tmax, "cuda", policy=pol)
    ref_cache = init_slot_cache(ref_cfg, S, Tmax, "cpu", policy=pol)
    for slot in range(S):
        a = paged_prefill_chunk_into_slot(model, prompt.cuda(), 0, Tp,
                                          table[slot:slot + 1].cuda(),
                                          dev_cache, Tmax)
        b = paged_prefill_chunk_into_slot(ref, prompt, 0, Tp,
                                          table[slot:slot + 1], ref_cache, Tmax)
    ablated_cache = {k: [t.clone() for t in v] for k, v in ref_cache.items()}
    toks = a.argmax().cpu().view(1, 1).repeat(S, 1)
    lengths = torch.full((S,), Tp, dtype=torch.int32)
    pairs, ablated = [(a.cpu(), b)], []
    twin = ttf.paged_decode_attention_plain

    def no_attention(*args, **kw):
        return torch.zeros_like(twin(*args, **kw))

    for _ in range(4):
        a = paged_decode_slots(model, toks.cuda(), lengths.cuda(), table.cuda(),
                               dev_cache, Tmax)
        b = paged_decode_slots(ref, toks, lengths, table, ref_cache, Tmax)
        ttf.paged_decode_attention_plain = no_attention
        try:
            c = paged_decode_slots(ref, toks, lengths, table, ablated_cache, Tmax)
        finally:
            ttf.paged_decode_attention_plain = twin
        pairs.append((a.cpu(), b))
        ablated.append((c, b))
        toks = a.argmax(-1).cpu().view(S, 1)
        lengths += 1
    card, control = _agreement(torch, pairs), _agreement(torch, ablated)
    result = dict(card=card, no_attention_control=control,
                  bound="max_abs<=1e-3" if cfg.dtype == "fp32"
                  else "cosine>=0.9995 and max_abs<=0.1*rms(ref)")
    if not _within(cfg, card):
        raise AssertionError(f"{cfg.name}: paged card logits off the fp32 CPU "
                             f"reference: {result}")
    if _within(cfg, control):
        raise AssertionError(f"{cfg.name}: the paged reference bound does not "
                             f"catch a model without decode attention: {result}")
    return result


def prefill_hits_timing(torch, engine_cls, model, requests: list, slots: int,
                        max_len: int) -> dict:
    """Prefill alone (each request cut to one new token, its first), over
    the requests that share a system prompt: with the prefix cache warmed by
    one request per system prompt, and with paging but no prefix cache.
    Host clock to a synchronised end; outside the main path's count."""
    import dataclasses

    shared = [(i % SYSTEM_PROMPTS, (p, dataclasses.replace(sp, max_new_tokens=1)))
              for i, (p, sp) in enumerate(requests) if i % 6 != 2]
    firsts = {}
    for k, (system, _) in enumerate(shared):
        firsts.setdefault(system, k)
    warm = [r for k, (_, r) in enumerate(shared) if k in firsts.values()]
    rest = [r for k, (_, r) in enumerate(shared) if k not in firsts.values()]
    out = {}
    for name, pol in (("hits", paged_policy(True)),
                      ("no_prefix_cache", dataclasses.replace(
                          paged_policy(True), prefix_cache=False))):
        eng = engine_cls(model, n_slots=slots, max_len=max_len, max_queue=64,
                         kv_policy=pol)
        for p, sp in warm:
            eng.submit(p, sp)
        eng.run_until_idle()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, sp in rest:
            eng.submit(p, sp)
        eng.run_until_idle()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        st = eng.stats()
        out[name] = dict(seconds=seconds, prefill_chunks=st["prefill_chunks"],
                         prefix_hits=st.get("prefix_store", {}).get("hits", 0))
        if eng.prefix_store is not None:
            out["cached_tokens"] = sum(eng.prefix_store.storable_span(len(p))
                                       for p, _ in rest)
    if out["hits"]["prefix_hits"] != len(rest):
        raise AssertionError(f"prefill timing: {out}")
    out.update(requests=len(rest), prompt_tokens=sum(len(p) for p, _ in rest),
               speedup=out["no_prefix_cache"]["seconds"] / out["hits"]["seconds"])
    return out


def paired_ticks(torch, engine_cls, model, requests: list, slots: int,
                 max_len: int, rounds: int = 6, window: int = 8) -> dict:
    """Steady decode ticks of the contiguous chunked engine (B5) and the
    paged one (B7) on the same model and requests, in alternating windows
    (contiguous, paged, paged, contiguous, ...) so both see the same host:
    host clock over ``window`` synchronised ticks, medians over ``rounds``
    windows each. Outside the main path's count; each engine's own prefill
    runs before the first window, and no request ends inside the windows."""
    import dataclasses

    engines = {}
    for name, paged in (("contiguous", False), ("paged", True)):
        eng = engine_cls(model, n_slots=slots, max_len=max_len, max_queue=64,
                         kv_policy=paged_policy(paged))
        for p, sp in requests[:slots]:
            eng.submit(p, dataclasses.replace(sp, max_new_tokens=max_len - len(p)))
        while eng._prefill_state or not eng.n_ticks:
            eng.step()
        engines[name] = eng
    times = {name: [] for name in engines}
    order = ["contiguous", "paged"]
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            eng = engines[name]
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), eng.n_ticks
            for _ in range(window):
                eng.step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / (eng.n_ticks - n0) * 1e3)
    out = {f"{k}_tick_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_windows_ms": v for k, v in times.items()},
               ratio=out["paged_tick_ms"] / out["contiguous_tick_ms"],
               rounds=rounds, window_ticks=window)
    return out


def phase_serve_paged(torch, workdir: str) -> dict:
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.ops.decode_step import (
        fused_decode_step,
        paged_decode_attention,
    )
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine

    served = {}
    for m in PAGED_SERVE:
        dt, slots, max_len = m["dtype"], m["slots"], m["context"]
        cfg = get_config(m["model"], m["size"], dtype=dt,
                         target_context_length=m["context"])
        requests = make_shared_requests(cfg, seed=5)
        pol = paged_policy(m["paged"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused_decode_step.launches = 0              # the main path's count
        paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        if m["cli"]:
            engine, records = serve_cli(torch, m, requests, workdir)
            outputs = [r.get("token_ids") for r in records]
            ttft = [r.get("ttft_s") for r in records]
            reasons = [r.get("finish_reason") for r in records]
        else:
            model = build_model(cfg, seed=0, device="cuda")
            engine = DecodeEngine(model, n_slots=slots, max_len=max_len,
                                  max_queue=64, kv_policy=pol)
            handles = serve(engine, requests)
            outputs = [h.output_ids for h in handles]
            ttft = [h.ttft_s() for h in handles]
            reasons = [h.finish_reason for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b5, b7 = fused_decode_step.launches, paged_decode_attention.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model = engine.model

        st = engine.stats()
        for i, ((p, sp), out, why) in enumerate(zip(requests, outputs, reasons)):
            if why != "length" or len(out) != sp.max_new_tokens:
                raise AssertionError(f"{m['label']}: request {i} ended {why} "
                                     f"after {len(out or [])}/{sp.max_new_tokens}")
        if st["requests_failed"] or st["requests_finished"] != len(requests):
            raise AssertionError(f"{m['label']}: {st}")
        hits = st["prefix_store"]["hits"]
        if hits < len(requests) - len(requests) // 6 - SYSTEM_PROMPTS:
            raise AssertionError(f"{m['label']}: {hits} prefix hits: "
                                 f"{st['prefix_store']}")
        ticks = st["n_ticks"]
        want = ((0, cfg.n_layers * ticks) if m["paged"]
                else (cfg.n_layers * ticks, 0))
        if (b5, b7) != want or ticks == 0:
            raise AssertionError(f"{m['label']}: B5/B7 launches {(b5, b7)} for "
                                 f"{cfg.n_layers} layers x {ticks} ticks")
        if m["paged"]:
            pool = st["page_pool"]
            stored = {p for e in engine.prefix_store._entries.values()
                      for p in e.pages}
            if st["pane_copies"] or pool["used"] != len(stored) or pool["reserved"]:
                raise AssertionError(f"{m['label']}: pane copies "
                                     f"{st['pane_copies']}, pool {pool}, "
                                     f"{len(stored)} stored pages")
        elif st["pane_copies"] != hits:
            raise AssertionError(f"{m['label']}: {st['pane_copies']} pane copies "
                                 f"for {hits} hits")

        # slot independence and hit = recompute: three greedy requests alone
        # in a fresh engine (empty store, so each prefills its whole prompt)
        greedy = [i for i, (_, sp) in enumerate(requests)
                  if sp.temperature == 0 and i % 6 != 2][:3]
        solo_engine = DecodeEngine(model, n_slots=slots, max_len=max_len,
                                   kv_policy=pol)
        for i in greedy:
            solo = serve(solo_engine, [requests[i]])[0]
            if solo.output_ids != outputs[i]:
                raise AssertionError(f"{m['label']}: request {i} alone gave "
                                     "other tokens than co-batched")
        row = dict(label=m["label"], model=cfg.name, dtype=dt,
                   layers=cfg.n_layers, slots=slots, max_len=max_len,
                   paged=m["paged"], page_tokens=PAGE_TOKENS if m["paged"] else None,
                   prefill_chunk=PREFILL_CHUNK, cli=m["cli"],
                   requests=len(requests),
                   prompt_tokens=sum(len(p) for p, _ in requests),
                   new_tokens=st["tokens_generated"], wall_s=wall,
                   decode_ticks=ticks, b5_launches=b5, b7_launches=b7,
                   decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
                   mean_tick_ms=st["decode_seconds"] / ticks * 1e3,
                   prefill_s=st["prefill_seconds"], decode_s=st["decode_seconds"],
                   prefill_chunks=st["prefill_chunks"],
                   ttft_p50_s=statistics.median(ttft), ttft_max_s=max(ttft),
                   prefix_store=st["prefix_store"], page_pool=st.get("page_pool"),
                   pane_copies=st["pane_copies"],
                   slot_independence=f"{len(greedy)} requests",
                   max_memory_gb=peak_gb)
        if m["paged"]:
            row["reference"] = paged_reference_check(torch, model, cfg)
        if m["cli"]:
            row["prefill_with_and_without_hits"] = prefill_hits_timing(
                torch, DecodeEngine, model, requests, slots, max_len)
            row["tick_profile"] = tick_profile(
                torch, DecodeEngine, model, requests, row["mean_tick_ms"],
                slots, max_len, kv_policy=pol)
            row["paired_ticks"] = paired_ticks(torch, DecodeEngine, model,
                                               requests, slots, max_len)
        emit("serve_paged", **row)
        served[m["label"]] = dict(
            launches=b7 if m["paged"] else b5, shape=m["shape"], paged=m["paged"],
            dims=(slots, cfg.n_heads, cfg.n_kv_groups, cfg.head_dim,
                  PAGE_TOKENS, max_len // PAGE_TOKENS, dt))
        del model, engine, solo_engine
        torch.cuda.empty_cache()
    return served


# ---------------------------------------------------------------------------
# phase 4c: multi-LoRA serving
# ---------------------------------------------------------------------------

LORA_SERVE = [
    # full width with phase 4's seeded weights; LLaMA-3.2-1B goes through
    # the CLI (--serve_adapters, the JSONL adapter field). Adapter ranks
    # differ so the pool's rank padding is exercised; the pool holds N =
    # LORA_POOL rows of rank LORA_RANK, phase 3c's shapes.
    dict(label="llama3_2-1B-lora", shape="llama3_2-1B", model="llama3_2",
         size="1B", dtype="bf16", context=1024, slots=8, cli=True,
         adapters={"a": 8, "b": 16, "c": 16}),
    dict(label="gpt2-124M-lora", shape="gpt2-124M", model="GPT2", size="124M",
         dtype="fp32", context=1024, slots=8, cli=False,
         adapters={"a": 16, "b": 8}),
]
#: each adapter's delta, as a share of its base projection's output rms
LORA_DELTA_RMS = 0.2


def write_adapters(torch, model, cfg, ranks: dict, workdir: str, label: str):
    """One artifact per adapter (the port's ``save_adapter``): A from a
    seeded init, B seeded and scaled so that on unit-variance inputs each
    projection's delta has LORA_DELTA_RMS of its base output's rms, at
    layer 0 (alpha = 2 rank). Returns ({name: path}, {name: the measured
    delta/base rms ratios at the first and last layer, per projection})."""
    from building_llm_from_scratch_tpu_torch.models.lora import (
        flatten_lora,
        init_lora_params,
        save_adapter,
        unflatten_lora,
    )

    dev = torch.device("cuda")
    params = model.flat_params()
    paths, ratios = {}, {}
    for k, (name, rank) in enumerate(ranks.items()):
        gen = torch.Generator(device=dev).manual_seed(900 + k)
        flat = flatten_lora(init_lora_params(cfg, gen, rank, device=dev))
        s = 2.0                                     # alpha / rank
        measured = {}
        for path in [p for p in flat if p[-1] == "A"]:
            wname, bpath = "/".join(path[:-1]), path[:-1] + ("B",)
            W, A = params[wname], flat[path]
            B = torch.randn(flat[bpath].shape, generator=gen, device=dev)
            x = torch.randn(64, W.shape[-2], generator=gen, device=dev)

            def ratio(B, layer):
                w, a, b = ((W[layer], A[layer], B[layer]) if W.ndim == 3
                           else (W, A, B))
                base = (x @ w.float()).pow(2).mean().sqrt()
                return ((s * (x @ a.float()) @ b.float()).pow(2).mean().sqrt()
                        / base).item()

            B = (B * (LORA_DELTA_RMS / ratio(B, 0))).to(cfg.torch_dtype)
            flat[bpath] = B
            last = W.shape[0] - 1 if W.ndim == 3 else 0
            measured[wname] = [ratio(B, 0), ratio(B, last)]
        paths[name] = os.path.join(workdir, f"{label}-{name}.npz")
        save_adapter(paths[name], unflatten_lora(flat), rank=rank,
                     alpha=2.0 * rank, cfg=cfg)
        ratios[name] = measured
    return paths, ratios


def lora_requests(cfg, names: list) -> list:
    """Phase 4's requests (prompts of 16-768 tokens, budgets of 32-128, every
    sixth sampled), the i-th naming ``names[i % len(names)]`` (None: base)."""
    import dataclasses

    reqs = make_requests(cfg, seed=11, n=24, max_prompt=768)
    return [(p, dataclasses.replace(sp, adapter=names[i % len(names)]))
            for i, (p, sp) in enumerate(reqs)]


def lora_reference_check(torch, model, cfg, reg, control: str = "other") -> dict:
    """One adapted prefill per slot (adapters a, b, c or a, b, a: the
    gathered path) and four decode ticks (B6 on the card, its twin on the
    CPU) against the same functions on the CPU in fp32 with the same pool,
    teacher-forced on the card's greedy tokens. Control: the CPU ticks with
    each row's adapter swapped for another's (``control`` "other") or for
    none (id -1, "base") must fall outside the bound."""
    from building_llm_from_scratch_tpu_torch.models.lora import flatten_lora
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        Transformer,
        decode_slots,
        init_slot_cache,
        prefill_into_slot,
    )
    from building_llm_from_scratch_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )

    ref_cfg = cfg.replace(dtype="fp32")
    ref = Transformer(ref_cfg, {k: v.float().cpu()
                                for k, v in model.flat_params().items()})
    cpu_reg = AdapterRegistry(ref_cfg, capacity=reg.capacity,
                              max_rank=reg.max_rank, device="cpu")
    pool, scaling = reg.pool_args()
    cpu_pool, cpu_scaling = cpu_reg.pool_args()
    cpu_flat = flatten_lora(cpu_pool)
    for path, leaf in flatten_lora(pool).items():
        cpu_flat[path].copy_(leaf.float().cpu())
    cpu_scaling.copy_(scaling.cpu())
    rows = [reg.lookup(n) for n in reg.names()]
    S, Tmax, Tp = 3, 64, 16
    ids = torch.tensor([rows[i % len(rows)] for i in range(S)], dtype=torch.int32)
    # control: every row served by the next adapter instead of its own, or
    # by the base model
    other = torch.tensor([rows[(i + 1) % len(rows)] if control == "other" else -1
                          for i in range(S)], dtype=torch.int32)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    prompt[0, Tp:] = 0
    dev_cache = init_slot_cache(cfg, S, Tmax, "cuda")
    ref_cache = init_slot_cache(ref_cfg, S, Tmax, "cpu")

    def arg(p, sc, row_ids):
        return {"pool": p, "scaling": sc, "ids": row_ids}

    pairs, swapped, toks = [], [], []
    for slot in range(S):
        one = ids[slot:slot + 1]
        a = prefill_into_slot(model, prompt.cuda(), Tp, slot, dev_cache,
                              adapter=arg(pool, scaling, one.cuda()))
        b = prefill_into_slot(ref, prompt, Tp, slot, ref_cache,
                              adapter=arg(cpu_pool, cpu_scaling, one))
        pairs.append((a.cpu(), b))
        toks.append(a.argmax().cpu())
    toks = torch.stack(toks).view(S, 1)
    lengths = torch.full((S,), Tp, dtype=torch.int32)
    for _ in range(4):
        control_cache = {k: [t.clone() for t in v] for k, v in ref_cache.items()}
        a = decode_slots(model, toks.cuda(), lengths.cuda(), dev_cache,
                         adapter=arg(pool, scaling, ids.cuda()))
        b = decode_slots(ref, toks, lengths, ref_cache,
                         adapter=arg(cpu_pool, cpu_scaling, ids))
        c = decode_slots(ref, toks, lengths, control_cache,
                         adapter=arg(cpu_pool, cpu_scaling, other))
        pairs.append((a.cpu(), b))
        swapped.append((c, b))
        toks = a.argmax(-1).cpu().view(S, 1)
        lengths += 1
    card = _agreement(torch, pairs)
    swapped_m = _agreement(torch, swapped)
    result = {"card": card, f"{control}_adapter_control": swapped_m,
              "ids": ids.tolist(), "control_ids": other.tolist(),
              "bound": "max_abs<=1e-3" if cfg.dtype == "fp32"
              else "cosine>=0.9995 and max_abs<=0.1*rms(ref)"}
    if not _within(cfg, card):
        raise AssertionError(f"{cfg.name}: adapted card logits off the fp32 "
                             f"CPU reference: {result}")
    if _within(cfg, swapped_m):
        raise AssertionError(f"{cfg.name}: the reference bound does not catch "
                             f"the {control} control's ids: {result}")
    return result


def lora_paired_ticks(torch, model, reg, requests: list, slots: int,
                      max_len: int, rounds: int = 6, window: int = 8) -> dict:
    """Steady decode ticks of an engine with the registry (the requests'
    adapters; B6 on every tick) and one without (the same requests as base
    traffic), in alternating windows (base, adapters, adapters, base, ...)
    on one host: host clock over ``window`` synchronised ticks, medians over
    ``rounds`` windows each. Outside the main path's count; no request ends
    inside the windows."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine

    engines = {}
    for name, registry in (("base", None), ("adapters", reg)):
        eng = DecodeEngine(model, n_slots=slots, max_len=max_len, max_queue=64,
                           adapters=registry)
        for p, sp in requests[:slots]:
            eng.submit(p, dataclasses.replace(
                sp, max_new_tokens=max_len - len(p),
                adapter=sp.adapter if registry is not None else None))
        while not eng.n_ticks:
            eng.step()
        engines[name] = eng
    times = {name: [] for name in engines}
    order = ["base", "adapters"]
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            eng = engines[name]
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), eng.n_ticks
            for _ in range(window):
                eng.step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / (eng.n_ticks - n0) * 1e3)
    out = {f"{k}_tick_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_windows_ms": v for k, v in times.items()},
               ratio=out["adapters_tick_ms"] / out["base_tick_ms"],
               rounds=rounds, window_ticks=window)
    return out


def _projection_shapes(cfg) -> dict:
    """(in, out) of each adapted block projection of ``cfg``."""
    D, F = cfg.emb_dim, cfg.hidden_dim
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_groups * cfg.head_dim
    out = {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D),
           "up": (D, F), "down": (F, D)}
    if cfg.activation == "swiglu":
        out["gate"] = (D, F)
    return out


class ShapeTally:
    """Stands in for ``lora_bgmv`` during a run and counts its launches by
    (in, out) width. ``launches`` reads and writes the wrapper's own count,
    so the wrapper's increment (made through its module-level name) still
    lands on it."""

    def __init__(self, fn):
        self.fn, self.by_shape = fn, {}

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def __call__(self, x, a_pool, b_pool, ids, scales):
        if x.is_cuda:
            key = (x.shape[1], b_pool.shape[2])
            self.by_shape[key] = self.by_shape.get(key, 0) + 1
        return self.fn(x, a_pool, b_pool, ids, scales)


def phase_serve_lora(torch, workdir: str) -> dict:
    import dataclasses
    import functools

    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
    from building_llm_from_scratch_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine

    served = {}
    for m in LORA_SERVE:
        dt, slots, max_len = m["dtype"], m["slots"], m["context"]
        cfg = get_config(m["model"], m["size"], dtype=dt,
                         target_context_length=m["context"])
        names = list(m["adapters"]) + [None]
        requests = lora_requests(cfg, names)
        torch.cuda.empty_cache()
        model = build_model(cfg, seed=0, device="cuda")
        specs, ratios = write_adapters(torch, model, cfg, m["adapters"], workdir,
                                       m["label"])
        if m["cli"]:
            del model                       # the CLI builds its own
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        # B6 launches by projection shape: a tally around the wrapper,
        # whose own count is checked against it
        launch = tds.lora_bgmv
        counted = ShapeTally(launch)
        tally = counted.by_shape
        tds.lora_bgmv = counted
        tds.fused_decode_step.launches = 0          # the main path's count
        launch.launches = 0
        t0 = time.perf_counter()
        try:
            if m["cli"]:
                engine, records = serve_cli(torch, m, requests, workdir, flags=[
                    "--serve_adapters", ",".join(f"{n}={p}" for n, p in specs.items()),
                    "--serve_adapter_slots", str(LORA_POOL)])
                outputs = [r.get("token_ids") for r in records]
                reasons = [r.get("finish_reason") for r in records]
            else:
                reg = AdapterRegistry.from_artifacts(cfg, specs,
                                                     capacity=LORA_POOL,
                                                     device="cuda")
                engine = DecodeEngine(model, n_slots=slots, max_len=max_len,
                                      max_queue=64, adapters=reg)
                handles = serve(engine, requests)
                outputs = [h.output_ids for h in handles]
                reasons = [h.finish_reason for h in handles]
            torch.cuda.synchronize()
        finally:
            tds.lora_bgmv = launch
        wall = time.perf_counter() - t0
        b5, b6 = tds.fused_decode_step.launches, launch.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model, reg = engine.model, engine.adapters

        st = engine.stats()
        ticks = st["n_ticks"]
        for i, ((p, sp), out, why) in enumerate(zip(requests, outputs, reasons)):
            if why != "length" or len(out) != sp.max_new_tokens:
                raise AssertionError(f"{m['label']}: request {i} ended {why} "
                                     f"after {len(out or [])}/{sp.max_new_tokens}")
        if st["requests_failed"] or st["requests_finished"] != len(requests):
            raise AssertionError(f"{m['label']}: {st}")
        shapes = _projection_shapes(cfg)
        want = {}
        for d_in_out in shapes.values():
            want[d_in_out] = want.get(d_in_out, 0) + cfg.n_layers * ticks
        if (b5 != cfg.n_layers * ticks or b6 != len(shapes) * cfg.n_layers * ticks
                or tally != want or ticks == 0):
            raise AssertionError(f"{m['label']}: B5 {b5}, B6 {b6} ({tally}) for "
                                 f"{len(shapes)} projections x {cfg.n_layers} "
                                 f"layers x {ticks} ticks")
        want_counts = {}
        for (p, sp) in requests:
            c = want_counts.setdefault(sp.adapter or "base", dict(
                finished=0, failed=0, tokens=0))
            c["finished"] += 1
            c["tokens"] += sp.max_new_tokens
        if st["per_adapter"] != want_counts or st["adapters_loaded"] != len(specs):
            raise AssertionError(f"{m['label']}: per-adapter counts "
                                 f"{st['per_adapter']}, want {want_counts}")

        # slot independence: three greedy adapted requests alone; the
        # adapters are visible: adapted greedy prompts served as base
        greedy = [i for i, (_, sp) in enumerate(requests)
                  if sp.temperature == 0 and sp.adapter is not None]
        solo_engine = DecodeEngine(model, n_slots=slots, max_len=max_len,
                                   adapters=reg)
        for i in greedy[:3]:
            solo = serve(solo_engine, [requests[i]])[0]
            if solo.output_ids != outputs[i]:
                raise AssertionError(f"{m['label']}: request {i} alone gave "
                                     "other tokens than co-batched")
        base_engine = DecodeEngine(model, n_slots=slots, max_len=max_len)
        as_base = serve(base_engine, [
            (requests[i][0], dataclasses.replace(requests[i][1], adapter=None))
            for i in greedy])
        differ = sum(h.output_ids != outputs[i] for h, i in zip(as_base, greedy))
        if 2 * differ < len(greedy):
            raise AssertionError(f"{m['label']}: adapted tokens differ from the "
                                 f"base model's on {differ}/{len(greedy)} prompts")

        row = dict(label=m["label"], model=cfg.name, dtype=dt,
                   layers=cfg.n_layers, slots=slots, max_len=max_len,
                   cli=m["cli"], adapters=m["adapters"],
                   pool_rows=reg.capacity, pool_rank=reg.max_rank,
                   pool_bytes=reg.pool_nbytes(),
                   delta_rms_ratios=ratios, requests=len(requests),
                   prompt_tokens=sum(len(p) for p, _ in requests),
                   new_tokens=st["tokens_generated"], wall_s=wall,
                   decode_ticks=ticks, b5_launches=b5, b6_launches=b6,
                   b6_launches_by_shape={f"{d}x{o}": n for (d, o), n in tally.items()},
                   per_adapter=st["per_adapter"],
                   decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
                   mean_tick_ms=st["decode_seconds"] / ticks * 1e3,
                   prefill_s=st["prefill_seconds"], decode_s=st["decode_seconds"],
                   slot_independence=f"{min(3, len(greedy))} requests",
                   differ_from_base=f"{differ}/{len(greedy)}",
                   max_memory_gb=peak_gb)
        row["reference"] = lora_reference_check(torch, model, cfg, reg)
        row["paired_ticks"] = lora_paired_ticks(torch, model, reg, requests,
                                                slots, max_len)
        if m["cli"]:
            row["tick_profile"] = tick_profile(
                torch, functools.partial(DecodeEngine, adapters=reg), model,
                requests, row["mean_tick_ms"], slots, max_len)
        emit("serve_lora", **row)
        served[m["shape"]] = dict(tally=tally, dims=(slots, reg.capacity,
                                                     reg.max_rank, dt))
        del model, engine, solo_engine, base_engine, reg
        gc.collect()        # the registry's in-use probe holds its engine
        torch.cuda.empty_cache()
    return served


def phase_serve_sft_adapter(torch, adapter: str, workdir: str) -> dict:
    """Phase 4c with phase 6s's trained adapter: LLaMA-3.2-1B bf16 through
    the CLI (``--serve_adapters sft=<path>``, phase 3c's pool of LORA_POOL
    rows of rank LORA_RANK) on the base the SFT run started from (the same
    seed), 8 requests, sft and base traffic in turn. Every budget finishes,
    B6 = adapted projections x layers x ticks, B5 = layers x ticks; the
    adapted rows within the fp32 CPU reference, and the same ticks served
    as the base model must fail it."""
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds

    m = dict(label="llama3_2-1B-sft", shape="llama3_2-1B", model="llama3_2",
             size="1B", dtype="bf16", context=1024, slots=LORA_S)
    cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                     target_context_length=m["context"])
    requests = lora_requests(cfg, ["sft", None])[:8]
    tds.fused_decode_step.launches = 0              # the main path's count
    tds.lora_bgmv.launches = 0
    t0 = time.perf_counter()
    engine, records = serve_cli(torch, m, requests, workdir, flags=[
        "--serve_adapters", f"sft={adapter}", "--serve_adapter_slots", str(LORA_POOL)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b5, b6 = tds.fused_decode_step.launches, tds.lora_bgmv.launches
    st = engine.stats()
    ticks, reg = st["n_ticks"], engine.adapters
    for i, ((p, sp), r) in enumerate(zip(requests, records)):
        if r.get("finish_reason") != "length" or len(r["token_ids"]) != sp.max_new_tokens:
            raise AssertionError(f"SFT adapter serving: request {i} ended {r}")
    shapes = _projection_shapes(cfg)
    dims = (m["slots"], reg.capacity, reg.max_rank, m["dtype"])
    if (ticks == 0 or b5 != cfg.n_layers * ticks
            or b6 != len(shapes) * cfg.n_layers * ticks):
        raise AssertionError(f"SFT adapter serving: B5 {b5}, B6 {b6} for "
                             f"{len(shapes)} projections x {cfg.n_layers} layers "
                             f"x {ticks} ticks")
    if dims != (LORA_S, LORA_POOL, LORA_RANK, "bf16"):
        raise AssertionError(f"SFT adapter served at {dims}, not phase 3c's shapes")
    row = dict(label=m["label"], model=cfg.name, adapter=adapter, requests=len(requests),
               new_tokens=st["tokens_generated"], wall_s=wall, decode_ticks=ticks,
               b5_launches=b5, b6_launches=b6, dims=list(dims),
               per_adapter=st["per_adapter"],
               mean_tick_ms=st["decode_seconds"] / ticks * 1e3,
               reference=lora_reference_check(torch, engine.model, cfg, reg,
                                              control="base"))
    emit("serve_sft_adapter", **row)
    del engine, reg
    gc.collect()
    torch.cuda.empty_cache()
    return row



# ---------------------------------------------------------------------------
# phase 8w: pretrained weights from a local directory, at full width
# ---------------------------------------------------------------------------

#: the families' checkpoint files written from seeded port models (every
#: leaf drawn, biases and norm scales too), in the reference's names and
#: layouts: GPT-2 (fused c_attn, Conv1D, ``transformer.`` prefix, no
#: lm_head), LLaMA-3.2-1B (HF naming, no lm_head: the tying fallback) and
#: LLaMA-2-7B cut to 2 layers (Meta's consolidated.00.pth, w1/w3/w2 =
#: gate/up/down). GPT-2 and LLaMA-3.2-1B also go through the serving CLI.
WEIGHTS = [
    dict(label="gpt2", model="GPT2", size="124M", dtype="fp32", layers=None,
         naming="gpt2", cli=True),
    dict(label="llama3_2", model="llama3_2", size="1B", dtype="bf16",
         layers=None, naming="hf", cli=True),
    dict(label="llama2", model="llama2", size="7B", dtype="bf16", layers=2,
         naming="meta", cli=False),
]
WEIGHTS_SEED = 7


def weights_config(w: dict):
    """The config the CLI builds for ``--load_weights`` of ``w`` (GPT-2
    with q/k/v biases), cut to ``w["layers"]``."""
    from building_llm_from_scratch_tpu_torch.configs import get_config

    cfg = get_config(w["model"], w["size"], dtype=w["dtype"],
                     qkv_bias=True if w["model"] == "GPT2" else None)
    return cfg.replace(n_layers=w["layers"]) if w["layers"] else cfg


def seeded_pretrained(torch, cfg, seed: int, tied: bool):
    """A seeded port model whose every leaf is drawn: the seeded init
    leaves biases at 0 and norm scales at 1, which would make a bias split
    or a norm mapping unobservable. ``tied``: the head is the embedding's
    transpose, as in the checkpoints that ship no head (GPT-2,
    LLaMA-3.2-1B)."""
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model

    model = build_model(cfg, seed, "cuda")
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed + 1)
    with torch.no_grad():
        for name, leaf in model.stacked.items():
            kind = name.rsplit("/", 1)[-1]
            if kind in ("scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"):
                noise = torch.randn(leaf.shape, generator=gen, device=leaf.device)
                leaf.copy_((1.0 if kind == "scale" else 0.0) + 0.05 * noise)
        if tied:
            model.stacked["head/weight"].copy_(model.stacked["tok_emb/weight"].t())
    return model


def hf_state_dict(torch, model, naming: str, control: bool = False) -> list:
    """(name, tensor) pairs of ``model`` in the checkpoint layout of
    ``naming`` (tensors on the card, views where no copy is needed).
    ``control`` writes the layout wrong: GPT-2 with q and k swapped in the
    fused c_attn, Meta without the w2/w3 swap (w2 = up, w3 = down)."""
    p, L = model.stacked, model.cfg.n_layers
    out = []
    if naming == "gpt2":
        q, k = ("wk", "wq") if control else ("wq", "wk")
        bq, bk = ("bk", "bq") if control else ("bq", "bk")
        pre = "transformer."
        out += [(pre + "wte.weight", p["tok_emb/weight"]),
                (pre + "wpe.weight", p["pos_emb/weight"])]
        for b in range(L):
            h = f"{pre}h.{b}."
            out += [
                (h + "ln_1.weight", p["blocks/norm1/scale"][b]),
                (h + "ln_1.bias", p["blocks/norm1/bias"][b]),
                (h + "attn.c_attn.weight", torch.cat(
                    [p[f"blocks/attn/{n}"][b] for n in (q, k, "wv")], dim=-1)),
                (h + "attn.c_attn.bias", torch.cat(
                    [p[f"blocks/attn/{n}"][b] for n in (bq, bk, "bv")], dim=-1)),
                (h + "attn.c_proj.weight", p["blocks/attn/wo"][b]),
                (h + "attn.c_proj.bias", p["blocks/attn/bo"][b]),
                (h + "ln_2.weight", p["blocks/norm2/scale"][b]),
                (h + "ln_2.bias", p["blocks/norm2/bias"][b]),
                (h + "mlp.c_fc.weight", p["blocks/mlp/up"][b]),
                (h + "mlp.c_fc.bias", p["blocks/mlp/b_up"][b]),
                (h + "mlp.c_proj.weight", p["blocks/mlp/down"][b]),
                (h + "mlp.c_proj.bias", p["blocks/mlp/b_down"][b])]
        return out + [(pre + "ln_f.weight", p["final_norm/scale"]),
                      (pre + "ln_f.bias", p["final_norm/bias"])]
    if naming == "hf":
        names = {"attn/wq": "self_attn.q_proj", "attn/wk": "self_attn.k_proj",
                 "attn/wv": "self_attn.v_proj", "attn/wo": "self_attn.o_proj",
                 "mlp/gate": "mlp.gate_proj", "mlp/up": "mlp.up_proj",
                 "mlp/down": "mlp.down_proj"}
        out.append(("model.embed_tokens.weight", p["tok_emb/weight"]))
        for b in range(L):
            h = f"model.layers.{b}."
            out += [(f"{h}{hf}.weight", p[f"blocks/{leaf}"][b].t())
                    for leaf, hf in names.items()]
            out += [(h + "input_layernorm.weight", p["blocks/norm1/scale"][b]),
                    (h + "post_attention_layernorm.weight", p["blocks/norm2/scale"][b])]
        return out + [("model.norm.weight", p["final_norm/scale"])]
    w2, w3 = ("up", "down") if control else ("down", "up")
    names = {"attention.wq": "attn/wq", "attention.wk": "attn/wk",
             "attention.wv": "attn/wv", "attention.wo": "attn/wo",
             "feed_forward.w1": "mlp/gate", "feed_forward.w2": f"mlp/{w2}",
             "feed_forward.w3": f"mlp/{w3}"}
    out += [("tok_embeddings.weight", p["tok_emb/weight"]),
            ("norm.weight", p["final_norm/scale"]),
            ("output.weight", p["head/weight"].t())]
    for b in range(L):
        h = f"layers.{b}."
        out += [(f"{h}{m}.weight", p[f"blocks/{leaf}"][b].t()) for m, leaf in names.items()]
        out += [(h + "attention_norm.weight", p["blocks/norm1/scale"][b]),
                (h + "ffn_norm.weight", p["blocks/norm2/scale"][b])]
    return out


_ST_DTYPES = {"float32": "F32", "bfloat16": "BF16", "float16": "F16"}


def write_safetensors(torch, path: str, tensors: list) -> int:
    """The safetensors format (an 8-byte little-endian header length, a
    JSON table of dtype / shape / byte offsets padded to 8 bytes, the raw
    bytes), written tensor by tensor from the card. Returns the bytes."""
    import struct

    header, offset = {}, 0
    for name, t in tensors:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in tensors:
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return os.path.getsize(path)


def write_checkpoint(torch, model, naming: str, weights_dir: str,
                     control: bool = False) -> int:
    """The family's checkpoint file of ``model`` in ``weights_dir`` (the
    file name the loader's tables give). Returns its bytes."""
    os.makedirs(weights_dir, exist_ok=True)
    tensors = hf_state_dict(torch, model, naming, control)
    if naming == "meta":
        path = os.path.join(weights_dir, "consolidated.00.pth")
        torch.save({k: t.detach().contiguous().cpu().clone() for k, t in tensors}, path)
        return os.path.getsize(path)
    return write_safetensors(torch, os.path.join(weights_dir, "model.safetensors"),
                             tensors)


class HostMemory:
    """Peak resident set size of this process over a block, sampled every
    2 ms from /proc/self/statm."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        return False


def load_leaves(torch, w: dict, cfg, weights_dir: str):
    """``load_hf_weights`` of ``w`` from ``weights_dir`` onto the card,
    timed, with the host's peak RSS over the load and the bytes the
    safetensors reader read (None for a ``.pth``: memory-mapped)."""
    from building_llm_from_scratch_tpu_torch.weights import fetch

    readers = []

    class Counted(fetch.LazyStateDict):
        def __init__(self, paths):
            super().__init__(paths)
            readers.append(self)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lazy, fetch.LazyStateDict = fetch.LazyStateDict, Counted
    try:
        with HostMemory() as mem:
            flat = fetch.load_hf_weights(w["model"], w["size"], cfg,
                                         weights_dir=weights_dir, device="cuda")
            torch.cuda.synchronize()
    finally:
        fetch.LazyStateDict = lazy
    return flat, dict(load_s=time.perf_counter() - t0,
                      read_bytes=sum(r.bytes_read for r in readers) if readers else None,
                      rss_start=mem.start, rss_peak=mem.peak)


def weights_requests(cfg, n: int = 8) -> list:
    """``n`` greedy requests of 16-256 prompt tokens and 32 new tokens."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams

    rng = np.random.default_rng(3)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257))).tolist(),
             SamplingParams(max_new_tokens=32, ignore_eos=True))
            for _ in range(n)]


def phase_weights(torch, workdir: str) -> dict:
    """Each of ``WEIGHTS`` written from a seeded model, then read back
    through ``load_hf_weights(weights_dir=)``: every loaded leaf bit-equal
    to the model's, and the control file (q/k swapped, or the Meta file
    without the w2/w3 swap) must not load bit-equal. GPT-2 and LLaMA-3.2-1B
    are then served through the CLI (``--mode serve --load_weights
    --weights_dir``; 8 slots of 1024, phase 4's B5 shapes): B5 = layers x
    decode ticks, and the greedy tokens equal those of the same weights
    served by the engine in process (an ``--init_params_from`` config
    carries no GPT-2 q/k/v biases, and its export would add 3 GB of disk
    writes for LLaMA). Returns the dirs kept for phase
    8r and B5's launches by shape."""
    from building_llm_from_scratch_tpu_torch.ops.decode_step import fused_decode_step
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine

    out = {"dirs": {}, "launches": {}}
    for w in WEIGHTS:
        cfg = weights_config(w)
        model = seeded_pretrained(torch, cfg, WEIGHTS_SEED, tied=w["naming"] != "meta")
        wdir = os.path.join(workdir, w["label"])
        t0 = time.perf_counter()
        file_bytes = write_checkpoint(torch, model, w["naming"], wdir)
        write_s = time.perf_counter() - t0
        flat, load = load_leaves(torch, w, cfg, wdir)
        off = sorted(k for k, v in model.stacked.items() if not same_bits(torch, v, flat[k]))
        if off or set(flat) != set(model.stacked):
            raise AssertionError(f"{cfg.name}: loaded leaves differ from the "
                                 f"written model's: {off}")
        del flat
        row = dict(model=cfg.name, dtype=w["dtype"], layers=cfg.n_layers,
                   naming=w["naming"], file_bytes=file_bytes, write_s=write_s,
                   **load, rss_over_file=(load["rss_peak"] - load["rss_start"]) / file_bytes)
        if w["naming"] in ("gpt2", "meta"):
            cdir = os.path.join(workdir, w["label"] + "-control")
            write_checkpoint(torch, model, w["naming"], cdir, control=True)
            try:
                bad, _ = load_leaves(torch, w, cfg, cdir)
                differ = sorted(k for k, v in model.stacked.items()
                                if not same_bits(torch, v, bad[k]))
                del bad
                row["control"] = dict(loaded=True, leaves_differing=differ)
                if not differ:
                    raise AssertionError(f"{cfg.name}: the control file loads "
                                         "bit-equal")
            except ValueError as e:              # a shape the layout cannot have
                row["control"] = dict(loaded=False, error=str(e)[:160])
            shutil.rmtree(cdir)
        if w["cli"]:
            requests = weights_requests(cfg)
            m = dict(label=f"weights-{w['label']}", model=w["model"], size=w["size"],
                     dtype=w["dtype"], context=1024, slots=8)
            fused_decode_step.launches = 0          # the main path's count
            eng, got = serve_cli(torch, m, requests, workdir,
                                 flags=["--load_weights", "--weights_dir", wdir])
            launches, st = fused_decode_step.launches, eng.stats()
            if launches != cfg.n_layers * st["n_ticks"] or launches == 0:
                raise AssertionError(f"{cfg.name}: B5 {launches} for {cfg.n_layers} "
                                     f"layers x {st['n_ticks']} ticks")
            # the same weights served by the engine in process (an
            # --init_params_from route would write one more export)
            engine = DecodeEngine(model, n_slots=8, max_len=1024, max_queue=64)
            want = [h.output_ids for h in serve(engine, requests)]
            tokens = [r["token_ids"] for r in got]
            if tokens != want or any(len(t) != 32 for t in tokens):
                raise AssertionError(f"{cfg.name}: the CLI served other tokens from "
                                     "the loaded weights than the engine in process")
            out["launches"][cfg.name] = launches
            row.update(cli_requests=len(requests), cli_ticks=st["n_ticks"],
                       b5_launches=launches, greedy_equal_to="engine in process")
            del eng
        emit("weights", **row)
        out["dirs"][w["label"]] = wdir
        del model
        torch.cuda.empty_cache()
        if w["label"] != "llama3_2":             # phase 8r starts from it
            shutil.rmtree(wdir)
    return out


# ---------------------------------------------------------------------------
# phase 8r: train-state checkpoints, stop and resume through the CLI
# ---------------------------------------------------------------------------

#: GPT-2-124M at the default dtype (fp32, dropout 0.1) pretraining, and
#: LLaMA-3.2-1B bf16 LoRA SFT (rank 16) from phase 8w's pretrained files,
#: each over two files of 9 and 1 steps (the first with one validation
#: batch: 9 steps of training data leave it one); 10 steps, a checkpoint
#: every 5, evaluations at 4 and 8 (in the first file), SIGTERM after step
#: 6, so that the resumed run crosses into the second file.
RESUME = [
    dict(label="gpt2", model="GPT2", size="124M", dtype=None, batch=8,
         context=1024, file_steps=(9, 1), lora=False),
    dict(label="llama3_2-sft", model="llama3_2", size="1B", dtype="bf16", batch=4,
         context=1024, file_steps=(9, 1), lora=True, rank=16, alpha=32.0),
]
RESUME_STOP = 6
RESUME_EVERY = 5
RESUME_EVAL = 4
#: the depth phase 8r runs at: full width cut to 2 layers. The script
#: keeps its disk writes under 45 GiB, and every save of a full-depth
#: state writes 1.96 GB (GPT-2 fp32) or 3.08 GB (the LoRA state's bf16
#: base); ``scripts/resume_phases.py`` runs the phase at full depth alone.
RESUME_LAYERS = 2


def resume_data(t: dict, data_dir: str) -> list:
    """A file for each of ``t["file_steps"]``, sized for that many steps:
    seeded corpora (pretraining; the first 90% of the text is the train
    split) or slices of a ``build_local_alpaca.py`` file (SFT; the first
    90% of the records)."""
    os.makedirs(data_dir, exist_ok=True)
    steps = t["file_steps"]
    if not t["lora"]:
        paths = [os.path.join(data_dir, f"corpus{i}.txt") for i in range(len(steps))]
        for i, (path, n) in enumerate(zip(paths, steps)):
            n_chars = int((n * t["batch"] * t["context"] + t["context"] // 2) / 0.9) - 15
            write_corpus(path, seed=21 + i, n_chars=n_chars)
        return paths
    sizes = [math.ceil(n * t["batch"] / 0.9) for n in steps]
    whole = os.path.join(data_dir, "all.json.tmp")
    write_alpaca(whole, sum(sizes))
    with open(whole) as f:
        records = json.load(f)
    os.remove(whole)
    paths = [os.path.join(data_dir, f"alpaca{i}.json") for i in range(len(steps))]
    for i, (path, n) in enumerate(zip(paths, sizes)):
        with open(path, "w") as f:
            json.dump(records[sum(sizes[:i]):sum(sizes[:i]) + n], f)
    return paths


@contextlib.contextmanager
def step_hook(torch, hook):
    """``hook(state, metrics)`` after every train step of the CLI runs in
    the block (through the trainer's step factory)."""
    import building_llm_from_scratch_tpu_torch.training.trainer as ttr

    make = ttr.make_train_step

    def hooked(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step_fn(state, batch):
            out = inner(state, batch)
            hook(*out)
            return out
        return step_fn

    ttr.make_train_step = hooked
    try:
        yield
    finally:
        ttr.make_train_step = make


@contextlib.contextmanager
def cut_depth(layers):
    """The CLI's configs cut to ``layers`` (None: as configured)."""
    from building_llm_from_scratch_tpu_torch import build_components

    get = build_components.get_config
    if layers:
        build_components.get_config = (
            lambda *a, **k: get(*a, **k).replace(n_layers=layers))
    try:
        yield
    finally:
        build_components.get_config = get


class FallbackChecked(Exception):
    """Ends the fallback run after its first step (its tail is the resumed
    run's, already held)."""


class LogTap(logging.Handler):
    """Keeps the records of the resume discovery's logger."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def resume_cli(torch, t: dict, data_dir: str, out_dir: str, weights_dir,
               layers, extra=(), stop_after=None, crash_after=None):
    """One CLI run of ``t`` (``main.run --mode train``) into ``out_dir`` at
    ``layers``, counted by ``main_path``. ``stop_after``: SIGTERM after
    that step (a preemption). ``crash_after``: the run ends by an
    exception after that step, without a save. Returns (trainer or None,
    facts: launches, the seconds to the first step's end, the steps' losses
    as the hook saw them, the resume discovery's log records)."""
    import signal

    from building_llm_from_scratch_tpu_torch import main as tmain

    flags = ["--mode", "train", "--model", t["model"], "--num_params", t["size"],
             *dtype_flags(t), "--byte_tokenizer", "--data_dir", data_dir,
             "--output_dir", out_dir, "--n_epochs", "1", "--batch_size", str(t["batch"]),
             "--eval_freq", str(RESUME_EVAL), "--print_sample_iter",
             str(sum(t["file_steps"])), "--save_ckpt_freq", str(RESUME_EVERY), *extra]
    if t["lora"]:
        flags += ["--finetune", "--dataset", "alpaca", "--use_lora", "--lora_rank",
                  str(t["rank"]), "--lora_alpha", str(t["alpha"]), "--load_weights",
                  "--weights_dir", weights_dir,
                  "--save_adapter", os.path.join(out_dir, "adapter.npz")]
    facts = {"seen": []}
    t0 = time.perf_counter()

    def hook(state, metrics):
        facts["seen"].append((state.step, metrics["loss"].item()))
        if "first_step_s" not in facts:
            torch.cuda.synchronize()
            facts["first_step_s"] = time.perf_counter() - t0
        if state.step == stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        if state.step == crash_after:
            raise FallbackChecked

    tap = LogTap()
    res_log = logging.getLogger("building_llm_from_scratch_tpu_torch.training.resilience")
    res_log.addHandler(tap)
    trainer = None
    try:
        with main_path(torch, False) as run, step_hook(torch, hook), cut_depth(layers):
            t0 = time.perf_counter()
            try:
                trainer = tmain.run(flags)        # returns: the CLI exits 0
            except FallbackChecked:
                pass
            facts["run_s"] = time.perf_counter() - t0
    finally:
        res_log.removeHandler(tap)
    facts.update(run, log=[(r.levelname, r.getMessage()) for r in tap.records])
    return trainer, facts


def _digest(a) -> str:
    import hashlib

    return hashlib.sha256(a.tobytes()).hexdigest()


def run_record(torch, trainer, facts: dict, out_dir: str) -> dict:
    """What a run's resume is held to: per-step losses, evaluations,
    counts, and the exports read back (each array's bytes as a sha256)."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.models.lora import (
        flatten_lora,
        load_adapter,
    )

    rec = dict(losses=[m["loss"] for m in trainer.step_metrics],
               steps=[m["step"] for m in trainer.step_metrics],
               train_loss=list(trainer.train_losses), val_loss=list(trainer.val_losses),
               global_step=trainer.global_step, tokens_seen=trainer.tokens_seen,
               preempted=trainer.preempted, launches=facts["launches"],
               saves=[dict(tag=s["tag"], step=s["step"], bytes=s["bytes"],
                           seconds=s["seconds"]) for s in trainer.checkpoint_saves],
               restored=trainer.restored, first_step_s=facts.get("first_step_s"),
               run_s=facts["run_s"], log=facts["log"],
               dirs=sorted(n for n in os.listdir(out_dir) if n.startswith("model_pg_")))
    export = os.path.join(out_dir, "model_pg_final.npz")
    if os.path.exists(export):
        with np.load(export) as data:
            rec["export"] = {k: _digest(data[k]) for k in data.files}
    adapter = os.path.join(out_dir, "adapter.npz")
    if os.path.exists(adapter):
        tree, _ = load_adapter(adapter)
        ints = {2: torch.int16, 4: torch.int32}
        rec["adapter"] = {"/".join(p): _digest(v.view(ints[v.element_size()]).numpy())
                          for p, v in flatten_lora(tree).items()}
    return rec


def corrupt_copy(src: str, dst: str, tag: str) -> str:
    """``dst``: ``src`` with its files hard-linked (no bytes copied) except
    one shard of ``model_pg_<tag>``, copied and with its last byte flipped."""
    shutil.copytree(src, dst, copy_function=os.link)
    ck = os.path.join(dst, f"model_pg_{tag}")
    with open(os.path.join(ck, "manifest.json")) as f:
        shard = os.path.join(ck, json.load(f)["leaves"][-1]["shards"][0]["file"])
    with open(shard, "rb") as f:
        data = bytearray(f.read())
    data[-1] ^= 0xFF
    os.remove(shard)                        # break the hard link first
    with open(shard, "wb") as f:
        f.write(data)
    return shard


def expect_tail(name: str, got: dict, ref: dict, start: int) -> None:
    """A resumed run from step ``start`` against the unbroken ``ref``: its
    per-step losses are ref's from step start + 1 on, its evaluations ref's
    last ones, the counts and the final exports equal, bit for bit."""
    n_eval = len(got["train_loss"])
    checks = dict(
        steps=got["steps"] == list(range(start + 1, ref["global_step"] + 1)),
        losses=got["losses"] == ref["losses"][start:],
        evals=(n_eval >= 1 and got["train_loss"] == ref["train_loss"][-n_eval:]
               and got["val_loss"] == ref["val_loss"][-n_eval:]),
        counts=(got["global_step"], got["tokens_seen"]) == (ref["global_step"],
                                                            ref["tokens_seen"]),
        export=got.get("export") == ref["export"],
        adapter=got.get("adapter") == ref.get("adapter"))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{name}: the resumed run differs from the unbroken "
                             f"one in {bad}: {got['losses']} vs {ref['losses'][start:]}")


def phase_resume(torch, card: dict, workdir: str, weights: dict,
                 layers=RESUME_LAYERS, labels=None, repeat: bool = False) -> dict:
    """Train-state checkpoints and resume through the CLI for each of
    ``RESUME`` (``labels``: a subset) at ``layers`` (None: full depth):
    the unbroken command (``--resume off``; with ``repeat`` twice, which
    must agree bit for bit); the same command with ``--keep_ckpts 1``
    stopped by SIGTERM after step 6 (it returns, as the CLI exits 0, with
    an ``interrupted`` checkpoint holding the cursor and no export; its
    steps equal the unbroken run's); the same command again (``--resume
    auto``), whose remaining per-step losses, evaluation, counts and final
    exports must be the unbroken run's bit for bit, crossing into the
    second file, and whose dir must hold the newest step checkpoint beside
    ``interrupted`` and ``final``; and a copy of the stopped run's dir with
    a shard of ``interrupted`` corrupted, which must resume, with an error
    line, from the step-5 checkpoint (its first step equal to the unbroken
    run's step 6; the harness ends it there, without a save). Launches are
    counted in every run (phase 6's rule); each run's dir goes once it is
    checked."""
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        checkpoint_metadata,
    )

    results = {}
    for t in RESUME:
        if labels and t["label"] not in labels:
            continue
        tdir = os.path.join(workdir, t["label"])
        data_dir = os.path.join(tdir, "data")
        resume_data(t, data_dir)
        wdir = weights["dirs"].get("llama3_2")
        dirs = {k: os.path.join(tdir, k) for k in ("a", "b", "c", "e")}
        steps, first = sum(t["file_steps"]), t["file_steps"][0]
        # each evaluation reads 5 train batches and the first file's one
        # validation batch
        evals = lambda lo, hi: sum(1 for s in range(lo + 1, hi + 1)  # noqa: E731
                                   if s % RESUME_EVAL == 0)

        def cli(key, extra=(), **kw):
            return resume_cli(torch, t, data_dir, dirs[key], wdir, layers, extra, **kw)

        def launches_ok(run, lo, hi):
            want = expected_launches(cfg, hi - lo, 6 * evals(lo, hi), False,
                                     lora=t["lora"])
            if run["launches"] != want:
                raise AssertionError(f"{t['label']}: launches {run['launches']} over "
                                     f"steps {lo + 1}-{hi}, expected {want}")

        trainer, facts = cli("a", ["--resume", "off"])
        a = run_record(torch, trainer, facts, dirs["a"])
        cfg = trainer.cfg
        del trainer
        if not (a["global_step"] == steps and all(map(math.isfinite, a["losses"]
                                                      + a["train_loss"] + a["val_loss"]))
                and a["losses"][-1] < a["losses"][0]
                and len(a["train_loss"]) == evals(0, steps)):
            raise AssertionError(f"{t['label']}: the unbroken run: {a['losses']}, "
                                 f"{a['train_loss']}, {a['val_loss']}")
        launches_ok(a, 0, steps)
        b = None
        if repeat:
            trainer, facts = cli("b", ["--resume", "off"])
            b = run_record(torch, trainer, facts, dirs["b"])
            del trainer
            same = {k: a.get(k) == b.get(k) for k in ("losses", "train_loss", "val_loss",
                                                      "export", "adapter", "launches")}
            if not all(same.values()):
                raise AssertionError(f"{t['label']}: two unbroken runs differ: {same}")
            shutil.rmtree(dirs["b"])
        torch.cuda.empty_cache()

        keep = ["--keep_ckpts", "1"]
        trainer, facts = cli("c", keep, stop_after=RESUME_STOP)
        c = run_record(torch, trainer, facts, dirs["c"])
        del trainer
        meta = checkpoint_metadata(os.path.join(dirs["c"], "model_pg_interrupted"))
        if (not c["preempted"] or c["global_step"] != RESUME_STOP
                or c["losses"] != a["losses"][:RESUME_STOP]
                or meta.get("cursor", {}).get("file_index") != 0
                or meta["cursor"]["batch_index"] != RESUME_STOP
                or "export" in c or c["dirs"] != ["model_pg_5", "model_pg_interrupted"]):
            raise AssertionError(f"{t['label']}: the stopped run: {c['dirs']}, "
                                 f"{meta}, preempted {c['preempted']}")
        launches_ok(c, 0, RESUME_STOP)
        shard = corrupt_copy(dirs["c"], dirs["e"], "interrupted")

        trainer, facts = cli("c", keep)
        d = run_record(torch, trainer, facts, dirs["c"])
        del trainer
        torch.cuda.empty_cache()
        expect_tail(f"{t['label']} resume", d, a, RESUME_STOP)
        if d["restored"]["step"] != RESUME_STOP or d["dirs"] != [
                "model_pg_10", "model_pg_final", "model_pg_final.npz",
                "model_pg_interrupted"] or first >= steps:
            raise AssertionError(f"{t['label']}: resume from {d['restored']}, "
                                 f"left {d['dirs']}")
        launches_ok(d, RESUME_STOP, steps)

        fallback = RESUME_EVERY
        _, facts = cli("e", keep, crash_after=fallback + 1)
        e = dict(seen=facts["seen"], first_step_s=facts["first_step_s"],
                 launches=facts["launches"], run_s=facts["run_s"])
        torch.cuda.empty_cache()
        loud = [m for lvl, m in facts["log"] if lvl == "ERROR" and "INVALID" in m
                and "model_pg_interrupted" in m]
        if not loud or e["seen"] != [(fallback + 1, a["losses"][fallback])]:
            raise AssertionError(f"{t['label']}: the corrupt checkpoint was not "
                                 f"skipped loudly to step {fallback}: {facts['log']}, "
                                 f"{e['seen']}")
        launches_ok(e, fallback, fallback + 1)
        slim = lambda r: r and {k: v for k, v in r.items()  # noqa: E731
                                if k not in ("export", "adapter", "log")}
        emit("resume", model=cfg.name, dtype=t["dtype"] or "fp32", layers=cfg.n_layers,
             batch=t["batch"], context=t["context"], lora=t["lora"],
             card=card["card_line"], corrupted_shard=os.path.relpath(shard, tdir),
             fallback_log=loud[0][:200], unbroken=slim(a), repeat=slim(b),
             stopped=slim(c), resumed=slim(d), fallback=slim(e))
        results[t["label"]] = dict(model=cfg.name, launches=a["launches"],
                                   resumed_launches=d["launches"],
                                   fallback_launches=e["launches"])
        shutil.rmtree(tdir)
    return results


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    try:
        import building_llm_from_scratch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 4

    import tempfile

    card = phase_env(torch)
    phase_build()
    rows = phase_kernel(torch, card)
    paged_rows = phase_paged_kernel(torch, card, rows)
    lora_rows = phase_lora_kernel(torch, card)
    # serving runs before training: its ticks are host-bound, and a clean
    # process keeps them comparable with earlier runs
    served = phase_serve(torch)
    served.update(phase_serve_longctx(torch))
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        served_paged = phase_serve_paged(torch, workdir)
        served_lora = phase_serve_lora(torch, workdir)
    attn_rows = phase_attention(torch, card)
    drop_attn_rows = phase_attention_dropout(torch, card)
    dropout_rows = phase_dropout(torch, card)
    xent_rows = phase_xent(torch, card)
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        trained, trained_gpt2, trained_gpt2_fp32, trained_fp32 = (
            phase_train(torch, card, os.path.join(workdir, name), t)
            for name, t in (("llama", TRAIN), ("gpt2", TRAIN_GPT2),
                            ("gpt2-fp32", TRAIN_GPT2_FP32), ("llama-fp32", TRAIN_FP32)))
        # precision policies, accumulation and remat (6m), host overlap (6h)
        mixed = phase_mixed(torch, card, os.path.join(workdir, "mixed"),
                            dict(llama=trained, gpt2_fp32=trained_gpt2_fp32))
        overlap = phase_host_overlap(torch, os.path.join(workdir, "overlap"))
    # LoRA SFT (phase 6s); the LLaMA run's adapter is served (phase 4c);
    # one SFT step against the CPU (phase 7s)
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        sft = phase_sft(torch, card, os.path.join(workdir, "llama"), SFT[0],
                        trained["pretrain"])
        phase_serve_sft_adapter(torch, sft["adapter"], workdir)
        phase_sft(torch, card, os.path.join(workdir, "gpt2"), SFT[1],
                  trained_gpt2_fp32["pretrain"])
        for spec in SFT_REFERENCES:
            phase_sft_reference(torch, spec, workdir)
    reference = phase_train_reference(torch, REFERENCES[0])
    reference_gpt2 = phase_train_reference(torch, REFERENCES[1])
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        phase_mixed_reference(torch, workdir)
    # pretrained weights from local files (8w), then train-state checkpoints
    # and resume through the CLI (8r, the LoRA run from 8w's LLaMA files)
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        weights = phase_weights(torch, os.path.join(workdir, "weights"))
        resumed = phase_resume(torch, card, os.path.join(workdir, "resume"), weights)
    for r in rows:
        shape = (r["S"], r["Hq"], r["Hkv"], r["hd"], r["Tmax"], r["dtype"])
        if served[r["shape"]]["shape"] != shape:
            raise AssertionError(f"{r['shape']}: served at "
                                 f"{served[r['shape']]['shape']}, not {shape}")
    kernels = [dict(name=f"fused_decode_step[{r['shape']}]", route="cuda",
                    source="building_llm_from_scratch_tpu_torch/csrc/decode_step.cu",
                    replaces="building_llm_from_scratch_tpu/ops/decode_step.py:37",
                    launches=served[r["shape"]]["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    kernel_ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"]) for r in rows]
    for k, r in zip(kernels, rows):                 # phase 8w's CLI serving
        if r["shape"] in weights["launches"]:
            k["launches_8w"] = weights["launches"][r["shape"]]
    paged_runs = {v["shape"]: v for v in served_paged.values() if v["paged"]}
    for r in paged_rows:
        run = paged_runs[r["shape"]]
        dims = (r["S"], r["Hq"], r["Hkv"], r["hd"], r["P"], r["M"], r["dtype"])
        if run["dims"] != dims:
            raise AssertionError(f"{r['shape']}: served paged at {run['dims']}, "
                                 f"not {dims}")
        kernels.append(dict(
            name=f"paged_decode_attention[{r['shape']}]", route="cuda",
            source="building_llm_from_scratch_tpu_torch/csrc/paged_decode.cu",
            replaces="building_llm_from_scratch_tpu/ops/decode_step.py:259",
            launches=run["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            b5_contiguous_ms=r["b5_contiguous_ms"]))
    for r in lora_rows:
        run = served_lora[r["shape"]]
        if run["dims"] != (r["S"], r["N"], r["r"], r["dtype"]):
            raise AssertionError(f"{r['shape']}: served with adapters at "
                                 f"{run['dims']}, not {(r['S'], r['N'], r['r'], r['dtype'])}")
        kernels.append(dict(
            name=f"lora_bgmv[{r['shape']}-{r['D']}x{r['O']}]", route="cuda",
            source="building_llm_from_scratch_tpu_torch/csrc/bgmv.cu",
            replaces="building_llm_from_scratch_tpu/ops/decode_step.py:184",
            launches=run["tally"].get((r["D"], r["O"]), 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], projections=r["projections"]))
    replaces = {"fwd": ("flash_attention_fwd",
                        "building_llm_from_scratch_tpu/ops/fused_attention.py:75"),
                "dq": ("flash_attention_dq",
                       "building_llm_from_scratch_tpu/ops/fused_attention.py:120"),
                "dkv": ("flash_attention_dkv",
                        "building_llm_from_scratch_tpu/ops/fused_attention.py:160")}
    attn_runs = {"llama3_2-1B-train": trained["main"],
                 "llama3_2-1B-train-fp32": trained_fp32["main"],
                 "llama3_2-1B-ref": reference["fp32"]["launches"],
                 "llama3_2-1B-ref-bf16": reference["bf16"]["launches"],
                 "gpt2-124M-train": trained_gpt2["main"],
                 "gpt2-124M-train-fp32": trained_gpt2_fp32["main"],
                 "gpt2-124M-ref": reference_gpt2["fp32"]["launches"],
                 "gpt2-124M-train-fp16": mixed["gpt2-fp16-policy"]["launches"]}
    source = "building_llm_from_scratch_tpu_torch/csrc/"
    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops.fused_attention import kernel_source

    # phase 8r's runs, by the training shape they ran at
    resume_runs = {"gpt2-124M-train-fp32": resumed["gpt2"],
                   "llama3_2-1B-train": resumed["llama3_2-sft"]}

    def other_launches(row: dict, shape: str, counter: str) -> None:
        run = resume_runs.get(shape)
        if run is not None and counter in run["launches"]:
            row["launches_8r"] = {k: run[k][counter] for k in (
                "launches", "resumed_launches", "fallback_launches")}
        # the shape's runs in phase 6m (bf16 and fp16 policies, fp32
        # accumulation, LLaMA remat) and 6h (GPT-2 bf16 synchronous and
        # overlapped)
        m6 = {label: r["launches"][counter] for label, r in mixed.items()
              if r["shape"] == shape and shape != "gpt2-124M-train-fp16"}
        if m6:
            row["launches_6m"] = m6
        if shape == "gpt2-124M-train":
            row["launches_6h"] = {k: r["launches"][counter] for k, r in overlap.items()}

    for r in attn_rows + drop_attn_rows:
        kname, where = replaces[r["kernel"]]
        tag = f"{r['shape']}-p{r['rate']}" if "rate" in r else r["shape"]
        src = kernel_source(DTYPE_MAP[r["dtype"]], r["kernel"])
        kernels.append(dict(
            name=f"{kname}[{tag}]", route="cuda", source=source + src,
            replaces=where, launches=attn_runs[r["shape"]][r["kernel"]],
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        other_launches(kernels[-1], r["shape"], r["kernel"])
    dropout_where = {"fwd": ("dropout_fwd", "dropout_fwd",
                             "building_llm_from_scratch_tpu/ops/fused_dropout.py:36"),
                     "fwd_add": ("dropout_fwd", "dropout_fwd",
                                 "building_llm_from_scratch_tpu/ops/fused_dropout.py:44"),
                     "bwd": ("dropout_bwd", "dropout_bwd",
                             "building_llm_from_scratch_tpu/ops/fused_dropout.py:48")}
    for r in dropout_rows:
        kname, counter, where = dropout_where[r["kernel"]]
        tag = "-add" if r["kernel"] == "fwd_add" else ""
        dt = "" if r["shape"].endswith(r["dtype"]) else f"-{r['dtype']}"
        kernels.append(dict(
            name=f"{kname}[{r['shape']}{dt}{tag}]", route="cuda",
            source=source + "fused_dropout.cu", replaces=where,
            launches=attn_runs[r["shape"]][counter], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        other_launches(kernels[-1], r["shape"], counter)
    xent_runs = {"gpt2-124M-train": trained_gpt2["xent_kernel"],
                 "gpt2-124M-train-fp32": trained_gpt2_fp32["xent_kernel"],
                 "gpt2-124M-train-fp16": mixed["gpt2-fp16-policy"]["launches"]}
    for r in xent_rows:
        kernels.append(dict(
            name=f"xent_fwd[{r['shape']}]", route="cuda", source=source + r["route"],
            replaces="building_llm_from_scratch_tpu/ops/xent_fwd_pallas.py:32",
            launches=xent_runs[r["shape"]]["xent_fwd"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if r["shape"] == "gpt2-124M-train-fp32":     # the sums loss, 6m
            kernels[-1]["launches_6m"] = {
                "gpt2-fp32-accum2": mixed["gpt2-fp32-accum2"]["launches"]["xent_fwd"]}
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    # every kernel of the new paths ran on them: B5 in 8w's CLI serving,
    # B1/B2a/B2b (and B3 with GPT-2's dropout) in each of 8r's runs
    if sorted(weights["launches"]) != ["gpt2-124M", "llama3_2-1B"] or not all(
            weights["launches"].values()):
        raise AssertionError(f"phase 8w: B5 launches {weights['launches']}")
    for label, run in resumed.items():
        need = ("fwd", "dq", "dkv") + (("dropout_fwd", "dropout_bwd")
                                        if label == "gpt2" else ())
        if any(run[k][c] < 1 for k in ("launches", "resumed_launches",
                                        "fallback_launches") for c in need):
            raise AssertionError(f"phase 8r {label}: a kernel was not launched: {run}")
    emit("io", **written_bytes())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["card_line"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
