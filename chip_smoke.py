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
     After phase 6s, the trained adapter's serving (4c), 4d, and 4s / 4q /
     4o's gates run while phases 7s / 7 / 7m run in a second process
     (``chip_smoke.py --references``, ``references_beside``); they take
     no timing there, and 4s / 4q / 4o's times are taken after it ends.
     4s. speculative decoding: LLaMA-3.2-1B (bf16) and GPT-2-124M (fp32)
     at full depth, 8 slots of 1024, 8 templated requests (a shared
     128-token system span, a 24-token field repeated three times) of 128
     new tokens, every fourth seeded-sampled, spec_k 4; contiguous, and
     paged with the prefix cache (the system span a hit). The spec-off
     engine first (B5 / B7 = layers x ticks), then the n-gram, oracle and
     never-right drafters: (a) all three commit the same tokens, (b) the
     oracle accepts more than half its drafts and the never-right fewer
     than a fifth, (c) a control whose verify mask lets query j see the
     drafts after it commits other tokens (contiguous), (d) each request's first token
     where spec on and spec off part, with the top-2 margin of the logits
     there (B5 and the plain verify differ in arithmetic). No verify tick
     launches B5 or B7. Then, alone on the host and with 64 new tokens on
     contiguous slots: tick ms, tokens a tick, decode tokens/s and
     acceptance, spec on against off (B5), and int8's.
     4q. int8 KV: the same models and requests (64 new tokens), contiguous
     and paged: B5 = B7 = B6 = 0 on the int8 ticks, the KV data bytes
     exactly 1 / element size of the model dtype's, logits within the JAX
     package's 0.15 of the model-dtype cache on the same prompt (B5 / B7
     there, teacher-forced), the slots an 8 GB KV budget holds under each
     policy; LLaMA-3.2-1B int8 with phase 4c's three adapters on the
     contiguous tick: B6 = adapted projections x layers x ticks, by shape.
     4o. serving operations, LLaMA-3.2-1B bf16 at full depth, 8 slots of
     1024: contiguous then paged, 8 greedy requests fault-free and again
     beside a poison prefill and a NaN-poisoned slot (``FaultHooks``):
     each poison fails alone, the co-residents' tokens are the fault-free
     run's bit for bit, a request re-served in the freed slot gets its
     tokens, B5 / B7 = layers x ticks; the HTTP frontend on loopback probed
     row by row against the JAX frontend's status map (413, 400, 404, 429
     with Retry-After, 503 while draining, 200); a hung tick with no
     restart budget turns ``/healthz`` to ``dead`` (POST 500); the paged
     engine's eviction under a byte budget holding one system prompt, its
     admission bounce on a pool of two worst-case rows (greedy tokens those
     of the unconstrained run) and adapter hot-load and evict under load
     (B6 = 7 x layers x ticks by shape; an evicted adapter's in-flight rows
     bit-equal to it served alone, its queued request failed alone, a
     submit naming it refused); GPT-2-124M fp32 through ``--mode serve
     --metrics_jsonl`` in a child process, SIGTERM after the first line:
     exit 0, every line written, a ``drain`` start / end in the JSONL.
     After the references: the hung tick under the watchdog
     (``--serve_tick_timeout`` 1 s) contiguous and paged: 8 in-flight
     failed, 2 queued served with their fault-free tokens, 0 kernel builds
     or loads, seconds from the fire to the first token, the peak it adds;
     tick ms with the supervisor on and off (off / on / on / off), drain
     seconds over 16 requests, the HTTP round trip against a direct submit
     and the ``/metrics`` scrape. The card tests hold B5 and B7 against
     their twins with a NaN row and NaN tails (tests/test_torch_cuda.py).
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
     served by the CLI (LLaMA fp32's is counted, not written). The run's own rate (all steps over their wall time,
     the trainer's window) and each step's device time (CUDA events around
     every step, step 1 apart); then steady step time, tokens/s, MFU, peak
     memory and a profiled window over re-runs of one batch (with the
     flash family's ms per step; the GQA group_sum must not run); MFU
     against the run dtype's dense peak (bf16 tensor cores, fp32 CUDA
     cores). For GPT-2, in bf16 and at the default dtype, the same 20
     steps again with BLLM_XENT_PALLAS=1: B4 = steps + eval batches, and
     the step-1 loss equal to the first run's to 1e-5. Each run's ``final``
     train state is counted, not written (phase 8r writes them). The
     LLaMA bf16 and GPT-2 fp32 runs carry the training telemetry
     (``--metrics_jsonl``, ``--log_every 5``, ``--stall_timeout 120``): every
     row valid under the port's schema, a cadence row every 5 steps with
     the JAX keys whose MFU equals the by-hand MFU of its window (its
     tokens over its step seconds, this script's FLOPs a token, the
     dtype's peak) to 1e-9, ``hbm_peak_bytes`` the allocator's peak once
     the step returned, finite health rows over L + the top-level groups,
     no stall; then the health bundle's own device ms on the run's state.
  6p. ``--profile --profile_steps 3`` on GPT-2-124M fp32 (p 0.1, B 8 x T
     1024, 3 steps) through the CLI: the exported Chrome trace's regions
     (data_wait, dispatch, forward, backward, optimizer) and its kernel
     events, B1 / B2a / B2b at layers x steps and B3 forward and backward
     at 25 a step, each kernel put in the region around its launch; the
     device ms a step of forward, backward, optimizer and the health
     bundle, printed beside the card.
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
  9t. text in and out: synthetic BPE files written from a seed
     (``scripts/build_local_bpe.py``: 3,000 merges learned on a text of
     accents, CJK, emoji, digit runs, contractions, CRLF and runs of
     spaces, padded with tokens of the bytes 0xF8-0xFF to Meta's 128,000
     and GPT-2's 50,256 ranks); the tokenizers' host figures (encode MB/s
     with the piece cache cold and warm, decode MB/s, the loads);
     LLaMA-3.2-1B bf16 pretraining through the CLI with --tokenizer_path
     and --tokenizer_cache_dir (B 4 x T 1024, 12 steps), relaunched into a
     fresh output directory: the loader's ids are ``tok.encode`` of the
     corpus and its first batch their windows, the relaunch reads the cache
     file (nothing tokenized) and repeats the losses bit for bit; GPT-2-124M
     fp32 LoRA SFT with B4 on GPT-2 BPE ids (8 steps, in process: the
     synthetic files are not tiktoken's): every record's prompt mask at
     ``len(encode(prompt))``; text prompts served by LLaMA-3.2-1B bf16
     (CLI) and GPT-2-124M fp32 (in process, with ``stream()`` and
     ``on_token``) at phase 4's shapes: greedy ids equal those of the same
     requests as ``prompt_ids``, ``text`` = ``decode(ids)``, the stream
     joins to it, B5 = layers x ticks; the hold rule on a split character;
     the tick with a tokenizer against the tick without (alternating
     windows). Launches exact; no train state or export is written.
  10d. data parallelism, FSDP and ZeRO-1 (``parallel/``). The CLI with
     ``--run_type multi_chip`` on the one card, where the launcher forms a
     one-rank NCCL group: LLaMA-3.2-1B bf16 pretraining (B 4 x T 1024, 10
     steps) under dp, fsdp and zero1, and its LoRA SFT (rank 16) under
     fsdp, each against the single_chip run of the same flags: per-step
     losses and evaluations bit for bit, launches exact, the group NCCL
     with one rank and its collectives counted; step ms beside
     single_chip's. Two ranks on the one card over gloo (NCCL refuses
     two ranks on one device; in a thread beside the reference window,
     before 10t / 10s / 10p's groups), spawned and driven through the
     library API
     (``initialize_distributed(backend="gloo")``, the plan, the sharded
     step), each on cuda:0: GPT-2-124M fp32 (12 layers, B 4 x T 1024 a
     rank, B4 on, dropout 0), 3 steps under dp, zero1, fsdp and a control
     that steps each rank alone on its rows; rank 0 also one rank on the
     global batch (B 8). Gates: zero1 bit-equal to dp; dp, fsdp and zero1
     within 1e-5 of the one rank (losses; the parameters' relative L2, all
     leaves as one vector) and every leaf within 1e-3 of its own norm; the
     control outside the 1e-5; each rank's moment bytes half of dp's up to
     the final norm's; the memory each rank holds between steps (its
     allocated bytes after the steps) smaller under fsdp than under zero1,
     and under zero1 than under dp (the peak is printed beside it); one
     bf16_hybrid fsdp step reducing every gradient in
     bf16; one step with dropout 0.1 on the same rows on both ranks whose
     loss shares differ (the rank folded into the seed); B1-B4 launches
     exact per rank. The step ms there are gloo's host staging, labelled
     so.
  6r. selective-save remat: LLaMA-3.2-1B bf16 (B 4 x T 1024) and
     GPT-2-124M fp32 (B 8 x T 1024, p 0.1), 4 steps of the library's train
     step each under save-all (the model's ``_SAVE_ALL``), selective (the default,
     which every other phase runs) and full remat (use_actv_ckpt): losses
     bit-equal across the three, launches exact (B1 twice a layer only
     under full remat), selective's peak below save-all's; step ms and
     each peak (``max_memory_allocated``). Phase 10d also gates fsdp's
     step peak per gloo rank below zero1's (it gathers the blocks layer by
     layer).
  10t / 10s. tensor and sequence parallelism on gloo ranks on the one card
     (``phase_mesh``: spawned ranks on cuda:0, the library API; beside the
     reference window, ``gloo_groups_beside``), full
     width, 2 steps: GPT-2-124M fp32 at tp 2 with p 0 and p 0.1,
     LLaMA-3.2-1B bf16 at tp 2 (8 layers; the vocab-parallel head and
     loss), GPT-2 fp32 p 0.1 and LLaMA bf16 (8 layers) at sp 2 (the ring,
     T 512 a rank), and GPT-2 tp_fsdp on four ranks (2, 1, 2); the GPT-2
     runs at 6 of its 12 layers (10p's time bought back). Each
     against one rank on the global batch: every rank's losses equal, the
     losses' largest relative difference and the parameters' relative L2
     within the run's bounds (fp32 1e-5; bf16 pinned beside the control),
     and a control outside them (tp: the row-parallel all-reduce skipped;
     sp: the k / v blocks never passed on); launches exact per rank (B1/B2
     at the rank's heads under tp, none under sp). The ring's ms a step and
     every step's gloo-staged ms. Before them, B3 on a sequence block with
     its layout: bit-equal to the twins and to the whole tensor's mask.
     Phases 5 and 5b also hold B1/B2 at a tp rank's heads (LLaMA Hq 16
     Hkv 4 bf16; GPT-2 H 6 fp32, with dropout at rank 1's head offset 6,
     whose mask is heads 6-11 of the whole model's).
  10p. pipeline parallelism in the same groups (``MESH_RUNS``' pp runs:
     the GPipe schedule, ``--shard_mode pp``'s library API): GPT-2-124M
     fp32 (12 layers, 6 a stage, p 0.1; 2 steps) and LLaMA-3.2-1B bf16 (8
     layers; 1 step) at pp 2, B 8 x T 1024 in 4 microbatches, then one
     evaluation, and GPT-2 fp32 p 0 at pp 2 x tp 2 (1, 2, 2) on the four
     ranks (1 step). Each
     against one rank on the global batch drawing the same folded masks
     (``dropout_stages``): every rank's losses equal, the bounds as 10t's
     (fp32 1e-5; bf16 pinned beside the control), the control outside them
     (every forward hop's activation zeroed: left unsent); B1 / B2a / B2b /
     B3a / B3b launches exact per stage rank ((L/S) x M a train step, B1
     again per evaluation; B3 2 (L/S) x M, plus M on stage 0 for the
     embedding). The step ms (gloo-staged) and the bubble share (S-1) /
     (M+S-1). Phase 10d's world-1 NCCL part adds LLaMA-3.2-1B bf16
     through the CLI with ``--shard_mode pp --pp 1 --pp_micro 4`` against
     single_chip's losses within a bound pinned beside a control (every
     step's last microbatch with its gradient zeroed), launches exact.
     Phases 5, 5b and 5c hold B1-B3 at the pp microbatches' shapes.
  9. the bytes the script and its reference process wrote to disk, the
     ``kernels`` line (one row per kernel and shape, each with the launches
     of the run at that shape; B6 by projection shape from phase 4c, with
     4q's int8 adapter run as ``launches_4q`` and 4o's hot-load run as
     ``launches_4o``; B5's and B7's rows add 4s's spec-off runs as
     ``launches_4s`` and 4o's isolation and restart runs as
     ``launches_4o``, B5's 8w's and 9t's CLI launches, the training rows 8r's, 6m's, 6h's, 6r's, 9t's,
     10d's and 10s's, per rank for the gloo ranks; the tp-shape rows read
     10t's rank 0, the pp-shape rows 10p's stage 0 and every rank's as
     ``launches_10p``), then the card line and the result line.

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
import tempfile
import threading
import time


_T0 = time.perf_counter()


#: one line at a time from the main thread and ``gloo_groups_beside``'s
_EMIT_LOCK = threading.Lock()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase, with the script's elapsed seconds."""
    line = json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 1),
                       **fields})
    with _EMIT_LOCK:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def written_bytes() -> dict:
    """What this process wrote (Linux ``/proc/self/io``): ``wchar``, the
    bytes passed to write calls (files, and the few on stdout), and
    ``write_bytes``, what reached storage. The card's machine caps a
    call's disk writes."""
    with open("/proc/self/io") as f:
        fields = dict(ln.split(": ") for ln in f.read().splitlines())
    return {k: int(fields[k]) for k in ("wchar", "write_bytes")}




def flash_peak(fig: dict, dtype: str) -> float:
    """The operations/s that bound a flash kernel: the 16-bit tensor-core
    rate, or for fp32 the fp32-grade rate of 3xTF32 on the tensor cores
    (three TF32 products per product: a third of the TF32 rate)."""
    return fig["peak_tf32"] / 3 if dtype == "fp32" else fig["peak16"]


def card_figures(name: str) -> tuple:
    """(table key, figures) of the card: NVIDIA's data-sheet memory rate
    and dense peaks (16-bit and TF32 tensor cores, fp32 CUDA cores) from
    the port's one table, ``obs/mfu.DEVICE_SPECS``; a card it does not name
    is taken as the H100 SXM."""
    from building_llm_from_scratch_tpu_torch.obs.mfu import DEVICE_SPECS
    from building_llm_from_scratch_tpu_torch.obs.mfu import card_figures as figures

    return figures(name) or ("H100 SXM", DEVICE_SPECS["H100 SXM"])


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def physical_cores() -> int:
    """Distinct (package, core) pairs in /proc/cpuinfo (0 when unreadable)."""
    cores, pkg = set(), None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key == "physical id":
                    pkg = val.strip()
                elif key == "core id":
                    cores.add((pkg, val.strip()))
    except OSError:
        return 0
    return len(cores)


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
    emit("env", nvidia_smi=card_line, device=name, host_cpus=os.cpu_count(),
         host_cores=physical_cores(),
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
    # a tensor-parallel rank's heads at tp 2 (phase 10t): LLaMA-3.2-1B bf16
    # Hq 16, Hkv 4; GPT-2-124M fp32 H 6 (B 4, the global batch)
    ("llama3_2-1B-tp2", 4, 16, 4, 1024, 64, "bf16"),
    ("gpt2-124M-tp2-fp32", 4, 6, 6, 1024, 64, "fp32"),
    # a pipeline microbatch (phase 10p: B 8 in 4 microbatches): LLaMA-3.2-1B
    # bf16 at pp 2; GPT-2-124M fp32 at pp 2 x tp 2 (a tp rank's 6 heads)
    ("llama3_2-1B-pp2", 2, 32, 8, 1024, 64, "bf16"),
    ("gpt2-124M-pp2-tp2-fp32", 2, 6, 6, 1024, 64, "fp32"),
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
    # rank 1's heads of GPT-2-124M at tp 2 (phase 10t, p 0.1): their masks
    # are heads 6-11 of the whole model's (ATTN_H0)
    ("gpt2-124M-tp2-fp32", 4, 6, 6, 1024, 64, "fp32"),
    # GPT-2-124M's pipeline microbatch at pp 2 (phase 10p, p 0.1)
    ("gpt2-124M-pp2-fp32", 2, 12, 12, 1024, 64, "fp32"),
]
DROP_RATE = 0.1
#: the global index of a shape's first head (a tensor-parallel rank's)
ATTN_H0 = {"gpt2-124M-tp2-fp32": 6}


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
        h0 = ATTN_H0.get(shape, 0)
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        q, k, v = rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd)
        do = rnd(B, T, Hq, hd)
        kern = (tfa.flash_attention_fwd, tfa.flash_attention_dq, tfa.flash_attention_dkv)
        plain = (tfa.fused_attention_fwd_plain, tfa.fused_attention_dq_plain,
                 grouped_dkv_plain)

        def run(fwd, dq_fn, dkv_fn, s=seed):
            out, lse = fwd(q, k, v, DROP_RATE, s, h0=h0)
            delta = tfa.attention_delta(out, do)
            return (out, lse, dq_fn(q, k, v, do, lse, delta, DROP_RATE, s, h0=h0)) + tuple(
                dkv_fn(q, k, v, do, lse, delta, DROP_RATE, s, h0=h0))

        got = run(*kern)
        torch.cuda.synchronize()
        twin = run(*plain)
        keep = tfa.keep_mask(seed, B, Hq, T, DROP_RATE, dev, h0)
        if h0 and not torch.equal(keep, tfa.keep_mask(seed, B, h0 + Hq, T, DROP_RATE,
                                                      dev)[:, h0:]):
            raise AssertionError(f"{shape}: heads {h0}.. are not the whole model's")
        causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        keep_fraction = keep[:, :, causal].float().mean().item()
        same = torch.equal(keep, tfa.keep_mask(seed, B, Hq, T, DROP_RATE, dev, h0))
        differ = (keep != tfa.keep_mask(seed + 1, B, Hq, T, DROP_RATE, dev, h0)
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
            "fwd": (lambda: kern[0](q, k, v, DROP_RATE, seed, h0=h0),
                    lambda: plain[0](q, k, v, DROP_RATE, seed, h0=h0)),
            "dq": (lambda: kern[1](q, k, v, do, lse, delta, DROP_RATE, seed, h0=h0),
                   lambda: plain[1](q, k, v, do, lse, delta, DROP_RATE, seed, h0=h0)),
            "dkv": (lambda: kern[2](q, k, v, do, lse, delta, DROP_RATE, seed, h0=h0),
                    lambda: plain[2](q, k, v, do, lse, delta, DROP_RATE, seed, h0=h0)),
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
                  ("gpt2-124M-train-fp16", 8 * 1024, 768, "fp16"),
                  ("gpt2-124M-pp2-fp32", 2 * 1024, 768, "fp32")]


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
             steps=20, keep_final=True, telemetry=True)
# GPT-2-124M as configured (drop_rate 0.1), the chunked cross entropy its
# width takes; then the same run with the opt-in B4 forward (in both dtypes)
TRAIN_GPT2 = dict(model="GPT2", size="124M", dtype="bf16", batch=8, context=1024,
                  steps=20, xent_run=True)
# fp32, the trainer's default dtype: GPT-2-124M through the CLI without
# --data_type (dtype None), and LLaMA-3.2-1B in fp32 (its flash rows'
# launches)
TRAIN_GPT2_FP32 = dict(model="GPT2", size="124M", dtype=None, batch=8, context=1024,
                       steps=20, xent_run=True, telemetry=True)
#: phase 6's telemetry (the LLaMA bf16 and GPT-2 fp32 runs): a cadence
#: row every TELEMETRY_EVERY steps, the flight recorder armed
TELEMETRY_EVERY = 5
TELEMETRY_STALL_S = 120
#: the JAX trainer's cadence-row keys (the XLA-only mfu_hlo / mfu_delta
#: aside); prefetch_* ride beside them with --prefetch
TELEMETRY_KEYS = {"step", "lr", "tokens_seen", "tok_s", "mfu", "step_time_s",
                  "data_wait_s", "dispatch_s", "host_fetch_s", "steps_in_window",
                  "grad_norm", "update_norm", "hbm_bytes_in_use", "hbm_peak_bytes",
                  "host_rss_bytes"}
#: phase 6p: GPT-2-124M fp32 (p 0.1) through the CLI with --profile
PROFILE_RUN = dict(model="GPT2", size="124M", dtype=None, batch=8, context=1024,
                   steps=3)
TRAIN_FP32 = dict(model="llama3_2", size="1B", dtype="fp32", batch=4, context=1024,
                  steps=20, export=False)


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


#: the train step's profiler regions (``record_function``), not kernels
STEP_REGIONS = ("forward", "backward", "optimizer", "health")


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
        # the step's named regions show on the device as spans over their
        # kernels: kernels only, or the busy time counts them twice
        if getattr(ev, "is_user_annotation", False) or ev.key in STEP_REGIONS:
            continue
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
                      lora: bool = False, grad_accum: int = 1,
                      eval_micro: int = 1) -> dict:
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
    saved). ``eval_micro``: the microbatches of an evaluation (pp's
    ``--pp_micro``, whose train microbatches ``grad_accum`` counts)."""
    L, remat = cfg.n_layers, cfg.use_actv_ckpt
    micro = steps * grad_accum
    drops = (1 + 2 * L) * micro if cfg.drop_rate > 0 else 0
    drops_bwd = drops - micro if lora and drops else drops
    if remat and drops:
        drops += L * micro
    return dict(fwd=L * ((2 if remat else 1) * micro + eval_batches * eval_micro),
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
    clock at each step's call), supervised, wall_s, peak_gb and
    peak_after_step (the allocator's peak bytes once each step's launch
    returned)."""
    import building_llm_from_scratch_tpu_torch.training.trainer as ttr

    kernels = train_kernels()
    events, supervised, starts, peaks = [], [], [], []
    makers = {k: getattr(ttr, k) for k in ("make_train_step", "make_sharded_train_step",
                                            "make_pp_train_step")}

    def timed(make):
        return lambda *args, **kwargs: timed_step_of(make(*args, **kwargs))

    def timed_step_of(step):
        def timed_step(state, batch):
            starts.append(time.perf_counter())
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = step(state, batch)
            pair[1].record()
            events.append(pair)
            peaks.append(torch.cuda.max_memory_allocated())
            if "weights" in batch:
                supervised.append(batch["weights"].sum())
            return out
        return timed_step

    torch.cuda.reset_peak_memory_stats()
    env = os.environ.get("BLLM_XENT_PALLAS")
    os.environ["BLLM_XENT_PALLAS"] = "1" if xent_kernel else "0"
    for f in kernels.values():
        f.launches = 0                              # the main path's count
    for k, make in makers.items():
        setattr(ttr, k, timed(make))
    facts = {}
    t0 = time.perf_counter()
    try:
        yield facts
        torch.cuda.synchronize()
    finally:
        for k, make in makers.items():
            setattr(ttr, k, make)
        if env is None:
            os.environ.pop("BLLM_XENT_PALLAS")
        else:
            os.environ["BLLM_XENT_PALLAS"] = env
    facts.update(wall_s=time.perf_counter() - t0,
                 launches={k: f.launches for k, f in kernels.items()},
                 step_starts=starts,
                 run_step_ms=[a.elapsed_time(b) for a, b in events],
                 supervised=[float(w) for w in supervised],
                 peak_after_step=peaks,
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
    if t.get("telemetry") and not xent_kernel:
        flags += telemetry_flags(out_dir)
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
    # pp: every train and eval step runs its --pp_micro microbatches
    micro = trainer.plan.n_micro if getattr(trainer.plan, "shard_mode", None) == "pp" else 1
    want = expected_launches(cfg, steps, eval_batches, xent_kernel,
                             grad_accum=trainer.grad_accum * micro, eval_micro=micro)
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
                 step_starts=run["step_starts"], peak_after_step=run["peak_after_step"],
                 # main.py draws it with matplotlib, or warns that it did not
                 losses_pdf=os.path.exists(os.path.join(out_dir, "losses.pdf")))
    return trainer, facts


def telemetry_flags(out_dir: str) -> list:
    """Phase 6's telemetry flags: the metrics JSONL in the run's output
    directory, a row every TELEMETRY_EVERY steps, the flight recorder."""
    return ["--metrics_jsonl", os.path.join(out_dir, "metrics.jsonl"),
            "--log_every", str(TELEMETRY_EVERY),
            "--stall_timeout", str(TELEMETRY_STALL_S)]


def check_telemetry(card: dict, t: dict, trainer, facts: dict) -> dict:
    """The run's metrics JSONL: every row of a registered type and every
    event valid under the port's schema; a cadence row every
    TELEMETRY_EVERY steps with the JAX keys, whose ``mfu`` equals the MFU
    computed here from the row's own window (its steps x B x T tokens over
    step_time_s x steps, this script's FLOPs a token, the dtype's peak) to
    1e-9 relative; ``hbm_peak_bytes`` the allocator's peak as it stood once
    the row's step returned (``torch.cuda.max_memory_allocated``, within
    16 MiB above it); a health row per cadence row, finite, with L + the
    top-level names as groups; no ``stall`` event."""
    from building_llm_from_scratch_tpu_torch.obs import schema

    path = os.path.join(facts["out_dir"], "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    cfg = trainer.cfg
    problems = [r.get("type") for r in rows if r.get("type") not in schema.ROW_TYPES]
    for r in rows:
        if r["type"] == "event":
            problems += schema.validate_event(
                r["event"], {k: v for k, v in r.items() if k not in ("type", "time",
                                                                     "event")})
    metrics = [r for r in rows if r["type"] == "metrics"]
    health = [r for r in rows if r["type"] == "health"]
    want_steps = list(range(TELEMETRY_EVERY, t["steps"] + 1, TELEMETRY_EVERY))
    if [r["step"] for r in metrics] != want_steps or \
            [r["step"] for r in health] != want_steps:
        problems.append(f"cadence rows at {[r['step'] for r in metrics]}, health "
                        f"at {[r['step'] for r in health]}, not {want_steps}")
    fpt = train_flops_per_token(cfg)
    dt = t["dtype"] or "fp32"
    peak = card["figures"]["peak32" if dt == "fp32" else "peak16"]
    by_hand, mfu_rel, hbm = [], [], []
    for r in metrics:
        missing = TELEMETRY_KEYS - set(r)
        if missing:
            problems.append(f"row {r['step']} lacks {sorted(missing)}")
            continue
        n = r["steps_in_window"]
        hand = n * t["batch"] * t["context"] / (r["step_time_s"] * n) * fpt / peak
        by_hand.append(hand)
        mfu_rel.append(abs(r["mfu"] - hand) / hand)
        after = facts["peak_after_step"][r["step"] - 1]
        hbm.append(dict(step=r["step"], row=r["hbm_peak_bytes"], after_step=after))
        if not after <= r["hbm_peak_bytes"] <= after + (16 << 20):
            problems.append(f"row {r['step']}: hbm_peak_bytes {r['hbm_peak_bytes']} "
                            f"against the allocator's {after}")
    if not mfu_rel or max(mfu_rel) > 1e-9:
        problems.append(f"mfu against the by-hand MFU: {mfu_rel}")
    tops = {k.split("/")[0] for k in trainer.state.params} - {"blocks"}
    groups = cfg.n_layers + len(tops)
    for r in health:
        arrays = [r[k] for k in ("grad_norm", "param_norm", "update_norm",
                                 "update_ratio")]
        if len(r["groups"]) != groups or any(len(a) != groups for a in arrays) or \
                not all(isinstance(x, float) and math.isfinite(x)
                        for a in arrays for x in a) or r["first_nonfinite"] is not None:
            problems.append(f"health row {r['step']}: {len(r['groups'])} groups "
                            f"(want {groups}), first_nonfinite {r['first_nonfinite']}")
    stalls = [r for r in rows if r.get("event") == "stall"]
    if stalls:
        problems.append(f"the flight recorder fired: {stalls}")
    if problems:
        raise AssertionError(f"{cfg.name} telemetry: {problems}")
    last = metrics[-1]
    return dict(rows=len(rows), types=sorted({r["type"] for r in rows}),
                events=sorted({r["event"] for r in rows if r["type"] == "event"}),
                cadence_steps=want_steps, mfu=[r["mfu"] for r in metrics],
                mfu_by_hand=by_hand, mfu_max_rel_diff=max(mfu_rel),
                tok_s=[r["tok_s"] for r in metrics],
                step_time_s=[r["step_time_s"] for r in metrics],
                data_wait_s=[r["data_wait_s"] for r in metrics],
                dispatch_s=[r["dispatch_s"] for r in metrics],
                host_fetch_s=[r["host_fetch_s"] for r in metrics],
                hbm_peak=hbm, host_rss_bytes=last["host_rss_bytes"],
                grad_norm=[r["grad_norm"] for r in metrics],
                update_norm=[r["update_norm"] for r in metrics],
                health_groups=groups, health_first_groups=health[-1]["groups"][:3],
                max_update_ratio=max(max(r["update_ratio"]) for r in health),
                stall_events=0, stall_timeout_s=TELEMETRY_STALL_S)


def health_bundle_ms(torch, trainer) -> dict:
    """The health bundle's own device time at the run's width: the step's
    ``GroupSums`` over the state's gradients, parameters and (a stand-in of
    the same shapes and dtypes) the parameters again as updates, timed as
    one call (CUDA events, L2 flushed). Bound: its bytes (each tree read
    once, the gradients twice: the sums and the finiteness pass) over the
    memory rate."""
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    state = trainer.state
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def bundle():
        sums = tts._health_sums(state, None)
        for kind, tree in (("grad", state.grads), ("update", state.params),
                           ("param", state.params)):
            sums.add(kind, tree)
        return sums.bundle()

    ms = device_time_ms(torch, bundle, flush, runs=10, warmup=2)
    nbytes = 4 * sum(v.numel() * v.element_size() for v in state.params.values())
    return dict(health_ms=ms, bytes=nbytes,
                bound_ms=nbytes / card_figures(torch.cuda.get_device_name(0))[1]["bw"]
                * 1e3, groups=len(bundle()["grad_norm"]))


def phase_profile(torch, card: dict, workdir: str) -> dict:
    """Phase 6p: GPT-2-124M fp32 (p 0.1, B 8 x T 1024) through the CLI with
    ``--profile --profile_steps 3`` over its 3 steps. The exported Chrome
    trace must hold the data_wait / dispatch / forward / backward /
    optimizer regions and the kernels of the steps at exactly layers x
    steps: B1 (``attn_fwd_f32_kernel``), B2a (``attn_dq_f32_kernel``), B2b
    (``attn_dkv_f32_kernel``), and B3's ``dropout_kernel`` at its 25 a step
    (1 + 2 x layers) under forward (B3a) and under backward (B3b); a
    kernel belongs to the innermost named region around its launch (the
    runtime or driver launch call of the same correlation id) on the
    step's thread, or to backward when autograd's device thread launched
    it. Prints each region's device ms a step (the health bundle's inside
    optimizer apart)."""
    from building_llm_from_scratch_tpu_torch import main as tmain

    t = PROFILE_RUN
    data_dir = os.path.join(workdir, "data")
    out_dir = os.path.join(workdir, "out")
    os.makedirs(data_dir, exist_ok=True)
    windows = t["steps"] * t["batch"]
    n_chars = int((windows * t["context"] + t["context"] // 2) / 0.9) - 15
    write_corpus(os.path.join(data_dir, "corpus.txt"), seed=11, n_chars=n_chars)
    t0 = time.perf_counter()
    # the final train state and export are counted, not written (the disk cap)
    with final_checkpoint_unwritten(), export_unwritten(write=False):
        trainer = tmain.run(["--mode", "train", "--model", t["model"], "--num_params",
                             t["size"], "--byte_tokenizer", "--data_dir", data_dir,
                             "--output_dir", out_dir, "--n_epochs", "1", "--batch_size",
                             str(t["batch"]), "--eval_freq", "1000",
                             "--print_sample_iter", "1000", "--save_ckpt_freq", "1000",
                             "--profile", "--profile_steps", str(t["steps"])])
    wall_s = time.perf_counter() - t0
    steps, L = trainer.global_step, trainer.cfg.n_layers
    with open(trainer.profile_trace) as f:
        trace_bytes = f.seek(0, 2)
        f.seek(0)
        events = json.load(f)["traceEvents"]
    regions = STEP_REGIONS
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")) for e in events
             if e.get("ph") == "X" and e.get("name") in regions + (
                 "data_wait", "dispatch")]
    names = {n for _a, _b, n, _t in spans}
    main_tid = next(t for _a, _b, n, t in spans if n == "forward")
    launch = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def region_of(k) -> str:
        """The innermost named region around the kernel's launch on the
        step's thread; a launch from another thread is the backward's
        (autograd's device thread runs the CUDA backward)."""
        ts, tid = launch.get(k.get("args", {}).get("correlation"), (None, None))
        if ts is None:
            return "none"
        if tid != main_tid:
            return "backward"
        inside = [(b - a, n) for a, b, n, t in spans if n in regions and t == tid
                  and a <= ts <= b]
        return min(inside)[1] if inside else "none"

    counts, ms = {}, {}
    for k in kernels:
        where = region_of(k)
        ms[where] = ms.get(where, 0.0) + k["dur"] / 1e3
        for label, key in (("B1", "attn_fwd_f32_kernel"), ("B2a", "attn_dq_f32_kernel"),
                           ("B2b", "attn_dkv_f32_kernel"), ("B3", "dropout_kernel")):
            if key in k["name"]:
                if label == "B3":
                    label += {"forward": "a", "backward": "b"}.get(where, f"@{where}")
                counts[label] = counts.get(label, 0) + 1
    want = {"B1": L * steps, "B2a": L * steps, "B2b": L * steps,
            "B3a": (1 + 2 * L) * steps, "B3b": (1 + 2 * L) * steps}
    missing = {"data_wait", "dispatch", "forward", "backward", "optimizer"} - names
    result = dict(model=trainer.cfg.name, steps=steps, layers=L, wall_s=wall_s,
                  trace_mb=trace_bytes / 1e6, kernel_events=len(kernels),
                  counts=counts, expected=want,
                  ms_per_step={k: v / steps for k, v in sorted(ms.items())})
    emit("profile", **result)
    if steps != t["steps"] or missing or counts != want:
        raise AssertionError(f"phase 6p: {missing} regions missing, kernel "
                             f"events {counts} against {want}")
    per = result["ms_per_step"]
    print(f"profile split (device ms a step, GPT-2-124M fp32): forward "
          f"{per.get('forward', 0.0):.3f}, backward {per.get('backward', 0.0):.3f}, "
          f"optimizer {per.get('optimizer', 0.0):.3f}, health "
          f"{per.get('health', 0.0):.3f}; {card['card_line']}", flush=True)
    del trainer
    shutil.rmtree(workdir, ignore_errors=True)
    return result


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
    served = []
    if t.get("export", True):
        # the export loads back and is served by the CLI (--mode serve
        # --init_params_from); LLaMA fp32's 4.9 GB export is counted, not
        # written (its run is here for the fp32 flash rows' launches)
        export = os.path.join(facts["out_dir"], "model_pg_final.npz")
        check_export(torch, trainer, facts["out_dir"])
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
    # every logging window's tokens over their summed training seconds
    window_tps = trainer.tokens_seen / trainer.step_seconds_total
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
    if t.get("telemetry"):
        tele = dict(check_telemetry(card, t, trainer, facts),
                    **health_bundle_ms(torch, trainer), step_ms=step_ms)
        emit("telemetry", model=cfg.name, dtype=dt, card=card["card_line"], **tele)
        print(f"health bundle {cfg.name} {dt}: {tele['health_ms']:.3f} ms a step "
              f"(bound {tele['bound_ms']:.3f}, step {step_ms:.2f} ms); "
              f"{card['card_line']}", flush=True)
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
                  export_bytes_unwritten=getattr(trainer, "export_unwritten_bytes",
                                                 None),
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
            # the model without attention: every block through autograd
            # (save-all), whose attention is causal_attention's
            attention = ttf.causal_attention
            ttf.causal_attention = lambda q, k, v, **kw: torch.zeros_like(q)
            ttf._SAVE_ALL = True
            try:
                ctl_loss, ctl_grads = one_step(ttf.Transformer(cfg, cpu_flat))
            finally:
                ttf.causal_attention = attention
                ttf._SAVE_ALL = False
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
                              if str(ev.device_type).endswith("CUDA")
                              and not getattr(ev, "is_user_annotation", False)
                              and ev.key not in STEP_REGIONS)
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
# phases 4s / 4q: speculative decoding and int8 KV
# ---------------------------------------------------------------------------

#: full width and depth, seeded weights: 8 slots of 1024, SPEC_REQUESTS
#: templated requests of SPEC_NEW new tokens, spec_k SPEC_K. Engines keep
#: a SPEC_PANE-token prefix pane (warmup_prompt_cap) so the shared system
#: span is what a paged prefix hit serves.
SPEC_MODELS = [
    dict(label="llama3_2-1B", model="llama3_2", size="1B", dtype="bf16",
         context=1024, slots=8),
    dict(label="gpt2-124M", model="GPT2", size="124M", dtype="fp32",
         context=1024, slots=8),
]
SPEC_K, SPEC_NEW, SPEC_REQUESTS, SPEC_PANE = 4, 128, 8, 128
#: new tokens of the timing runs (the gates' requests, shorter)
SPEC_TIMING_NEW = 64
#: the int8 runs' budget, and the KV byte budget whose slots 4q prints
INT8_NEW, KV_BUDGET_GB = 64, 8
#: the JAX package's pinned int8-vs-model-dtype logits bound
INT8_LOGITS_ATOL = 0.15


def spec_requests(cfg, seed: int) -> list:
    """SPEC_REQUESTS templated prompts, as in extraction or code work: a
    shared SPEC_PANE-token system span (a prefix hit when paged), then a
    24-token field repeated three times between 8-token fillers (216
    tokens in all); SPEC_NEW new tokens, eos ignored; every fourth row
    sampled (T 0.8, top-k 40, seeded), the rest greedy."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.serving.request import (
        SamplingParams,
    )

    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    system = rng.integers(0, V, SPEC_PANE)
    out = []
    for i in range(SPEC_REQUESTS):
        field = rng.integers(0, V, 24)
        body = np.concatenate([field, rng.integers(0, V, 8), field,
                               rng.integers(0, V, 8), field])
        sampled = i % 4 == 3
        sp = SamplingParams(max_new_tokens=SPEC_NEW,
                            temperature=0.8 if sampled else 0.0,
                            top_k=40 if sampled else None, seed=3000 + i,
                            ignore_eos=True)
        out.append((np.concatenate([system, body]).tolist(), sp))
    return out


def spec_drafters(sequences) -> dict:
    """The oracle (drafts the continuation of recorded sequences) and the
    never-right drafter (always token 3), beside which the n-gram drafter
    runs."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.serving.spec import Drafter

    class Oracle(Drafter):
        def __init__(self):
            self.seqs = [np.asarray(s, np.int32) for s in sequences]

        def propose(self, history, k):
            L = history.shape[0]
            for seq in self.seqs:
                if L <= seq.shape[0] and np.array_equal(seq[:L], history):
                    cont = seq[L:L + k]
                    return np.concatenate([cont, np.full(
                        (k - cont.shape[0],), history[-1], np.int32)])
            return super().propose(history, k)

    class NeverRight(Drafter):
        def propose(self, history, k):
            return np.full((k,), 3, np.int32)

    return {"oracle": Oracle(), "never_right": NeverRight()}


@contextlib.contextmanager
def leaky_verify_mask():
    """The 4s control: the verify's attention with every query at its row's
    last candidate position, so query j sees the drafts after it. Only the
    verify's Tq = SPEC_K + 1 calls change (chunks are wider)."""
    import building_llm_from_scratch_tpu_torch.models.transformer as ttf

    attend = ttf.decode_attention

    def leaky(q, k_cache, v_cache, *, q_positions, kv_length, **kw):
        if q.shape[1] == SPEC_K + 1:
            q_positions = q_positions.amax(dim=1, keepdim=True).expand_as(q_positions)
        return attend(q, k_cache, v_cache, q_positions=q_positions,
                      kv_length=kv_length, **kw)

    ttf.decode_attention = leaky
    try:
        yield
    finally:
        ttf.decode_attention = attend


def spec_engine(model, m: dict, paged: bool, kv_quant: str = "model", **kw):
    """An engine of ``m``'s slots: contiguous, or paged with the prefix
    cache (chunks of PREFILL_CHUNK, pages of PAGE_TOKENS)."""
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
    from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy

    pol = KVCachePolicy(kv_quant=kv_quant, prefix_cache=paged, paged=paged,
                        prefill_chunk=PREFILL_CHUNK if paged else 0,
                        page_tokens=PAGE_TOKENS)
    return DecodeEngine(model, n_slots=m["slots"], max_len=m["context"],
                        max_queue=64, warmup_prompt_cap=SPEC_PANE,
                        kv_policy=pol, **kw)


def spec_run(torch, model, m: dict, requests: list, paged: bool, **kw) -> dict:
    """Serve ``requests`` through a fresh engine; the tokens, finish
    reasons, stats and the decode kernels' launches counted from 0."""
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds

    engine = spec_engine(model, m, paged, **kw)
    for f in (tds.fused_decode_step, tds.paged_decode_attention, tds.lora_bgmv):
        f.launches = 0
    handles = serve(engine, requests)
    torch.cuda.synchronize()
    st = engine.stats()
    out = dict(tokens=[list(h.output_ids) for h in handles],
               reasons=[h.finish_reason for h in handles], stats=st,
               b5=tds.fused_decode_step.launches,
               b7=tds.paged_decode_attention.launches,
               b6=tds.lora_bgmv.launches, engine=engine)
    for (_, sp), toks, why in zip(requests, out["tokens"], out["reasons"]):
        if why != "length" or len(toks) != sp.max_new_tokens:
            raise AssertionError(f"{m['label']}: a request ended {why} after "
                                 f"{len(toks)}/{sp.max_new_tokens} tokens")
    return out


def spec_rates(st: dict) -> dict:
    """A run's acceptance, tokens a tick (the engine's, and a decoding
    row's: 1 spec off; with spec on each row's verify ticks are its
    drafted / spec_k), tick ms and decode tokens/s."""
    ticks = st["n_ticks"]
    out = dict(ticks=ticks, tokens_per_tick=st["decode_tokens"] / ticks,
               tokens_per_row_tick=1.0,
               tick_ms=st["decode_seconds"] / ticks * 1e3,
               decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"])
    if "spec_k" in st:
        out["acceptance"] = st.get("spec_acceptance_ratio", 0.0)
        out["tokens_per_row_tick"] = (st["decode_tokens"] * st["spec_k"]
                                      / st["spec_tokens_drafted"])
    return out


def first_divergence(torch, model, cfg, prompt, a: list, b: list):
    """(index, top-2 margin) of the first token where ``a`` and ``b`` part,
    the margin of the logits a one-shot prefill of prompt + a[:index] gives
    at that position; (None, None) when they agree."""
    from building_llm_from_scratch_tpu_torch.generate import _bucket
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        init_slot_cache,
        prefill_into_slot,
    )

    idx = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if idx is None:
        return None, None
    ids = list(prompt) + list(a[:idx])
    Tpb = min(_bucket(len(ids)), cfg.context_length)
    tokens = torch.zeros((1, Tpb), dtype=torch.long, device=model.device)
    tokens[0, :len(ids)] = torch.tensor(ids, device=model.device)
    cache = init_slot_cache(cfg, 1, Tpb, model.device)
    top = prefill_into_slot(model, tokens, len(ids), 0, cache).topk(2).values
    return idx, (top[0] - top[1]).item()


def phase_serve_spec(torch) -> dict:
    """Phase 4s's gates (no timing: phases 7s / 7 / 7m run beside them in
    another process). For each model, contiguous and paged with a prefix
    hit: the spec-off engine (B5 / B7 counted), then spec_k SPEC_K under
    the n-gram, oracle and never-right drafters and the control."""
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model

    served = {}
    for m in SPEC_MODELS:
        cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                         target_context_length=m["context"])
        model = build_model(cfg, seed=0, device="cuda")
        requests = spec_requests(cfg, seed=9)
        for paged in (False, True):
            label = f"{m['label']}-{'paged' if paged else 'contiguous'}"
            off = spec_run(torch, model, m, requests, paged)
            ticks, L = off["stats"]["n_ticks"], cfg.n_layers
            if (off["b5"], off["b7"]) != ((0, L * ticks) if paged else (L * ticks, 0)):
                raise AssertionError(f"{label}: spec off, B5/B7 {off['b5']}/"
                                     f"{off['b7']} for {L} x {ticks} ticks")
            ngram = spec_run(torch, model, m, requests, paged, spec_k=SPEC_K)
            seqs = [p + t for (p, _), t in zip(requests, ngram["tokens"])]
            runs = {"ngram": ngram}
            for name, drafter in spec_drafters(seqs).items():
                runs[name] = spec_run(torch, model, m, requests, paged,
                                      spec_k=SPEC_K, drafter=drafter)
            control = None
            if not paged:           # the control once a model
                with leaky_verify_mask():
                    control = spec_run(torch, model, m, requests, paged,
                                       spec_k=SPEC_K)
            for name, r in runs.items():
                # the verify tick never launches B5 or B7
                if (r["b5"], r["b7"]) != (0, 0):
                    raise AssertionError(f"{label} {name}: B5/B7 {r['b5']}/{r['b7']}")
                if r["tokens"] != ngram["tokens"]:
                    raise AssertionError(f"{label}: the {name} drafter committed "
                                         "other tokens than the n-gram drafter")
            acc = {k: r["stats"]["spec_acceptance_ratio"] for k, r in runs.items()}
            if not (acc["oracle"] > 0.5 and acc["never_right"] < 0.2):
                raise AssertionError(f"{label}: acceptance {acc}")
            control_differs = control and sum(
                a != b for a, b in zip(control["tokens"], ngram["tokens"]))
            if control and not control_differs:
                raise AssertionError(f"{label}: the leaky-mask control commits the "
                                     "sound verify's tokens: gate (a) cannot fail")
            hits = off["stats"].get("prefix_store", {}).get("hits")
            if paged and not (hits and ngram["stats"]["prefix_store"]["hits"]):
                raise AssertionError(f"{label}: no prefix hit: {off['stats']}")
            divergence = []
            for i, ((p, sp), a, b) in enumerate(zip(requests, ngram["tokens"],
                                                     off["tokens"])):
                idx, margin = first_divergence(torch, model, cfg, p, a, b)
                divergence.append(dict(request=i, greedy=sp.temperature == 0,
                                       first_diverging=idx, top2_margin=margin))
            emit("serve_spec", label=label, model=cfg.name, dtype=m["dtype"],
                 layers=L, slots=m["slots"], max_len=m["context"], paged=paged,
                 spec_k=SPEC_K, requests=len(requests), new_tokens=SPEC_NEW,
                 prompt_tokens=len(requests[0][0]),
                 spec_off_launches=dict(b5=off["b5"], b7=off["b7"], ticks=ticks),
                 acceptance=acc,
                 drafted={k: r["stats"]["spec_tokens_drafted"] for k, r in runs.items()},
                 ticks={k: r["stats"]["n_ticks"] for k, r in runs.items()},
                 prefix_hits=hits, drafters_agree=True,
                 control_requests_differing=control_differs,
                 control_acceptance=control and control["stats"]["spec_acceptance_ratio"],
                 spec_vs_off_divergence=divergence,
                 spec_equals_off=sum(d["first_diverging"] is None for d in divergence),
                 kv_bytes=ngram["stats"]["kv_bytes"],
                 note="gates only; phases 7s / 7 / 7m ran beside them")
            served[label] = dict(launches=off["b7"] if paged else off["b5"],
                                 shape=m["label"], paged=paged)
        del model, runs, ngram, off, control        # the engines hold caches
        gc.collect()
        torch.cuda.empty_cache()
    return served


def int8_logits_check(torch, model, cfg, paged: bool) -> dict:
    """The same 200-token prompt prefilled into a model-dtype cache and an
    int8 one through the card's serving functions, then 8 decode ticks of
    2 rows on each, teacher-forced on the model-dtype greedy tokens (B5, or
    B7 paged, against the plain int8 attention): the largest logit
    difference, beside the logits' rms."""
    from building_llm_from_scratch_tpu_torch.models import transformer as ttf
    from building_llm_from_scratch_tpu_torch.serving.kvcache import KVCachePolicy

    dev = model.device
    gen = torch.Generator().manual_seed(17)
    Tp, S, T = 200, 2, 256
    prompt = torch.randint(0, cfg.vocab_size, (1, T), generator=gen).to(dev)
    lengths = torch.full((S,), Tp, dtype=torch.int32, device=dev)
    logits = {}
    for quant in ("model", "int8"):
        if paged:
            pol = KVCachePolicy(kv_quant=quant, paged=True, page_tokens=PAGE_TOKENS,
                                prefill_chunk=PREFILL_CHUNK)
            cache = pol.alloc(cfg, S, T, dev)
            M = pol.pages_per_slot(T)
            table = torch.arange(1, S * M + 1, dtype=torch.int32,
                                 device=dev).view(S, M).flip(1).contiguous()
            for s in range(S):
                for lo in range(0, Tp, PREFILL_CHUNK):
                    last = ttf.paged_prefill_chunk_into_slot(
                        model, prompt[:, lo:lo + PREFILL_CHUNK], lo, Tp,
                        table[s:s + 1], cache, T)
        else:
            cache = KVCachePolicy(kv_quant=quant).alloc(cfg, S, T, dev)
            for s in range(S):
                last = ttf.prefill_into_slot(model, prompt, Tp, s, cache)
        rows = [last]
        toks = logits.get("model", rows)[0].argmax().view(1, 1).repeat(S, 1)
        lens = lengths.clone()
        for _ in range(8):
            out = (ttf.paged_decode_slots(model, toks, lens, table, cache, T)
                   if paged else ttf.decode_slots(model, toks, lens, cache))
            rows.append(out[0])
            toks = (logits["model"][len(rows) - 1].argmax().view(1, 1).repeat(S, 1)
                    if quant == "int8" else out.argmax(-1).view(S, 1))
            lens += 1
        logits[quant] = rows
    delta = max((a - b).abs().max().item()
                for a, b in zip(logits["int8"], logits["model"]))
    rms = min(b.pow(2).mean().sqrt().item() for b in logits["model"])
    if not (0 < delta <= INT8_LOGITS_ATOL):
        raise AssertionError(f"{cfg.name} {'paged' if paged else 'contiguous'}: "
                             f"int8 logits {delta} from the model-dtype cache's "
                             f"(bound {INT8_LOGITS_ATOL})")
    return dict(max_abs_diff=delta, logits_rms_min=rms, ticks=8, prompt=Tp,
                bound=INT8_LOGITS_ATOL)


def phase_serve_int8(torch, workdir: str) -> dict:
    """Phase 4q's gates (no timing; phases 7s / 7 / 7m run beside them):
    each model contiguous and paged on int8 KV (SPEC_REQUESTS requests of
    INT8_NEW tokens), then LLaMA-3.2-1B int8 with phase 4c's three adapters
    on the contiguous tick."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
    from building_llm_from_scratch_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )
    from building_llm_from_scratch_tpu_torch.serving.kvcache import (
        KVCachePolicy,
        cache_nbytes,
    )

    out = {}
    for m in SPEC_MODELS:
        cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                         target_context_length=m["context"])
        model = build_model(cfg, seed=0, device="cuda")
        requests = [(p, dataclasses.replace(sp, max_new_tokens=INT8_NEW))
                    for p, sp in spec_requests(cfg, seed=9)]
        width = torch.empty((), dtype=cfg.torch_dtype).element_size()
        for paged in (False, True):
            label = f"{m['label']}-{'paged' if paged else 'contiguous'}-int8"
            run = spec_run(torch, model, m, requests, paged, kv_quant="int8")
            st, eng = run["stats"], run["engine"]
            if (run["b5"], run["b7"], run["b6"]) != (0, 0, 0) or st["n_ticks"] == 0:
                raise AssertionError(f"{label}: B5/B7/B6 {run['b5']}/{run['b7']}/"
                                     f"{run['b6']} on int8 ticks")
            # the same engine's k/v in the model dtype, from its policy
            model_pol = dataclasses.replace(eng.kv_policy, kv_quant="model")
            model_kv = (eng.page_pool.n_pages * model_pol.page_bytes(cfg) if paged
                        else m["slots"] * model_pol.bytes_per_slot(
                            cfg, eng._cache_len)["kv_bytes"])
            kv = cache_nbytes({k: eng.cache[k] for k in ("k", "v")})
            if kv * width != model_kv:
                raise AssertionError(f"{label}: int8 KV data {kv} bytes, the "
                                     f"model dtype's {model_kv}")
            emit("serve_int8", label=label, model=cfg.name, dtype=m["dtype"],
                 layers=cfg.n_layers, slots=m["slots"], max_len=m["context"],
                 paged=paged, requests=len(requests), new_tokens=INT8_NEW,
                 decode_ticks=st["n_ticks"], b5_launches=run["b5"],
                 b7_launches=run["b7"], b6_launches=run["b6"],
                 kv_data_bytes=kv, model_dtype_kv_bytes=model_kv,
                 kv_fraction_of_model_dtype=kv / model_kv,
                 cache_bytes=st["kv_bytes"],
                 logits=int8_logits_check(torch, model, cfg, paged),
                 note="gates only; phases 7s / 7 / 7m ran beside them")
            del run, eng
        # the KV byte budget's slots (1024 tokens a slot) under each policy
        fits = {}
        for quant in ("model", "int8"):
            pol = KVCachePolicy(kv_quant=quant)
            b = pol.bytes_per_slot(cfg, m["context"])
            fits[quant] = dict(bytes_per_slot=b["total_bytes"],
                               kv_bytes_per_slot=b["kv_bytes"],
                               scale_bytes_per_slot=b["scale_bytes"],
                               slots=int(KV_BUDGET_GB * 1e9 // b["total_bytes"]))
        emit("serve_int8_budget", model=cfg.name, dtype=m["dtype"],
             budget_gb=KV_BUDGET_GB, tokens_per_slot=m["context"], policies=fits)
        out[m["label"]] = dict(fits=fits)
        if m["model"] == "llama3_2":
            # int8 with adapters: the contiguous tick still sends every
            # projection's delta through B6
            names = ["a", "b", "c", None]
            specs, _ = write_adapters(torch, model, cfg, {"a": 8, "b": 16, "c": 16},
                                      workdir, "int8")
            reg = AdapterRegistry.from_artifacts(cfg, specs, capacity=LORA_POOL,
                                                 device="cuda")
            launch = tds.lora_bgmv
            counted = ShapeTally(launch)
            tds.lora_bgmv = counted
            try:
                run = spec_run(torch, model, m, [
                    (p, dataclasses.replace(sp, adapter=names[i % 4]))
                    for i, (p, sp) in enumerate(requests)], False,
                    kv_quant="int8", adapters=reg)
            finally:
                tds.lora_bgmv = launch
            ticks, shapes = run["stats"]["n_ticks"], _projection_shapes(cfg)
            want = {}
            for d_in_out in shapes.values():
                want[d_in_out] = want.get(d_in_out, 0) + cfg.n_layers * ticks
            if (run["b5"], run["b7"]) != (0, 0) or counted.by_shape != want \
                    or run["b6"] != len(shapes) * cfg.n_layers * ticks:
                raise AssertionError(f"int8 + adapters: B5 {run['b5']}, B6 "
                                     f"{run['b6']} ({counted.by_shape}) for "
                                     f"{len(shapes)} x {cfg.n_layers} x {ticks}")
            emit("serve_int8_lora", model=cfg.name, dtype=m["dtype"],
                 adapters={"a": 8, "b": 16, "c": 16}, pool_rows=reg.capacity,
                 pool_rank=reg.max_rank, decode_ticks=ticks,
                 b5_launches=run["b5"], b6_launches=run["b6"],
                 b6_launches_by_shape={f"{d}x{o}": n
                                       for (d, o), n in counted.by_shape.items()},
                 per_adapter=run["stats"]["per_adapter"])
            out["lora"] = dict(tally=dict(counted.by_shape),
                               dims=(m["slots"], reg.capacity, reg.max_rank,
                                     m["dtype"]))
            del run, reg
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_serve_spec_timing(torch) -> None:
    """Phase 4s / 4q's times, taken with nothing else running: for each
    model on contiguous slots, the spec-off engine (B5) against spec_k
    SPEC_K (n-gram drafter) and int8 KV (spec off), on the gates'
    requests cut to SPEC_TIMING_NEW new tokens: tick ms, tokens a tick,
    decode tokens/s and acceptance."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model

    for m in SPEC_MODELS:
        cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                         target_context_length=m["context"])
        model = build_model(cfg, seed=0, device="cuda")
        requests = [(p, dataclasses.replace(sp, max_new_tokens=SPEC_TIMING_NEW))
                    for p, sp in spec_requests(cfg, seed=9)]
        rates = {}
        for name, kw in (("spec_off", {}), ("spec_on", dict(spec_k=SPEC_K)),
                         ("int8", dict(kv_quant="int8"))):
            run = spec_run(torch, model, m, requests, False, **kw)
            rates[name] = spec_rates(run["stats"])
            del run
        emit("serve_spec_timing", model=cfg.name, dtype=m["dtype"],
             layers=cfg.n_layers, slots=m["slots"], spec_k=SPEC_K,
             requests=len(requests), new_tokens=SPEC_TIMING_NEW, rates=rates,
             # a decoding row's tokens a second, spec on over spec off
             row_rate_ratio=rates["spec_on"]["tokens_per_row_tick"]
             * rates["spec_off"]["tick_ms"] / rates["spec_on"]["tick_ms"])
        del model
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4o: serving operations
# ---------------------------------------------------------------------------

#: LLaMA-3.2-1B bf16 at full depth on 8 slots of 1024, phase 4's weights;
#: the GPT-2-124M fp32 CLI run; the gates' requests and the watchdog
OPS_MODEL = dict(label="llama3_2-1B", model="llama3_2", size="1B", dtype="bf16",
                 context=1024, slots=8)
OPS_CLI = dict(model="GPT2", size="124M", dtype="fp32", context=1024, slots=8,
               requests=24, new=64)
OPS_NEW, OPS_TICK_TIMEOUT = 32, 1.0
#: first prompt token of the poison requests (the gates' prompts start >= 16)
OPS_POISON_PREFILL, OPS_POISON_NAN = 3, 5
#: the JAX frontend's status for each probe of ``http_status_map``
#: (``tests/test_torch_serving_ops.py`` holds the two frontends equal)
HTTP_MAP = [413, 400, 400, 400, 400, 400, 413, 400, 200, 404, 429, 503]


def ops_requests(cfg, seed: int, n: int = 8, new: int = OPS_NEW) -> list:
    """n greedy requests, prompts of 16-256 tokens (first token >= 16),
    ``new`` new tokens, eos ignored."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.serving.request import (
        SamplingParams,
    )

    rng = np.random.default_rng(seed)
    return [(rng.integers(16, cfg.vocab_size, int(rng.integers(16, 257))).tolist(),
             SamplingParams(max_new_tokens=new, seed=3000 + i, ignore_eos=True))
            for i in range(n)]


def ops_hooks():
    """Fault hooks of the gates: the two poison marks, a hang the next tick
    takes (``hang`` set; it waits on ``release``), and a gate at the first
    accepted token (``first`` set; that thread waits for ``go``)."""
    import threading

    from building_llm_from_scratch_tpu_torch.serving.supervisor import (
        FaultHooks,
    )

    class Hooks(FaultHooks):
        def __init__(self, gate_first=False):
            self.hang, self.release = threading.Event(), threading.Event()
            self.first, self.go = threading.Event(), threading.Event()
            self.gate_first = gate_first

        def before_tick(self, engine):
            if self.hang.is_set():
                self.hang.clear()
                self.release.wait(60)

        def before_prefill(self, req):
            if int(req.prompt_ids[0]) == OPS_POISON_PREFILL:
                raise RuntimeError("injected prefill fault")

        def poison_nan(self, req):
            return int(req.prompt_ids[0]) == OPS_POISON_NAN

        def after_token(self, req, tok):
            if self.gate_first and not self.first.is_set():
                self.first.set()
                self.go.wait(60)

    return Hooks


def ops_engine(model, policy=None, **kw):
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine

    return DecodeEngine(model, n_slots=OPS_MODEL["slots"],
                        max_len=OPS_MODEL["context"], max_queue=64,
                        kv_policy=policy, **kw)


def ops_isolation(torch, model, cfg, paged: bool, requests: list) -> dict:
    """A fault-free run, then the same traffic with a poison prefill and a
    NaN-poisoned slot admitted after the first tick: each fails alone, the
    co-residents' tokens are the fault-free run's bit for bit, a request
    re-served in the freed slots gets its fault-free tokens, and B5 (B7
    when paged) = layers x decode ticks in both runs."""
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
    from building_llm_from_scratch_tpu_torch.serving.request import (
        SamplingParams,
    )

    kernel = tds.paged_decode_attention if paged else tds.fused_decode_step
    other = tds.fused_decode_step if paged else tds.paged_decode_attention
    policy = paged_policy(True) if paged else None
    Hooks = ops_hooks()

    def run(poison: bool):
        eng = ops_engine(model, policy, hooks=Hooks())
        kernel.launches = other.launches = 0
        hs = [eng.submit(p, sp) for p, sp in requests[:4]]
        eng.step()
        bad = []
        if poison:
            for mark in (OPS_POISON_PREFILL, OPS_POISON_NAN):
                bad.append(eng.submit([mark] + requests[0][0][1:40],
                                      SamplingParams(max_new_tokens=16,
                                                     ignore_eos=True)))
        hs += [eng.submit(p, sp) for p, sp in requests[4:]]
        eng.run_until_idle()
        again = eng.submit(*requests[0])
        eng.run_until_idle()
        torch.cuda.synchronize()
        st = eng.stats()
        if kernel.launches != cfg.n_layers * st["n_ticks"] or other.launches \
                or st["n_ticks"] == 0:
            raise AssertionError(f"4o isolation (paged={paged}): {kernel.launches} "
                                 f"launches for {cfg.n_layers} x {st['n_ticks']} "
                                 f"ticks, the other kernel {other.launches}")
        return [h.output_ids for h in hs], bad, again, st, kernel.launches

    clean, _, _, _, n0 = run(False)
    toks, bad, again, st, n = run(True)
    reasons = [(h.finish_reason, h.error or "") for h in bad]
    if not (reasons[0][0] == "error" and "prefill" in reasons[0][1]
            and reasons[1][0] == "error" and "non-finite" in reasons[1][1]):
        raise AssertionError(f"4o isolation (paged={paged}): poison outcomes {reasons}")
    if toks != clean or again.output_ids != clean[0] or st["requests_failed"] != 2:
        raise AssertionError(f"4o isolation (paged={paged}): co-residents differ "
                             "from the fault-free run")
    return dict(launches=n, launches_fault_free=n0, decode_ticks=st["n_ticks"],
                poison=[r[0] for r in reasons], coresidents_bit_equal=len(clean))


def http_status_map(torch, model, cfg) -> list:
    """Probe the HTTP frontend on loopback (port 0) with one request per
    row of the status map; returns the statuses."""
    import http.client
    import threading

    from building_llm_from_scratch_tpu_torch.serving.frontend import (
        make_http_server,
    )

    def post(port, body, path="/generate"):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        headers = dict(resp.getheaders())
        conn.close()
        return resp.status, headers

    eng = ops_engine(model)
    eng.warmup()
    eng.start()
    server = make_http_server(eng, 0, host="127.0.0.1", max_body_bytes=4096)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    ok = {"prompt_ids": [16, 17], "max_new_tokens": 4, "ignore_eos": True}
    codes, retry = [], {}
    try:
        for body in (b"x" * 5000, b"{not json", b"[1, 2, 3]",
                     json.dumps({"prompt_ids": [16], "top_k": [1]}).encode(),
                     json.dumps({"prompt_ids": [16, cfg.vocab_size]}).encode(),
                     json.dumps({"max_new_tokens": 2}).encode(),
                     json.dumps({"prompt_ids": [16] * OPS_MODEL["context"]}).encode(),
                     json.dumps(dict(ok, deadline_s=0)).encode(),
                     json.dumps(ok).encode()):
            codes.append(post(port, body)[0])
        codes.append(post(port, b"{}", path="/nowhere")[0])
        with eng._lock:             # a backlog the deadline cannot meet
            eng._tpot_ewma, eng._tokens_ewma = 10.0, 100.0
        status, headers = post(port, json.dumps(dict(ok, deadline_s=1)).encode())
        codes.append(status)
        retry["429"] = headers.get("Retry-After")
        eng.drain(timeout=30.0)
        status, headers = post(port, json.dumps(ok).encode())
        codes.append(status)
        retry["503"] = headers.get("Retry-After")
    finally:
        server.shutdown()
        server.server_close()
        eng.shutdown()
    if codes != HTTP_MAP or None in retry.values():
        raise AssertionError(f"4o HTTP: {codes} (the JAX map {HTTP_MAP}), "
                             f"Retry-After {retry}")
    return codes


def ops_dead_healthz(torch, model) -> dict:
    """A hung tick with no restart budget left: the watchdog's escalation
    fails every request and ``/healthz`` reads ``dead``; a POST gets 500."""
    import http.client
    import threading

    from building_llm_from_scratch_tpu_torch.serving.frontend import (
        make_http_server,
    )

    hooks = ops_hooks()(gate_first=True)
    eng = ops_engine(model, hooks=hooks, tick_timeout_s=OPS_TICK_TIMEOUT,
                     max_restarts=0)
    eng.warmup()
    eng.start()
    server = make_http_server(eng, 0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        cfg = model.cfg
        h = eng.submit(*ops_requests(cfg, seed=40, n=1)[0])
        if not hooks.first.wait(60):
            raise AssertionError("4o dead: no first token")
        hooks.hang.set()
        hooks.go.set()
        try:
            h.result(timeout=60)
        except RuntimeError:
            pass
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.request("POST", "/generate", body=json.dumps(
            {"prompt_ids": [16, 17], "max_new_tokens": 2}).encode())
        status = conn.getresponse().status
        conn.close()
    finally:
        hooks.release.set()
        server.shutdown()
        server.server_close()
        eng._stop.set()
        if eng.supervisor is not None:
            eng.supervisor.stop()
    if health["status"] != "dead" or status != 500 or h.finish_reason != "error":
        raise AssertionError(f"4o dead: /healthz {health['status']}, POST {status}, "
                             f"request {h.finish_reason}")
    return dict(healthz=health["status"], post=status, restarts=health["restarts"])


def ops_cli_sigterm(torch, workdir: str) -> dict:
    """``--mode serve`` in a child process at GPT-2-124M fp32 with
    ``--metrics_jsonl``: SIGTERM after the first result line drains it; it
    exits 0 with every request's line written and a drain in the JSONL."""
    import signal

    m = OPS_CLI
    from building_llm_from_scratch_tpu_torch.configs import get_config

    cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                     target_context_length=m["context"])
    src = os.path.join(workdir, "ops_cli.jsonl")
    mj = os.path.join(workdir, "ops_cli_metrics.jsonl")
    with open(src, "w") as f:
        for p, sp in ops_requests(cfg, seed=41, n=m["requests"], new=m["new"]):
            f.write(json.dumps({"prompt_ids": p, "max_new_tokens": sp.max_new_tokens,
                                "ignore_eos": True, "seed": sp.seed}) + "\n")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "building_llm_from_scratch_tpu_torch", "--mode",
         "serve", "--model", m["model"], "--num_params", m["size"],
         "--data_type", m["dtype"], "--serve_slots", str(m["slots"]),
         "--serve_max_len", str(m["context"]), "--serve_prompts", src,
         "--metrics_jsonl", mj, "--serve_metrics_every", "16",
         "--drain_timeout", "300"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        lines = [proc.stdout.readline()]
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        lines += proc.stdout.readlines()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recs = [json.loads(ln) for ln in lines if ln.strip()]
    with open(mj) as f:
        rows = [json.loads(ln) for ln in f]
    drains = [r for r in rows if r.get("event") == "drain"]
    if rc != 0 or len(recs) != m["requests"] or any(
            r.get("finish_reason") != "length" for r in recs) \
            or [d["phase"] for d in drains] != ["start", "end"]:
        raise AssertionError(f"4o CLI: rc {rc}, {len(recs)} lines, drains {drains}")
    return dict(rc=rc, lines=len(recs), drain=drains[-1],
                metrics_rows=sum(r["type"] == "metrics" for r in rows),
                device_kind=rows[0].get("device_kind"),
                wall_s=time.perf_counter() - t0,
                sigterm_to_exit_s=time.perf_counter() - t_sig)


def ops_paged_queue3(torch, model, cfg) -> dict:
    """The paged engine's three behaviours the CPU tests alone ran: prefix
    entries evicted under a byte budget that holds one system prompt, and
    admission bounced by a pool of two worst-case rows; every request
    finishes with the greedy tokens of the unconstrained run."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds

    requests = [(p, dataclasses.replace(sp, max_new_tokens=OPS_NEW))
                for p, sp in make_shared_requests(cfg, seed=42, n=8)]
    base = paged_policy(True)

    def run(policy):
        eng = ops_engine(model, policy)
        bounced = []
        admit_pages = eng._admit_pages

        def counted(slot, req):
            ok = admit_pages(slot, req)
            if ok is False:
                bounced.append(req.id)
            return ok

        eng._admit_pages = counted
        tds.paged_decode_attention.launches = 0
        hs = [eng.submit(p, sp) for p, sp in requests]
        eng.run_until_idle()
        torch.cuda.synchronize()
        st = eng.stats()
        if any(h.finish_reason != "length" for h in hs) or \
                tds.paged_decode_attention.launches != cfg.n_layers * st["n_ticks"]:
            raise AssertionError(f"4o queue 3 ({policy}): {st}")
        greedy = [h.output_ids for h, (_, sp) in zip(hs, requests)
                  if sp.temperature == 0]
        return greedy, st, len(bounced)

    ref, _, _ = run(base)
    span_bytes = SYSTEM_TOKENS // PAGE_TOKENS * base.page_bytes(cfg)
    evicting = dataclasses.replace(base, prefix_budget_bytes=int(span_bytes * 1.5))
    got_e, st_e, _ = run(evicting)
    worst = base.pages_per_slot(OPS_MODEL["context"])
    bouncing = dataclasses.replace(base, pool_pages=2 * worst)
    got_b, st_b, n_bounced = run(bouncing)
    if st_e["prefix_store"]["evictions"] < 1 or n_bounced < 1 \
            or got_e != ref or got_b != ref:
        raise AssertionError(f"4o queue 3: evictions {st_e['prefix_store']}, "
                             f"bounces {n_bounced}, tokens equal "
                             f"{got_e == ref}/{got_b == ref}")
    return dict(evictions=st_e["prefix_store"]["evictions"],
                budget_bytes=evicting.prefix_budget_bytes,
                bounces=n_bounced, pool_pages=bouncing.pool_pages,
                peak_pages_used=st_b["page_pool"]["peak_used"],
                greedy_equal=len(ref))


def ops_adapter_hot_load(torch, model, cfg, workdir: str) -> dict:
    """Multi-LoRA under load (contiguous, B6 on every tick): with a and b
    loaded and their requests decoding, b is evicted (its in-flight rows
    finish on the kept row), c is hot-loaded into a free row and served, a
    request naming b is refused at submit, and one naming a that waits in
    the queue when a is evicted fails alone. B6 = 7 x layers x ticks, and
    the in-flight b requests' tokens equal those of b served alone."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
    from building_llm_from_scratch_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )

    paths, _ = write_adapters(torch, model, cfg, {"a": 8, "b": 16, "c": 16},
                              workdir, "ops")
    reg = AdapterRegistry.from_artifacts(cfg, {k: paths[k] for k in ("a", "b")},
                                         capacity=LORA_POOL, device="cuda")
    reqs = ops_requests(cfg, seed=43, n=8)
    named = [(p, dataclasses.replace(sp, adapter=("a", "b", None, "b")[i % 4]))
             for i, (p, sp) in enumerate(reqs)]
    eng = ops_engine(model, adapters=reg)
    launch = tds.lora_bgmv
    counted = ShapeTally(launch)
    tds.lora_bgmv = counted
    try:
        tds.lora_bgmv.launches = 0
        hs = [eng.submit(p, sp) for p, sp in named]
        queued_a = eng.submit(*named[0])     # the ninth: it waits for a slot
        for _ in range(3):
            eng.step()
        reg.evict("b")
        reg.load("c", paths["c"])
        try:
            eng.submit(named[1][0], named[1][1])
            refused = False
        except ValueError:
            refused = True
        hc = [eng.submit(p, dataclasses.replace(sp, adapter="c"))
              for p, sp in reqs[:2]]
        reg.evict("a")                   # queued_a still waits for a slot
        eng.run_until_idle()
        torch.cuda.synchronize()
    finally:
        tds.lora_bgmv = launch
    st = eng.stats()
    layers, ticks, n_b6 = cfg.n_layers, st["n_ticks"], tds.lora_bgmv.launches
    ok = (refused and all(h.finish_reason == "length" for h in hs + hc)
          and queued_a.finish_reason == "error"
          and "adapter_not_loaded" in (queued_a.error or "")
          and n_b6 == 7 * layers * ticks)
    reg_b = AdapterRegistry.from_artifacts(cfg, {"b": paths["b"]},
                                           capacity=LORA_POOL, device="cuda")
    alone = ops_engine(model, adapters=reg_b)
    hb = [alone.submit(p, sp) for p, sp in named if sp.adapter == "b"]
    alone.run_until_idle()
    b_equal = [h.output_ids for h in hb] == [h.output_ids for h, (_, sp) in
                                             zip(hs, named) if sp.adapter == "b"]
    if not (ok and b_equal):
        raise AssertionError(f"4o adapters: refused {refused}, outcomes "
                             f"{[h.finish_reason for h in hs + hc]}, queued a "
                             f"{queued_a.finish_reason} {queued_a.error}, B6 "
                             f"{n_b6} for 7 x {layers} x {ticks}, "
                             f"b alone equal {b_equal}")
    return dict(b6_launches=n_b6, decode_ticks=ticks,
                b6_by_shape=dict(counted.by_shape),
                per_adapter=st["per_adapter"], refused_evicted=refused,
                queued_evicted=queued_a.finish_reason, evicted_b_bit_equal=b_equal)


def ops_kernel_nan_gates(torch, cfg) -> dict:
    """B5's and B7's serving gates at the ops model's decode shape (8 slots
    of 1024, its heads, bf16), each against its plain twin at TWIN_TOL: one
    slot's KV all NaN (B7: its pages) makes that row, and only it,
    non-finite, the twin's row mask, the other rows within the bound; NaN
    past every row's length (B7: and in the trash page) leaves every row
    finite and within the bound of the twin on the clean cache. Controls
    that must fail: the twin over the NaN tails (it weighs masked positions
    by an exact 0), and NaN inside one row's length in the kernel."""
    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds

    dt = OPS_MODEL["dtype"]
    dtype, dev = DTYPE_MAP[dt], torch.device("cuda")
    S, T, P = OPS_MODEL["slots"], OPS_MODEL["context"], PAGE_TOKENS
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_groups, cfg.head_dim
    atol, rtol = TWIN_TOL[dt]
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
    lens = torch.tensor([0, 5, 300, T - 24, 17, 511, 64, 1000][:S],
                        dtype=torch.int32, device=dev)
    nan = float("nan")

    def rows(out):
        return torch.isfinite(out.float()).flatten(1).all(1).tolist()

    def err(a, b, keep=slice(None)):
        return (a[keep].float() - b[keep].float()).abs().max().item()

    def gate(name, out, ref, ref_rows, keep, tail_out, tail_ref, tail_twin, ctrl):
        res = dict(poison_rows=rows(out), twin_poison_rows=rows(ref),
                   poison_err=err(out, ref, keep), tail_finite=all(rows(tail_out)),
                   tail_err=err(tail_out, tail_ref),
                   twin_tail_finite_rows=sum(rows(tail_twin)), control_rows=rows(ctrl))
        ok = (res["poison_rows"] == res["twin_poison_rows"] == ref_rows
              and torch.allclose(out[keep].float(), ref[keep].float(), atol=atol, rtol=rtol)
              and res["tail_finite"]
              and torch.allclose(tail_out.float(), tail_ref.float(), atol=atol, rtol=rtol)
              and res["twin_tail_finite_rows"] == 0 and res["control_rows"][2] is False)
        if not ok:
            raise AssertionError(f"4o {name} NaN gates: {res}")
        return res

    want = [s != 1 for s in range(S)]
    keep = torch.tensor([s for s in range(S) if s != 1], device=dev)
    q, kn, vn = rnd(S, 1, Hq, hd), rnd(S, 1, Hkv, hd), rnd(S, 1, Hkv, hd)
    K, V = rnd(S, Hkv, T, hd), rnd(S, Hkv, T, hd)

    def b5(Kx, Vx):
        out = tds.fused_decode_step(q, kn, vn, Kx.clone(), Vx.clone(), lens)[0]
        torch.cuda.synchronize()
        return out

    def b5_twin(Kx, Vx):
        return tds.fused_decode_step_plain(q, kn, vn, Kx.clone(), Vx.clone(), lens)[0]

    Kp, Vp = K.clone(), V.clone()
    Kp[1], Vp[1] = nan, nan
    tail = (torch.arange(T, device=dev)[None, :] > lens[:, None].long())[:, None, :, None]
    Kt, Vt = torch.where(tail, nan, K), torch.where(tail, nan, V)
    Vc = V.clone()
    Vc[2, :, 299] = nan                                 # inside row 2's length
    out = dict(B5=gate("B5", b5(Kp, Vp), b5_twin(Kp, Vp), want, keep, b5(Kt, Vt),
                       b5_twin(K, V), b5_twin(Kt, Vt), b5(K, Vc)))
    del K, V, Kp, Vp, Kt, Vt, Vc, tail

    M = T // P
    N = S * M + 1
    K, V = rnd(N, Hkv, P, hd), rnd(N, Hkv, P, hd)
    pages = (torch.randperm(N - 1, generator=gen, device=dev) + 1).view(S, M)
    col = torch.arange(M, device=dev)[None, :]
    table = torch.where(col < (lens.long() // P + 1)[:, None], pages, 0)
    table = table.to(torch.int32).contiguous()

    def b7(Kx, Vx):
        out = tds.paged_decode_attention(q, Kx, Vx, table, lens)
        torch.cuda.synchronize()
        return out

    def b7_twin(Kx, Vx):
        return tds.paged_decode_attention_plain(q, Kx, Vx, table, lens)

    mine = table[1][table[1] > 0].long()
    Kp, Vp = K.clone(), V.clone()
    Kp[mine], Vp[mine] = nan, nan
    Kt, Vt = K.clone(), V.clone()
    Kt[0], Vt[0] = nan, nan                             # the trash page
    for s in range(S):
        t = int(lens[s])
        page = int(table[s, t // P])
        Kt[page, :, t % P + 1:], Vt[page, :, t % P + 1:] = nan, nan
    Vc = V.clone()
    Vc[int(table[2, 0]), :, 0] = nan                    # row 2's position 0
    out["B7"] = gate("B7", b7(Kp, Vp), b7_twin(Kp, Vp), want, keep, b7(Kt, Vt),
                     b7_twin(K, V), b7_twin(Kt, Vt), b7(K, Vc))
    return dict(shape=dict(S=S, Hq=Hq, Hkv=Hkv, hd=hd, Tmax=T, page=P, dtype=dt),
                lengths=lens.tolist(), tol=dict(atol=atol, rtol=rtol), **out)


def phase_serve_ops(torch, workdir: str) -> dict:
    """Phase 4o's gates (no timing; phases 7s / 7 / 7m run beside them):
    B5's and B7's NaN gates, fault isolation contiguous then paged, the
    HTTP status map, a hung tick
    with no budget left, the GPT-2 CLI's SIGTERM drain, and the paged
    eviction, admission bounce and adapter hot-load under load. Returns the
    launch counts and the model for ``phase_serve_ops_timing``."""
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model

    m = OPS_MODEL
    cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                     target_context_length=m["context"])
    model = build_model(cfg, seed=0, device="cuda")
    emit("serve_ops_nan_gates", model=cfg.name, **ops_kernel_nan_gates(torch, cfg))
    requests = ops_requests(cfg, seed=39)
    out = dict(model=model)
    for paged in (False, True):
        res = ops_isolation(torch, model, cfg, paged, requests)
        emit("serve_ops_isolation", model=cfg.name, dtype=m["dtype"],
             layers=cfg.n_layers, slots=m["slots"], max_len=m["context"],
             paged=paged, kernel="B7" if paged else "B5", **res,
             note="gates only; phases 7s / 7 / 7m ran beside them")
        out["b7" if paged else "b5"] = res["launches"]
    emit("serve_ops_http", model=cfg.name, statuses=http_status_map(torch, model, cfg),
         jax_map=HTTP_MAP)
    emit("serve_ops_dead", model=cfg.name, **ops_dead_healthz(torch, model))
    emit("serve_ops_queue3", model=cfg.name, **ops_paged_queue3(torch, model, cfg))
    hot = ops_adapter_hot_load(torch, model, cfg, workdir)
    out["b6"] = hot.pop("b6_by_shape")
    emit("serve_ops_adapters", model=cfg.name, **hot,
         b6_launches_by_shape={f"{d}x{o}": n for (d, o), n in out["b6"].items()})
    emit("serve_ops_cli", model=f"{OPS_CLI['model']}-{OPS_CLI['size']}",
         dtype=OPS_CLI["dtype"], **ops_cli_sigterm(torch, workdir))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ops_restart(torch, model, cfg, paged: bool, requests: list, clean: list) -> dict:
    """A hung tick under the watchdog (``OPS_TICK_TIMEOUT``): the 8 in-flight
    requests fail, the 2 queued are kept and served with their fault-free
    tokens, no kernel is built or loaded again, the abandoned thread once
    released commits nothing, and launches = layers x ticks. Seconds from
    the watchdog's fire to the first token after the restart, and the
    device peak it adds (two caches live)."""
    from building_llm_from_scratch_tpu_torch.ops import _kernels
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds

    kernel = tds.paged_decode_attention if paged else tds.fused_decode_step
    hooks = ops_hooks()(gate_first=True)
    eng = ops_engine(model, paged_policy(True) if paged else None, hooks=hooks,
                     tick_timeout_s=OPS_TICK_TIMEOUT, max_restarts=1,
                     restart_backoff_s=0.05)
    eng.warmup()
    builds0 = dict(_kernels.STATS)
    fired = []
    on_stall = eng.supervisor.detector.on_stall

    def timed(elapsed, thr):
        fired.append(time.monotonic())
        on_stall(elapsed, thr)

    eng.supervisor.detector.on_stall = timed
    kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    inflight = [eng.submit(p, sp) for p, sp in requests]
    queued = [eng.submit(p, sp) for p, sp in requests[:2]]
    eng.start()
    try:
        if not hooks.first.wait(60):
            raise AssertionError("4o restart: no first token")
        hooks.hang.set()
        hooks.go.set()
        for h in queued:
            h.result(timeout=120)
        peak = torch.cuda.max_memory_allocated() - base
        hooks.release.set()
        again = eng.submit(*requests[0])
        again.result(timeout=120)
        eng.shutdown()
    finally:
        hooks.release.set()
        hooks.go.set()
    torch.cuda.synchronize()
    st = eng.stats()
    failed = [h.finish_reason for h in inflight]
    ok = (eng.n_restarts == 1 and eng.n_recompiles == 0
          and dict(_kernels.STATS) == builds0
          and failed == ["error"] * len(inflight)
          and [h.output_ids for h in queued] == clean[:2]
          and again.output_ids == clean[0]
          and kernel.launches == cfg.n_layers * st["n_ticks"] and fired)
    if not ok:
        raise AssertionError(f"4o restart (paged={paged}): restarts {eng.n_restarts}, "
                             f"builds {builds0} -> {_kernels.STATS}, in-flight "
                             f"{failed}, queued equal "
                             f"{[h.output_ids for h in queued] == clean[:2]}, "
                             f"launches {kernel.launches} for {st['n_ticks']} ticks")
    return dict(restart_s=queued[0].t_first_token - fired[0],
                inflight_failed=len(failed), queued_served=len(queued),
                kernel_builds=_kernels.STATS["builds"] - builds0["builds"],
                library_loads=_kernels.STATS["loads"] - builds0["loads"],
                launches=kernel.launches, decode_ticks=st["n_ticks"],
                peak_added_gb=peak / 1e9,
                cache_gb=sum(t.numel() * t.element_size()
                             for v in eng.cache.values() for t in v) / 1e9)


def phase_serve_ops_timing(torch, ops: dict) -> dict:
    """Phase 4o's times, with nothing else running (LLaMA-3.2-1B bf16, 8
    slots): the restart gate contiguous and paged with its seconds; the
    loop's wall a decode tick with the supervisor on against off (8 runs,
    off / on / on / off twice; medians) and one heartbeat's cost in a
    tight loop; drain seconds over a full batch; the HTTP round trip
    against a direct submit on the same engine; and the ``/metrics``
    scrape."""
    import http.client
    import statistics as stats
    import threading

    from building_llm_from_scratch_tpu_torch.serving.frontend import (
        make_http_server,
    )
    from building_llm_from_scratch_tpu_torch.serving.supervisor import (
        EngineSupervisor,
    )

    model = ops.pop("model")
    cfg = model.cfg
    requests = ops_requests(cfg, seed=39)
    clean = {}
    for paged in (False, True):
        eng = ops_engine(model, paged_policy(True) if paged else None)
        hs = [eng.submit(p, sp) for p, sp in requests]
        eng.run_until_idle()
        clean[paged] = [h.output_ids for h in hs]
    restart = {("paged" if paged else "contiguous"):
               ops_restart(torch, model, cfg, paged, requests, clean[paged])
               for paged in (False, True)}
    emit("serve_ops_restart", model=cfg.name, tick_timeout_s=OPS_TICK_TIMEOUT,
         **restart)

    long = ops_requests(cfg, seed=44, new=64)
    ticks = {"off": [], "on": []}
    for label in ("off", "on", "on", "off") * 2:
        eng = ops_engine(model, tick_timeout_s=30.0 if label == "on" else 0.0)
        eng.warmup()
        hs = [eng.submit(p, sp) for p, sp in long]
        eng.start()
        for h in hs:
            h.result(timeout=300)
        eng.shutdown()
        # decode ticks only: the request admitted last finishes last, and
        # from its first token to its finish the loop ran new - 1 decode
        # ticks and admitted nothing
        window = (max(h.t_finish for h in hs)
                  - max(h.t_first_token for h in hs))
        ticks[label].append(window / (len(hs[0].output_ids) - 1) * 1e3)
    # the heartbeat alone, its watchdog thread polling beside it
    sup = EngineSupervisor(eng, tick_timeout_s=30.0).start()
    n_beats = 200_000
    t0 = time.perf_counter()
    for _ in range(n_beats):
        sup.notify_tick()
    notify_us = (time.perf_counter() - t0) / n_beats * 1e6
    sup.stop()

    hooks = ops_hooks()(gate_first=True)
    eng = ops_engine(model, hooks=hooks)
    eng.warmup()
    eng.start()
    hs = [eng.submit(p, sp) for p, sp in long + ops_requests(cfg, seed=45, new=64)]
    hooks.first.wait(60)
    hooks.go.set()
    drain = eng.drain(timeout=300.0)
    eng.shutdown()
    drain["tokens_finished"] = sum(len(h.output_ids) for h in hs)

    eng = ops_engine(model)
    eng.warmup()
    eng.start()
    server = make_http_server(eng, 0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    probe = [(p[:64], sp) for p, sp in ops_requests(cfg, seed=46, n=8, new=8)]
    http_ms, direct_ms, scrape_ms = [], [], []
    try:
        for p, sp in probe * 2:
            body = json.dumps({"prompt_ids": p, "max_new_tokens": sp.max_new_tokens,
                               "ignore_eos": True, "seed": sp.seed}).encode()
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/generate", body=body)
            resp = conn.getresponse()
            resp.read()
            conn.close()
            http_ms.append((time.perf_counter() - t0) * 1e3)
            if resp.status != 200:
                raise AssertionError(f"4o timing: POST {resp.status}")
            t0 = time.perf_counter()
            eng.submit(p, sp).result(timeout=120)
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(20):
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read()
            conn.close()
            scrape_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        server.shutdown()
        server.server_close()
        eng.shutdown()
    emit("serve_ops_timing", model=cfg.name, dtype=OPS_MODEL["dtype"],
         layers=cfg.n_layers, slots=OPS_MODEL["slots"], requests=len(long),
         new_tokens=64, decode_tick_ms=ticks,
         decode_tick_ms_median={k: stats.median(v) for k, v in ticks.items()},
         decode_tick_ms_spread={k: max(v) - min(v) for k, v in ticks.items()},
         supervisor_tick_ms_on_minus_off=stats.median(ticks["on"])
         - stats.median(ticks["off"]),
         notify_tick_us=notify_us, notify_tick_calls=n_beats,
         drain=drain, http_ms_median=stats.median(http_ms),
         direct_ms_median=stats.median(direct_ms),
         http_overhead_ms=stats.median(http_ms) - stats.median(direct_ms),
         http_samples=len(http_ms), scrape_ms_median=stats.median(scrape_ms),
         scrape_ms_max=max(scrape_ms), scrape_bytes=len(text))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return restart


# ---------------------------------------------------------------------------
# phases 7s / 7 / 7m in a second process, beside 4c (SFT adapter), 4d, 4s, 4q
# ---------------------------------------------------------------------------

#: CPU threads of the reference process (the card's machine has 8 CPUs;
#: two are left to the host-bound serving phases beside it)
REFERENCE_THREADS = 6


def reference_phases(torch) -> dict:
    """Phases 7s, 7 and 7m (each one step on the card against the CPU)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        for spec in SFT_REFERENCES:
            phase_sft_reference(torch, spec, workdir)
    reference = phase_train_reference(torch, REFERENCES[0])
    reference_gpt2 = phase_train_reference(torch, REFERENCES[1])
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        phase_mixed_reference(torch, workdir)
    return dict(reference=reference, reference_gpt2=reference_gpt2)


@contextlib.contextmanager
def references_beside():
    """Run ``reference_phases`` in a child process (``chip_smoke.py
    --references``) for the body's duration: its lines go to a file and are
    printed after it ends, its results come back as JSON. The body must
    take no timing: the child keeps the host's cores busy. A failure on
    either side stops the child."""
    here = os.path.dirname(os.path.abspath(__file__))
    box: dict = {}
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        lines, result = os.path.join(tmp, "lines.jsonl"), os.path.join(tmp, "out.json")
        with open(lines, "w") as sink:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--references", result,
                 str(time.perf_counter() - _T0)], stdout=sink, cwd=here)
            try:
                yield box
                rc = proc.wait(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(lines) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()
        if rc != 0:
            raise AssertionError(f"the reference phases (7s / 7 / 7m) exited {rc}")
        with open(result) as f:
            box.update(json.load(f))


def references_main(torch, result: str, t0: float) -> int:
    """The child of ``references_beside``: TF32 off as phase 1 sets it, the
    kernels already built by the parent, ``t_s`` on the parent's clock."""
    global _T0
    _T0 = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(REFERENCE_THREADS)
    out = reference_phases(torch)
    out["io"] = written_bytes()
    with open(result, "w") as f:
        json.dump(out, f)
    return 0


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


# ---------------------------------------------------------------------------
# phase 9t: text in and out (BPE tokenizers, the token cache, text serving)
# ---------------------------------------------------------------------------

#: LLaMA-3.2-1B bf16 pretraining on BPE ids through the CLI, then the same
#: command relaunched into a fresh output directory over the same token
#: cache; GPT-2-124M fp32 LoRA SFT on GPT-2 BPE ids with B4, in process
#: (12 steps: the 10% validation split then holds one batch)
TEXT_TRAIN = dict(model="llama3_2", size="1B", dtype="bf16", batch=4, context=1024,
                  steps=12)
TEXT_SFT = dict(model="GPT2", size="124M", dtype=None, batch=8, context=1024,
                steps=8, rank=16, alpha=32.0)
#: text prompts served at phase 4's shapes: LLaMA-3.2-1B through the CLI,
#: GPT-2-124M in process (its synthetic files are not tiktoken's)
TEXT_SERVE = [dict(model="llama3_2", size="1B", dtype="bf16", context=1024, slots=8,
                   requests=12, cli=True, label="llama3_2-1B"),
              dict(model="GPT2", size="124M", dtype="fp32", context=1024, slots=8,
                   requests=12, cli=False, label="gpt2-124M")]
#: merges learned for the synthetic BPE files (padded to the real sizes)
TEXT_MERGES = 3000
TEXT_SEED = 21


def bpe_writer() -> dict:
    """``scripts/build_local_bpe.py``'s functions (run from the checkout)."""
    import runpy

    return runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "scripts", "build_local_bpe.py"))


def tokenizer_rates(writer: dict, assets: dict) -> dict:
    """Host figures of the BPE: the character classes' build, the load of
    each table, encode MB/s over a seeded 1 MB text with the piece cache
    cold and warm (ids equal), decode MB/s (the text back)."""
    from building_llm_from_scratch_tpu_torch.data import tokenizers as ttok

    ttok.unicode_classes.cache_clear()
    t0 = time.perf_counter()
    ttok.unicode_classes()
    out = dict(unicode_classes_s=time.perf_counter() - t0)
    text = writer["sample_text"](TEXT_SEED + 1, 1_000_000)
    mb = len(text.encode("utf-8")) / 1e6
    for name, make in (("llama3", lambda: ttok.Llama3Tokenizer(assets["tokenizer_model"])),
                       ("gpt2", lambda: ttok.GPT2Tokenizer.from_files(
                           assets["vocab_bpe"], assets["encoder_json"]))):
        t0 = time.perf_counter()
        tok = make()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cold = tok.encode(text)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = tok.encode(text)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = tok.decode(cold)
        decode_s = time.perf_counter() - t0
        if cold != warm or back != text:
            raise AssertionError(f"{name}: the piece cache changed the ids or the "
                                 "text does not come back")
        out[name] = dict(load_s=load_s, vocab_size=tok.vocab_size, eos_id=tok.eos_id,
                         text_mb=mb, tokens=len(cold),
                         bytes_per_token=mb * 1e6 / len(cold),
                         encode_cold_mb_s=mb / cold_s, encode_warm_mb_s=mb / warm_s,
                         decode_mb_s=mb / decode_s)
    want = dict(llama3=(128_256, 128_001), gpt2=(50_257, 50_256))
    got = {k: (out[k]["vocab_size"], out[k]["eos_id"]) for k in want}
    if got != want:
        raise AssertionError(f"BPE vocab sizes / eos ids {got}, not {want}")
    return out


def sized_text_corpus(tok, writer: dict, path: str, t: dict) -> int:
    """A ``sample_text`` corpus whose train split makes exactly t["steps"]
    batches of the tokenizer's ids (the loader's own count); returns its
    characters."""
    from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader

    loader = PretrainLoader(tok, t["batch"], t["context"], stride=t["context"])
    text = writer["sample_text"](TEXT_SEED, 60 * t["steps"] * t["batch"] * t["context"] // 10)
    lo, hi = 1, len(text)
    while lo < hi:                  # the fewest characters giving the steps
        mid = (lo + hi) // 2
        with open(path, "w") as f:
            f.write(text[:mid])
        steps = loader.get_total_steps_epoch([path], "<|end_of_text|>")
        lo, hi = (mid + 1, hi) if steps < t["steps"] else (lo, mid)
        loader.token_cache = type(loader.token_cache)()
    with open(path, "w") as f:
        f.write(text[:lo])
    return lo


def text_pretrain(torch, tok, writer: dict, assets: dict, workdir: str) -> dict:
    """LLaMA-3.2-1B bf16 pretraining through the CLI with ``--tokenizer_path``
    and ``--tokenizer_cache_dir``, then the same command into a fresh output
    directory. Gates: the loader's ids are ``tok.encode`` of the corpus and
    its first batch their windows; the first run tokenizes the file and
    writes the cache, the relaunch reads it (nothing tokenized) and gives
    the first run's losses bit for bit; losses finite and falling; B1 /
    B2a / B2b launches exact. No train state or export is written."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch import main as tmain

    t = TEXT_TRAIN
    data_dir = os.path.join(workdir, "data")
    cache_dir = os.path.join(workdir, "token-cache")
    os.makedirs(data_dir, exist_ok=True)
    corpus = os.path.join(data_dir, "corpus.txt")
    n_chars = sized_text_corpus(tok, writer, corpus, t)
    flags = ["--mode", "train", "--model", t["model"], "--num_params", t["size"],
             "--data_type", t["dtype"], "--tokenizer_path", assets["tokenizer_model"],
             "--tokenizer_cache_dir", cache_dir, "--data_dir", data_dir,
             "--n_epochs", "1", "--batch_size", str(t["batch"]), "--warmup_steps", "2",
             "--eval_freq", str(t["steps"]), "--print_sample_iter", str(t["steps"])]
    runs = {}
    for label in ("first", "relaunch"):
        out_dir = os.path.join(workdir, f"out-{label}")
        t0 = time.perf_counter()
        with main_path(torch, False) as run, final_checkpoint_unwritten(), \
                export_unwritten(False):
            trainer = tmain.run(flags + ["--output_dir", out_dir])
        final_checkpoint(trainer)
        cfg, loader = trainer.cfg, trainer.loader
        tr_ds, va_ds = loader.create_datasets_for_file(corpus, cfg.eos_text)
        n_evals = len(trainer.train_losses)
        eval_batches = n_evals * (min(5, loader.num_batches(tr_ds))
                                  + min(5, loader.num_batches(va_ds)))
        steps = trainer.global_step
        want = expected_launches(cfg, steps, eval_batches, False)
        losses = [m["loss"] for m in trainer.step_metrics]
        runs[label] = dict(steps=steps, eval_batches=eval_batches,
                           launches=run["launches"], expected=want, losses=losses,
                           cache=dict(loader.token_cache.stats),
                           to_first_step_s=run["step_starts"][0] - t0,
                           run_step_ms=run["run_step_ms"], wall_s=run["wall_s"])
        if (steps != t["steps"] or n_evals != 1 or run["launches"] != want
                or not all(map(math.isfinite, losses + trainer.train_losses
                               + trainer.val_losses)) or not losses[-1] < losses[0]):
            raise AssertionError(f"phase 9t pretraining ({label}): {runs[label]}")
        if label == "first":
            with open(corpus) as f:
                text = f.read() + f" {cfg.eos_text} "
            cut = int(0.9 * len(text))
            ids = [np.asarray(tok.encode(p), np.int32) for p in (text[:cut], text[cut:])]
            inputs, targets = next(loader.batches(tr_ds, epoch=0))
            order = np.random.default_rng(trainer.loader.seed).permutation(len(tr_ds))
            rows = [ids[0][r * t["context"]:(r + 1) * t["context"] + 1]
                    for r in order[:t["batch"]]]
            if not (np.array_equal(tr_ds.token_ids, ids[0])
                    and np.array_equal(va_ds.token_ids, ids[1])
                    and np.array_equal(inputs, np.stack([r[:-1] for r in rows]))
                    and np.array_equal(targets, np.stack([r[1:] for r in rows]))):
                raise AssertionError("phase 9t: the loader's ids or first batch are "
                                     "not tok.encode of the corpus")
            runs[label]["tokens"] = dict(train=len(ids[0]), val=len(ids[1]))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    first, again = runs["first"], runs["relaunch"]
    cache_files = sorted(os.listdir(cache_dir))
    if (first["cache"]["encoded"], first["cache"]["disk"]) != (1, 0) or \
            (again["cache"]["encoded"], again["cache"]["disk"]) != (0, 1) or \
            len(cache_files) != 1:
        raise AssertionError(f"phase 9t token cache: first {first['cache']}, "
                             f"relaunch {again['cache']}, files {cache_files}")
    if again["losses"] != first["losses"]:
        raise AssertionError(f"phase 9t: the relaunch's losses {again['losses']} are "
                             f"not the first run's {first['losses']}")
    return dict(runs, corpus_chars=n_chars,
                cache_file_bytes=os.path.getsize(os.path.join(cache_dir, cache_files[0])))


def text_sft(torch, tok, workdir: str) -> dict:
    """GPT-2-124M fp32 LoRA SFT on ``build_local_alpaca.py`` records
    tokenized by the synthetic GPT-2 BPE (given to the CLI's component
    builder in process), with B4 on. Gates: every record's prompt mask
    (the first supervised target) at ``len(tok.encode(prompt)) - 1``; B1-B4
    launches exact; losses finite."""
    import numpy as np

    import building_llm_from_scratch_tpu_torch.build_components as tbc
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.data.instruct import (
        collate_batch,
        format_input,
    )

    t = TEXT_SFT
    data_dir = os.path.join(workdir, "data")
    os.makedirs(data_dir, exist_ok=True)
    records = math.ceil(t["steps"] * t["batch"] / 0.9)
    data = os.path.join(data_dir, "alpaca.json")
    write_alpaca(data, records)
    flags = ["--mode", "train", "--model", t["model"], "--num_params", t["size"],
             *dtype_flags(t), "--finetune", "--dataset", "alpaca", "--use_lora",
             "--lora_rank", str(t["rank"]), "--lora_alpha", str(t["alpha"]),
             "--seed", str(SFT_SEED), "--data_dir", data_dir,
             "--output_dir", os.path.join(workdir, "out"), "--n_epochs", "1",
             "--batch_size", str(t["batch"]), "--warmup_steps", "2",
             "--eval_freq", str(t["steps"]), "--print_sample_iter", str(t["steps"])]
    build = tbc.build_tokenizer
    tbc.build_tokenizer = lambda *a, **kw: tok
    try:
        with main_path(torch, True) as run, final_checkpoint_unwritten(), \
                export_unwritten(False):
            trainer = tmain.run(flags)
    finally:
        tbc.build_tokenizer = build
    final_checkpoint(trainer)
    cfg, loader = trainer.cfg, trainer.loader
    with open(data) as f:
        recs = json.load(f)
    tr_ds, va_ds = loader.create_datasets(recs)
    masks = []
    for ds in (tr_ds, va_ds):
        for i, rec in enumerate(ds.data):
            n = len(tok.encode(format_input(rec)))
            _, _, w = collate_batch([ds[i]], pad_token_id=cfg.eos_id,
                                    allowed_max_length=cfg.context_length)
            first = int(np.flatnonzero(w[0])[0])
            masks.append((ds.instruction_lengths[i], n, first))
    bad = [m for m in masks if not (m[0] == m[1] and m[2] == m[1] - 1)]
    n_evals = len(trainer.train_losses)
    eval_batches = n_evals * (min(5, loader.num_batches(tr_ds))
                              + min(5, loader.num_batches(va_ds)))
    steps = trainer.global_step
    want = expected_launches(cfg, steps, eval_batches, True, lora=True)
    losses = [m["loss"] for m in trainer.step_metrics]
    facts = dict(records=records, steps=steps, eval_batches=eval_batches,
                 launches=run["launches"], expected=want, losses=losses,
                 masked_records=len(masks), prompt_tokens_mean=statistics.mean(
                     m[1] for m in masks), run_step_ms=run["run_step_ms"])
    if bad or steps != t["steps"] or run["launches"] != want or not all(
            map(math.isfinite, losses + trainer.train_losses + trainer.val_losses)):
        raise AssertionError(f"phase 9t SFT: {facts}, masks off {bad[:4]}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return facts


def text_requests(writer: dict, n: int) -> list:
    """n text prompts of 40-600 characters cut from a seeded
    ``sample_text``, greedy, budgets of 24-64 new tokens, eos ignored."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams

    rng = np.random.default_rng(TEXT_SEED + 2)
    text = writer["sample_text"](TEXT_SEED + 2, 40_000)
    out = []
    for i in range(n):
        a = int(rng.integers(0, len(text) - 600))
        prompt = text[a:a + int(rng.integers(40, 601))]
        out.append((prompt, SamplingParams(max_new_tokens=int(rng.integers(24, 65)),
                                           seed=i, ignore_eos=True)))
    return out


def text_serve_cli(torch, m: dict, tok, assets: dict, requests: list, workdir: str,
                   text: bool) -> tuple:
    """``main.run --mode serve`` on a JSONL of the requests, as ``"prompt"``
    text with ``--tokenizer_path`` or as ``"prompt_ids"`` (``tok.encode``)
    without a tokenizer; B5's launches counted from 0. Returns (engine,
    result records, launches)."""
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.ops.decode_step import fused_decode_step

    tag = "text" if text else "ids"
    src = os.path.join(workdir, f"{m['label']}-{tag}.jsonl")
    dst = os.path.join(workdir, f"{m['label']}-{tag}.out.jsonl")
    with open(src, "w") as f:
        for p, sp in requests:
            rec = {"prompt": p} if text else {"prompt_ids": tok.encode(p)}
            rec.update(max_new_tokens=sp.max_new_tokens, seed=sp.seed,
                       ignore_eos=sp.ignore_eos)
            f.write(json.dumps(rec) + "\n")
    fused_decode_step.launches = 0                  # the main path's count
    engine = tmain.run([
        "--mode", "serve", "--model", m["model"], "--num_params", m["size"],
        "--data_type", m["dtype"], "--target_context_length", str(m["context"]),
        "--seed", "0", "--serve_prompts", src, "--serve_out", dst,
        "--serve_slots", str(m["slots"]), "--serve_max_len", str(m["context"]),
        *(["--tokenizer_path", assets["tokenizer_model"]] if text else [])])
    launches = fused_decode_step.launches
    with open(dst) as f:
        return engine, [json.loads(line) for line in f], launches


def detok_hold_check(engine_cls, model, tok) -> dict:
    """The hold rule on the engine's own ``_detok_piece`` with ``tok``: the
    three one-byte tokens of a 3-byte character give "", "" and the
    character; 17 tokens that each decode to U+FFFD commit at the 16th
    (``_DETOK_HOLD_MAX``); a held tail is flushed by ``final``."""
    from building_llm_from_scratch_tpu_torch.serving.request import Request, SamplingParams

    engine = engine_cls(model, tok, n_slots=1, max_len=64)
    ranks = tok._enc._ranks
    req = Request(0, [1], SamplingParams())
    split = []
    for b in "字".encode("utf-8"):
        req.output_ids.append(ranks[bytes([b])])
        split.append(engine._detok_piece(req))
    req = Request(1, [1], SamplingParams())
    held = []
    for _ in range(17):
        req.output_ids.append(ranks[b"\xf8"])
        held.append(engine._detok_piece(req))
    flushed = engine._detok_piece(req, final=True)
    want_held = [""] * 15 + ["\ufffd" * 16, ""]
    if split != ["", "", "字"] or held != want_held or flushed != "\ufffd":
        raise AssertionError(f"phase 9t hold rule: {split}, {held}, {flushed!r}")
    return dict(split_pieces=split, commit_at=held.index("\ufffd" * 16) + 1,
                flushed=len(flushed))


def detok_paired_ticks(torch, engine_cls, model, tok, requests: list, slots: int,
                       max_len: int, rounds: int = 10, window: int = 16) -> dict:
    """Steady decode ticks of two engines on the same model and prompts,
    one with the tokenizer and one without, in alternating windows (host
    clock over ``window`` synchronised ticks, medians over ``rounds``
    windows each). Outside the main path's count; no request ends inside
    the windows."""
    import dataclasses

    engines = {}
    for name, t in (("with_tokenizer", tok), ("without", None)):
        eng = engine_cls(model, t, n_slots=slots, max_len=max_len, max_queue=64)
        for p, sp in requests[:slots]:
            ids = tok.encode(p)
            eng.submit(ids, dataclasses.replace(sp, max_new_tokens=max_len - len(ids)))
        eng.step()
        engines[name] = eng
    times = {name: [] for name in engines}
    detok0 = engines["with_tokenizer"].detok_seconds
    ticks0 = engines["with_tokenizer"].n_ticks
    order = list(engines)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            eng = engines[name]
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), eng.n_ticks
            for _ in range(window):
                eng.step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / (eng.n_ticks - n0) * 1e3)
    eng = engines["with_tokenizer"]
    out = {f"{k}_tick_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_windows_ms": v for k, v in times.items()},
               detok_ms_per_tick=(eng.detok_seconds - detok0) / (eng.n_ticks - ticks0) * 1e3,
               rounds=rounds, window_ticks=window)
    return out


def text_serve(torch, card: dict, tokenizers: dict, assets: dict, writer: dict,
               workdir: str) -> dict:
    """Text prompts served at phase 4's shapes. LLaMA-3.2-1B bf16 through
    the CLI (``--tokenizer_path``), GPT-2-124M fp32 in process, with
    ``on_token`` pieces and ``stream()``. Gates: every budget finished;
    greedy ids bit-equal to the same requests sent as ``prompt_ids =
    tok.encode(prompt)`` without a tokenizer; ``text`` = ``decode(ids)``;
    the streamed pieces join to ``text`` and are the non-empty ``on_token``
    pieces, then the tail held at the finish; B5 = layers x ticks. Then
    the hold rule and the tick with the tokenizer against the tick without
    it (GPT-2)."""
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.ops.decode_step import fused_decode_step
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine

    os.makedirs(workdir, exist_ok=True)
    out = {}
    for m in TEXT_SERVE:
        tok = tokenizers[m["model"]]
        requests = text_requests(writer, m["requests"])
        cfg = get_config(m["model"], m["size"], dtype=m["dtype"],
                         target_context_length=m["context"])
        facts = dict(shape=(m["slots"], cfg.n_heads, cfg.n_kv_groups, cfg.head_dim,
                            m["context"], m["dtype"]),
                     prompt_tokens=sum(len(tok.encode(p)) for p, _ in requests))
        if m["cli"]:
            engine, lines, launches = text_serve_cli(torch, m, tok, assets, requests,
                                                     workdir, text=True)
            st = engine.stats()
            _, id_lines, _ = text_serve_cli(torch, m, tok, assets, requests, workdir,
                                            text=False)
            ids = [ln["token_ids"] for ln in lines]
            texts = [ln["text"] for ln in lines]
            same = ids == [ln["token_ids"] for ln in id_lines]
            streamed = on_token = None
            del engine
        else:
            model = build_model(cfg, seed=0, device="cuda")
            pieces = {}

            def on_tok(req, tok_id, piece):
                pieces.setdefault(req.id, []).append(piece)

            engine = DecodeEngine(model, tok, n_slots=m["slots"], max_len=m["context"],
                                  max_queue=64)
            fused_decode_step.launches = 0          # the main path's count
            engine.start()
            try:
                handles = [engine.submit(p, sp, block=True, on_token=on_tok)
                           for p, sp in requests]
                streamed = [list(h.stream(timeout=600)) for h in handles]
                for h in handles:
                    h.result(timeout=600)
            finally:
                engine.shutdown()
            launches = fused_decode_step.launches
            st = engine.stats()
            ids = [h.output_ids for h in handles]
            texts = [h.text for h in handles]
            # on_token sees each token's committed piece; a tail still held
            # when the request finishes reaches only the stream, last
            on_token = [[p for p in pieces[h.id] if p] for h in handles]
            tails = [t[len("".join(p)):] for t, p in zip(texts, on_token)]
            on_token = [p + ([t] if t else []) for p, t in zip(on_token, tails)]
            facts.update(held_tokens=sum(p == "" for h in handles for p in pieces[h.id]),
                         tails_at_finish=sum(map(bool, tails)),
                         stream_pieces=sum(map(len, streamed)))
            id_handles = serve(DecodeEngine(model, n_slots=m["slots"], max_len=m["context"],
                                            max_queue=64),
                               [(tok.encode(p), sp) for p, sp in requests])
            same = ids == [h.output_ids for h in id_handles]
            facts["hold_rule"] = detok_hold_check(DecodeEngine, model, tok)
            facts["ticks"] = detok_paired_ticks(torch, DecodeEngine, model, tok, requests,
                                                m["slots"], m["context"])
            del model, engine
        budgets = [sp.max_new_tokens for _, sp in requests]
        decoded = [tok.decode(i) for i in ids]
        facts.update(launches=launches, decode_ticks=st["n_ticks"],
                     detok_s=st.get("detok_seconds"), decode_s=st["decode_seconds"],
                     mean_tick_ms=st["decode_seconds"] / st["n_ticks"] * 1e3,
                     new_tokens=st["tokens_generated"], ids_equal=same,
                     text_chars=sum(map(len, texts)),
                     replacement_chars=sum(t.count("\ufffd") for t in texts))
        ok = (same and [len(i) for i in ids] == budgets and texts == decoded
              and launches == cfg.n_layers * st["n_ticks"] and launches > 0
              and (streamed is None or (streamed == on_token and texts == [
                  "".join(p) for p in streamed])))
        emit("text-serve", card=card["card_line"], model=cfg.name, dtype=m["dtype"],
             via="cli" if m["cli"] else "in process", **facts)
        if not ok:
            raise AssertionError(f"phase 9t serving {cfg.name}: ids equal {same}, "
                                 f"texts {texts == decoded}, launches {launches} for "
                                 f"{cfg.n_layers} x {st['n_ticks']}, streamed "
                                 f"{streamed == on_token}")
        out[m["label"]] = facts
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_text(torch, card: dict, workdir: str) -> dict:
    """Phase 9t: synthetic BPE files written from a seed
    (``scripts/build_local_bpe.py``: 3,000 learned merges, padded to
    128,000 / 50,256 ranks), the tokenizers' host rates, LLaMA-3.2-1B
    pretraining with the token cache and its relaunch, GPT-2 LoRA SFT with
    B4, and text serving."""
    from building_llm_from_scratch_tpu_torch.data import tokenizers as ttok

    writer = bpe_writer()
    io0 = written_bytes()
    t0 = time.perf_counter()
    assets = writer["write_assets"](os.path.join(workdir, "bpe"), TEXT_MERGES, full=True)
    write_s = time.perf_counter() - t0
    rates = tokenizer_rates(writer, assets)
    emit("text-tokenizers", card=card["card_line"], assets_write_s=write_s,
         merges=assets["merges"], llama3_ranks=assets["llama3_ranks"],
         gpt2_ranks=assets["gpt2_ranks"], **rates)
    tokenizers = {"llama3_2": ttok.Llama3Tokenizer(assets["tokenizer_model"]),
                  "GPT2": ttok.GPT2Tokenizer.from_files(assets["vocab_bpe"],
                                                        assets["encoder_json"])}
    pretrain = text_pretrain(torch, tokenizers["llama3_2"], writer, assets,
                             os.path.join(workdir, "pretrain"))
    emit("text-pretrain", card=card["card_line"], model="llama3_2-1B", dtype="bf16",
         corpus_chars=pretrain["corpus_chars"], tokens=pretrain["first"]["tokens"],
         cache_file_bytes=pretrain["cache_file_bytes"],
         prepass_first_s=pretrain["first"]["cache"]["encode_seconds"],
         prepass_relaunch_s=pretrain["relaunch"]["cache"]["disk_seconds"],
         **{f"{k}_{f}": pretrain[k][f] for k in ("first", "relaunch")
            for f in ("launches", "losses", "to_first_step_s", "run_step_ms", "cache")})
    sft = text_sft(torch, tokenizers["GPT2"], os.path.join(workdir, "sft"))
    emit("text-sft", card=card["card_line"], model="gpt2-124M", dtype="fp32", **sft)
    served = text_serve(torch, card, tokenizers, assets, writer,
                        os.path.join(workdir, "serve"))
    io1 = written_bytes()
    emit("text-io", wchar=io1["wchar"] - io0["wchar"],
         write_bytes=io1["write_bytes"] - io0["write_bytes"])
    return dict(pretrain=pretrain, sft=sft, served=served)


# ---------------------------------------------------------------------------
# phase 10d: data-parallel, FSDP and ZeRO-1 training (parallel/)
# ---------------------------------------------------------------------------

#: the world-1 NCCL runs: LLaMA-3.2-1B bf16 at phase 6's shape, 10 steps
SHARD_TRAIN = dict(model="llama3_2", size="1B", dtype="bf16", batch=4,
                   context=1024, steps=10, export=False)
SHARD_SFT = dict(model="llama3_2", size="1B", dtype="bf16", batch=4,
                 context=1024, steps=10, rank=16, alpha=32.0)
#: the two ranks over gloo on the one card: GPT-2-124M at its default dtype
#: (fp32), 12 layers, B 4 x T 1024 per rank against one rank at B 8
GLOO = dict(model="GPT2", size="124M", batch=4, context=1024, steps=3,
            seed=5, timeout_s=420)


@contextlib.contextmanager
def group_watch():
    """Around a ``--run_type multi_chip`` CLI run: the collectives counted
    from 0, and the group's backend and world size as the first sharded
    step saw them (the launcher destroys the group when the run ends)."""
    import torch.distributed as dist

    import building_llm_from_scratch_tpu_torch.training.trainer as ttr
    from building_llm_from_scratch_tpu_torch.parallel import collectives

    seen = {}
    makers = {k: getattr(ttr, k) for k in ("make_sharded_train_step",
                                            "make_pp_train_step")}

    def watched(make):
        def build(*args, **kwargs):
            step = make(*args, **kwargs)

            def watched_step(state, batch):
                if "backend" not in seen:
                    seen.update(backend=dist.get_backend(),
                                world=dist.get_world_size(),
                                mode=state.plan.shard_mode)
                return step(state, batch)
            return watched_step
        return build

    collectives.reset_counters()
    for k, make in makers.items():
        setattr(ttr, k, watched(make))
    try:
        yield seen
    finally:
        for k, make in makers.items():
            setattr(ttr, k, make)
        seen["counters"] = collectives.counters()


def shard_sft_run(torch, t: dict, workdir: str, flags: list) -> dict:
    """LLaMA-3.2-1B LoRA SFT through the CLI on phase 6s's Alpaca records
    sized for t["steps"] steps, ``flags`` added; the launches of phase 6's
    rule, finite losses; nothing written (checkpoint and export
    counted)."""
    from building_llm_from_scratch_tpu_torch import main as tmain

    data_dir = os.path.join(workdir, "data")
    os.makedirs(data_dir, exist_ok=True)
    data = os.path.join(data_dir, "alpaca.json")
    write_alpaca(data, math.ceil(t["steps"] * t["batch"] / 0.9))
    argv = ["--mode", "train", "--model", t["model"], "--num_params", t["size"],
            *dtype_flags(t), "--byte_tokenizer", "--finetune", "--dataset", "alpaca",
            "--use_lora", "--lora_rank", str(t["rank"]), "--lora_alpha", str(t["alpha"]),
            "--seed", str(SFT_SEED), "--data_dir", data_dir,
            "--output_dir", os.path.join(workdir, "out"), "--n_epochs", "1",
            "--batch_size", str(t["batch"]), "--eval_freq", str(t["steps"]),
            "--print_sample_iter", str(t["steps"]), *flags]
    with main_path(torch, False) as run, final_checkpoint_unwritten(), \
            export_unwritten(False):
        trainer = tmain.run(argv)
    cfg, loader = trainer.cfg, trainer.loader
    with open(data) as f:
        tr_ds, va_ds = loader.create_datasets(json.load(f))
    eval_batches = len(trainer.train_losses) * (
        min(5, loader.num_batches(tr_ds)) + min(5, loader.num_batches(va_ds)))
    want = expected_launches(cfg, trainer.global_step, eval_batches, False, lora=True)
    losses = [m["loss"] for m in trainer.step_metrics]
    if trainer.global_step != t["steps"] or run["launches"] != want or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"phase 10d SFT {flags}: {trainer.global_step} steps, "
                             f"launches {run['launches']} != {want}, losses {losses}")
    return dict(losses=losses, launches=run["launches"], expected=want,
                run_step_ms=run["run_step_ms"], wall_s=run["wall_s"],
                peak_gb=run["peak_gb"], evals=trainer.train_losses + trainer.val_losses)


#: phase 10d's world-1 pp run (LLaMA-3.2-1B bf16, 4 microbatches of one
#: row) against single_chip: the per-step losses' largest relative
#: difference, pinned beside the control's (each step's last microbatch
#: with its gradient zeroed). The first step's losses agree to 8e-8; the
#: bf16 gradients of four microbatches add in bf16, so the 10 steps drift
#: apart: measured 4.9e-3 against the control's 0.232 (NVIDIA H100 80GB
#: HBM3, 700.00 W), the bound near their geometric middle
PP_WORLD1 = dict(micro=4, loss_tol=3e-2)


@contextlib.contextmanager
def pp_last_microbatch_unlearned(n_micro: int):
    """The control of 10d's pp run: every train step's last microbatch keeps
    its loss but gives no gradient (its backward still runs, on zeros, so
    the launches stay exact)."""
    import torch

    import building_llm_from_scratch_tpu_torch.training.train_step as tts

    sums, calls = tts.dense_sums, [0]

    def control(*args, **kwargs):
        nll, w = sums(*args, **kwargs)
        if torch.is_grad_enabled():
            calls[0] += 1
            if calls[0] % n_micro == 0:
                nll = nll.detach() + 0.0 * nll
        return nll, w

    tts.dense_sums = control
    try:
        yield
    finally:
        tts.dense_sums = sums


def phase_shard_world1(torch, card: dict, workdir: str) -> dict:
    """10d, part 1: the CLI with ``--run_type multi_chip`` on the one card
    (a one-rank NCCL group the launcher forms) under dp, fsdp and zero1
    (LLaMA-3.2-1B bf16 pretraining) and fsdp (its LoRA SFT), each against
    the ``single_chip`` run of the same flags: per-step losses and
    evaluations bit for bit, the launches exact, the group NCCL with one
    rank and its collectives counted; the step ms beside single_chip's
    (the cost of the collectives at world 1)."""
    import gc

    runs = {}
    base_trainer, base = train_run(torch, dict(SHARD_TRAIN),
                                   os.path.join(workdir, "single"))
    base_evals = base_trainer.train_losses + base_trainer.val_losses
    del base_trainer
    gc.collect()
    torch.cuda.empty_cache()
    base_ms = statistics.median(base["run_step_ms"][1:])
    for mode in ("dp", "fsdp", "zero1"):
        flags = ["--run_type", "multi_chip", "--shard_mode", mode]
        with group_watch() as seen:
            trainer, facts = train_run(torch, dict(SHARD_TRAIN, flags=flags),
                                       os.path.join(workdir, mode))
        evals = trainer.train_losses + trainer.val_losses
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        ms = statistics.median(facts["run_step_ms"][1:])
        row = dict(mode=mode, backend=seen.get("backend"), world=seen.get("world"),
                   counters=seen["counters"], losses_bit_equal=facts["losses"] == base["losses"],
                   evals_bit_equal=evals == base_evals, launches=facts["launches"],
                   expected=facts["expected"], step_ms=ms, single_chip_step_ms=base_ms,
                   collective_cost_ms=ms - base_ms, peak_gb=facts["peak_gb"],
                   losses=facts["losses"], single_chip_losses=base["losses"])
        emit("shard_world1", card=card["card_line"], model="llama3_2-1B",
             dtype="bf16", B=SHARD_TRAIN["batch"], T=SHARD_TRAIN["context"],
             steps=SHARD_TRAIN["steps"], **row)
        if (seen.get("backend") != "nccl" or seen.get("world") != 1
                or not any(c["calls"] for c in seen["counters"].values())
                or not row["losses_bit_equal"] or not row["evals_bit_equal"]):
            raise AssertionError(f"phase 10d world-1 {mode}: {row}")
        runs[mode] = row
    # pp at world 1: one stage, --pp_micro microbatches; the normal entry
    # point on the card, held to single_chip's losses within a bound that
    # its control fails
    flags = ["--run_type", "multi_chip", "--shard_mode", "pp", "--pp", "1",
             "--pp_micro", str(PP_WORLD1["micro"])]
    pp = {}
    for label, control in (("run", contextlib.nullcontext()),
                           ("control", pp_last_microbatch_unlearned(PP_WORLD1["micro"]))):
        with group_watch() as seen, control:
            trainer, facts = train_run(torch, dict(SHARD_TRAIN, flags=flags),
                                       os.path.join(workdir, f"pp-{label}"))
        pp[label] = dict(facts, evals=trainer.train_losses + trainer.val_losses,
                         seen=seen, plan=trainer.plan.shard_mode)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    rel = {k: max(abs(a / b - 1.0) for a, b in zip(v["losses"], base["losses"]))
           for k, v in pp.items()}
    ms = statistics.median(pp["run"]["run_step_ms"][1:])
    row = dict(mode="pp", micro=PP_WORLD1["micro"], backend=pp["run"]["seen"].get("backend"),
               world=pp["run"]["seen"].get("world"), loss_rel=rel["run"],
               control_loss_rel=rel["control"], loss_tol=PP_WORLD1["loss_tol"],
               evals=pp["run"]["evals"], single_chip_evals=base_evals,
               launches=pp["run"]["launches"], expected=pp["run"]["expected"],
               control_launches=pp["control"]["launches"], step_ms=ms,
               single_chip_step_ms=base_ms, peak_gb=pp["run"]["peak_gb"],
               losses=pp["run"]["losses"], control_losses=pp["control"]["losses"],
               single_chip_losses=base["losses"])
    emit("shard_world1_pp", card=card["card_line"], model="llama3_2-1B", dtype="bf16",
         B=SHARD_TRAIN["batch"], T=SHARD_TRAIN["context"], steps=SHARD_TRAIN["steps"],
         **row)
    if (row["backend"] != "nccl" or row["world"] != 1 or pp["run"]["plan"] != "pp"
            or not rel["run"] <= PP_WORLD1["loss_tol"] < rel["control"]):
        raise AssertionError(f"phase 10d world-1 pp: {row}")
    runs["pp"] = row
    sft_base = shard_sft_run(torch, SHARD_SFT, os.path.join(workdir, "sft-single"), [])
    flags = ["--run_type", "multi_chip", "--shard_mode", "fsdp"]
    with group_watch() as seen:
        sft = shard_sft_run(torch, SHARD_SFT, os.path.join(workdir, "sft-fsdp"), flags)
    ms, b_ms = (statistics.median(r["run_step_ms"][1:]) for r in (sft, sft_base))
    row = dict(mode="fsdp", backend=seen.get("backend"), world=seen.get("world"),
               counters=seen["counters"], losses_bit_equal=sft["losses"] == sft_base["losses"],
               evals_bit_equal=sft["evals"] == sft_base["evals"],
               launches=sft["launches"], expected=sft["expected"], step_ms=ms,
               single_chip_step_ms=b_ms, collective_cost_ms=ms - b_ms,
               losses=sft["losses"], single_chip_losses=sft_base["losses"])
    emit("shard_world1_sft", card=card["card_line"], model="llama3_2-1B", dtype="bf16",
         rank=SHARD_SFT["rank"], B=SHARD_SFT["batch"], T=SHARD_SFT["context"],
         steps=SHARD_SFT["steps"], **row)
    if (seen.get("backend") != "nccl" or seen.get("world") != 1
            or not any(c["calls"] for c in seen["counters"].values())
            or not row["losses_bit_equal"] or not row["evals_bit_equal"]):
        raise AssertionError(f"phase 10d world-1 SFT fsdp: {row}")
    runs["sft-fsdp"] = row
    return runs


def _rel_l2(torch, a: dict, b: dict) -> dict:
    """The relative L2 distance of the parameters ``a`` from ``b`` (all
    leaves as one vector), and the leaf whose own relative distance is the
    largest (zero-initialised biases move by a few updates only, so theirs
    magnifies the roundings that Adam's g / sqrt(v) turns into steps)."""
    diff = sum(float((a[k].double() - v.double()).square().sum()) for k, v in b.items())
    norm = sum(float(v.double().square().sum()) for v in b.values())
    leaf = {k: float((a[k].double() - v.double()).norm() / v.double().norm().clamp_min(1e-30))
            for k, v in b.items()}
    worst = max(leaf, key=leaf.get)
    return dict(rel_l2=(diff / norm) ** 0.5, worst_leaf=worst, worst_leaf_rel_l2=leaf[worst])


def gloo_rank(rank: int, spec: dict) -> None:
    """One of 10d's two ranks on the one card (``torch.multiprocessing``
    spawn): a gloo group on ``cuda:0`` through the library API, GPT-2-124M
    fp32 sharded steps per mode on the rank's rows, rank 0 also one rank on
    the global batch; writes ``rank<r>.json`` into spec["out"]."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, spec["root"])
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.parallel import collectives
    from building_llm_from_scratch_tpu_torch.parallel import mesh
    from building_llm_from_scratch_tpu_torch.parallel.sharding import build_mesh_plan
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts
    from building_llm_from_scratch_tpu_torch.training.precision import get_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["BLLM_XENT_PALLAS"] = "1"
    dev = torch.device(spec.get("device", "cuda:0"))
    mesh.initialize_distributed(backend="gloo", init_method=spec["init"], rank=rank,
                                world_size=2, device=dev, timeout_s=spec["timeout_s"])
    kernels = train_kernels()
    g = spec["gloo"]
    cfg0 = dataclasses.replace(get_config(g["model"], g["size"]), drop_rate=0.0,
                               **g.get("cut", {}))
    T = cfg0.context_length
    rng = np.random.default_rng(g["seed"])
    x = torch.from_numpy(rng.integers(0, cfg0.vocab_size, (g["steps"], 2 * g["batch"], T + 1)))
    mine = slice(rank, None, 2)

    def run(mode, rows=mine, policy=None, cfg=cfg0, steps=g["steps"]):
        # this rank's memory from here on: what the run allocates on top of
        # what earlier runs left (their parameters, kept for the comparison)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        allocated = lambda: torch.cuda.memory_allocated(dev) if cuda else 0  # noqa: E731
        base = allocated()
        model = build_model(cfg, g["seed"], dev)
        opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
        plan = build_mesh_plan(mode) if mode in ("dp", "fsdp", "zero1") else None
        state = tts.init_train_state(model, opt, policy=get_policy(policy), plan=plan)
        step = (tts.make_sharded_train_step(cfg, opt, plan, policy=get_policy(policy))
                if plan else tts.make_train_step(cfg, opt, policy=get_policy(policy)))
        for f in kernels.values():
            f.launches = 0
        collectives.reset_counters()
        losses, wall = [], []
        for i in range(steps):
            batch = {"inputs": x[i, rows, :-1].to(dev), "targets": x[i, rows, 1:].to(dev)}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            wall.append((time.perf_counter() - t0) * 1e3)
        # between steps (fsdp has freed its working copy and gradients)
        # and at the peak of the steps
        memory = dict(resident_gb=(allocated() - base) / 1e9,
                      peak_gb=((torch.cuda.max_memory_allocated(dev) if cuda else 0)
                               - base) / 1e9)
        tts.gather_params(state)
        out = dict(losses=losses, step_ms=wall, counters=collectives.counters(),
                   **memory,
                   leaves=len(state.full),
                   launches={k: f.launches for k, f in kernels.items()},
                   expected=expected_launches(cfg, steps, 0, True),
                   moment_bytes=sum(t.numel() * t.element_size() for d in (
                       state.opt_state.mu, state.opt_state.nu) for t in d.values()))
        return out, {k: v.detach().clone() for k, v in state.full.items()}

    res, params = {}, {}
    for mode in ("dp", "zero1", "fsdp", "control"):
        res[mode], params[mode] = run(mode)
    if rank == 0:
        res["reference"], params["reference"] = run("reference", rows=slice(None))
        ref = params["reference"]
        res["compare"] = dict(
            zero1_bit_equal_dp=all(torch.equal(params["zero1"][k], v)
                                   for k, v in params["dp"].items()),
            **{f"{m}_params": _rel_l2(torch, params[m], ref)
               for m in ("dp", "fsdp", "zero1", "control")},
            **{f"{m}_loss_rel": max(abs(a / b - 1.0) for a, b in zip(
                res[m]["losses"], res["reference"]["losses"]))
               for m in ("dp", "fsdp", "zero1")})
    del params
    torch.cuda.empty_cache()
    res["bf16_hybrid"], _ = run("fsdp", policy="bf16_hybrid", steps=1)
    # one step with dropout 0.1 on the SAME rows on both ranks: each rank's
    # own loss share (before the all-reduce) shows whether its masks differ
    shares = []
    loss = tts._Collectives.loss
    tts._Collectives.loss = lambda self, v: shares.append(float(v.detach())) or loss(self, v)
    try:
        res["dropout"], _ = run("dp", rows=slice(0, g["batch"]), steps=1,
                                cfg=dataclasses.replace(cfg0, drop_rate=0.1))
    finally:
        tts._Collectives.loss = loss
    res["dropout"]["local_share"] = shares[0]
    res["dropout"]["expected"] = expected_launches(
        dataclasses.replace(cfg0, drop_rate=0.1), 1, 0, True)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh.shutdown_distributed()


def phase_shard_gloo(torch, card: dict, workdir: str) -> dict:
    """10d, part 2: two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), GPT-2-124M fp32 at full width (12 layers), B 4
    per rank, 3 steps a mode, dropout 0, B4 on (module docstring gates)."""
    import torch.multiprocessing as mp

    out = os.path.join(workdir, "gloo")
    os.makedirs(out, exist_ok=True)
    spec = dict(root=os.path.dirname(os.path.abspath(__file__)), out=out,
                init=f"file://{out}/rendezvous", gloo=GLOO,
                timeout_s=GLOO["timeout_s"])
    ctx = mp.start_processes(gloo_rank, args=(spec,), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + GLOO["timeout_s"]
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError("phase 10d: the two gloo ranks did not finish "
                                     f"in {GLOO['timeout_s']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    res = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    cmp_ = res[0]["compare"]
    small = 2 * 2 * 768 * 4           # the final norm's scale and bias: mu, nu
    fails = []
    if not cmp_["zero1_bit_equal_dp"]:
        fails.append("zero1 != dp")
    for m in ("dp", "fsdp", "zero1"):
        # all leaves as one vector within 1e-5, and every leaf within 1e-3
        # of its own norm (zero-initialised biases have small norms)
        if cmp_[f"{m}_params"]["rel_l2"] > 1e-5 or cmp_[f"{m}_loss_rel"] > 1e-5 \
                or cmp_[f"{m}_params"]["worst_leaf_rel_l2"] > 1e-3:
            fails.append(f"{m} vs one rank")
    if not cmp_["control_params"]["rel_l2"] > 1e-5:
        fails.append("the no-reduce control passed the bound")
    for r, rr in enumerate(res):
        for m in ("zero1", "fsdp"):
            if abs(rr[m]["moment_bytes"] - rr["dp"]["moment_bytes"] / 2) > small:
                fails.append(f"rank {r} {m} moments not halved")
        if not rr["fsdp"]["resident_gb"] < rr["zero1"]["resident_gb"] \
                < rr["dp"]["resident_gb"]:
            fails.append(f"rank {r} held between steps: fsdp, zero1, dp not in "
                         "increasing order")
        # fsdp gathers and reduce-scatters the blocks layer by layer: its
        # step's peak is below zero1's
        if not rr["fsdp"]["peak_gb"] < rr["zero1"]["peak_gb"]:
            fails.append(f"rank {r} step peak: fsdp {rr['fsdp']['peak_gb']} not "
                         f"below zero1 {rr['zero1']['peak_gb']}")
        for m in ("dp", "zero1", "fsdp", "control", "dropout"):
            if rr[m]["launches"] != rr[m]["expected"]:
                fails.append(f"rank {r} {m} launches {rr[m]['launches']}")
        hyb = rr["bf16_hybrid"]["counters"]
        n_bf16 = sum(hyb.get(f"{op}/bf16", {}).get("calls", 0)
                     for op in ("all_reduce", "reduce_scatter"))
        if n_bf16 != rr["bf16_hybrid"]["leaves"] or "reduce_scatter/fp32" in hyb:
            fails.append(f"rank {r} bf16_hybrid reduces {hyb}")
    masks_differ = res[0]["dropout"]["local_share"] != res[1]["dropout"]["local_share"]
    if not masks_differ:
        fails.append("both ranks drew the same dropout masks")
    row = dict(card=card["card_line"], model="gpt2-124M", dtype="fp32", layers=12,
               B_per_rank=GLOO["batch"], T=GLOO["context"], steps=GLOO["steps"],
               compare=cmp_, masks_differ=masks_differ,
               dropout_local_shares=[rr["dropout"]["local_share"] for rr in res],
               moment_bytes={m: [rr[m]["moment_bytes"] for rr in res]
                             for m in ("dp", "zero1", "fsdp")},
               memory_gb={m: {k: [rr[m][k] for rr in res]
                              for k in ("resident_gb", "peak_gb")}
                          for m in ("dp", "zero1", "fsdp", "control")},
               launches={m: res[0][m]["launches"] for m in
                         ("dp", "zero1", "fsdp", "control", "dropout")},
               counters={m: res[0][m]["counters"] for m in ("dp", "zero1", "fsdp",
                                                           "bf16_hybrid")},
               gloo_host_staging_step_ms={m: res[0][m]["step_ms"] for m in
                                          ("dp", "zero1", "fsdp", "bf16_hybrid")},
               timed_beside="the reference window (gloo_groups_beside)",
               one_rank_b8_step_ms=res[0]["reference"]["step_ms"],
               no_reduce_step_ms=res[0]["control"]["step_ms"], fails=fails)
    emit("shard_gloo", **row)
    if fails:
        raise AssertionError(f"phase 10d two gloo ranks: {fails}")
    return dict(launches=row["launches"])


@contextlib.contextmanager
def gloo_groups_beside(torch, card: dict):
    """10d's two gloo ranks, then 10t / 10s / 10p's groups, in a thread of
    their own for the body's duration (the reference window: its gates take
    no timing). They run in processes they spawn and are gated as when run
    alone; their step ms (gloo-staged host numbers) are taken beside the
    window's phases, and say so. Yields a dict filled on exit (``gloo``,
    ``mesh``); a failure in the thread is raised on exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    box: dict = {}
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        def work():
            try:
                box["gloo"] = phase_shard_gloo(torch, card, workdir)
                box["mesh"] = phase_mesh(torch, card, workdir)
            except BaseException as e:          # raised again on exit
                box["error"] = e

        thread = threading.Thread(target=work, name="gloo-groups")
        thread.start()
        try:
            yield box
        finally:
            thread.join()
    if "error" in box:
        raise box["error"]


# ---------------------------------------------------------------------------
# phase 6r: selective-save remat, save-all and full remat
# ---------------------------------------------------------------------------

#: the two training shapes of phase 6r: LLaMA-3.2-1B bf16 (B 4 x T 1024)
#: and GPT-2-124M fp32 (B 8 x T 1024, dropout 0.1), a few steps each
REMAT = [dict(model="llama3_2", size="1B", dtype="bf16", batch=4, context=1024,
              steps=4, drop=None, seed=31),
         dict(model="GPT2", size="124M", dtype="fp32", batch=8, context=1024,
              steps=4, drop=0.1, seed=32)]
REMAT_MODES = ("none", "selective", "full")


def remat_run(torch, t: dict, mode: str) -> dict:
    """t["steps"] steps of the library's train step from one seeded model
    and batches in remat ``mode`` (the model's ``_SAVE_ALL`` for "none",
    use_actv_ckpt for "full"): the losses, each step's ms (host clock around a synchronised
    step), the peak of allocated memory (reset before the model is built)
    and every kernel's launches."""
    import dataclasses

    import numpy as np

    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    from building_llm_from_scratch_tpu_torch.models import transformer as ttf

    dev = torch.device("cuda")
    ttf._SAVE_ALL = mode == "none"
    cfg = get_config(t["model"], t["size"], dtype=t["dtype"],
                     use_actv_ckpt=mode == "full")
    if t["drop"] is not None:
        cfg = dataclasses.replace(cfg, drop_rate=t["drop"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, t["seed"], dev)
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(model, opt, seed=t["seed"])
    step = tts.make_train_step(cfg, opt)
    x = torch.from_numpy(np.random.default_rng(t["seed"]).integers(
        0, cfg.vocab_size, (t["steps"], t["batch"], t["context"] + 1))).to(dev)
    kernels = train_kernels()
    for f in kernels.values():
        f.launches = 0
    losses, ms = [], []
    try:
        for i in range(t["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, {"inputs": x[i, :, :-1], "targets": x[i, :, 1:]})
            losses.append(m["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        ttf._SAVE_ALL = False
    out = dict(losses=losses, step_ms=ms, steady_ms=statistics.median(ms[1:]),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               launches={k: f.launches for k, f in kernels.items()},
               expected=expected_launches(cfg, t["steps"], 0, False))
    del state, model, step, x
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_remat(torch, card: dict) -> dict:
    """Phase 6r: each of REMAT's shapes under save-all, selective (the
    default) and full remat: per-step losses bit-equal across the three,
    launches exact (B1 once a layer and step without full remat, twice
    with it), selective's peak below save-all's; step ms and peaks."""
    out = {}
    for t in REMAT:
        runs = {mode: remat_run(torch, t, mode) for mode in REMAT_MODES}
        name = f"{t['model']}-{t['size']}-{t['dtype']}"
        fails = []
        for mode, r in runs.items():
            if r["losses"] != runs["none"]["losses"]:
                fails.append(f"{mode} losses differ from save-all's")
            if r["launches"] != r["expected"]:
                fails.append(f"{mode} launches {r['launches']} != {r['expected']}")
            if not all(map(math.isfinite, r["losses"])):
                fails.append(f"{mode} losses not finite")
        if not runs["selective"]["peak_gb"] < runs["none"]["peak_gb"]:
            fails.append("selective's peak is not below save-all's")
        emit("remat", card=card["card_line"], model=name, B=t["batch"], T=t["context"],
             steps=t["steps"], drop=t["drop"],
             **{mode: {k: r[k] for k in ("losses", "step_ms", "steady_ms", "peak_gb",
                                         "launches")} for mode, r in runs.items()},
             fails=fails)
        if fails:
            raise AssertionError(f"phase 6r {name}: {fails}")
        out[name] = runs
    return out


# ---------------------------------------------------------------------------
# phases 10t and 10s: tensor and sequence parallelism on gloo ranks
# ---------------------------------------------------------------------------

#: the runs of a group: name, model, size, dtype (None: fp32), mode, tp,
#: sp (pp: the stages and microbatches), the global batch, dropout (None:
#: the config's), steps, and the bounds against one rank on the global
#: batch (the losses' largest relative difference and the parameters'
#: relative L2, all leaves as one vector), pinned beside the control's
#: (the row-parallel all-reduce skipped under tp, the ring's hops under sp,
#: the forward hops' activations zeroed under pp)
MESH_RUNS = {
    # GPT-2's tp / sp / tp_fsdp runs at 6 of its 12 layers: phase 10p's
    # time is bought back from them
    2: [dict(name="gpt2-tp2", model="GPT2", size="124M", dtype=None, mode="tp", tp=2,
             sp=1, batch=4, drop=0.0, steps=2, layers=6, loss_tol=1e-5, param_tol=1e-5),
        dict(name="gpt2-tp2-p0.1", model="GPT2", size="124M", dtype=None, mode="tp",
             tp=2, sp=1, batch=4, drop=0.1, steps=2, layers=6, loss_tol=1e-5,
             param_tol=1e-5),
        # bf16: each row-parallel output sums two bf16 partial products
        # (one rank rounds one GEMM); at this cut (8 layers, 2 steps)
        # measured 3.6e-5 / 1.87e-3 against the control's 3.2e-4 / 2.43e-2
        # (NVIDIA H100 80GB HBM3, 700.00 W): the bounds sit near the
        # geometric middles, so the control fails both
        dict(name="llama-tp2", model="llama3_2", size="1B", dtype="bf16", mode="tp",
             tp=2, sp=1, batch=4, drop=None, steps=2, layers=8, loss_tol=1.5e-4,
             param_tol=6e-3),
        dict(name="gpt2-sp2-p0.1", model="GPT2", size="124M", dtype=None, mode="dp",
             tp=1, sp=2, batch=4, drop=0.1, steps=2, layers=6, loss_tol=1e-5,
             param_tol=1e-5),
        # bf16: the ring's fp32 scores and P.V against B1's bf16 P; at this
        # cut measured 1.6e-5 / 1.83e-3 against the control's 1.5e-3 /
        # 2.5e-2 (the same card), bounds as above
        dict(name="llama-sp2", model="llama3_2", size="1B", dtype="bf16", mode="dp",
             tp=1, sp=2, batch=4, drop=None, steps=2, layers=8, loss_tol=1.5e-4,
             param_tol=6e-3),
        # phase 10p: GPipe at pp 2, B 8 in 4 microbatches of 2 rows, against
        # one rank holding every layer and drawing the same folded masks.
        # Each stage runs what the one rank runs on its layers, so both
        # measured 0 / 0 (bit-equal) against the controls' 1.4e-2 / 2.3e-2
        # (GPT-2) and 3.3e-2 / 2.7e-2 (LLaMA bf16; NVIDIA H100 80GB HBM3,
        # 700.00 W): LLaMA takes the fp32 bounds too
        dict(name="gpt2-pp2", model="GPT2", size="124M", dtype=None, mode="pp", tp=1,
             sp=1, pp=2, micro=4, batch=8, drop=0.1, steps=2, loss_tol=1e-5,
             param_tol=1e-5),
        dict(name="llama-pp2", model="llama3_2", size="1B", dtype="bf16", mode="pp",
             tp=1, sp=1, pp=2, micro=4, batch=8, drop=None, steps=1, layers=8,
             loss_tol=1e-5, param_tol=1e-5)],
    4: [dict(name="gpt2-tp_fsdp", model="GPT2", size="124M", dtype=None, mode="tp_fsdp",
             tp=2, sp=1, batch=8, drop=0.0, steps=2, layers=6, loss_tol=1e-5,
             param_tol=1e-5),
        dict(name="gpt2-pp2-tp2", model="GPT2", size="124M", dtype=None, mode="pp",
             tp=2, sp=1, pp=2, micro=4, batch=8, drop=0.0, steps=1, loss_tol=1e-5,
             param_tol=1e-5)],
}
MESH = dict(seed=13, timeout_s=900)


def mesh_config(r: dict):
    """A mesh run's config: full width, its depth cut to r["layers"] where
    it names one (the gloo staging of the gradients and the gathers scales
    with it), its dropout rate where it names one."""
    import dataclasses

    from building_llm_from_scratch_tpu_torch.configs import get_config

    cfg = get_config(r["model"], r["size"], dtype=r["dtype"])
    if r["drop"] is not None:
        cfg = dataclasses.replace(cfg, drop_rate=r["drop"])
    if r.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=r["layers"])
    return cfg


def _mesh_control(kind: str):
    """The control of a mesh run: the row-parallel outputs left unreduced
    (tp), the ring's k/v blocks never passed on (sp), or every forward hop's
    activation zeroed, left unsent (pp)."""
    from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
    from building_llm_from_scratch_tpu_torch.parallel import pipeline
    from building_llm_from_scratch_tpu_torch.parallel import tensor as ptensor

    if kind == "pp":
        hop = pipeline.hop_forward
        pipeline.hop_forward = lambda y, dst: hop(y.new_zeros(y.shape), dst)

        def undo():
            pipeline.hop_forward = hop
    elif kind == "tp":
        saved = ptensor.Parallel.reduce_from_model
        ptensor.Parallel.reduce_from_model = lambda self, x: x

        def undo():
            ptensor.Parallel.reduce_from_model = saved
    else:
        shift = coll.ring_shift
        coll.ring_shift = lambda ts, group=None, label=None: [t.clone() for t in ts]

        def undo():
            coll.ring_shift = shift
    return undo


def _ring_timer(torch):
    """Wrap the ring's forward and backward with synchronised host timers;
    returns (the list of ms, undo)."""
    from building_llm_from_scratch_tpu_torch.ops import ring_attention as ra

    spent, orig = [], (ra.ring_attention_fwd, ra.ring_attention_bwd)

    def timed(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    ra.ring_attention_fwd, ra.ring_attention_bwd = timed(orig[0]), timed(orig[1])

    def undo():
        ra.ring_attention_fwd, ra.ring_attention_bwd = orig
    return spent, undo


def mesh_rank(rank: int, spec: dict) -> None:
    """One rank of a 10t / 10s group on cuda:0 over gloo: each run of
    MESH_RUNS[world] on the mesh, then its control; rank 0 then runs one
    rank on the global batch and compares. Writes ``rank<r>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, spec["root"])
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.parallel import collectives
    from building_llm_from_scratch_tpu_torch.parallel import mesh
    from building_llm_from_scratch_tpu_torch.parallel import pipeline
    from building_llm_from_scratch_tpu_torch.parallel.sharding import build_mesh_plan
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    world = spec["world"]

    def steps_of(r, cfg, opt, plan_args):
        """(plan, train step, eval step or None) of a run: pp's pipelined
        steps (one rank holding every layer as the reference, drawing the
        run's masks), else the sharded or the single-device step."""
        if r["mode"] == "pp":
            plan = (pipeline.build_pp_plan(r["pp"], n_micro=r["micro"], tp=r["tp"])
                    if plan_args else
                    pipeline.PipelinePlan(mesh=pipeline.make_pp_mesh(1, world_size=1),
                                          n_micro=r["micro"]))
            return (plan, tts.make_pp_train_step(cfg, opt, plan, dropout_stages=r["pp"]),
                    tts.make_pp_eval_step(cfg, plan))
        plan = build_mesh_plan(**plan_args) if plan_args else None
        return (plan, tts.make_sharded_train_step(cfg, opt, plan) if plan
                else tts.make_train_step(cfg, opt), None)
    mesh.initialize_distributed(backend="gloo", init_method=spec["init"], rank=rank,
                                world_size=world, device=dev, timeout_s=spec["timeout_s"])
    kernels = train_kernels()
    res = {}
    for r in MESH_RUNS[world]:
        cfg = mesh_config(r)
        T = cfg.context_length
        x = torch.from_numpy(np.random.default_rng(spec["seed"]).integers(
            0, cfg.vocab_size, (r["steps"], r["batch"], T + 1)))

        def run(plan_args, control=None):
            model = build_model(cfg, spec["seed"], dev)
            opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
            plan, step, evaluate = steps_of(r, cfg, opt, plan_args)
            state = tts.init_train_state(model, opt, plan=plan)
            rows = slice(None)
            if plan is not None and r["mode"] != "pp":
                rows = slice(plan.data_rank, None, plan.n_data)
            undo = _mesh_control(control) if control else None
            ring_ms, ring_undo = _ring_timer(torch) if plan and plan.n_seq > 1 else ([], None)
            for f in kernels.values():
                f.launches = 0
            collectives.reset_counters()
            losses, wall = [], []
            try:
                for i in range(r["steps"]):
                    batch = {"inputs": x[i, rows, :-1].to(dev), "targets": x[i, rows, 1:].to(dev)}
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    losses.append(m["loss"].item())
                    wall.append((time.perf_counter() - t0) * 1e3)
                # pp: one evaluation of the last batch (its B1 launches count)
                ev = evaluate(state, batch).item() if evaluate else None
            finally:
                if undo:
                    undo()
                if ring_undo:
                    ring_undo()
            facts = dict(losses=losses, step_ms=wall, counters=collectives.counters(),
                         eval_loss=ev, stage=getattr(plan, "stage_rank", None),
                         launches={k: f.launches for k, f in kernels.items()},
                         ring_ms_per_step=sum(ring_ms) / r["steps"] if ring_ms else None,
                         peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
            whole = tts.gather_whole(state)
            params = ({k: v.detach().clone() for k, v in whole.stacked.items()}
                      if rank == 0 else None)
            del state, model, whole, step
            gc.collect()
            torch.cuda.empty_cache()
            return facts, params

        args = dict(shard_mode=r["mode"], tp=r["tp"], sp=r["sp"])
        mine, params = run(args)
        control, cparams = run(args, "pp" if r["mode"] == "pp" else
                               "tp" if r["tp"] > 1 else "sp")
        out = dict(run=mine, control=control)
        if rank == 0:
            ref, rparams = run(None)
            diff = {}
            if ev_ref := ref.get("eval_loss"):
                diff["eval_rel"] = abs(mine["eval_loss"] / ev_ref - 1.0)
            for label, ps in (("run", params), ("control", cparams)):
                d = sum(float((ps[k].double() - v.double()).square().sum())
                        for k, v in rparams.items())
                n = sum(float(v.double().square().sum()) for v in rparams.values())
                ps.clear()
                diff[label] = dict(
                    params_rel_l2=(d / n) ** 0.5,
                    loss_rel=max(abs(a / b - 1.0) for a, b in
                                 zip(out[label]["losses"], ref["losses"])))
            out.update(reference=ref, compare=diff)
            del params, cparams, rparams
        dist.barrier()
        res[r["name"]] = out
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh.shutdown_distributed()


def mesh_group(torch, world: int, workdir: str) -> list:
    """MESH_RUNS[world] on ``world`` spawned gloo ranks on the one card;
    every rank's results."""
    import torch.multiprocessing as mp

    out = os.path.join(workdir, f"mesh{world}")
    os.makedirs(out, exist_ok=True)
    spec = dict(root=os.path.dirname(os.path.abspath(__file__)), out=out, world=world,
                init=f"file://{out}/rendezvous", **MESH)
    ctx = mp.start_processes(mesh_rank, args=(spec,), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + MESH["timeout_s"]
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 10t/10s: the {world} gloo ranks did not "
                                     f"finish in {MESH['timeout_s']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


#: the kernel rows at a pipeline microbatch's shape (phases 5, 5b, 5c) and
#: the 10p run that launches them
PP_SHAPES = {"llama3_2-1B-pp2": "llama-pp2", "gpt2-124M-pp2-fp32": "gpt2-pp2",
             "gpt2-124M-pp2-tp2-fp32": "gpt2-pp2-tp2"}


def pp_expected_launches(cfg, r: dict, stage: int) -> dict:
    """A pp stage rank's launches in a 10p run: each of its L/S layers runs
    B1 / B2a / B2b once per microbatch of a train step (selective remat)
    and B1 again per microbatch of the evaluation; with dropout, B3
    forward and backward twice per layer and microbatch, plus the
    embedding's once per microbatch on stage 0."""
    per, M, steps = cfg.n_layers // r["pp"], r["micro"], r["steps"]
    drops = (2 * per + (stage == 0)) * M * steps if cfg.drop_rate > 0 else 0
    return dict(fwd=per * M * (steps + 1), dq=per * M * steps, dkv=per * M * steps,
                dropout_fwd=drops, dropout_bwd=drops, xent_fwd=0)


def phase_mesh(torch, card: dict, workdir: str) -> dict:
    """Phases 10t, 10s and 10p: MESH_RUNS on two and four gloo ranks on the
    one card. Gates per run: every rank reports the same losses; against
    one rank on the global batch, the losses and the parameters within the
    run's bounds while the control falls outside them; launches exact per
    rank (B1/B2 at the rank's heads under tp, none under sp: the ring; per
    stage under pp, ``pp_expected_launches``)."""
    out = {}
    for world in (2, 4):
        res = mesh_group(torch, world, workdir)
        for r in MESH_RUNS[world]:
            name, fails = r["name"], []
            cmp_ = res[0][name]["compare"]
            for rr in res[1:]:
                if rr[name]["run"]["losses"] != res[0][name]["run"]["losses"]:
                    fails.append("the ranks' losses differ")
            if cmp_["run"]["loss_rel"] > r["loss_tol"] or \
                    cmp_["run"]["params_rel_l2"] > r["param_tol"]:
                fails.append(f"off one rank: {cmp_['run']}")
            if not (cmp_["control"]["loss_rel"] > r["loss_tol"]
                    or cmp_["control"]["params_rel_l2"] > r["param_tol"]):
                fails.append(f"the control passed the bounds: {cmp_['control']}")
            cfg = mesh_config(r)
            pp = r["mode"] == "pp"
            want = expected_launches(cfg, r["steps"], 0, False)
            if r["sp"] > 1:
                want.update(fwd=0, dq=0, dkv=0)
            wants = [pp_expected_launches(cfg, r, rr[name]["run"]["stage"]) if pp else want
                     for rr in res]
            for k, rr in enumerate(res):
                if rr[name]["run"]["launches"] != wants[k]:
                    fails.append(f"rank {k} launches {rr[name]['run']['launches']} "
                                 f"!= {wants[k]}")
            if pp and not cmp_["eval_rel"] <= r["loss_tol"]:
                fails.append(f"the eval loss off one rank's: {cmp_['eval_rel']}")
            row = dict(card=card["card_line"], run=name, world=world, mode=r["mode"],
                       tp=r["tp"], sp=r["sp"], batch=r["batch"], steps=r["steps"],
                       layers=cfg.n_layers,
                       loss_tol=r["loss_tol"], param_tol=r["param_tol"], compare=cmp_,
                       losses=res[0][name]["run"]["losses"],
                       one_rank_losses=res[0][name]["reference"]["losses"],
                       launches=res[0][name]["run"]["launches"], expected=want,
                       counters=res[0][name]["run"]["counters"],
                       gloo_host_staging_step_ms=res[0][name]["run"]["step_ms"],
                       timed_beside="the reference window (gloo_groups_beside)",
                       one_rank_step_ms=res[0][name]["reference"]["step_ms"],
                       ring_ms_per_step=res[0][name]["run"]["ring_ms_per_step"],
                       peak_gb=[rr[name]["run"]["peak_gb"] for rr in res], fails=fails)
            if pp:
                S, M = r["pp"], r["micro"]
                row.update(pp=S, micro=M, bubble_share=(S - 1) / (M + S - 1),
                           launches=[rr[name]["run"]["launches"] for rr in res],
                           expected=wants,
                           stages=[rr[name]["run"]["stage"] for rr in res],
                           eval_loss=res[0][name]["run"]["eval_loss"],
                           one_rank_eval_loss=res[0][name]["reference"]["eval_loss"])
            emit("mesh_pp" if pp else "mesh_sp" if r["sp"] > 1 else "mesh_tp", **row)
            if fails:
                raise AssertionError(f"phase 10t/10s/10p {name}: {fails}")
            out[name] = row
    return out


def sp_dropout_check(torch) -> dict:
    """B3 on a sequence-parallel rank's block (B 4, T 512 of 1024, D 768,
    fp32): forward with the residual add and backward bit-equal to the
    twins with the same layout, and the block's mask the whole tensor's
    (the twin's output on the whole tensor, sliced)."""
    from building_llm_from_scratch_tpu_torch.ops import fused_dropout as tfd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    B, T, D, n = 4, 1024, 768, 2
    xw = torch.randn(B, T, D, generator=gen, device=dev)
    hw = torch.randn(B, T, D, generator=gen, device=dev)
    whole = tfd.dropout_fwd_plain(xw, hw, 1234, 0.1)
    out = {}
    for s in range(n):
        blk = slice(s * T // n, (s + 1) * T // n)
        x, h = xw[:, blk].contiguous(), hw[:, blk].contiguous()
        row = T // n * D
        layout = (row // 4, row * n // 4, s * row // 4)
        k_fwd = tfd.dropout_fwd(x, h, 1234, 0.1, layout)
        k_bwd = tfd.dropout_bwd(h, 1234, 0.1, layout)
        ok = (torch.equal(k_fwd, tfd.dropout_fwd_plain(x, h, 1234, 0.1, layout))
              and torch.equal(k_bwd, tfd.dropout_bwd_plain(h, 1234, 0.1, layout))
              and torch.equal(k_fwd, whole[:, blk]))
        out[f"block{s}"] = ok
    emit("sp_dropout_kernel", B=B, T=T, D=D, blocks=n, **out)
    if not all(out.values()):
        raise AssertionError(f"B3 on a sequence block: {out}")
    return out


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
    if sys.argv[1:2] == ["--references"]:          # references_beside's child
        return references_main(torch, sys.argv[2], float(sys.argv[3]))

    card = phase_env(torch)
    phase_build()
    rows = phase_kernel(torch, card)
    paged_rows = phase_paged_kernel(torch, card, rows)
    lora_rows = phase_lora_kernel(torch, card)
    # serving runs before training: its ticks are host-bound, and a clean
    # process keeps them comparable with earlier runs
    served = phase_serve(torch)
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
        # the --profile trace of three GPT-2 fp32 steps (6p)
        profiled = phase_profile(torch, card, os.path.join(workdir, "profile"))
        # precision policies, accumulation and remat (6m), host overlap (6h)
        mixed = phase_mixed(torch, card, os.path.join(workdir, "mixed"),
                            dict(llama=trained, gpt2_fp32=trained_gpt2_fp32))
        overlap = phase_host_overlap(torch, os.path.join(workdir, "overlap"))
    # save-all, selective-save (the default) and full remat (6r)
    remat = phase_remat(torch, card)
    # LoRA SFT (phase 6s)
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        sft = phase_sft(torch, card, os.path.join(workdir, "llama"), SFT[0],
                        trained["pretrain"])
        phase_sft(torch, card, os.path.join(workdir, "gpt2"), SFT[1],
                  trained_gpt2_fp32["pretrain"])
        # the CPU reference phases 7s / 7 / 7m in a second process, beside
        # the phases that take no timing: the LLaMA SFT adapter served
        # (phase 4c), 4d, and the gates of 4s, 4q and 4o; and beside them
        # the gloo groups' processes (10d's two ranks, 10t / 10s / 10p)
        with references_beside() as refs, gloo_groups_beside(torch, card) as groups:
            phase_serve_sft_adapter(torch, sft["adapter"], workdir)
            served.update(phase_serve_longctx(torch))
            served_spec = phase_serve_spec(torch)
            served_int8 = phase_serve_int8(torch, workdir)
            served_ops = phase_serve_ops(torch, workdir)
    reference, reference_gpt2 = refs["reference"], refs["reference_gpt2"]
    phase_serve_spec_timing(torch)
    ops_restart_runs = phase_serve_ops_timing(torch, served_ops)
    # pretrained weights from local files (8w), then train-state checkpoints
    # and resume through the CLI (8r, the LoRA run from 8w's LLaMA files)
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        weights = phase_weights(torch, os.path.join(workdir, "weights"))
        resumed = phase_resume(torch, card, os.path.join(workdir, "resume"), weights)
    # text in and out: BPE tokenizers, the token cache, text serving (9t)
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        text = phase_text(torch, card, workdir)
    # dp / fsdp / zero1 and pp: one NCCL rank through the CLI (10d; its two
    # gloo ranks ran beside the reference window)
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        sharded = dict(world1=phase_shard_world1(torch, card, workdir),
                       gloo=groups["gloo"])
    # B3 on a sequence block (10s); the groups' 10t / 10s / 10p results
    sp_dropout_check(torch)
    meshed = groups["mesh"]

    def shape_of(r: dict) -> tuple:
        return (r["S"], r["Hq"], r["Hkv"], r["hd"], r["Tmax"], r["dtype"])

    for r in rows:
        shape = shape_of(r)
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
    spec_off = {v["shape"]: v["launches"] for v in served_spec.values()
                if not v["paged"]}
    for k, r in zip(kernels, rows):                 # phase 8w's CLI serving
        if r["shape"] in spec_off:                  # phase 4s, spec off
            k["launches_4s"] = spec_off[r["shape"]]
        if r["shape"] == OPS_MODEL["label"]:        # phase 4o, contiguous
            k["launches_4o"] = dict(
                isolation=served_ops["b5"],
                restart=ops_restart_runs["contiguous"]["launches"])
        if r["shape"] in weights["launches"]:
            k["launches_8w"] = weights["launches"][r["shape"]]
        text_served = text["served"].get(r["shape"])  # phase 9t's text prompts
        if text_served is not None:
            if text_served["shape"] != shape_of(r):
                raise AssertionError(f"{r['shape']}: text served at "
                                     f"{text_served['shape']}, not {shape_of(r)}")
            k["launches_9t"] = text_served["launches"]
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
            b5_contiguous_ms=r["b5_contiguous_ms"],
            launches_4s=next(v["launches"] for v in served_spec.values()
                             if v["paged"] and v["shape"] == r["shape"])))
        if r["shape"] == OPS_MODEL["label"]:        # phase 4o, paged
            kernels[-1]["launches_4o"] = dict(
                isolation=served_ops["b7"],
                restart=ops_restart_runs["paged"]["launches"])
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
        if run["dims"] == served_int8["lora"]["dims"]:      # phase 4q, int8
            kernels[-1]["launches_4q"] = served_int8["lora"]["tally"].get(
                (r["D"], r["O"]), 0)
            # phase 4o: hot-load and evict under load, the same pool shape
            kernels[-1]["launches_4o"] = served_ops["b6"].get((r["D"], r["O"]), 0)
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
                 "gpt2-124M-train-fp16": mixed["gpt2-fp16-policy"]["launches"],
                 # phase 10t, rank 0's heads (every rank launches the same)
                 "llama3_2-1B-tp2": meshed["llama-tp2"]["launches"],
                 "gpt2-124M-tp2-fp32": meshed["gpt2-tp2"]["launches"],
                 # phase 10p, stage 0's microbatches (launches_10p: every rank)
                 **{shape: meshed[run]["launches"][0] for shape, run in PP_SHAPES.items()}}
    # the p 0.1 rows of a shape whose p 0 rows read another run
    drop_attn_runs = {"gpt2-124M-tp2-fp32": meshed["gpt2-tp2-p0.1"]["launches"]}
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
        # phase 9t: LLaMA pretraining on BPE ids and its relaunch, GPT-2 SFT
        if shape == "llama3_2-1B-train":
            row["launches_9t"] = {k: text["pretrain"][k]["launches"][counter]
                                  for k in ("first", "relaunch")}
        if shape == "gpt2-124M-train-fp32":
            row["launches_9t"] = text["sft"]["launches"][counter]
        # phase 10d: LLaMA's world-1 NCCL runs; GPT-2 fp32 per gloo rank
        if shape == "llama3_2-1B-train":
            row["launches_10d"] = {k: r["launches"][counter]
                                   for k, r in sharded["world1"].items()}
        if shape == "gpt2-124M-train-fp32":
            row["launches_10d"] = {k: r[counter] for k, r in
                                   sharded["gloo"]["launches"].items()}
            # phase 10s: a seq rank's (B 4, T 512) blocks of GPT-2 fp32
            row["launches_10s_B4_T512"] = meshed["gpt2-sp2-p0.1"]["launches"][counter]
        # phase 10p: the run at a pp microbatch's shape, per rank
        if shape in PP_SHAPES:
            row["launches_10p"] = {PP_SHAPES[shape]: [
                rr[counter] for rr in meshed[PP_SHAPES[shape]]["launches"]]}
        # phase 6p: the --profile trace's kernel events of its 3 steps
        trace_key = {"fwd": "B1", "dq": "B2a", "dkv": "B2b", "dropout_fwd": "B3a",
                     "dropout_bwd": "B3b"}.get(counter)
        if shape == "gpt2-124M-train-fp32" and trace_key:
            row["launches_6p_trace"] = profiled["counts"][trace_key]
        # phase 6r: the same shapes' save-all, selective and full remat runs
        by_shape = {"llama3_2-1B-train": "llama3_2-1B-bf16",
                    "gpt2-124M-train-fp32": "GPT2-124M-fp32"}
        if shape in by_shape:
            row["launches_6r"] = {m: r["launches"][counter]
                                  for m, r in remat[by_shape[shape]].items()}

    for r in attn_rows + drop_attn_rows:
        kname, where = replaces[r["kernel"]]
        tag = f"{r['shape']}-p{r['rate']}" if "rate" in r else r["shape"]
        src = kernel_source(DTYPE_MAP[r["dtype"]], r["kernel"])
        runs = drop_attn_runs if "rate" in r and r["shape"] in drop_attn_runs else attn_runs
        kernels.append(dict(
            name=f"{kname}[{tag}]", route="cuda", source=source + src,
            replaces=where, launches=runs[r["shape"]][r["kernel"]],
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
                 "gpt2-124M-train-fp16": mixed["gpt2-fp16-policy"]["launches"],
                 # phase 10t, rank 0's heads (every rank launches the same)
                 "llama3_2-1B-tp2": meshed["llama-tp2"]["launches"],
                 "gpt2-124M-tp2-fp32": meshed["gpt2-tp2"]["launches"]}
    # the p 0.1 rows of a shape whose p 0 rows read another run
    drop_attn_runs = {"gpt2-124M-tp2-fp32": meshed["gpt2-tp2-p0.1"]["launches"]}
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
            kernels[-1]["launches_9t"] = text["sft"]["launches"]["xent_fwd"]
            kernels[-1]["launches_10d"] = {k: r["xent_fwd"] for k, r in
                                           sharded["gloo"]["launches"].items()}
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
    # phase 9t's paths ran every kernel they take: B1/B2a/B2b in both
    # pretraining runs, B1-B4 in the SFT run, B5 serving text
    need = dict(first=("fwd", "dq", "dkv"), relaunch=("fwd", "dq", "dkv"))
    if any(text["pretrain"][k]["launches"][c] < 1 for k, cs in need.items() for c in cs) \
            or any(v < 1 for v in text["sft"]["launches"].values()) \
            or any(v["launches"] < 1 for v in text["served"].values()):
        raise AssertionError("phase 9t: a kernel was not launched")
    io = written_bytes()
    emit("io", **io, references_process=refs["io"],
         total={k: io[k] + refs["io"][k] for k in io})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["card_line"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
