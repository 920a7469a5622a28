#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failed check raises and the script
exits non-zero):

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, capability (must be 9.0); TF32 off for matmuls and cuDNN.
  2. build: compiles the package's CUDA kernels from ``csrc/`` with nvcc.
  3. decode kernel vs twin: the fused decode-step kernel (B5) against its
     plain PyTorch twin at the serving shapes of LLaMA-3.2-1B (bf16),
     GPT-2-124M (fp32) and LLaMA-3-8B (bf16): caches bit-equal, outputs
     within tolerance of the twin and within one unit in the last place of
     the exact (fp32) result;
     times of the kernel, the twin and ``scaled_dot_product_attention`` on
     the same cache, beside the bound the card's memory rate sets.
  4. serving: the continuous-batching engine at full width, random weights
     from a seed: LLaMA-3.2-1B in bf16 with its 16 layers and GPT-2-124M in
     fp32 (24 requests over 8 slots of 1024), then LLaMA-3-8B in bf16 cut to
     2 layers (12 requests over 4 slots of 4096). Every request finishes its
     budget, the kernel's launch count equals layers x decode ticks, three
     greedy requests re-run alone in a fresh engine give the same tokens,
     and the card's logits agree with an fp32 CPU reference more closely
     than a reference without decode attention does.
  5. flash-attention kernels vs twins: forward (B1), dq (B2a) and dk/dv
     (B2b) at LLaMA-3.2-1B's training shape (B 4, Hq 32, Hkv 8, T 1024,
     hd 64, bf16) and the reference shapes (B 1, T 256, fp32 and bf16): out, lse and
     the gradients within tolerance of the twin and of the exact (fp32)
     result, each bound shown to fail for a wrong result; times of the
     kernels, the twins and ``scaled_dot_product_attention`` (forward and
     forward+backward), beside the bound the card's peak rate sets.
     5b. the same kernels with attention dropout p = 0.1 at GPT-2-124M's
     training shape (B 8, H 12, T 1024, hd 64, bf16) and its fp32
     reference shape (B 1, T 256): against the twin (the same mask) and an
     exact fp32 oracle built from the dumped mask; the mask's keep fraction
     (within 1e-3 of 0.9 over the causal entries), the same mask for the
     same seed and another for the next; the twin with the next seed must
     fail the bound. SDPA with dropout_p = 0.1 is the library yardstick.
     5c. the fused dropout kernel B3 (dropout, dropout + add, backward) at
     (8 x 1024, 768) in bf16 and fp32: bit-equal to the twins, p = 0 the
     identity, the keep fraction, the backward of ones equal to the
     forward's mask times 1/(1-p); F.dropout (+ add) as the yardstick.
     5d. the vocab-streamed cross-entropy forward B4 at N 8192, D 768,
     V 50257, bf16: lse and nll against the twin at the JAX test's bounds;
     the twin without the padded-column mask must fail them.
  6. training: ``main.run`` (--mode train) at full width on a seeded text
     file, 20 steps, one evaluation, the warm-up and one greedy sample, the
     final export: LLaMA-3.2-1B (bf16, 16 layers, batch 4, context 1024),
     then GPT-2-124M (bf16, 12 layers, batch 8, context 1024, dropout 0.1,
     the chunked cross entropy). Launch counts exact (B1 = layers x (steps
     + eval batches), B2a = B2b = layers x steps, B3 forward and backward =
     (1 + 2 x layers) x steps with dropout, B4 = 0), every loss finite,
     the last below the first; the export loads back bit for bit and is
     served by the CLI. The run's own rate (all steps over their wall time,
     the trainer's window) and each step's device time (CUDA events around
     every step, step 1 apart); then steady step time, tokens/s, MFU, peak
     memory and a profiled window over re-runs of one batch. For GPT-2 the
     same 20 steps again with BLLM_XENT_PALLAS=1: B4 = steps + eval
     batches, and the step-1 loss equal to the first run's to 1e-5.
  7. training reference: one step at full width cut to 2 layers, B 1,
     T 256, in fp32 and in bf16, on the card and on the CPU (the twins)
     with the same weights, batch and dropout seed: loss and every leaf's
     gradient within the dtype's bound. Controls: LLaMA-3.2-1B without
     attention fails the gradient bound; GPT-2-124M (dropout 0.1) with
     another dropout seed on the CPU side fails the gradient bound, and in
     fp32 the loss bound (in bf16 its loss change is reported: it lies
     inside bf16's loss bound at this size).
  8. the ``kernels`` line (one row per kernel and shape, each with the
     launches of the run at that shape), then the card line and the result
     line.

It exits non-zero without printing a result when no CUDA device is present
or when the package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# card figures from NVIDIA's data sheets: memory bytes/s and dense peak
# operations/s for 16-bit (tensor cores) and 32-bit float (CUDA cores)
_CARDS = {
    "H100 PCIe": dict(bw=2.0e12, peak16=756e12, peak32=51e12),
    "H100 NVL": dict(bw=3.9e12, peak16=835e12, peak32=60e12),
    "H100 SXM": dict(bw=3.35e12, peak16=989e12, peak32=67e12),
}


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
    resources = [ln.strip() for ln in info.get("log", "").splitlines()
                 if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         built=info["built"], library=info["path"],
         sources=[str(s.name) for s in _kernels.sources()],
         ptxas=resources[:24])


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

KERNEL_SHAPES = [
    # name (the model served at this shape in phase 4), S, Hq, Hkv, hd,
    # Tmax, dtype
    ("llama3_2-1B", 8, 32, 8, 64, 1024, "bf16"),
    ("gpt2-124M", 8, 12, 12, 64, 1024, "fp32"),
    ("llama3-8B", 4, 32, 8, 128, 4096, "bf16"),
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
        lens[0], lens[1] = 0, Tmax - 1
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
                   lengths=[int(x) for x in lens.tolist()],
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
# phase 5: the flash-attention kernels (B1, B2a, B2b) against their twins
# ---------------------------------------------------------------------------

ATTN_SHAPES = [
    # name, B, Hq, Hkv, T, hd, dtype: the training shape of LLaMA-3.2-1B
    # (phase 6) and the reference shapes (phase 7: full width cut to 2
    # layers, B 1, T 256, fp32 and bf16)
    ("llama3_2-1B-train", 4, 32, 8, 1024, 64, "bf16"),
    ("llama3_2-1B-ref", 1, 32, 8, 256, 64, "fp32"),
    ("llama3_2-1B-ref-bf16", 1, 32, 8, 256, 64, "bf16"),
]

# max |kernel - ref| / max |ref| per tensor (lse: absolute), against the
# twin and against the exact result (the twin in fp32 on the same inputs):
# fp32 the same arithmetic in another order (1e-5 for out and lse, 5e-5 for
# gradients summed over up to T terms); bf16 2e-2 (P and dS are rounded to 8
# bits before their products, at other places in the kernel and the twin).
# The same limits as tests/test_torch_cuda.py.
FLASH_TOL = {"fp32": (1e-5, 5e-5), "bf16": (2e-2, 2e-2)}


def _flash_err(torch, name: str, a, b) -> float:
    if name == "lse":
        return (a - b).abs().max().item()
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


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
                 tfa.fused_attention_dkv_plain)
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
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        doh = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            sdpa().backward(doh)

        sdpa_ms = device_time_ms(torch, lambda: sdpa().detach(), flush)
        sdpa_fb_ms = device_time_ms(torch, sdpa_fwd_bwd, flush)
        sdpa_err = _flash_err(torch, "out", sdpa().detach().transpose(1, 2), out)

        elt = q.element_size()
        pairs = B * Hq * T * (T + 1) // 2          # causal (q, k) pairs
        qb, kvb, stat = B * T * Hq * hd * elt, B * T * Hkv * hd * elt, B * Hq * T * 4
        work = {"fwd": (4 * hd * pairs, qb + 2 * kvb + qb + stat),
                "dq": (6 * hd * pairs, 2 * qb + 2 * kvb + 2 * stat + qb),
                "dkv": (8 * hd * pairs, 2 * qb + 2 * kvb + 2 * stat + 2 * qb)}
        peak = fig["peak32"] if dtype == torch.float32 else fig["peak16"]
        for kname, (kfn, pfn) in calls.items():
            ops, nbytes = work[kname]
            t_bytes, t_ops = nbytes / fig["bw"], ops / peak
            row = dict(shape=shape, kernel=kname, B=B, Hq=Hq, Hkv=Hkv, T=T,
                       hd=hd, dtype=dt, ms=device_time_ms(torch, kfn, flush, runs=15),
                       plain_ms=device_time_ms(torch, pfn, flush, runs=5, warmup=2),
                       library_ms=sdpa_ms if kname == "fwd" else None,
                       sdpa_fwd_ms=sdpa_ms, sdpa_fwd_bwd_ms=sdpa_fb_ms,
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
        del got, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5b: the flash-attention kernels with attention dropout
# ---------------------------------------------------------------------------

DROPOUT_ATTN_SHAPES = [
    # name, B, Hq, Hkv, T, hd, dtype: GPT-2-124M's training shape (phase 6b)
    # and its reference shape (phase 7b: 2 layers, B 1, T 256, fp32)
    ("gpt2-124M-train", 8, 12, 12, 1024, 64, "bf16"),
    ("gpt2-124M-ref", 1, 12, 12, 256, 64, "fp32"),
]
DROP_RATE = 0.1


def dense_dropout_oracle(torch, q, k, v, do, keep, rate):
    """Exact fp32 attention with the dumped keep mask on the softmax
    weights (the same-mask oracle), and its autograd gradients; dk and dv
    per kv head (the shapes here have no GQA)."""
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
                 tfa.fused_attention_dkv_plain)

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
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        doh = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  dropout_p=DROP_RATE, enable_gqa=True)

        def sdpa_fwd_bwd():
            sdpa().backward(doh)

        sdpa_ms = device_time_ms(torch, lambda: sdpa().detach(), flush)
        sdpa_fb_ms = device_time_ms(torch, sdpa_fwd_bwd, flush)
        elt = q.element_size()
        pairs = B * Hq * T * (T + 1) // 2
        qb, kvb, stat = B * T * Hq * hd * elt, B * T * Hkv * hd * elt, B * Hq * T * 4
        work = {"fwd": (4 * hd * pairs, qb + 2 * kvb + qb + stat),
                "dq": (6 * hd * pairs, 2 * qb + 2 * kvb + 2 * stat + qb),
                "dkv": (8 * hd * pairs, 2 * qb + 2 * kvb + 2 * stat + 2 * qb)}
        peak = fig["peak32"] if dtype == torch.float32 else fig["peak16"]
        for kname, (kfn, pfn) in calls.items():
            ops, nbytes = work[kname]
            t_bytes, t_ops = nbytes / fig["bw"], ops / peak
            row = dict(shape=shape, kernel=kname, B=B, Hq=Hq, Hkv=Hkv, T=T, hd=hd,
                       dtype=dt, rate=DROP_RATE,
                       ms=device_time_ms(torch, kfn, flush, runs=15),
                       plain_ms=device_time_ms(torch, pfn, flush, runs=5, warmup=2),
                       library_ms=sdpa_ms if kname == "fwd" else None,
                       sdpa_fwd_ms=sdpa_ms, sdpa_fwd_bwd_ms=sdpa_fb_ms,
                       ops=ops, bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=(abs_err["out"] if kname == "fwd" else
                                    abs_err["dq"] if kname == "dq" else
                                    max(abs_err["dk"], abs_err["dv"])),
                       err=err, oracle_err=oracle_err, control_err=control_err,
                       tol=tols, keep_fraction=keep_fraction, next_seed_differs=differ)
            emit("attention_dropout_kernel", **row)
            rows.append(row)
        del got, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5c: the fused dropout kernel (B3)
# ---------------------------------------------------------------------------

DROPOUT_SHAPES = [("gpt2-124M-train", 8 * 1024, 768, "bf16"),
                  ("gpt2-124M-ref", 8 * 1024, 768, "fp32")]


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

XENT_SHAPE = ("gpt2-124M-train", 8 * 1024, 768, 50257, "bf16")


def phase_xent(torch, card: dict) -> dict:
    """B4 at GPT-2-124M's training shape: lse and nll against the twin at
    the JAX kernel test's bounds (lse 1e-5; nll 1e-4 relative, 2e-4
    absolute); the twin over W padded with unmasked zero columns must fail
    them. Times beside torch.mm(out_dtype=float32) + logsumexp + gather."""
    import torch.nn.functional as F

    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf

    shape, N, D, V, dt = XENT_SHAPE
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
        logits = torch.mm(x, w, out_dtype=torch.float32)
        lse_l = torch.logsumexp(logits, dim=-1)
        return lse_l - logits.gather(1, t[:, None])[:, 0], lse_l

    lib_nll, _ = library()
    errs["library_nll_max_abs"] = (lib_nll - nll_t).abs().max().item()
    elt = x.element_size()
    ops = 2 * N * D * V
    nbytes = (N * D + D * V) * elt + N * 8 + 2 * N * 4
    t_bytes, t_ops = nbytes / fig["bw"], ops / fig["peak16"]
    row = dict(shape=shape, N=N, D=D, V=V, dtype=dt, ms=device_time_ms(torch, lambda: txf.xent_fwd(x, w, t), flush, runs=10),
               plain_ms=device_time_ms(torch, lambda: txf.xent_fwd_plain(x, w, t), flush, runs=5, warmup=2),
               library_ms=device_time_ms(torch, library, flush, runs=10),
               ops=ops, bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=max(errs["lse_max_abs"], errs["nll_max_abs"]), **errs)
    emit("xent_kernel", **row)
    del x, w, nll_t, lse_t, lse_c
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 6: training at full width through the CLI
# ---------------------------------------------------------------------------

TRAIN = dict(model="llama3_2", size="1B", dtype="bf16", batch=4, context=1024,
             steps=20)
# GPT-2-124M as configured (drop_rate 0.1), the chunked cross entropy its
# width takes; then the same run with the opt-in B4 forward
TRAIN_GPT2 = dict(model="GPT2", size="124M", dtype="bf16", batch=8, context=1024,
                  steps=20)
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
    unprofiled median step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
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


def expected_launches(cfg, steps: int, eval_batches: int, xent_kernel: bool) -> dict:
    """Each kernel's launches in a run: B1 per layer in every train and
    eval step, B2a/B2b per layer in every train step, B3 forward and
    backward once for the embedding and twice per layer in every train step
    of a dropout config, B4 once per train and eval step when it is on."""
    L = cfg.n_layers
    drops = (1 + 2 * L) * steps if cfg.drop_rate > 0 else 0
    return dict(fwd=L * (steps + eval_batches), dq=L * steps, dkv=L * steps,
                dropout_fwd=drops, dropout_bwd=drops,
                xent_fwd=(steps + eval_batches) if xent_kernel else 0)


def train_run(torch, t: dict, workdir: str, xent_kernel: bool = False):
    """One ``main.run`` (--mode train) of ``t`` on a seeded corpus sized for
    exactly t["steps"] steps, with each step's device time (CUDA events) and
    every kernel's launches counted from 0. Returns (trainer, facts)."""
    import os

    import building_llm_from_scratch_tpu_torch.training.trainer as ttr
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
             "--data_type", t["dtype"], "--byte_tokenizer",
             "--data_dir", data_dir, "--output_dir", out_dir,
             "--n_epochs", "1", "--batch_size", str(t["batch"]),
             "--eval_freq", str(t["steps"]), "--print_sample_iter", str(t["steps"])]
    kernels = train_kernels()
    # CUDA events around every step of the run (no host sync): each step's
    # time on the device's clock, idle gaps while the host enqueues included
    events = []
    make_train_step = ttr.make_train_step

    def timed_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def timed_step(state, batch):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = step(state, batch)
            pair[1].record()
            events.append(pair)
            return out
        return timed_step

    torch.cuda.reset_peak_memory_stats()
    env = os.environ.get("BLLM_XENT_PALLAS")
    os.environ["BLLM_XENT_PALLAS"] = "1" if xent_kernel else "0"
    for f in kernels.values():
        f.launches = 0                              # the main path's count
    ttr.make_train_step = timed_make_train_step
    t0 = time.perf_counter()
    try:
        trainer = tmain.run(flags)
        torch.cuda.synchronize()
    finally:
        ttr.make_train_step = make_train_step
        if env is None:
            os.environ.pop("BLLM_XENT_PALLAS")
        else:
            os.environ["BLLM_XENT_PALLAS"] = env
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    run_step_ms = [a.elapsed_time(b) for a, b in events]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cfg, loader = trainer.cfg, trainer.loader
    tr_ds, va_ds = loader.create_datasets_for_file(corpus, cfg.eos_text)
    n_evals = len(trainer.train_losses)
    eval_batches = n_evals * (min(5, loader.num_batches(tr_ds))
                              + min(5, loader.num_batches(va_ds)))
    steps = trainer.global_step
    want = expected_launches(cfg, steps, eval_batches, xent_kernel)
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
    facts = dict(check, wall_s=wall, corpus=corpus, corpus_chars=n_chars,
                 out_dir=out_dir, run_step_ms=run_step_ms, peak_gb=peak_gb,
                 losses=losses, tr_ds=tr_ds)
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
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_exported_params,
    )

    trainer, facts = train_run(torch, t, workdir)
    cfg, loader = trainer.cfg, trainer.loader
    L, losses = cfg.n_layers, facts["losses"]
    export = os.path.join(facts["out_dir"], "model_pg_final.npz")
    back = load_exported_params(export, cfg, "cuda")
    for key, leaf in trainer.model.stacked.items():
        a, b = leaf.detach(), back.stacked[key]
        if a.dtype != b.dtype or not torch.equal(a.view(torch.int16),
                                                 b.view(torch.int16)):
            raise AssertionError(f"export leaf {key} does not load back "
                                 "bit for bit")
    del back

    # the export served by the CLI (--mode serve --init_params_from)
    req = os.path.join(workdir, "req.jsonl")
    with open(req, "w") as f:
        for text in ("Every ", "effort "):
            ids = trainer.tokenizer.encode(text)
            f.write(json.dumps({"prompt_ids": ids, "max_new_tokens": 8}) + "\n")
    served_out = os.path.join(workdir, "served.jsonl")
    eng = tmain.run(["--mode", "serve", "--model", t["model"], "--num_params",
                     t["size"], "--data_type", t["dtype"], "--init_params_from",
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
    window_tps = trainer.throughput_tokens_per_s[0]
    run_step_ms = facts["run_step_ms"]
    run_rate = dict(window_tokens_per_s=window_tps,
                    window_ms_per_step=tokens / window_tps * 1e3,
                    window_mfu=window_tps * fpt / card["figures"]["peak16"],
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
    result = dict(model=cfg.name, dtype=t["dtype"], layers=L, emb_dim=cfg.emb_dim,
                  vocab=cfg.vocab_size, drop_rate=cfg.drop_rate, batch=t["batch"],
                  context=t["context"], corpus_chars=facts["corpus_chars"],
                  wall_s=facts["wall_s"], **check,
                  first_loss=losses[0], last_loss=losses[-1], step_losses=losses,
                  train_loss=trainer.train_losses, val_loss=trainer.val_losses,
                  grad_norms=[m["grad_norm"] for m in trainer.step_metrics],
                  lrs=trainer.track_lrs, sample=trainer.samples[-1][:120],
                  served_tokens=[r["token_ids"] for r in served], **run_rate,
                  step_ms=step_ms, step_ms_all=step_times, tokens_per_s=tps,
                  flops_per_token=fpt, mfu=tps * fpt / card["figures"]["peak16"],
                  mfu_basis="flops_per_token = 6 x non-embedding params (head "
                            "included) + 12 x layers x emb_dim x context; "
                            "peak = bf16 dense",
                  peak_memory_gb=facts["peak_gb"], profile=prof)
    emit("train", **result)
    runs = {"main": facts["launches"]}
    del trainer, batch
    torch.cuda.empty_cache()

    if cfg.emb_dim <= 1024:         # the chunked loss: the B4 run
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
        del trainer
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 7: one training step on the card against the CPU
# ---------------------------------------------------------------------------

# (relative error of the loss, relative L2 error of every leaf's gradient)
# of the card's step against the CPU's: fp32 is the same arithmetic in
# another order; in bf16 both devices round every operation to 8 bits, but
# GEMM sums and the flash kernel round at other places than the CPU's
# GEMMs and the twin (the port against the JAX package on the CPU, at a
# small size, measures about 1e-2: tests/test_torch_training.py)
REF_BOUNDS = {"fp32": (1e-5, 1e-4), "bf16": (1e-3, 3e-2)}


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
                 slots: int, max_len: int, n_ticks: int = 12) -> dict:
    """Device time by kernel over a window of steady decode ticks
    (torch.profiler). Runs after the main path and outside its count. The
    profiler slows the host, so the idle share is taken against the
    unprofiled mean tick ``tick_ms`` of the main run."""
    from torch.profiler import ProfilerActivity, profile

    eng = engine_cls(model, n_slots=slots, max_len=max_len, max_queue=64)
    for p, sp in requests[:slots]:
        eng.submit(p, sp)
    eng.step()                      # admission (prefill) + first tick
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
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
    return dict(ticks=ticks, device_events=len(rows),
                profiled_tick_ms=wall / ticks * 1e3,
                device_busy_ms_per_tick=busy_ms,
                device_idle_share=1.0 - busy_ms / tick_ms,
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
    # serving runs before training: its ticks are host-bound, and a clean
    # process keeps them comparable with earlier runs
    served = phase_serve(torch)
    attn_rows = phase_attention(torch, card)
    drop_attn_rows = phase_attention_dropout(torch, card)
    dropout_rows = phase_dropout(torch, card)
    xent_row = phase_xent(torch, card)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as workdir:
        trained = phase_train(torch, card, os.path.join(workdir, "llama"), TRAIN)
        trained_gpt2 = phase_train(torch, card, os.path.join(workdir, "gpt2"),
                                   TRAIN_GPT2)
    reference = phase_train_reference(torch, REFERENCES[0])
    reference_gpt2 = phase_train_reference(torch, REFERENCES[1])
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
    replaces = {"fwd": ("flash_attention_fwd",
                        "building_llm_from_scratch_tpu/ops/fused_attention.py:75"),
                "dq": ("flash_attention_dq",
                       "building_llm_from_scratch_tpu/ops/fused_attention.py:120"),
                "dkv": ("flash_attention_dkv",
                        "building_llm_from_scratch_tpu/ops/fused_attention.py:160")}
    attn_runs = {"llama3_2-1B-train": trained["main"],
                 "llama3_2-1B-ref": reference["fp32"]["launches"],
                 "llama3_2-1B-ref-bf16": reference["bf16"]["launches"],
                 "gpt2-124M-train": trained_gpt2["main"],
                 "gpt2-124M-ref": reference_gpt2["fp32"]["launches"]}
    source = "building_llm_from_scratch_tpu_torch/csrc/"
    for r in attn_rows + drop_attn_rows:
        kname, where = replaces[r["kernel"]]
        tag = f"{r['shape']}-p{r['rate']}" if "rate" in r else r["shape"]
        kernels.append(dict(
            name=f"{kname}[{tag}]", route="cuda", source=source + "fused_attention.cu",
            replaces=where, launches=attn_runs[r["shape"]][r["kernel"]],
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    dropout_where = {"fwd": ("dropout_fwd", "dropout_fwd",
                             "building_llm_from_scratch_tpu/ops/fused_dropout.py:36"),
                     "fwd_add": ("dropout_fwd", "dropout_fwd",
                                 "building_llm_from_scratch_tpu/ops/fused_dropout.py:44"),
                     "bwd": ("dropout_bwd", "dropout_bwd",
                             "building_llm_from_scratch_tpu/ops/fused_dropout.py:48")}
    for r in dropout_rows:
        kname, counter, where = dropout_where[r["kernel"]]
        tag = "-add" if r["kernel"] == "fwd_add" else ""
        kernels.append(dict(
            name=f"{kname}[{r['shape']}-{r['dtype']}{tag}]", route="cuda",
            source=source + "fused_dropout.cu", replaces=where,
            launches=attn_runs[r["shape"]][counter], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    kernels.append(dict(
        name=f"xent_fwd[{xent_row['shape']}]", route="cuda",
        source=source + "xent_fwd.cu",
        replaces="building_llm_from_scratch_tpu/ops/xent_fwd_pallas.py:32",
        launches=trained_gpt2["xent_kernel"]["xent_fwd"],
        max_abs_err=xent_row["max_abs_err"], ms=xent_row["ms"],
        plain_ms=xent_row["plain_ms"], bound_ms=xent_row["bound_ms"],
        bound_by=xent_row["bound_by"], library_ms=xent_row["library_ms"]))
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["card_line"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
