"""Times the port's flash-attention kernels (B1 forward, B2a dq, B2b dk/dv)
on one NVIDIA GPU at the training shapes of LLaMA-3.2-1B and GPT-2-124M, in
bf16 and in fp32 (the trainer's default dtype), and at LLaMA's reference
step, after checking each against its plain twin; SDPA on the same inputs
is timed beside them.

    python3 scripts/flash_attention_timing.py            # from a tree's root
    python3 scripts/flash_attention_timing.py --dtypes fp32 --no-library

The package imported is the one under the current directory, so two trees
(say a parent commit unpacked beside the working tree) are compared by
running the script from each root in turn, alternating (A, B, B, A), on one
card in one sitting. One JSON line per (shape, dtype), then the card's name
and power limit. Times are medians of CUDA-event readings with L2 flushed
before each launch, as chip_smoke.py takes them. The library times are
SDPA's forward and its backward alone (``autograd.grad`` of one saved
forward) with ``enable_gqa``; where the query heads outnumber the kv heads
in fp32, SDPA has no fused kernel for that call and runs its math path, so
SDPA on K and V repeated to the query heads (its memory-efficient kernel,
3xTF32) is timed as well.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SHAPES = [
    # name, B, T, Hq, Hkv, hd, dropout rate
    ("llama3_2-1B-train", 4, 1024, 32, 8, 64, 0.0),
    ("gpt2-124M-train-p0.1", 8, 1024, 12, 12, 64, 0.1),
    ("gpt2-124M-train", 8, 1024, 12, 12, 64, 0.0),
    ("hd128-gqa", 2, 2048, 16, 4, 128, 0.0),
    # LLaMA-3.2-1B's reference step (chip_smoke.py phase 7): few key tiles
    ("llama3_2-1B-ref", 1, 256, 32, 8, 64, 0.0),
]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# (out, gradients): max |kernel - twin| / max |twin| (tests/test_torch_cuda.py
# FLASH_TOL)
TOL = {"bf16": (2e-2, 2e-2), "fp32": (1e-5, 5e-5)}


def median_ms(fn, flush, runs=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sdpa_ms(q, k, v, do, rate, flush, gqa=True):
    """SDPA's forward and backward alone on (B, T, H, D) inputs."""
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, dropout_p=rate,
                                              enable_gqa=gqa)

    saved = fwd()
    doh = do.transpose(1, 2)
    return dict(fwd=median_ms(lambda: fwd().detach(), flush, runs=10),
                bwd=median_ms(lambda: torch.autograd.grad(saved, (qh, kh, vh), doh,
                                                          retain_graph=True), flush, runs=10))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", default="bf16,fp32", help="comma-separated: bf16, fp32")
    ap.add_argument("--no-library", action="store_true", help="skip the SDPA timings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    seed = 12345
    for name, B, T, Hq, Hkv, hd, rate in SHAPES:
        for dt in args.dtypes.split(","):
            dtype = DTYPES[dt]
            gen = torch.Generator(device="cuda").manual_seed(1)
            rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
            q, k, v, do = (rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd),
                           rnd(B, T, Hq, hd))
            out, lse = tfa.flash_attention_fwd(q, k, v, rate, seed)
            delta = tfa.attention_delta(out, do)
            dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, rate, seed)
            dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, rate, seed)
            out_t, _ = tfa.fused_attention_fwd_plain(q, k, v, rate, seed)
            dq_t = tfa.fused_attention_dq_plain(q, k, v, do, lse, delta, rate, seed)
            dk_t, dv_t = tfa.fused_attention_dkv_plain(q, k, v, do, lse, delta, rate, seed)
            err = dict(out=rel(out, out_t), dq=rel(dq, dq_t),
                       dk=rel(dk, tfa.group_sum(dk_t, Hkv)),
                       dv=rel(dv, tfa.group_sum(dv_t, Hkv)))
            del out_t, dq_t, dk_t, dv_t
            tol_out, tol_grad = TOL[dt]
            if err["out"] > tol_out or max(err["dq"], err["dk"], err["dv"]) > tol_grad:
                raise AssertionError(f"{name} {dt}: kernels off their twins: {err}")
            ms = dict(
                fwd=median_ms(lambda: tfa.flash_attention_fwd(q, k, v, rate, seed), flush),
                dq=median_ms(lambda: tfa.flash_attention_dq(q, k, v, do, lse, delta, rate,
                                                            seed), flush),
                dkv=median_ms(lambda: tfa.flash_attention_dkv(q, k, v, do, lse, delta, rate,
                                                              seed), flush))
            row = dict(shape=name, dtype=dt, B=B, T=T, Hq=Hq, Hkv=Hkv, hd=hd, rate=rate,
                       tree=os.getcwd(), ms=ms, sum_ms=sum(ms.values()),
                       bwd_ms=ms["dq"] + ms["dkv"], err=err)
            if not args.no_library:
                row["sdpa_ms"] = sdpa_ms(q, k, v, do, rate, flush)
                if dtype == torch.float32 and Hq != Hkv:
                    G = Hq // Hkv
                    row["sdpa_repeated_kv_ms"] = sdpa_ms(
                        q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2), do, rate,
                        flush, gqa=False)
            print(json.dumps(row), flush=True)
            del q, k, v, do, out, lse, delta, dq, dk, dv
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
