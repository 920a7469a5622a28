"""Times the port's flash-attention kernels (B1 forward, B2a dq, B2b dk/dv)
on one NVIDIA GPU at the training shapes of LLaMA-3.2-1B and GPT-2-124M,
after checking each against its plain twin.

    python3 scripts/flash_attention_timing.py            # from a tree's root

The package imported is the one under the current directory, so two trees
(say a parent commit unpacked beside the working tree) are compared by
running the script from each root in turn, alternating (A, B, B, A), on one
card in one sitting. One JSON line per shape, then the card's name and
power limit. Times are medians of CUDA-event readings with L2 flushed before
each launch, as chip_smoke.py takes them.
"""

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

SHAPES = [
    # name, B, T, Hq, Hkv, hd, dropout rate
    ("llama3_2-1B-train", 4, 1024, 32, 8, 64, 0.0),
    ("gpt2-124M-train-p0.1", 8, 1024, 12, 12, 64, 0.1),
    ("gpt2-124M-train", 8, 1024, 12, 12, 64, 0.0),
    ("hd128-gqa", 2, 2048, 16, 4, 128, 0.0),
]
TOL = 2e-2      # max |kernel - twin| / max |twin|, bf16 (tests/test_torch_cuda.py)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_attention_timing: no CUDA device", file=sys.stderr)
        return 1
    from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    seed = 12345
    for name, B, T, Hq, Hkv, hd, rate in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
        q, k, v, do = rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hq, hd)
        out, lse = tfa.flash_attention_fwd(q, k, v, rate, seed)
        delta = tfa.attention_delta(out, do)
        dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, rate, seed)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, rate, seed)
        out_t, _ = tfa.fused_attention_fwd_plain(q, k, v, rate, seed)
        dq_t = tfa.fused_attention_dq_plain(q, k, v, do, lse, delta, rate, seed)
        dk_t, dv_t = tfa.fused_attention_dkv_plain(q, k, v, do, lse, delta, rate, seed)
        err = dict(out=rel(out, out_t), dq=rel(dq, dq_t),
                   dk=rel(dk, tfa.group_sum(dk_t, Hkv)), dv=rel(dv, tfa.group_sum(dv_t, Hkv)))
        del out_t, dq_t, dk_t, dv_t
        if max(err.values()) > TOL:
            raise AssertionError(f"{name}: kernels off their twins: {err}")
        ms = dict(fwd=median_ms(lambda: tfa.flash_attention_fwd(q, k, v, rate, seed), flush),
                  dq=median_ms(lambda: tfa.flash_attention_dq(q, k, v, do, lse, delta, rate,
                                                              seed), flush),
                  dkv=median_ms(lambda: tfa.flash_attention_dkv(q, k, v, do, lse, delta, rate,
                                                                seed), flush))
        print(json.dumps(dict(shape=name, B=B, T=T, Hq=Hq, Hkv=Hkv, hd=hd, rate=rate,
                              tree=os.getcwd(), ms=ms, sum_ms=sum(ms.values()), err=err)),
              flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
