"""Times the port's decode-step kernel B5 (csrc/decode_step.cu) on one
NVIDIA GPU at chip_smoke.py's phase-3 serving shapes, after checking it
against its plain twin, and splits its time between its launches (the
split pass and the merge) with torch.profiler.

    python3 scripts/decode_step_timing.py            # from a tree's root
    python3 scripts/decode_step_timing.py --tick     # + chip_smoke phases 4, 4d

The package and chip_smoke.py imported are the ones under the current
directory, so two trees (say a parent commit unpacked beside the working
tree) are compared by running the script from each root in turn,
alternating (A, B, B, A), on one card in one sitting. One JSON line per
shape: the wrapper's device time (median of CUDA-event readings with L2
flushed before each call, as chip_smoke.py takes it), each kernel's mean
device time from the profiler (L2 flushed the same way), the bytes the
call must move over the wrapper's time, and the host's time to issue one
call (checks, allocations, launches) while the device is kept busy, which
is what a host-bound serving tick pays for it. With --tick, chip_smoke.py's
phases 4 (LLaMA-3.2-1B, GPT-2-124M, LLaMA-3-8B served) and 4d (longctx-32k
on 32,768-token slots) run after, each printing its mean decode tick. Then
the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

TOL = 2e-2      # max |kernel - twin|, 16-bit (chip_smoke.py TWIN_TOL)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_step_timing: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    for name, S, Hq, Hkv, hd, Tmax, dt in cs.KERNEL_SHAPES:
        dtype = DTYPE_MAP[dt]
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        q, kn, vn = rnd(S, 1, Hq, hd), rnd(S, 1, Hkv, hd), rnd(S, 1, Hkv, hd)
        K, V = rnd(S, Hkv, Tmax, hd), rnd(S, Hkv, Tmax, hd)
        lens = torch.randint(1, Tmax - 1, (S,), generator=gen, device=dev)
        lens[0], lens[1] = (8200 if Tmax > 8192 else 0), Tmax - 1
        lens = lens.to(torch.int32)
        out, _, _ = tds.fused_decode_step(q, kn, vn, K.clone(), V.clone(), lens)
        ref, _, _ = tds.fused_decode_step_plain(q, kn, vn, K.clone(), V.clone(), lens)
        err = (out.float() - ref.float()).abs().max().item()
        if err > TOL:
            raise AssertionError(f"{name}: the kernel is off its twin by {err}")
        fn = lambda: tds.fused_decode_step(q, kn, vn, K, V, lens)  # noqa: E731
        ms = cs.device_time_ms(torch, fn, flush, runs=50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            for kname in ("decode_split_kernel", "decode_combine_kernel",
                          "fused_decode_step_kernel"):
                if kname in e.key:
                    total = getattr(e, "device_time_total", None) or e.cuda_time_total
                    kernels[kname] = total / max(e.count, 1) / 1e3
        torch.cuda.synchronize()
        torch.cuda._sleep(500_000_000)      # the device stays busy: the host never waits
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        prefix = int(lens.long().sum().item())
        nbytes = K.element_size() * (2 * S * Hq * hd + 4 * S * Hkv * hd
                                     + 2 * prefix * Hkv * hd) + 4 * S
        plan = getattr(tds, "split_kv_plan", None)      # absent before split-KV
        C, n_splits = plan(Tmax, hd, dtype) if plan else (None, None)
        print(json.dumps(dict(shape=name, dtype=dt, C=C, n_splits=n_splits, ms=ms,
                              kernels_ms=kernels, host_us=host_us, bytes=nbytes,
                              gbps=nbytes / (ms * 1e-3) / 1e9, max_abs_err=err)),
              flush=True)
    if "--tick" in sys.argv:
        cs.phase_serve(torch)
        cs.phase_serve_longctx(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    return 0


if __name__ == "__main__":
    sys.exit(main())
