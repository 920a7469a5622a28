"""Times the port's serving decode kernels on one NVIDIA GPU at
chip_smoke.py's shapes, after checking each against its plain twin, and
splits each call's device time between its launches with torch.profiler:
B5 (csrc/decode_step.cu: split pass + merge) at phase 3's shapes, B7
(csrc/paged_decode.cu: split pass + merge) at phase 3b's, beside B5 on the
same rows laid out contiguously, and B6 (csrc/bgmv.cu: shrink + expand) at
phase 3c's.

    python3 scripts/decode_step_timing.py                    # B5, from a tree's root
    python3 scripts/decode_step_timing.py --kernels b6,b7    # B6 and B7
    python3 scripts/decode_step_timing.py --kernels b6,b7 --tick

The package and chip_smoke.py imported are the ones under the current
directory, so two trees (say a parent commit unpacked beside the working
tree) are compared by running the script from each root in turn,
alternating (A, B, B, A), on one card in one sitting. One JSON line per
kernel and shape: the wrapper's device time (median of CUDA-event readings
with L2 flushed before each call, as chip_smoke.py takes it), each launch's
mean device time from the profiler (L2 flushed the same way), the bytes the
call must move over the wrapper's time, and the host's time to issue one
call (checks, allocations, launches) while the device is kept busy, which
is what a host-bound serving tick pays for it (the median of five windows
of 100 calls). With --tick, the serving
phases that ride the chosen kernels run after, each printing its ticks:
chip_smoke.py's phases 4 and 4d for B5, 4b (paged, with its contiguous and
paged ticks in alternating windows) for B7, 4c (with its base and adapter
ticks in alternating windows) for B6. Then the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

TOL = 2e-2      # max |kernel - twin|, 16-bit (chip_smoke.py TWIN_TOL)


def launch_times(prof) -> dict:
    """Mean device ms of each kernel in a profile, by name (the L2 flush's
    fill kernel and the runtime's launch calls left out)."""
    out = {}
    for e in prof.key_averages():
        key = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
        total = getattr(e, "device_time_total", 0)
        if (total <= 0 or key.startswith("cuda") or "kernel" not in key
                or "elementwise" in key or "Fill" in key or "spin" in key):
            continue
        out[key.split("<")[0].split("(")[0]] = total / max(e.count, 1) / 1e3
    return out


def timeline(prof) -> list:
    """The last profiled call's kernels as (name, start us, duration us),
    start from the first kernel of the call: the kernels after the last
    L2 flush of the trace."""
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and "spin" not in e["name"] and "sleep" not in e["name"]),
                     key=lambda e: e["ts"])
    last = [i for i, e in enumerate(kernels)
            if "elementwise" in e["name"] or "Fill" in e["name"]]
    call = kernels[last[-1] + 1:] if last else kernels
    if not call:
        return []
    t0 = call[0]["ts"]
    name = lambda n: n.replace("void ", "").replace("(anonymous namespace)::", "").split("<")[0]  # noqa: E731
    return [(name(e["name"]), round(e["ts"] - t0, 2), round(e["dur"], 2)) for e in call]


def measure(cs, fn, flush) -> dict:
    """Device ms (CUDA events), the launches' ms (profiler), the last
    profiled call's kernel timeline and the host us to issue one call with
    the device busy."""
    from torch.profiler import ProfilerActivity, profile

    ms = cs.device_time_ms(torch, fn, flush, runs=50)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flush.zero_()
            torch.cuda._sleep(2_000_000)     # the call is queued before the device reaches it
            fn()
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    windows = []
    for _ in range(5):
        torch.cuda._sleep(200_000_000)      # the device stays busy: the host never waits
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        windows.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    return dict(ms=ms, kernels_ms=launch_times(prof), timeline=timeline(prof),
                host_us=statistics.median(windows), host_us_windows=windows)


def time_b5(cs, tds, DTYPE_MAP, dev, flush) -> None:
    gen = torch.Generator(device=dev).manual_seed(1234)
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
            raise AssertionError(f"{name}: B5 is off its twin by {err}")
        row = measure(cs, lambda: tds.fused_decode_step(q, kn, vn, K, V, lens), flush)
        prefix = int(lens.long().sum().item())
        nbytes = K.element_size() * (2 * S * Hq * hd + 4 * S * Hkv * hd
                                     + 2 * prefix * Hkv * hd) + 4 * S
        C, n_splits = tds.split_kv_plan(Tmax, hd, dtype)
        print(json.dumps(dict(kernel="b5", shape=name, dtype=dt, C=C, n_splits=n_splits,
                              bytes=nbytes, gbps=nbytes / (row["ms"] * 1e-3) / 1e9,
                              max_abs_err=err, **row)), flush=True)


def time_b7(cs, tds, DTYPE_MAP, dev, flush) -> None:
    gen = torch.Generator(device=dev).manual_seed(4321)
    for name, S, Hq, Hkv, hd, P, M, dt in cs.PAGED_SHAPES:
        dtype = DTYPE_MAP[dt]
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        N = S * M + 1
        q, K, V = rnd(S, 1, Hq, hd), rnd(N, Hkv, P, hd), rnd(N, Hkv, P, hd)
        lens = torch.randint(1, M * P - 1, (S,), generator=gen, device=dev)
        lens[0], lens[1] = 0, M * P - 1
        lens = lens.to(torch.int32)
        pages = (torch.randperm(N - 1, generator=gen, device=dev) + 1).view(S, M)
        used = lens.long() // P + 1
        col = torch.arange(M, device=dev)[None, :]
        table = torch.where(col < used[:, None], pages, 0).to(torch.int32).contiguous()
        out = tds.paged_decode_attention(q, K, V, table, lens)
        ref = tds.paged_decode_attention_plain(q, K, V, table, lens)
        err = (out.float() - ref.float()).abs().max().item()
        if err > TOL:
            raise AssertionError(f"{name}: B7 is off its twin by {err}")
        Kc = tds.paged_view(K, table, M * P).contiguous()
        Vc = tds.paged_view(V, table, M * P).contiguous()
        at = (torch.arange(S, device=dev), slice(None), lens.long())
        kn, vn = Kc[at][:, None].contiguous(), Vc[at][:, None].contiguous()
        out_b5, _, _ = tds.fused_decode_step(q, kn, vn, Kc, Vc, lens)
        row = measure(cs, lambda: tds.paged_decode_attention(q, K, V, table, lens), flush)
        b5 = measure(cs, lambda: tds.fused_decode_step(q, kn, vn, Kc, Vc, lens), flush)
        rows_read = int(lens.long().sum().item()) + S
        nbytes = (K.element_size() * (2 * S * Hq * hd + 2 * rows_read * Hkv * hd)
                  + 4 * int(used.sum().item()) + 4 * S)
        print(json.dumps(dict(kernel="b7", shape=name, dtype=dt, P=P, M=M, bytes=nbytes,
                              gbps=nbytes / (row["ms"] * 1e-3) / 1e9, max_abs_err=err,
                              b5_max_abs_diff=(out.float() - out_b5.float()).abs().max().item(),
                              b5_contiguous=b5, **row)), flush=True)


def time_b6(cs, tds, DTYPE_MAP, dev, flush) -> None:
    import math

    gen = torch.Generator(device=dev).manual_seed(5678)
    S, N, r = cs.LORA_S, cs.LORA_POOL, cs.LORA_RANK
    ids = torch.tensor(cs.LORA_IDS, dtype=torch.int32, device=dev)
    for name, projs, D, O, dt in cs.LORA_SHAPES:
        dtype = DTYPE_MAP[dt]
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
        x = rnd(S, D).to(dtype)
        A = (rnd(N, 2, D, r) / math.sqrt(D)).to(dtype)[:, 1]
        B = rnd(N, 2, r, O).to(dtype)[:, 1]
        sc = torch.rand(N, generator=gen, device=dev) + 0.5
        out = tds.lora_bgmv(x, A, B, ids, sc)
        exact, mag = cs.bgmv_magnitude(torch, x, A, B, ids, sc)
        rel = cs._rel_err(torch, out, exact, mag)
        if rel > cs.BGMV_TOL[dt][1]:
            raise AssertionError(f"{name} {projs}: B6 is off the exact result by {rel} M")
        row = measure(cs, lambda: tds.lora_bgmv(x, A, B, ids, sc), flush)
        plan = getattr(tds, "bgmv_plan", None)      # absent before the split design
        print(json.dumps(dict(kernel="b6", shape=name, projections=projs, D=D, O=O, dtype=dt,
                              plan=plan(D, r, O, dtype) if plan else None,
                              exact_err_over_m=rel, **row)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_step_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP
    from building_llm_from_scratch_tpu_torch.ops import decode_step as tds

    kernels = ["b5"]
    if "--kernels" in sys.argv:
        kernels = sys.argv[sys.argv.index("--kernels") + 1].split(",")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    timers = {"b5": time_b5, "b6": time_b6, "b7": time_b7}
    for k in kernels:
        timers[k](cs, tds, DTYPE_MAP, dev, flush)
    if "--tick" in sys.argv:
        if "b5" in kernels:
            cs.phase_serve(torch)
            cs.phase_serve_longctx(torch)
        with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
            if "b7" in kernels:
                cs.phase_serve_paged(torch, workdir)
            if "b6" in kernels:
                cs.phase_serve_lora(torch, workdir)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    return 0


if __name__ == "__main__":
    sys.exit(main())
