"""Times the training loss and dropout kernels on one NVIDIA GPU: B3 (fused
dropout: forward, forward + residual add, backward) in bf16, fp16 and fp32,
and B4 (the vocab-streamed cross-entropy forward) in bf16 and fp32, at
chip_smoke.py's shapes (GPT-2-124M's training step: (8 x 1024, 768) for
B3; N 8192, D 768, V 50257 for B4), after checking each against its plain
twin (B3 bit for bit, B4 within the JAX test's bounds).

    python3 scripts/train_kernel_timing.py            # from a tree's root
    python3 scripts/train_kernel_timing.py --floors --sass --train

The package imported is the one under the current directory, so two trees
(a parent commit unpacked beside the working tree) are compared by running
the script from each root in turn, alternating (A, B, B, A), on one card in
one sitting; a parent tree takes this tree's script. One JSON line per
(kernel, dtype), then the card's name and power limit. Times are medians of
CUDA-event readings with L2 flushed before each call, as chip_smoke.py
takes them (by writing 64 MB, which leaves L2 full of dirty lines that the
timed call then writes back; ``--flush read`` flushes by reading instead);
each B4 row also has the device time of every CUDA kernel one call
launches (torch.profiler). Options:

  --floors  B3's two floors, built apart from the library from this tree's
            csrc/fused_dropout.cu with -DBLLM_DROPOUT_FLOOR=1 (loads and
            stores, no Philox) and =2 (Philox, no loads or stores), timed
            through the same wrappers;
  --sass    where the dropout kernels' 128-bit loads and the Philox
            multiplies (IMAD.HI) fall in their SASS (cuobjdump);
  --train   re-runs phase 6's GPT-2-124M training runs (20 steps, bf16 and
            the default fp32) with the chunked loss and with B4
            (BLLM_XENT_PALLAS=1), through chip_smoke.train_run.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}
DROPOUT_SHAPE = (8 * 1024, 768)
XENT_SHAPE = (8 * 1024, 768, 50257)
RATE = 0.1


class L2Flush:
    """Evicts L2 before a timed call by writing 64 MB (``mode`` "write",
    chip_smoke.py's way) or by reading them ("read")."""

    def __init__(self, mode: str):
        self.mode = mode
        self.buf = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def __call__(self):
        if self.mode == "write":
            self.buf.zero_()
        else:
            self.buf.sum()


def median_ms(fn, flush, runs=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush()
        torch.cuda._sleep(1_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_breakdown(fn):
    """Device ms of each CUDA kernel one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
            if ev.self_device_time_total > 0}


def dropout_rows(dtypes, flush, library: bool, tag: str = "kernel"):
    from building_llm_from_scratch_tpu_torch.ops import fused_dropout as tfd

    N, D = DROPOUT_SHAPE
    rows = []
    for dt in dtypes:
        dtype = DTYPES[dt]
        gen = torch.Generator(device="cuda").manual_seed(1357)
        x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
        h = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
        seed = 0xD20F0000 + N
        calls = {"fwd": (lambda: tfd.dropout_fwd(None, h, seed, RATE),
                         lambda: tfd.dropout_fwd_plain(None, h, seed, RATE),
                         lambda: F.dropout(h, RATE), 2),
                 "fwd_add": (lambda: tfd.dropout_fwd(x, h, seed, RATE),
                             lambda: tfd.dropout_fwd_plain(x, h, seed, RATE),
                             lambda: x + F.dropout(h, RATE), 3),
                 "bwd": (lambda: tfd.dropout_bwd(h, seed, RATE),
                         lambda: tfd.dropout_bwd_plain(h, seed, RATE),
                         lambda: F.dropout(h, RATE), 2)}
        for name, (kfn, pfn, lfn, n_tensors) in calls.items():
            if tag == "kernel":
                a = kfn()
                torch.cuda.synchronize()
                if not torch.equal(a.view(torch.uint8), pfn().view(torch.uint8)):
                    raise AssertionError(f"B3 {name} {dt}: not bit-equal to its twin")
            nbytes = n_tensors * N * D * h.element_size()
            row = dict(kernel=f"dropout_{name}", variant=tag, dtype=dt, N=N, D=D,
                       tree=os.getcwd(), flush=flush.mode, ms=median_ms(kfn, flush),
                       bytes=nbytes, bytes_bound_ms=nbytes / 3.35e12 * 1e3)
            if tfd_plan := getattr(tfd, "dropout_plan", None):
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                row["plan"] = tfd_plan(N * D, dtype, sms)
            if library:
                row["library_ms"] = median_ms(lfn, flush)
            print(json.dumps(row), flush=True)
            rows.append(row)
        del x, h
        torch.cuda.empty_cache()
    return rows


def xent_rows(dtypes, flush, library: bool):
    from building_llm_from_scratch_tpu_torch.ops import xent_fwd as txf

    N, D, V = XENT_SHAPE
    for dt in dtypes:
        dtype = DTYPES[dt]
        gen = torch.Generator(device="cuda").manual_seed(9753)
        x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
        w = (0.02 * torch.randn(D, V, generator=gen, device="cuda")).to(dtype)
        t = torch.randint(0, V, (N,), generator=gen, device="cuda")
        t[0] = V - 1
        nll, lse = txf.xent_fwd(x, w, t)
        torch.cuda.synchronize()
        nll_t, lse_t = txf.xent_fwd_plain(x, w, t)
        err = dict(lse=(lse - lse_t).abs().max().item(), nll=(nll - nll_t).abs().max().item())
        if not (torch.allclose(lse, lse_t, rtol=1e-5, atol=1e-5)
                and torch.allclose(nll, nll_t, rtol=1e-4, atol=2e-4)):
            raise AssertionError(f"B4 {dt}: off its twin: {err}")
        del nll_t, lse_t
        ops = 2 * N * D * V
        peak = 495e12 / 3 if dtype == torch.float32 else 989e12
        row = dict(kernel="xent_fwd", dtype=dt, N=N, D=D, V=V, tree=os.getcwd(), flush=flush.mode,
                   source=txf.kernel_source(dtype), err=err,
                   ms=median_ms(lambda: txf.xent_fwd(x, w, t), flush, runs=10),
                   ops_bound_ms=ops / peak * 1e3,
                   kernels_ms=kernel_breakdown(lambda: txf.xent_fwd(x, w, t)))
        if library:
            def lib():
                logits = (torch.mm(x, w) if dtype == torch.float32
                          else torch.mm(x, w, out_dtype=torch.float32))
                lse_l = torch.logsumexp(logits, dim=-1)
                return lse_l - logits.gather(1, t[:, None])[:, 0], lse_l
            row["library_ms"] = median_ms(lib, flush, runs=10)
        print(json.dumps(row), flush=True)
        del x, w, t, nll, lse
        torch.cuda.empty_cache()


def floor_library(level: int):
    """csrc/fused_dropout.cu built alone with -DBLLM_DROPOUT_FLOOR=level."""
    from building_llm_from_scratch_tpu_torch.ops import _kernels

    src = _kernels.CSRC / "fused_dropout.cu"
    if "BLLM_DROPOUT_FLOOR" not in src.read_text():
        return None
    out = _kernels.BUILD_DIR / "floors" / f"libdropout_floor{level}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_kernels._nvcc(), *flags, "-shared", f"-DBLLM_DROPOUT_FLOOR={level}",
                    "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    i32, u32, f32, ptr = ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p
    lib.bllm_dropout.argtypes = [i32, ctypes.c_longlong, i32, u32, f32, u32, u32] + [ptr] * 4
    lib.bllm_dropout.restype = i32
    return lib


def floor_rows(dtypes, flush):
    """B3's wrappers timed on each floor library in place of the kernel's."""
    from building_llm_from_scratch_tpu_torch.ops import _kernels

    real = _kernels.load_library
    for level, name in ((1, "floor_copy_only"), (2, "floor_philox_only")):
        lib = floor_library(level)
        if lib is None:
            print(json.dumps(dict(variant=name, skipped="this tree's kernel has no floors")))
            continue
        _kernels.load_library = lambda lib=lib: lib
        try:
            dropout_rows(dtypes, flush, library=False, tag=name)
        finally:
            _kernels.load_library = real


def sass_rows():
    """For each dropout kernel in the built library: the SASS line numbers
    of its 128-bit global loads and of its Philox multiplies (IMAD.HI or
    IMAD.WIDE.U32 by Philox's constants 0xD2511F53 / 0xCD9E8D57), and how
    many of the loads come before the first multiply."""
    from building_llm_from_scratch_tpu_torch.ops import _kernels

    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    path = _kernels.build()["path"]
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    for f in funcs[1:]:
        name = f.split("\n", 1)[0].strip()
        if "dropout_kernel" not in name:
            continue
        lines = [ln for ln in f.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
        loads = [i for i, ln in enumerate(lines) if "LDG.E.128" in ln]
        muls = [i for i, ln in enumerate(lines) if "IMAD" in ln and
                re.search(r"0xd2511f53|0xcd9e8d57", ln, re.I)]
        hi = [ln.split(";")[0].split("*/")[-1].split()[0] for ln in lines
              if "IMAD" in ln and re.search(r"0xd2511f53|0xcd9e8d57", ln, re.I)]
        first_mul = muls[0] if muls else len(lines)
        print(json.dumps(dict(sass=name, instructions=len(lines), ldg128=loads,
                              philox_mul_first=first_mul, philox_mul_count=len(muls),
                              philox_mul_ops=sorted(set(hi)),
                              loads_before_first_philox_mul=sum(i < first_mul
                                                                for i in loads))), flush=True)


def train_rows():
    import chip_smoke

    here = os.getcwd()
    for t in (chip_smoke.TRAIN_GPT2, chip_smoke.TRAIN_GPT2_FP32):
        for xent_kernel in (False, True):
            with tempfile.TemporaryDirectory(dir=here) as workdir:
                trainer, facts = chip_smoke.train_run(torch, t, workdir, xent_kernel=xent_kernel)
            steps = facts["run_step_ms"]
            print(json.dumps(dict(
                train="gpt2-124M", dtype=t["dtype"] or "fp32", xent_kernel=xent_kernel,
                tree=here, launches=facts["launches"], step1_loss=facts["losses"][0],
                last_loss=facts["losses"][-1], step1_ms=steps[0],
                later_steps_median_ms=statistics.median(steps[1:]),
                later_steps_ms=steps[1:], peak_memory_gb=facts["peak_gb"])), flush=True)
            del trainer
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dropout-dtypes", default="bf16,fp16,fp32")
    ap.add_argument("--xent-dtypes", default="bf16,fp32")
    ap.add_argument("--no-library", action="store_true", help="skip the library timings")
    ap.add_argument("--floors", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="evict L2 before each timed call by writing (default) or reading")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = L2Flush(args.flush)
    dd = [d for d in args.dropout_dtypes.split(",") if d]
    xd = [d for d in args.xent_dtypes.split(",") if d]
    dropout_rows(dd, flush, library=not args.no_library)
    if args.floors:
        floor_rows(dd, flush)
    xent_rows(xd, flush, library=not args.no_library)
    if args.sass:
        sass_rows()
    if args.train:
        train_rows()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
