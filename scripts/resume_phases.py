#!/usr/bin/env python3
"""chip_smoke.py's phases 8w (pretrained weights from a local directory)
and 8r (train-state checkpoints, stop and resume through the CLI) alone,
at a chosen depth, on one NVIDIA H100:

    python3 scripts/resume_phases.py                  # 8r at 2 layers, as chip_smoke
    python3 scripts/resume_phases.py --layers 0 --models gpt2   # full depth

Run it from a tree's root. It prints chip_smoke's JSON lines (the card's
name and power limit first) and the seconds each phase took. A full-depth
8r save writes 1.96 GB (GPT-2 fp32) or 3.08 GB (LLaMA-3.2-1B's LoRA state):
to keep a run's disk writes under 45 GiB, run one model a run at full
depth. Unlike chip_smoke it runs each unbroken command
twice (``--no_repeat`` leaves the second out), and the two must agree bit
for bit.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=2,
                   help="Depth of the 8r runs; 0 keeps each model's own.")
    p.add_argument("--models", type=str, default="gpt2,llama3_2-sft",
                   help="Labels of chip_smoke.RESUME to run.")
    p.add_argument("--no_repeat", action="store_true",
                   help="Leave out the second unbroken run (chip_smoke does).")
    args = p.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("resume_phases: no CUDA device is available", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    card = cs.phase_env(torch)
    cs.phase_build()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
        t = time.perf_counter()
        weights = cs.phase_weights(torch, os.path.join(workdir, "weights"))
        weights_s = time.perf_counter() - t
        t = time.perf_counter()
        resumed = cs.phase_resume(torch, card, os.path.join(workdir, "resume"),
                                  weights, layers=args.layers or None,
                                  labels=args.models.split(","),
                                  repeat=not args.no_repeat)
        resume_s = time.perf_counter() - t
    print(json.dumps({"weights_s": weights_s, "resume_s": resume_s,
                      "total_s": time.perf_counter() - t0,
                      "b5_launches": weights["launches"], "resume": resumed}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
