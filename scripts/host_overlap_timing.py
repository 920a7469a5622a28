#!/usr/bin/env python3
"""The host overlap of the trainer, in alternating rounds on one NVIDIA
H100: GPT-2-124M bf16 (B 8 x T 1024, dropout 0.1) through the CLI, 20
steps a run, as chip_smoke's phase 6h runs it.

    python3 scripts/host_overlap_timing.py              # 3 rounds
    python3 scripts/host_overlap_timing.py --rounds 5
    python3 scripts/host_overlap_timing.py --rounds 0 --pairs 2

Each round runs, in turn:
  - ``--prefetch 0`` and ``--prefetch 2`` without saves: the median step
    (CUDA events around each step, steps 2-19) and the median host gap
    between step calls;
  - ``--async_ckpt off`` and ``--async_ckpt on`` (both ``--prefetch 2``)
    with a checkpoint every 5 steps (``--keep_ckpts 1``): the host gap of
    each save step, and the median step of steps 6-9, 11-14 and 16-19,
    which the asynchronous writes run beside, against the same steps of
    the synchronous run.

``--pairs N`` also runs chip_smoke's phase 6h N times as it is (the
synchronous run, then the overlapped one) and N times with the two runs
swapped, so that a difference of order shows apart from one of mode.

Run it from a tree's root. It prints chip_smoke's JSON lines, the card's
name and power limit first; one ``host_overlap_round`` line a run, and a
``host_overlap_order`` line before each 6h pair. The machine runs other
work beside the card's: compare runs only within one call, and read the
rounds' spread before a difference.
"""

import argparse
import os
import statistics
import sys
import tempfile

sys.path.insert(0, os.getcwd())

RUN = dict(model="GPT2", size="124M", dtype="bf16", batch=8, context=1024,
           steps=20, export=False)
#: the steps (1-based) after each save of a --save_ckpt_freq 5 run, before
#: the next save
AFTER_SAVES = [s for first in (6, 11, 16) for s in range(first, first + 4)]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--pairs", type=int, default=0,
                   help="chip_smoke's 6h pairs to run in each order.")
    args = p.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("host_overlap_timing: no CUDA device is available", file=sys.stderr)
        return 3
    cs.phase_env(torch)
    cs.phase_build()
    variants = [("prefetch0", ["--prefetch", "0"]),
                ("prefetch2", ["--prefetch", "2"]),
                ("sync_saves", ["--prefetch", "2", "--async_ckpt", "off",
                                "--save_ckpt_freq", "5", "--keep_ckpts", "1"]),
                ("async_saves", ["--prefetch", "2", "--async_ckpt", "on",
                                 "--save_ckpt_freq", "5", "--keep_ckpts", "1"])]
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
        for rnd in range(args.rounds):
            for name, flags in variants:
                trainer, facts = cs.train_run(
                    torch, dict(RUN, flags=flags),
                    os.path.join(workdir, f"{name}-{rnd}"))
                ms = facts["run_step_ms"]
                starts = facts["step_starts"]
                gaps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
                row = dict(round=rnd, run=name, flags=flags,
                           steady_step_ms=statistics.median(ms[1:19]),
                           steady_gap_ms=statistics.median(gaps[1:18]))
                if "--save_ckpt_freq" in flags:
                    # gaps[s - 1]: from step s's call to step s + 1's
                    row.update(save_gaps_ms=[gaps[s - 1] for s in (5, 10, 15)],
                               after_saves_step_ms=statistics.median(
                                   ms[s - 1] for s in AFTER_SAVES),
                               saves=[{k: r.get(k) for k in (
                                   "tag", "seconds", "snapshot_s", "write_s",
                                   "overlap_s")} for r in trainer.checkpoint_saves])
                cs.emit("host_overlap_round", **row)
                del trainer
                torch.cuda.empty_cache()
        runs = list(cs.HOST_RUNS)
        for pair in range(args.pairs):
            for order, runs_in_order in (("as chip_smoke", runs),
                                         ("swapped", runs[::-1])):
                cs.emit("host_overlap_order", pair=pair, order=order,
                        runs=[name for name, _ in runs_in_order])
                cs.HOST_RUNS = runs_in_order
                try:
                    cs.phase_host_overlap(
                        torch, os.path.join(workdir, f"6h-{pair}-{order[0]}"))
                finally:
                    cs.HOST_RUNS = runs
    return 0


if __name__ == "__main__":
    sys.exit(main())
