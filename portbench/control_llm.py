#!/usr/bin/env python3
"""Runs of the Moonlight cell with its correctness check's control, or a
planted fault, in the program's place: what sets the upper reading of each
compared number (PERF.md, "How correct is decided"), beside the sound
program's lower readings.

    python3 portbench/control_llm.py --modes sound,fp8,top5,... \\
        --seeds <n>[,<n>...] [--seconds <s>] [--workload <cell>]

Modes: ``sound`` (the program as it is), ``fp8`` (the control: the
reference with the routed experts' weights and inputs rounded to fp8
e4m3), ``top5``, ``nobias``, ``nocausal`` (faults; see
``reference/moonlight.py``); ``tf32`` (the fusion path's control: the
reference's steps in TF32) and ``half_batch`` (a fusion fault: half of
each batch left out of the loss). Each (seed, mode) is a run of the cell at its
own size in this one process; one JSON line per run, with the compared
numbers and the notes. Needs a CUDA card.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

MODES = ("sound", "fp8", "top5", "nobias", "nocausal", "tf32", "half_batch")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="moonlight-bf16.train-b16-llm")
    p.add_argument("--modes", default="sound")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    modes = args.modes.split(",")
    if not set(modes) <= set(MODES):
        p.error(f"modes are {', '.join(MODES)}")
    harness.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("control_llm: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            line, out = harness.local(
                args.workload, seed, args.seconds, device="cuda",
                control=None if mode == "sound" else mode)
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, "correct": line["correct"],
                              "compared": line["compared"],
                              "metrics": line["metrics"],
                              "notes": out.notes}), flush=True)
            del line, out
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
