#!/usr/bin/env python3
"""Runs of a cell with the correctness check's control, or a planted
fault, put in the program's place: what sets the upper reading of each
compared number (PERF.md, "How correct is decided").

    python3 portbench/control.py --workload <cell> --mode <mode> \\
        --seeds <n>[,<n>...] [--seconds <s>]

Modes: ``tf32`` (the reference in TF32 in the program's place: the
control of an fp32 configuration), ``half_batch`` (a training fault: the
loss over half of each batch), ``altered`` (a fault of the answering
cell: each answer's text altered where the evaluator decodes it), and
``sound`` (the program as it is, for the lower readings). Each seed is a
run of the cell at its own size in this one process; one JSON line per
seed, with the compared numbers. Needs a CUDA card.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def alter_answers() -> None:
    """Plant the altered-answer fault: every answer the evaluator decodes
    gets another text."""
    from ruart_tpu_torch.eval import evaluator

    decode_batch = evaluator.decode_batch

    def batch(*args, **kw):
        res, save, anls, acc = decode_batch(*args, **kw)
        return res, [dict(s, prediction=s["prediction"] + "x")
                     for s in save], anls, acc

    evaluator.decode_batch = batch


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("tf32", "half_batch", "altered", "sound"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    harness.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    if args.mode == "altered":
        alter_answers()
    for seed in (int(s) for s in args.seeds.split(",")):
        line, out = harness.local(
            args.workload, seed, args.seconds, device="cuda",
            control=args.mode if args.mode in ("tf32", "half_batch")
            else None)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": line["correct"],
                          "compared": line["compared"], "notes": out.notes}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
