#!/usr/bin/env python3
"""Reproduce the native crash of a profiled train-graph replay on one CUDA
card: an open fault of the PyTorch port.

    python3 tools/torch_train_graph_crash.py [--arms N] [--hold] [--reps R]

Trains a model through the CLI on synthetic data as ``chip_smoke.py``'s
phase 6 does, then runs phase 13 (a) as the smoke does (the fp32, BF16 and
LOCK_BERT-off arms; the fp32 eager and graph arms are kept), then builds
``--arms`` (3) more train steps with ``make_train_step(graphs=True)`` on the
LOCK_BERT-off conf and runs each for its 10 steps, dropping it at once or,
with ``--hold``, only after the timing; last it runs phase 13 (c): the kept
fp32 arms in turns, each round ending in one step under ``torch.profiler``.
``--reps`` repeats the extra arms and the timing in the same process. When
phase 13 (a) itself held LOCK_BERT off with three graph arms (code not
kept), the process died there with a segmentation fault inside
``torch.cuda.CUDAGraph.replay``, called from ``SignatureGraphs.__call__``
(``ruart_tpu_torch/utils/graphs.py``). This tool rebuilds that input as
closely as the kept code allows; its runs so far have not crashed (PERF.md
§6), so it is where a search for the cause starts, not a proof of it.
``--arms 0`` is what ``chip_smoke.py`` runs. Exits 0 when the replays all
ran, and prints the card and the options first.
"""

import argparse
import faulthandler
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arms", type=int, default=3,
                        help="LOCK_BERT-off graph arms built and dropped")
    parser.add_argument("--hold", action="store_true",
                        help="drop the extra arms after the timing")
    parser.add_argument("--reps", type=int, default=1,
                        help="times the extra arms and the timing run")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    faulthandler.enable()
    import chip_smoke as cs
    from ruart_tpu_torch.ops import attention as att

    print(f"{cs.card_line()}; {args.arms} extra LOCK_BERT-off graph arms, "
          f"hold {args.hold}, {args.reps} reps", flush=True)
    os.makedirs(os.path.join(HERE, "_scratch"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="crash_",
                            dir=os.path.join(HERE, "_scratch"))
    try:
        trainer, _ = cs.run_training(att, cs.write_training_data(root))
        setup = {
            "opt": dict(trainer.opt), "bert": trainer.spec.bert,
            "weights": {k: v.detach().clone()
                        for k, v in trainer.model.state_dict().items()},
            "batches": cs.train_batches_on_device(trainer,
                                                  cs.N_GRAPH_BATCHES)}
        del trainer

        def drive(label, fn, batches, bf16=False, exact=False):
            return fn()

        arms = cs.train_graph_equality(setup, drive)
        opt = {k: v for k, v in setup["opt"].items() if k != "LOCK_BERT"}
        for rep in range(args.reps):
            held = []
            for i in range(args.arms):
                step, state, batches = cs.train_arm(setup, opt, True)
                cs.run_arm(step, state, batches)
                print(f"rep {rep} extra arm {i}: {len(step.graphs)} captures",
                      flush=True)
                if args.hold:
                    held.append((step, state))
                del step, state
            cs.train_graph_timing(arms, setup)
            del held
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("all replays ran", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
