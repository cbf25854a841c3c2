#!/usr/bin/env python3
"""Rebuild, on one CUDA card, the input under which a profiled train-graph
replay of the PyTorch port segfaulted, and count how often it crashes.

    python3 tools/torch_train_graph_crash.py [--form after|inside]
        [--arms N] [--hold] [--reps R] [--phase6-profile] [--sessions N]
        [--no-teardown] [--root DIR] [--runs R --logs DIR]

Each form trains a model through the CLI on synthetic data as
``chip_smoke.py``'s phase 6 does (its trainer, train graphs and eval
graphs dropped after), then runs phase 13 (a): the shipped conf in fp32,
``BF16`` and ``LOCK_BERT`` off, the fp32 eager and graph arms kept; then
phase 13 (c): the kept fp32 arms in turns, each round ending in one step
under ``torch.profiler``.

* ``--form after`` (the default): 13 (a) as ``chip_smoke.py`` runs it (one
  LOCK_BERT-off graph arm, rerun in place), then ``--arms`` (3) more
  LOCK_BERT-off graph arms built with ``make_train_step(graphs=True)``,
  each run for its 10 steps and dropped at once (``--hold``: after the
  timing). ``--reps`` repeats the extra arms and the timing.
* ``--form inside``: 13 (a) as it first ran, when four of four processes
  segfaulted inside ``torch.cuda.CUDAGraph.replay`` in 13 (c): after the
  fp32 and BF16 arms (each conf: two eager arms, a graph arm, then two
  eager arms and a graph arm under deterministic kernels), three eager
  LOCK_BERT-off arms and ``--arms`` (3) LOCK_BERT-off graph arms of their
  own, each built, run for its 10 steps and dropped.

Factors: ``--hold`` (the dropped arms held to the end),
``--phase6-profile`` (three train steps of the CLI's trainer profiled
before it is dropped, as ``chip_smoke.py``'s phase 6 does), ``--sessions
N`` (N more profiler sessions, each around one of its train steps) and
``--no-teardown`` (``TEARDOWN_CUPTI=0`` and ``DISABLE_CUPTI_LAZY_REINIT=1``
set before torch is imported: CUPTI stays set up between profiler
sessions, the workaround ``torch.profiler`` applies for
``torch.compile``'s graphs).

``--root DIR`` runs the port and ``chip_smoke.py`` of an earlier checkout
(``git archive`` into an ignored folder). With ``--runs R`` the tool
starts R fresh processes of itself with the other options, one at a time
(a run takes some 20 GB of an 80 GB card; two at a time ran out of
memory), each killed after RUN_TIMEOUT seconds, writes each one's output
under ``--logs`` (default ``_scratch/train_graph_crash/``) and prints each
exit code and a JSON summary (-11 is a segmentation fault). A run prints
the card and
its options first and exits 0 when every replay ran. No form has crashed
in fresh processes so far; the crash has shown in ``chip_smoke.py``'s
full run, whose phases 1-12 come first (PERF.md, section 6).
"""

import argparse
import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 900  # seconds for one fresh process of --runs


def options(args) -> str:
    return (f"form {args.form}, {args.arms} dropped LOCK_BERT-off graph arms, "
            f"hold {args.hold}, reps {args.reps}, phase6_profile "
            f"{args.phase6_profile}, sessions {args.sessions}, no_teardown "
            f"{args.no_teardown}, root {args.root or HERE}")


class Dropped:
    """The LOCK_BERT-off graph arms this run builds and drops (or holds,
    with ``--hold``)."""

    def __init__(self, cs, setup, args):
        self.cs, self.setup, self.args, self.held = cs, setup, args, []
        self.opt = {k: v for k, v in setup["opt"].items() if k != "LOCK_BERT"}

    def run(self, label):
        step, state, batches = self.cs.train_arm(self.setup, self.opt, True)
        self.cs.run_arm(step, state, batches)
        print(f"{label}: {len(step.graphs)} captures", flush=True)
        if self.args.hold:
            self.held.append((step, state))


def equality_inside(cs, setup, dropped):
    """Phase 13 (a) as it first ran: the LOCK_BERT-off graph arms are three
    arms of their own, built, run and dropped. Returns the kept fp32 arms."""
    kept = {}
    base = dict(setup["opt"])
    for label, opt in (("fp32", base), ("BF16", dict(base, BF16=True))):
        def arm(graphs, keep=""):
            step, state, batches = cs.train_arm(setup, opt, graphs)
            out = cs.run_arm(step, state, batches)
            if keep and label == "fp32":
                kept[keep] = (step, state)
            return out

        eager = [arm(False, "eager"), arm(False)]
        got = arm(True, "graph")
        with cs.deterministic_kernels():
            det = [arm(False), arm(False), arm(True)]
        print(f"13 (a) {label}: graphs vs eager {cs.arm_diff(got, eager[0])}, "
              f"deterministic {cs.arm_diff(det[2], det[0])}", flush=True)
    lock_off = {k: v for k, v in base.items() if k != "LOCK_BERT"}
    for _ in range(3):
        step, state, batches = cs.train_arm(setup, lock_off, False)
        cs.run_arm(step, state, batches)
        del step, state
    for i in range(dropped.args.arms):
        dropped.run(f"13 (a) LOCK_BERT off graph arm {i}")
    return kept


def one_process(args) -> int:
    if args.no_teardown:
        os.environ["TEARDOWN_CUPTI"] = "0"
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    root = os.path.abspath(args.root or HERE)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    faulthandler.enable()
    import chip_smoke as cs
    from ruart_tpu_torch.ops import attention as att

    print(f"{cs.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {options(args)}", flush=True)
    t0 = time.time()
    os.makedirs(os.path.join(HERE, "_scratch"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="crash_", dir=os.path.join(HERE, "_scratch"))
    try:
        trainer, _ = cs.run_training(att, cs.write_training_data(work))
        if args.phase6_profile or args.sessions:
            [batch] = cs.train_batches_on_device(trainer)
        if args.phase6_profile:
            cs.profile_device(lambda: [trainer.train_step(trainer.state, *batch)
                                       for _ in range(3)], "3 train steps")
        for _ in range(args.sessions):
            cs.profile_counts(lambda: trainer.train_step(trainer.state, *batch))
        if args.phase6_profile or args.sessions:
            del batch
        setup = {
            "opt": dict(trainer.opt), "bert": trainer.spec.bert,
            "weights": {k: v.detach().clone()
                        for k, v in trainer.model.state_dict().items()},
            "batches": cs.train_batches_on_device(trainer,
                                                  cs.N_GRAPH_BATCHES)}
        del trainer
        print(f"phase 6 done in {time.time() - t0:.1f} s", flush=True)
        dropped = Dropped(cs, setup, args)
        if args.form == "inside":
            arms = equality_inside(cs, setup, dropped)
            print(f"13 (a) done in {time.time() - t0:.1f} s", flush=True)
            cs.train_graph_timing(arms, setup)
        else:
            def drive(label, fn, batches, bf16=False, exact=False):
                return fn()

            arms = cs.train_graph_equality(setup, drive)
            print(f"13 (a) done in {time.time() - t0:.1f} s", flush=True)
            for rep in range(args.reps):
                for i in range(args.arms):
                    dropped.run(f"rep {rep} extra arm {i}")
                cs.train_graph_timing(arms, setup)
        del dropped
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"all replays ran in {time.time() - t0:.1f} s", flush=True)
    return 0


def many(args, argv) -> int:
    """``args.runs`` fresh processes of this tool with ``argv`` less the
    run options, one at a time."""
    child_argv, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--runs", "--logs"):
            skip = True
        elif not a.startswith(("--runs=", "--logs=")):
            child_argv.append(a)
    os.makedirs(args.logs, exist_ok=True)
    tag = re.sub(r"[^\w.-]+", "_", "_".join(child_argv)).strip("_") or "after"
    cmd = [sys.executable, os.path.abspath(__file__), *child_argv]
    print(f"{args.runs} fresh processes of: {' '.join(cmd)}", flush=True)
    rcs = []
    for i in range(args.runs):
        t0 = time.time()
        path = os.path.join(args.logs, f"{tag}.{i}.log")
        with open(path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            try:
                proc.wait(timeout=RUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        rcs.append(proc.returncode)
        with open(path) as f:
            tail = f.read().strip().splitlines()[-2:]
        print(f"run {i}: rc {proc.returncode} in {time.time() - t0:.1f} s; "
              + " | ".join(t[:200] for t in tail), flush=True)
    print(json.dumps({"options": options(args), "runs": len(rcs),
                      "crashed": sum(rc < 0 for rc in rcs),
                      "failed": sum(rc > 0 for rc in rcs), "rcs": rcs}),
          flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--form", choices=("after", "inside"), default="after")
    parser.add_argument("--arms", type=int, default=3,
                        help="LOCK_BERT-off graph arms built and dropped")
    parser.add_argument("--hold", action="store_true",
                        help="hold the dropped arms to the end")
    parser.add_argument("--reps", type=int, default=1,
                        help="form after: times the extra arms and the "
                             "timing run")
    parser.add_argument("--phase6-profile", action="store_true")
    parser.add_argument("--sessions", type=int, default=0,
                        help="profiled train steps of the CLI's trainer, "
                             "one session each, before it is dropped")
    parser.add_argument("--no-teardown", action="store_true")
    parser.add_argument("--root", default="",
                        help="an earlier checkout to run instead")
    parser.add_argument("--runs", type=int, default=0,
                        help="fresh processes to start one at a time "
                             "(0: run here)")
    parser.add_argument("--logs", default=os.path.join(
        HERE, "_scratch", "train_graph_crash"),
        help="with --runs: the folder of the runs' outputs")
    args = parser.parse_args()
    if args.runs:
        return many(args, sys.argv[1:])
    return one_process(args)


if __name__ == "__main__":
    sys.exit(main())
