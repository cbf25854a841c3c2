#!/usr/bin/env python3
"""Rebuild, on one CUDA card, the input under which a profiled train-graph
replay of the PyTorch port segfaulted, and count how often it crashes.

    python3 tools/torch_train_graph_crash.py
        [--form after|inside|smoke|smoke_inside|release]
        [--gc none|before|inside|off] [--skip 1,4,...] [--reps R]
        [--arms N] [--hold] [--phase6-profile] [--sessions N]
        [--then-release N] [--no-teardown] [--root DIR]
        [--runs R --logs DIR]

Each form but ``release`` ends in phase 13 (c) of ``chip_smoke.py``: the
kept fp32 eager and graph train arms in turns, each round ending in one
step under ``torch.profiler`` (PyTorch's CUPTI settings unless
``--no-teardown``).

* ``--form smoke``: ``chip_smoke.py``'s own phases 1-12 in this process
  (``chip_smoke.run``; ``--skip`` leaves out any of 1, 4, 5, 7-12), then
  13 (a), then ``--reps`` times 13 (f) (three LOCK_BERT-off graph arms
  built, run and dropped) and 13 (c). The smoke's crash came from this
  order; the smoke form repeats its last two steps.
* ``--form smoke_inside``: the same with 13 (a) as it first ran (as
  ``--form inside`` below) and 13 (c) right after it in the first rep:
  the input under which the first smoke with three graph arms of their
  own crashed in 4 of 4 runs. ``--then-release N`` goes on, in the same
  process, with the release form's steps below (N reps) after 13 (c):
  one process then holds a run of each form, the release form's after a
  longer prefix.
* ``--form release``: phases 1-12 (less ``--skip``), the automatic
  collector off, a kept fp32 graph train arm (10 steps) and a kept graph
  engine (one ``predict`` of the 40 requests), then ``--reps`` times:
  four more owners built, each with its graphs captured (a graph engine
  to be quantized, one to be closed and dropped, a LOCK_BERT-off train
  step to be called with a new state, one to be dropped); a profiler
  session replays the kept train graph and the kept engine's eval graphs;
  outside any session every owner frees its graphs through the port's
  API (``quantize()``, ``close()``, the new state, ``del``); a second
  session replays the kept graphs (``chip_smoke.
  released_between_sessions``, which phase 13 (g) runs with one owner).
* ``--form after`` (the default): phase 6 alone (training through the
  CLI, its trainer dropped), 13 (a) as ``chip_smoke.py`` runs it, then
  ``--reps`` times ``--arms`` (3) more LOCK_BERT-off graph arms, each run
  for its 10 steps and dropped at once (``--hold``: after the timing),
  and 13 (c).
* ``--form inside``: phase 6 alone, then 13 (a) as it first ran (fp32 and
  BF16: two eager arms, a graph arm, then two eager arms and a graph arm
  under deterministic kernels; three eager LOCK_BERT-off arms and
  ``--arms`` LOCK_BERT-off graph arms built, run and dropped), then 13 (c).

The collector (``--gc``): under ``before``, ``inside`` and ``off`` the
automatic collector is off from the first dropped arm on; at 13 (c)'s
first profiled replay of the graph arm in each timing run, ``before``
runs ``gc.collect()`` just before its profiler session opens and
``inside`` inside the session just before the replay, so that collection
frees the dropped arms.
The port's entry points raise its gen-0 threshold to 100,000
(``utils/gctune.py``), so whatever cyclic garbage a process leaves waits
for a collection at an arbitrary later allocation.

Factors of the after and inside forms: ``--hold``, ``--phase6-profile``
(three train steps of the CLI's trainer profiled before it is dropped, as
``chip_smoke.py``'s phase 6 does), ``--sessions N`` (N more profiler
sessions, each around one of its train steps). ``--no-teardown`` sets
``TEARDOWN_CUPTI=0`` and ``DISABLE_CUPTI_LAZY_REINIT=1`` before torch is
imported (CUPTI stays set up between profiler sessions).

Every run records, before torch is imported, (1) a fatal-signal handler
(``tools/native_stack.py``) that prints the native stack of a crash,
library, offset and symbol of each frame, then faulthandler's Python
stacks of all threads; (2) a lifetime log, one JSON line per event: each
``torch.cuda.CUDAGraph`` that ``SignatureGraphs._capture`` makes (captured,
and destroyed: a ``weakref.finalize``, which runs just before the C++
destructor), each profiler session's start and stop, with the time, the
tool's phase, whether a profiler session is open and the generation of
the collection running (``gc.callbacks``), if any.

``--root DIR`` runs the port (``ruart_tpu_torch``) of another checkout
(``git archive`` into an ignored folder; its kernel library is built at
first use) under this tree's ``chip_smoke.py`` and hooks. With ``--runs
R`` the tool starts R fresh processes of itself with the other options,
one at a time (a run takes some 20 GB of an 80 GB card; two at a time
ran out of memory), each killed after RUN_TIMEOUT
seconds, writes each one's output (``.log``), native stack (``.stack``)
and lifetime log (``.lifetimes.jsonl``) under ``--logs`` (default
``_scratch/train_graph_crash/``) and prints each exit code and a JSON
summary (-11 is a segmentation fault). A run prints the card and its
options first and exits 0 when every replay ran.

Crashes seen (PERF.md section 6 has the tables; NVIDIA H100 80GB HBM3,
700.00 W; torch 2.11.0+cu128): ``--form smoke_inside`` on the port of
``36d5969``, whose train steps left their graphs to the cyclic
collector, segfaulted in 5 of 5 runs with PyTorch's CUPTI settings and
in 1 of 1 with ``--no-teardown``, each inside CUPTI's callback on
``cuGraphLaunch`` after a collection freed dropped train graphs between
two profiler sessions; on the tree whose graph owners free their graphs
at once, in none. With ``--skip 1,4,5,7,8`` it still crashed that port in
2 of 2; leaving out 9 and 11, or 12, stopped it. ``--form release`` on
the same phases crashed neither port. The phase-6-only forms never
crashed, with or without ``--gc``.
"""

import argparse
import faulthandler
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import weakref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 900  # seconds for one fresh process of --runs
SKIPPABLE = (1, 4, 5, 7, 8, 9, 10, 11, 12)
NEEDS = {9: 11, 10: 12}  # phase: the later phase that reads its files


def options(args) -> str:
    return (f"form {args.form}, gc {args.gc}, skip {args.skip or '-'}, reps "
            f"{args.reps}, then release {args.then_release}, {args.arms} "
            f"dropped LOCK_BERT-off graph arms, "
            f"hold {args.hold}, phase6_profile {args.phase6_profile}, "
            f"sessions {args.sessions}, no_teardown {args.no_teardown}, "
            f"root {args.root or HERE}")


class Lifetimes:
    """The lifetime log: JSON lines written unbuffered (``os.write``), so a
    crash loses none."""

    def __init__(self, path: str):
        self.fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        self.t0 = time.perf_counter()
        self.phase = "start"
        self.generation = None  # of the collection running
        self.graphs = 0
        self.profiler_on = lambda: False
        gc.callbacks.append(self._collector)

    def _collector(self, phase, info):
        self.generation = info["generation"] if phase == "start" else None

    def write(self, event: str, **fields):
        fields.update(event=event, t=round(time.perf_counter() - self.t0, 4),
                      phase=self.phase, profiler=self.profiler_on(),
                      gc=self.generation)
        os.write(self.fd, (json.dumps(fields) + "\n").encode())

    def hook(self, torch, signature_graphs):
        """Log every graph ``signature_graphs._capture`` makes and every
        profiler session."""
        self.profiler_on = torch.autograd._profiler_enabled
        capture = signature_graphs._capture

        def logged_capture(graphs, key, args):
            entry, result = capture(graphs, key, args)
            fn = getattr(graphs.fn, "func", graphs.fn)
            owner = getattr(fn, "__qualname__", type(fn).__name__)
            self.graphs += 1
            self.write("captured", graph=self.graphs, owner=owner)
            weakref.finalize(entry.graph, self.write, "destroyed",
                             graph=self.graphs, owner=owner).atexit = False
            return entry, result

        signature_graphs._capture = logged_capture
        profile = torch.profiler.profile
        start, stop = profile.start, profile.stop

        def logged_start(prof):
            self.write("session start")
            start(prof)

        def logged_stop(prof):
            stop(prof)
            self.write("session stop")

        profile.start, profile.stop = logged_start, logged_stop


class Collector:
    """``--gc``: the collector at 13 (c)'s first profiled graph replay of
    each timing run (``train_graph_timing``: round 0 profiles the eager
    arm's step, then the graph arm's)."""

    def __init__(self, mode: str, cs, lifetimes: Lifetimes):
        self.mode, self.cs, self.lifetimes = mode, cs, lifetimes
        self.sessions = None  # profiled steps of the timing run under way
        self.timing = cs.train_graph_timing
        self.profile = cs.profile_counts
        cs.train_graph_timing = self.train_graph_timing
        cs.profile_counts = self.profile_counts

    def dropping(self):
        """Called before each arm that is dropped: from the first on, the
        automatic collector is off under every mode but ``none``."""
        if self.mode != "none" and gc.isenabled():
            gc.disable()
            self.lifetimes.write("gc disabled")

    def train_graph_timing(self, arms, setup):
        self.sessions = 0
        try:
            return self.timing(arms, setup)
        finally:
            self.sessions = None

    def profile_counts(self, fn):
        if self.sessions is not None:
            self.sessions += 1
            if self.sessions == 2 and self.mode == "before":
                self.collect("gc.collect before the session")
            elif self.sessions == 2 and self.mode == "inside":
                inner = fn

                def fn():
                    self.collect("gc.collect inside the session")
                    return inner()

        return self.profile(fn)

    def collect(self, label):
        self.lifetimes.write(label)
        found = gc.collect()
        self.lifetimes.write(label + ": done", unreachable=found)


class Dropped:
    """The LOCK_BERT-off graph arms this run builds and drops (or holds,
    with ``--hold``)."""

    def __init__(self, cs, setup, args, collector):
        self.cs, self.setup, self.args, self.held = cs, setup, args, []
        self.collector = collector
        self.opt = {k: v for k, v in setup["opt"].items() if k != "LOCK_BERT"}

    def run(self, label):
        self.collector.dropping()
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


def smoke_form(cs, args, lifetimes, collector) -> None:
    """Phases 1-12 of ``chip_smoke.py`` (less ``--skip``), 13 (a), then
    ``--reps`` times 13 (f) and 13 (c); ``smoke_inside``: 13 (a) as it
    first ran, and no 13 (f) before the first 13 (c)."""
    def phase13(setup, drive):
        lifetimes.phase = "13 (a)"
        if args.form == "smoke_inside":
            arms = equality_inside(cs, setup,
                                   Dropped(cs, setup, args, collector))
        else:
            arms = cs.train_graph_equality(setup, drive)
        for rep in range(args.reps):
            if rep or args.form == "smoke":
                lifetimes.phase = f"13 (f) rep {rep}"
                collector.dropping()
                cs.dropped_graph_arms(setup, drive)
            lifetimes.phase = f"13 (c) rep {rep}"
            cs.train_graph_timing(arms, setup)
            print(f"rep {rep}: 13 (c) ran", flush=True)
        if args.then_release:
            release_steps(cs, args.then_release, lifetimes, setup, drive)

    lifetimes.phase = "phases 1-12"
    cs.run(phase13=phase13, skip=args.skip)


def release_owners(cs, setup, reqs):
    """The owners whose graphs ``--form release`` frees between two
    profiler sessions, each with its graphs captured: (name, graphs,
    release) as ``chip_smoke.released_between_sessions`` takes them. Each
    frees through the port's API: ``InferenceEngine.quantize()``,
    ``InferenceEngine.close()`` and the engine dropped, a LOCK_BERT-off
    train step called with a new state (its graphs for the old one go, the
    new one's are captured), a LOCK_BERT-off train step dropped."""
    held = {}
    for name in ("quantize", "close"):
        held[name] = cs.build_engine("auto", setup["params"])[0]
        held[name].predict(reqs)
    lock_off = {k: v for k, v in setup["opt"].items() if k != "LOCK_BERT"}
    for name in ("new state", "dropped"):
        step, state, batches = cs.train_arm(setup, lock_off, True)
        cs.run_arm(step, state, batches)
        held[name] = (step, state, batches)

    def close():
        held.pop("close").close()

    def new_state():
        step, _, batches = held.pop("new state")
        state = cs.train_arm(setup, lock_off, True)[1]
        step(state, *batches[0])
        held["new state"] = (step, state, batches)

    def drop():
        del held["dropped"]

    return [
        ("InferenceEngine.quantize()", lambda: held["quantize"].eval_step,
         lambda: held["quantize"].quantize()),
        ("InferenceEngine.close(), then dropped",
         lambda: held["close"].eval_step, close),
        ("a LOCK_BERT-off train step called with a new state",
         lambda: held["new state"][0].graphs, new_state),
        ("a LOCK_BERT-off train step dropped",
         lambda: held["dropped"][0].graphs, drop)]


def release_steps(cs, reps, lifetimes, setup, drive) -> None:
    """The collector off, a kept fp32 graph train arm and a kept graph
    engine, then ``reps`` times: the owners of :func:`release_owners`
    built, a profiler session replaying the kept train graph and the kept
    engine's eval graphs, every owner released outside any session, and a
    second session replaying the kept graphs (``chip_smoke.
    released_between_sessions``)."""
    gc.disable()  # every graph goes through the port's API
    lifetimes.write("gc disabled")
    lifetimes.phase = "release: kept"
    step, state, batches = cs.train_arm(setup, setup["opt"], True)
    cs.run_arm(step, state, batches)
    reqs = cs.requests()
    engine = cs.build_engine("auto", setup["params"])[0]
    engine.predict(reqs)  # captures this pass's signatures
    for rep in range(reps):
        lifetimes.phase = f"release rep {rep}: owners"
        owners = release_owners(cs, setup, reqs)
        lifetimes.phase = f"release rep {rep}"
        destroyed, held, launches = cs.released_between_sessions(
            (step, state, setup["batches"][0]), engine, reqs, owners,
            drive, f"release rep {rep}")
        lifetimes.phase = f"release rep {rep}: owners dropped"
        del owners
        print(f"release rep {rep}: {destroyed} of {held} graphs destroyed "
              f"between two profiler sessions, graph launches {launches}",
              flush=True)


def release_form(cs, args, lifetimes) -> None:
    """Phases 1-12 of ``chip_smoke.py`` (less ``--skip``), then
    :func:`release_steps` ``--reps`` times."""
    def phase13(setup, drive):
        release_steps(cs, args.reps, lifetimes, setup, drive)

    lifetimes.phase = "phases 1-12"
    cs.run(phase13=phase13, skip=args.skip)


def phase6_forms(cs, att, args, lifetimes, collector) -> None:
    """The after and inside forms: phase 6 alone, then 13."""
    t0 = time.time()
    os.makedirs(os.path.join(HERE, "_scratch"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="crash_", dir=os.path.join(HERE, "_scratch"))
    try:
        lifetimes.phase = "phase 6"
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
        dropped = Dropped(cs, setup, args, collector)
        lifetimes.phase = "13 (a)"
        if args.form == "inside":
            arms = equality_inside(cs, setup, dropped)
            print(f"13 (a) done in {time.time() - t0:.1f} s", flush=True)
            lifetimes.phase = "13 (c)"
            cs.train_graph_timing(arms, setup)
        else:
            def drive(label, fn, batches, bf16=False, exact=False):
                return fn()

            arms = cs.train_graph_equality(setup, drive)
            print(f"13 (a) done in {time.time() - t0:.1f} s", flush=True)
            for rep in range(args.reps):
                lifetimes.phase = f"13 (f) rep {rep}"
                for i in range(args.arms):
                    dropped.run(f"rep {rep} extra arm {i}")
                lifetimes.phase = f"13 (c) rep {rep}"
                cs.train_graph_timing(arms, setup)
        del dropped
    finally:
        shutil.rmtree(work, ignore_errors=True)


def harness():
    """This tree's ``chip_smoke.py``, whichever checkout's port is first on
    ``sys.path``: the harness stays the same when ``--root`` changes the
    port."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs  # as an import would register it
    spec.loader.exec_module(cs)
    return cs


def one_process(args) -> int:
    if args.no_teardown:
        os.environ["TEARDOWN_CUPTI"] = "0"
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    root = os.path.abspath(args.root or HERE)
    prefix = args.log_prefix or os.path.join(args.logs, "single")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    faulthandler.enable(all_threads=True)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import native_stack

    native_stack.install(prefix + ".stack")
    lifetimes = Lifetimes(prefix + ".lifetimes.jsonl")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cs = harness()
    from ruart_tpu_torch.ops import attention as att
    from ruart_tpu_torch.utils.graphs import SignatureGraphs

    lifetimes.hook(torch, SignatureGraphs)
    collector = Collector(args.gc, cs, lifetimes)
    print(f"{cs.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {options(args)}; native stack handler "
          f"{'active' if native_stack.active() else 'REPLACED'}; CUPTI "
          + ", ".join(f"{k}={os.environ.get(k)}" for k in
                      ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")),
          flush=True)
    t0 = time.time()
    if args.form == "release":
        release_form(cs, args, lifetimes)
    elif args.form.startswith("smoke"):
        smoke_form(cs, args, lifetimes, collector)
    else:
        phase6_forms(cs, att, args, lifetimes, collector)
    lifetimes.phase = "end"
    print(f"all replays ran in {time.time() - t0:.1f} s; native stack "
          f"handler {'active' if native_stack.active() else 'REPLACED'}; "
          f"{lifetimes.graphs} graphs captured", flush=True)
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
    tag = re.sub(r"[^\w.-]+", "_", "_".join(a.lstrip("-") for a in child_argv)
                 ).strip("_") or "after"
    cmd = [sys.executable, os.path.abspath(__file__), *child_argv]
    print(f"{args.runs} fresh processes of: {' '.join(cmd)}", flush=True)
    rcs = []
    for i in range(args.runs):
        t0 = time.time()
        prefix = os.path.join(args.logs, f"{tag}.{i}")
        with open(prefix + ".log", "w") as log:
            proc = subprocess.Popen(cmd + ["--log-prefix", prefix],
                                    stdout=log, stderr=subprocess.STDOUT)
            try:
                proc.wait(timeout=RUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        rcs.append(proc.returncode)
        with open(prefix + ".log") as f:
            tail = f.read().strip().splitlines()[-2:]
        print(f"run {i}: rc {proc.returncode} in {time.time() - t0:.1f} s; "
              + " | ".join(t[:200] for t in tail), flush=True)
    print(json.dumps({"options": options(args), "runs": len(rcs),
                      "crashed": sum(rc < 0 for rc in rcs),
                      "failed": sum(rc > 0 for rc in rcs), "rcs": rcs}),
          flush=True)
    return 0


def phase_list(text: str):
    """``--skip``: a comma-separated list of phases of SKIPPABLE (phase 11
    reads the files phase 9 writes, phase 12 (f) those of phase 10)."""
    phases = {int(p) for p in text.split(",") if p.strip()}
    if not phases <= set(SKIPPABLE):
        raise argparse.ArgumentTypeError(
            f"only phases {SKIPPABLE} can be skipped")
    for needed, by in NEEDS.items():
        if needed in phases and by not in phases:
            raise argparse.ArgumentTypeError(
                f"phase {by} needs phase {needed}")
    return frozenset(phases)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--form", choices=("after", "inside", "smoke",
                                      "smoke_inside", "release"),
                   default="after")
    p.add_argument("--gc", choices=("none", "before", "inside", "off"),
                   default="none",
                   help="the collector at 13 (c)'s first profiled graph "
                        "replay of each timing run")
    p.add_argument("--skip", type=phase_list, default=frozenset(),
                   help="forms smoke*, release: phases of 1-12 left out")
    p.add_argument("--arms", type=int, default=3,
                   help="LOCK_BERT-off graph arms built and dropped")
    p.add_argument("--hold", action="store_true",
                   help="hold the dropped arms to the end")
    p.add_argument("--reps", type=int, default=1,
                   help="forms after and smoke*: times the dropped arms "
                        "and the timing run; release: times the owners "
                        "and the two sessions")
    p.add_argument("--then-release", type=int, default=0, metavar="N",
                   help="forms smoke*: after 13 (c), in the same process, "
                        "the release form's steps with N reps")
    p.add_argument("--phase6-profile", action="store_true")
    p.add_argument("--sessions", type=int, default=0,
                   help="profiled train steps of the CLI's trainer, one "
                        "session each, before it is dropped")
    p.add_argument("--no-teardown", action="store_true")
    p.add_argument("--root", default="",
                   help="another checkout to run instead")
    p.add_argument("--runs", type=int, default=0,
                   help="fresh processes to start one at a time (0: run "
                        "here)")
    p.add_argument("--logs", default=os.path.join(
        HERE, "_scratch", "train_graph_crash"),
        help="the folder of the runs' outputs, stacks and lifetime logs")
    p.add_argument("--log-prefix", default="", help=argparse.SUPPRESS)
    return p


def main() -> int:
    args = parser().parse_args()
    if args.skip and args.form in ("after", "inside"):
        raise SystemExit("--skip needs a smoke or release form")
    if args.then_release and not args.form.startswith("smoke"):
        raise SystemExit("--then-release needs a smoke form")
    if args.runs:
        return many(args, sys.argv[1:])
    return one_process(args)


if __name__ == "__main__":
    sys.exit(main())
