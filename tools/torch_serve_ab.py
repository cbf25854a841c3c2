#!/usr/bin/env python3
"""Time the PyTorch port's serving paths on one CUDA card, for this tree
and an earlier one, in one call.

    python3 tools/torch_serve_ab.py [--parent DIR] [--rounds 2] [--switch S]

``DIR`` holds an earlier checkout (``git archive <commit> | tar -x -C
DIR``, in an ignored folder such as ``_scratch/``). Each arm runs in a
child Python with its own tree first on ``sys.path``, in the order
parent, change, change, parent (without ``--parent``: this tree twice;
``--rounds 2`` runs the order twice). ``--switch S`` adds, after each
arm, the same tree with ``sys.setswitchinterval(S)`` (seconds; CPython's
default is 0.005): how long a thread that asks for the GIL may wait for
one that holds it. A child builds the serving engine of ``chip_smoke.py``
phase 2 (BERT-base, batch 16, seeded random weights; the kernel built
from its tree) and, on the same 40 requests after one warm pass, times:

* one batch's forward on the card, from a synchronized start: the host
  time until the call returns (its launches) and the wait for the device
  after it (ms, medians over 3 passes of the batches);
* ``predict`` and ``chip_smoke.serial_predict`` (the batches one after
  the other, no prefetch thread): requests per second of five calls
  each, in turns (host clock, synchronized);
* ``BatchingServer(max_wait_ms=10)``: three bursts of the 40 requests on
  one server; for each, the time from the burst's submit to each
  request's result (ms; the p50, the first and the last) and q/s.

Prints the card and one JSON line per child.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str, switch: float) -> dict:
    import importlib.util

    sys.path.insert(0, tree)
    import torch

    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from ruart_tpu_torch.serve import BatchingServer

    if switch:
        sys.setswitchinterval(switch)
    engine, _ = smoke.build_engine("auto")
    reqs = smoke.requests()
    engine.predict(reqs)
    # host time for a batch's forward to return (its launches), then the
    # wait for the device to finish it
    enqueue, wait = [], []
    for _ in range(3):
        for _, _, (q, ocr, od, _gt, _extra) in engine._collated_batches(reqs):
            blocks = [engine.to_device(b) for b in (q, ocr, od)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._forward(blocks)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append((t1 - t0) * 1e3)
            wait.append((time.perf_counter() - t1) * 1e3)
    qps = {"predict": [], "serial": []}
    for i in range(5):
        arms = ("predict", "serial") if i % 2 == 0 else ("serial", "predict")
        for arm in arms:
            fn = (engine.predict if arm == "predict"
                  else lambda r: smoke.serial_predict(engine, r))
            qps[arm].append(smoke.timed_qps(lambda: fn(reqs))[1])

    bursts = []
    with BatchingServer(engine, max_wait_ms=10) as server:
        for _ in range(3):
            done = []
            t0 = time.perf_counter()
            futs = [server.submit(r) for r in reqs]
            for f in futs:
                f.add_done_callback(
                    lambda _f: done.append((time.perf_counter() - t0) * 1e3))
            for f in futs:
                f.result(timeout=300)
            while len(done) < len(futs):  # callbacks run after result()
                time.sleep(1e-3)
            done.sort()
            bursts.append({"p50_ms": statistics.median(done),
                           "first_ms": done[0], "last_ms": done[-1],
                           "qps": len(done) / done[-1] * 1e3})
    torch.cuda.synchronize()
    return {"tree": os.path.relpath(tree, HERE) or ".",
            "switch_interval_s": sys.getswitchinterval(),
            "forward_enqueue_ms": statistics.median(enqueue),
            "forward_wait_ms": statistics.median(wait),
            "predict_qps": qps["predict"],
            "predict_median": statistics.median(qps["predict"]),
            "serial_qps": qps["serial"],
            "serial_median": statistics.median(qps["serial"]),
            "bursts": bursts}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="an earlier checkout")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--switch", type=float, default=0.0,
                        help="also run each arm at this GIL switch interval")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.switch)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = ([os.path.abspath(args.parent), HERE, HERE,
              os.path.abspath(args.parent)] if args.parent else [HERE, HERE])
    switches = [0.0, args.switch] if args.switch else [0.0]
    for tree in order * args.rounds:
        for switch in switches:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree,
                 "--switch", str(switch)], capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
