#!/usr/bin/env python3
"""Attribute the matrix-product kernels of a benchmark cell's step to the
calls that launch them: which Linear, M x N x K, which kernel, its device
time and rate.

    python3 tools/torch_gemm_shapes.py [--cells train-b16,offline-b64]
        [--seed N] [--steps 12] [--out _scratch/gemm_shapes.json]

Builds each cell's path as ``portbench/drivers/<kind>.py`` does (the same
items, conf and seeded weights), then steps it eagerly (``graphs=False``)
under ``torch.profiler`` with input shapes recorded: a graph replay
launches the same kernels as the eager step it was captured from, but
the profiler sees no operator, and so no shape, around a replayed kernel.
Every Linear of the model is labelled with its module name for the
duration of its call, so each product kernel is charged to the Linear
(or to the backward) that launched it. Prints one table per cell and, as
the last line, one JSON object with the rows; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PRODUCT_OPS = ("aten::addmm", "aten::mm", "aten::bmm", "aten::baddbmm",
               "aten::addmv", "aten::mv")


def label_linears(model):
    """Forward hooks that open a ``linear.<name>`` profiler span around
    each ``nn.Linear`` call; returns the hook handles."""
    import torch

    handles = []
    for name, mod in model.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        spans = []

        def pre(_m, _a, name=name, spans=spans):
            span = torch.profiler.record_function(f"linear.{name}")
            span.__enter__()
            spans.append(span)

        def post(_m, _a, _o, spans=spans):
            spans.pop().__exit__(None, None, None)

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post))
    return handles


def owner(evt) -> str:
    """The Linear whose span holds ``evt``, by its kind: the encoder's six
    (``query`` ... ``output_dense``) and the pooler keep their attribute
    name; other Linears are ``fusion``; products outside any Linear are
    ``backward`` (autograd's thread) or ``other``."""
    p = evt.cpu_parent
    while p is not None:
        if p.name.startswith("linear."):
            name = p.name[len("linear."):]
            if name.startswith("Bert."):
                return name.rsplit(".", 1)[-1]
            return "fusion"
        p = p.cpu_parent
    return "backward" if evt.fwd_thread and evt.fwd_thread != evt.thread \
        else "other"


def mnk(op: str, shapes):
    """(M, N, K, batch) of a product op from its recorded input shapes."""
    try:
        if op == "aten::addmm":
            (m, k), (_k, n) = shapes[1], shapes[2]
            return m, n, k, 1
        if op == "aten::mm":
            (m, k), (_k, n) = shapes[0], shapes[1]
            return m, n, k, 1
        if op in ("aten::bmm", "aten::baddbmm"):
            a, b = (shapes[0], shapes[1]) if op == "aten::bmm" else (
                shapes[1], shapes[2])
            return a[1], b[2], a[2], a[0]
        if op in ("aten::addmv", "aten::mv"):
            a = shapes[1] if op == "aten::addmv" else shapes[0]
            return a[0], 1, a[1], 1
    except (IndexError, TypeError, ValueError):
        pass
    return None


def attribute(prof, steps: int):
    """Rows {owner, op, M, N, K, kernel, calls, us} per step, and the
    step's summed kernel time."""
    rows = collections.defaultdict(lambda: [0, 0.0])
    all_us = 0.0
    for evt in prof.events():
        kernels = [(k.name, k.duration) for k in evt.kernels]
        all_us += sum(d for _, d in kernels)
        if evt.name not in PRODUCT_OPS or not kernels:
            continue
        dims = mnk(evt.name, evt.input_shapes)
        if dims is None:
            continue
        who = owner(evt)
        for kname, dur in kernels:
            key = (who, evt.name, *dims, kname[:90])
            rows[key][0] += 1
            rows[key][1] += dur
    out = []
    for (who, op, m, n, kk, b, kern), (calls, us) in rows.items():
        flops = 2.0 * m * n * kk * b * calls
        out.append({"owner": who, "op": op, "M": m, "N": n, "K": kk,
                    "batch": b, "kernel": kern,
                    "calls_per_step": calls / steps,
                    "us_per_step": us / steps,
                    "tflop_per_s": flops / (us * 1e-6) / 1e12 if us else None})
    out.sort(key=lambda r: -r["us_per_step"])
    return out, all_us / steps


def train_cell(run):
    from portbench.drivers import common, train
    from ruart_tpu_torch.data.pipeline import batch_iterator, prefetch
    from ruart_tpu_torch.train.optim import make_row_pinner
    from ruart_tpu_torch.train.train_step import make_train_step

    spans, phases = common.Spans(), common.Phases()
    tr, _raw, _extra, train_data, _ = train.build(run, spans, phases)
    tune = (int(tr.cfg.opt["tune_partial"]) if "TUNE_PARTIAL" in tr.cfg.opt
            else None)
    tr.train_step = make_train_step(
        tr.loss_fn, make_row_pinner(tr.model, tr.spec, tune), graphs=False)
    feed = prefetch(batch_iterator(train_data, train.sampler_for(
        tr, len(train_data)), tr.collator), size=2, host_put=tr._host_put)

    def one():
        q, ocr, od, gt, _ = tr._device_put(next(feed))
        tr.state, loss = tr.train_step(tr.state, q, ocr, od, gt)
        return loss

    return tr.model, one


def offline_cell(run):
    import ruart_tpu_torch.train.train_step as ts
    from portbench.drivers import common, offline
    from ruart_tpu_torch.data.pipeline import device_put_batch, host_batch
    from ruart_tpu_torch.data.sampler import VQASampler

    made = {}
    graphed = ts.make_eval_step

    def eager(model, loss_fn=None, **kw):
        made["model"] = model
        return graphed(model, loss_fn, graphs=False)

    ts.make_eval_step = eager  # offline.build imports it at call time
    try:
        spans, phases = common.Spans(), common.Phases()
        (cfg, spec, device, _raw, _extra, step, dataset, collator,
         _) = offline.build(run, spans, phases)
    finally:
        ts.make_eval_step = graphed
    order = list(VQASampler(len(dataset), cfg.batch_size, train=False))
    slim = bool(int(cfg.opt.get("h2d_slim", 1)))
    at = [0]

    def one():
        idx = order[at[0] % len(order)]
        at[0] += 1
        batch = collator([dataset[i] for i in idx])
        q, ocr, od, gt, _ = device_put_batch(host_batch(batch, spec, slim),
                                             device)
        return step(q, ocr, od, gt)[0]

    return made["model"], one


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default="train-b16,offline-b64")
    p.add_argument("--config", default="stvqa-fp32")
    p.add_argument("--seed", type=int, default=3141592653)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--out", default=os.path.join(ROOT, "_scratch",
                                                 "gemm_shapes.json"))
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness

    if not torch.cuda.is_available():
        print("torch_gemm_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    harness.set_environment()
    bench = harness.benchmark()
    report = {"card": harness.card_line(), "cells": {}}
    print(f"card: {report['card']}", flush=True)
    for mix in args.cells.split(","):
        name = f"{args.config}.{mix}"
        ns = argparse.Namespace(workload=name, seed=args.seed, seconds=1.0,
                                trace=0)
        run = harness.make_run(ns, bench, device, harness.process_age_s())
        model, one = (train_cell if run.traffic["kind"] == "train"
                      else offline_cell)(run)
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        handles = label_linears(model)
        with profile(activities=activities, record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                one()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        for h in handles:
            h.remove()
        rows, device_us = attribute(prof, args.steps)
        report["cells"][name] = {"steps": args.steps,
                                 "device_us_per_step": device_us,
                                 "eager_host_s_per_step": host_s / args.steps,
                                 "rows": rows}
        print(f"\n{name}: {device_us / 1e3:.3f} ms of kernels per eager step")
        print(f"{'owner':24s} {'M':>6s} {'N':>5s} {'K':>5s} {'calls':>6s} "
              f"{'us':>9s} {'TF/s':>6s}  kernel")
        for r in rows[:40]:
            print(f"{r['owner']:24s} {r['M']:6d} {r['N']:5d} {r['K']:5d} "
                  f"{r['calls_per_step']:6.1f} {r['us_per_step']:9.1f} "
                  f"{(r['tflop_per_s'] or 0):6.1f}  {r['kernel'][:70]}")
        del model, one
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"out": args.out, "cells": list(report["cells"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
