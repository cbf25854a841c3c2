"""The training path: ``Trainer.train_step`` (a ``TrainStep`` replaying one
CUDA graph per batch signature on a card) fed by ``data/pipeline.py``'s
``batch_iterator`` + ``prefetch`` with the trainer's ``_host_put`` and
``_device_put``, as ``Trainer.train`` composes them, losses drained every
``drain_every`` steps as ``Trainer.train`` drains them.

Set-up builds one trainer from the seed (items, vocabulary, weights on
the device) and warms every batch signature the checked steps and the
window can reach: the sampler's order is fixed, so the signatures of its
first ``CHECKED + max_steps_per_s * seconds`` batches are collated ahead
and each one is captured and replayed once. It then puts the train state
back as the seed made it, in place (parameters, buffers, moments, the
step count, the dropout generator's state), and drives the first
:data:`CHECKED` steps through the window's own feed and step: replays of
the graphs the window times, which the reference follows. A capture among
them counts against ``train.checked_captures``, whose limit is 0. The
window then goes on with the same feed for ``--seconds`` and ends with a
synchronize. ``train_questions_per_s`` = questions of the steps in the
window over the window.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import check, corpus, trace
from portbench.drivers import common
from portbench.harness import Outcome

CHECKED = 3


class Start:
    """The train state as set-up made it, put back in place by
    :meth:`restore`: the graphs captured since hold the same tensors."""

    def __init__(self, state):
        model, opt = state.model, state.optimizer
        self.params = {n: p.detach().clone() for n, p in opt.params.items()}
        self.tensors = [(p, self.params[n]) for n, p in opt.params.items()]
        self.tensors += [(b, b.detach().clone()) for b in model.buffers()]
        self.tensors += [(t, t.detach().clone()) for moments in
                         opt.state.values() for t in moments.values()]
        self.count, self.step = opt.count, state.step
        self.generator = state.generator.get_state()

    def restore(self, state) -> None:
        import torch

        with torch.no_grad():
            for live, saved in self.tensors:
                live.copy_(saved)
        state.optimizer.count, state.step = self.count, self.step
        state.generator.set_state(self.generator)


def build(run, spans, phases):
    import torch

    from ruart_tpu_torch.data.collate import Collator
    from ruart_tpu_torch.data.dataset import VQADataset
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.text.wordpiece import (
        WordPieceTokenizer, build_demo_vocab)
    from ruart_tpu_torch.train.loss import make_loss_fn
    from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
    from ruart_tpu_torch.train.train_step import (
        init_train_state, make_train_step)
    from ruart_tpu_torch.train.trainer import Trainer

    t = run.traffic
    extra = common.data_keys(run)
    cfg = common.program_conf(run, extra)
    raw = corpus.make_items(t["items"], run.seed, t.get("corpus"),
                            with_answers=True)
    phases.mark("items")
    tok = WordPieceTokenizer(build_demo_vocab())
    tr = Trainer(cfg, common.bert_config(run, tok), device=run.device)
    data = common.featurize(tr.preproc, raw)
    phases.mark("featurize")
    tr.vocab = tr.preproc.train_vocab
    # Trainer.setup_model, with the seed's weights made on the device
    # instead of its host draw and pretrained tables
    tr.tokenizer = tok
    tr.spec = ModelSpec.from_config(cfg, tr.bert_config)
    tr._int8_eval = False
    with tr.device:
        model = RUArtModel(tr.spec)
    from portbench.build import make_weights

    make_weights(model, run.seed)
    tr.collator = common.TimedCollator(Collator(cfg), spans)
    tr._h2d_slim = bool(int(cfg.opt.get("h2d_slim", 1)))
    tr._setup_mesh(model)
    tune = int(cfg.opt["tune_partial"]) if "TUNE_PARTIAL" in cfg.opt else None
    tr.optimizer = Optimizer(
        str(cfg.opt.get("optimizer", "#")),
        float(cfg.opt["lr"]) if "lr" in cfg.opt else None,
        float(cfg.opt.get("grad_clipping", 10)), tr.model, tr.spec,
        tune is not None, mesh=tr.mesh)
    tr.loss_fn = make_loss_fn(str(cfg.opt.get("loss", "BCE_D1")))
    tr.train_step = make_train_step(
        tr.loss_fn, make_row_pinner(tr.model, tr.spec, tune))
    tr.state = init_train_state(tr.model, tr.optimizer, cfg.seed)
    train_data = VQADataset(data, cfg, mode="train", tokenizer=tok)
    phases.mark("model")
    return tr, raw, extra, train_data, torch


def sampler_for(tr, n):
    from ruart_tpu_torch.data.sampler import VQASampler

    opt = tr.cfg.opt
    return VQASampler(n, tr.cfg.batch_size, train=True,
                      max_batch_number=int(opt.get("max_batch_num", 0)) or None,
                      batch_st=0, epoch=opt.get("epoch"))


def run(run) -> Outcome:
    from ruart_tpu_torch.data.pipeline import batch_iterator, host_batch, prefetch
    from ruart_tpu_torch.utils.graphs import signature

    spans, phases = common.Spans(), common.Phases()
    tr, raw, extra, train_data, torch = build(run, spans, phases)
    k1 = common.K1Calls() if tr.device.type == "cuda" else None
    t = run.traffic
    bs = tr.cfg.batch_size
    sampler = common.RecordingSampler(sampler_for(tr, len(train_data)))
    feed = prefetch(batch_iterator(train_data, sampler, tr.collator,
                                   num_workers=int(tr.cfg.opt.get("num_worker", 0))),
                    size=2, host_put=tr._host_put)
    keys = []

    def step(host):
        q, ocr, od, gt, _extra = tr._device_put(host)
        key = signature((q, ocr, od, gt))
        keys.append(key)

        def go():
            return tr.train_step(tr.state, q, ocr, od, gt)

        tr.state, loss = k1.first_call(key, go) if k1 else go()
        return loss

    def n_graphs():
        graphs = tr.train_step.graphs
        return len(graphs) if graphs is not None else 0

    # warm every signature the checked steps and the window can reach
    start_state = Start(tr.state)
    horizon = CHECKED + int(t["max_steps_per_s"] * run.seconds) + 1
    ahead = sampler_for(tr, len(train_data))
    want = {}
    items = {}
    for n, idx in enumerate(ahead):
        if n >= horizon:
            break
        for i in idx:
            if i not in items:
                items[i] = train_data[i]
        batch = tr.collator.collator([items[i] for i in idx])
        key = signature(host_batch(batch, tr.spec, tr._h2d_slim)[:4])
        if key not in want:
            want[key] = batch
    del items
    phases.mark("signature_scan")
    for _ in range(2):  # its capture, then its first replay
        for batch in want.values():
            step(tr._host_put(batch))
    phases.mark("captures")

    # the checked steps: from the seed's state, through the window's own
    # feed and step, as replays
    start_state.restore(tr.state)
    before = n_graphs()
    losses, grads = [], {}
    opt = tr.optimizer
    b1 = 0.9
    for i in range(CHECKED):
        losses.append(step(next(feed)))
        if i == 0:
            grads = {n: float(st["mu"].double().norm()) / (1 - b1)
                     for n, st in opt.state.items()}
    changes = {n: float((p.detach() - start_state.params[n]).double().norm())
               for n, p in opt.params.items()}
    checked_captures = n_graphs() - before
    del start_state
    prog = {"loss": [float(x) for x in losses], "grad": grads,
            "change": changes}
    phases.mark("checked_steps")
    captures_before = n_graphs()
    if tr.device.type == "cuda":
        torch.cuda.synchronize()

    # the window
    seconds = run.seconds if not run.trace else min(
        run.seconds, float(t.get("trace_seconds", run.seconds)))
    drain_every = int(t.get("drain_every", 30))
    pending, failed, steps = [], 0, 0
    setup_s = run.setup_s()
    first_window_key = len(keys)
    spans.on = run.trace
    fallbacks = tr.collator.dedup_fallbacks
    with trace.Session(run.trace) as session, common.HostWatch() as host:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            pending.append(step(next(feed)))
            steps += 1
            if steps % drain_every == 0:
                failed += _drain(pending, torch)
        failed += _drain(pending, torch)
        if tr.device.type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - start
    spans.on = False
    fallbacks = tr.collator.dedup_fallbacks - fallbacks
    captures = n_graphs() - captures_before
    peak = torch.cuda.max_memory_allocated() if tr.device.type == "cuda" else 0
    window_keys = keys[first_window_key:]
    # index batches of the window's steps (the warm-up's batches came from
    # outside the feed; the feed runs ahead of the steps)
    fed = sampler.batches[CHECKED:CHECKED + steps]
    checked_idx = sampler.batches[:CHECKED]
    k1_totals = k1.totals(window_keys) if k1 else None
    if k1:
        k1.close()
    spec_dtype = tr.spec.bert.dtype if tr.spec.bert else "float32"
    tr.train_step.release()
    warmed = len(want)
    del tr, feed, want
    common.free_memory()

    # the reference
    ref = check.Reference(run.config, extra, run.device, run.seed)
    ds = ref.featurize(raw, raw, "train")
    ref.build_model()
    batches = [ref.collate([ds[i] for i in idx]) for idx in checked_idx]
    ref_steps = check.reference_steps(ref, batches)
    if run.control in ("tf32", "half_batch"):
        # the control (or a fault) put in the program's place: the
        # reference again from the seed's weights, in TF32 or with half of
        # each batch left out of the loss
        ref.build_model()
        with check.precision(run.control == "tf32"):
            prog = check.reference_steps(
                ref, batches, half_batch=run.control == "half_batch")
    numbers, worst = check.train_numbers(prog, ref_steps)
    numbers["checked_captures"] = checked_captures
    compared = check.limited(numbers, run.limits, "train")

    record = {"kind": "train", "spans": spans.seconds,
              "graph_captures": captures, "steps": steps}
    tr_summary = session.read()
    if tr_summary is not None:
        record["trace"] = tr_summary
        flops = {"bert": 0.0, "fp32": 0.0}
        for idx in fed:
            f = _flops(ref, [ds[i] for i in idx], train=True)
            flops["bert"] += f["bert"]
            flops["fp32"] += f["fp32"]
        record["flops"] = flops
        record["bert_dtype"] = spec_dtype
        record["k1"] = k1_totals
    e2e = {"train_questions_per_s": steps * bs / window, "setup_s": setup_s}
    out = Outcome(attempted=steps, failed=failed, e2e=e2e, record=record,
                  compared=compared, memory_peak_bytes=peak,
                  trace=tr_summary)
    out.notes = {"worst_leaf": worst, "warmed_signatures": warmed,
                 "captures_in_window": captures,
                 "dedup_fallbacks_in_window": fallbacks, **host.notes(),
                 "setup_phases": phases.seconds}
    return out


def _flops(ref, items, train):
    from portbench import counts

    return counts.model_flops(ref.model, ref.collate(items), train)


def _drain(pending, torch) -> int:
    """Losses to the host (one copy for the lot); the non-finite count."""
    if not pending:
        return 0
    vals = torch.stack(pending).double().cpu().numpy()
    pending.clear()
    return int((~np.isfinite(vals)).sum())
