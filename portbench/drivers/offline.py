"""The offline scoring path: ``eval/evaluator.py::evaluate`` over a fixed
test set with ``train_step.make_eval_step(model, loss_fn)`` (one CUDA graph
per batch signature on a card), as ``Trainer.predict_for_test`` drives it,
with a timing wrapper as its ``collator``.

Set-up draws the test set from the seed, featurizes it with the port's
``Preprocessor``, makes the weights on the device and scores one whole
pass (every signature of the set is captured there). The window scores
the set pass after pass and closes at the end of the first pass that ends
after ``--seconds``: ``offline_questions_per_s`` = questions scored and
decoded in the window over the window. A sample of the window's batches,
drawn from the seed, is held against the reference.
"""

from __future__ import annotations

import time

from portbench import check, corpus, trace
from portbench.drivers import common
from portbench.harness import Outcome


def build(run, spans, phases):
    import torch

    from ruart_tpu_torch.data.collate import Collator
    from ruart_tpu_torch.data.dataset import VQADataset
    from ruart_tpu_torch.data.preprocess import Preprocessor
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.serve import resolve_device
    from ruart_tpu_torch.text.wordpiece import (
        WordPieceTokenizer, build_demo_vocab)
    from ruart_tpu_torch.train.loss import make_loss_fn
    from ruart_tpu_torch.train.train_step import make_eval_step

    from portbench.build import make_weights

    t = run.traffic
    extra = common.data_keys(run)
    cfg = common.program_conf(run, extra)
    device = resolve_device(run.device)
    raw = corpus.make_items(t["items"], run.seed, t.get("corpus"))
    phases.mark("items")
    tok = WordPieceTokenizer(build_demo_vocab())
    pre = Preprocessor(cfg)
    data = common.featurize(pre, raw)
    phases.mark("featurize")
    spec = ModelSpec.from_config(cfg, common.bert_config(run, tok))
    with device:
        model = RUArtModel(spec)
    make_weights(model, run.seed)
    loss_fn = make_loss_fn(str(cfg.opt.get("loss", "BCE_D1")))
    step = make_eval_step(model, loss_fn)
    dataset = VQADataset(data, cfg, mode="test", tokenizer=tok)
    collator = common.TimedCollator(Collator(cfg), spans)
    phases.mark("model")
    return cfg, spec, device, raw, extra, step, dataset, collator, torch


def run(run) -> Outcome:
    from ruart_tpu_torch.eval.evaluator import evaluate
    from ruart_tpu_torch.utils.graphs import release, signature

    spans, phases = common.Spans(), common.Phases()
    (cfg, spec, device, raw, extra, eval_step, dataset, collator,
     torch) = build(run, spans, phases)
    k1 = common.K1Calls() if device.type == "cuda" else None
    keys, recording = [], [False]

    def step(q, ocr, od, gt):
        key = signature((q, ocr, od, gt))
        if recording[0]:
            keys.append(key)
        if k1 is None:
            return eval_step(q, ocr, od, gt)
        return k1.first_call(key, lambda: eval_step(q, ocr, od, gt))

    def one_pass():
        return evaluate(step, dataset, cfg, spec, device, collator)

    one_pass()  # set-up: every signature of the set is captured here
    phases.mark("warm_pass")
    captures_before = len(eval_step) if hasattr(eval_step, "__len__") else 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = run.seconds if not run.trace else min(
        run.seconds, float(run.traffic.get("trace_seconds", run.seconds)))
    setup_s = run.setup_s()
    # only the last pass's answers are kept (the check reads them), as a
    # caller of the evaluator keeps one pass's: holding every pass would
    # grow the heap the collector walks
    last, failed, ends = None, 0, []
    spans.on = recording[0] = run.trace
    fallbacks = collator.dedup_fallbacks
    with trace.Session(run.trace) as session, common.HostWatch() as host:
        start = time.perf_counter()
        while last is None or time.perf_counter() - start < seconds:
            last = one_pass()["save_res"]
            failed += sum(1 for x in last if not x["score"] == x["score"])
            ends.append(time.perf_counter() - start)
        if device.type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - start
    spans.on = recording[0] = False
    captures = (len(eval_step) if hasattr(eval_step, "__len__") else 0
                ) - captures_before
    fallbacks_in_window = collator.dedup_fallbacks - fallbacks
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    n = len(dataset)
    bs = cfg.batch_size
    n_batches = -(-n // bs)
    checked = common.sample(run.seed, n_batches,
                            int(run.traffic.get("checked_batches", 4)), 3)
    answers = [[(r, last[b * bs + r]["prediction"], last[b * bs + r]["idx"],
                 last[b * bs + r]["score"]) for r in range(bs)
                if b * bs + r < n] for b in checked]
    attempted = len(ends) * n
    k1_totals = k1.totals(keys) if k1 else None
    if k1:
        k1.close()
    bert_dtype = spec.bert.dtype if spec.bert else "float32"
    release(eval_step)
    del eval_step, last
    common.free_memory()

    ref = check.Reference(run.config, extra, run.device, run.seed)
    ref_data = ref.featurize(raw, raw, "test")
    ref.build_model()
    batches = [ref.collate([ref_data[i] for i in
                            range(b * bs, min(n, (b + 1) * bs))])
               for b in checked]
    if getattr(run, "control", None) == "tf32":
        answers = _tf32_answers(ref, batches, answers)
    numbers = check.answer_numbers(ref, batches, answers)
    compared = check.limited(numbers, run.limits, "offline")

    record = {"kind": "offline", "spans": spans.seconds,
              "graph_captures": captures}
    summary = session.read()
    if summary is not None:
        from portbench import counts

        per_pass = {"bert": 0.0, "fp32": 0.0}
        for b in range(n_batches):
            f = counts.model_flops(ref.model, ref.collate(
                [ref_data[i] for i in range(b * bs, min(n, (b + 1) * bs))]),
                train=False)
            per_pass["bert"] += f["bert"]
            per_pass["fp32"] += f["fp32"]
        p = attempted // n
        record.update(trace=summary, k1=k1_totals, bert_dtype=bert_dtype,
                      flops={k: v * p for k, v in per_pass.items()})
    e2e = {"offline_questions_per_s": attempted / window, "setup_s": setup_s}
    out = Outcome(attempted=attempted, failed=failed, e2e=e2e,
                  record=record, compared=compared, memory_peak_bytes=peak,
                  trace=summary)
    out.notes = {"passes": attempted // n,
                 "pass_s": [round(b - a, 3) for a, b in zip([0.0] + ends, ends)],
                 "captures_in_window": captures,
                 "dedup_fallbacks_in_window": fallbacks_in_window,
                 **host.notes(), "setup_phases": phases.seconds}
    return out


def _tf32_answers(ref, batches, answers):
    """The control: the reference in TF32 put in the program's place."""
    from portbench.reference.decoder import decode_answer

    out = []
    with check.precision(True):
        for batch, rows in zip(batches, answers):
            probs = ref.scores(batch)
            got = []
            for row, _a, _i, _s in rows:
                d = decode_answer(probs[row], batch[4][row]["ocr_list"],
                                  int(batch[1]["num"][row]), None,
                                  ref.spec.label_yesno,
                                  ref.spec.label_no_answer)
                got.append((row, d["answer"], d["idx"], d["score"]))
            out.append(got)
    return out
